"""DirectConvOperator, WaveletOperator, FunctionOperator and
RadonOperator of rls_tpu_torch against rls_tpu on the same numpy inputs:
each operator's mv / rmv / normal on a batch against a JAX ``vmap``, in
float64 (JAX x64, scoped; 1e-12 relative) and float32 (1e-5 of max|x|),
the adjoint identity ⟨A x, y⟩ = ⟨x, Aᴴ y⟩, odd and even convolution
kernels, real and complex wavelet and function operators (the vjp
adjoint against a dense complex A), the Radon transform at 1e-5, a
composed FISTA-TV solve on the direct convolution, and ``convert``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.ops.wavelet import WAVELET_FILTERS as JAX_FILTERS
from rls_tpu.ops.wavelet import max_wavelet_levels as jax_max_levels
from rls_tpu_torch.convert import convert
from rls_tpu_torch.ops import wavelet as twav

TOL = {"float32": 1e-5, "complex64": 1e-5, "float64": 1e-12, "complex128": 1e-12}
P = 3


def _x64(dtype):
    return jax.enable_x64(dtype in ("float64", "complex128"))


def _draw(rng, shape, dtype):
    v = rng.normal(size=shape)
    if dtype.startswith("complex"):
        v = v + 1j * rng.normal(size=shape)
    return v.astype(dtype)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


def _hold(jop, top, dtype, rng, methods=("mv", "rmv", "normal"), tol=None):
    tol = TOL[dtype] if tol is None else tol
    X = _draw(rng, (P, jop.in_size), dtype)
    Y = _draw(rng, (P, jop.out_size), dtype)
    for name in methods:
        V = Y if name == "rmv" else X
        _close(getattr(top, name)(torch.from_numpy(V)),
               jax.jit(jax.vmap(getattr(jop, name)))(jnp.asarray(V)), tol, name)


def _adjoint(top, dtype, rng, tol):
    x = torch.from_numpy(_draw(rng, (top.in_size,), dtype))
    y = torch.from_numpy(_draw(rng, (top.out_size,), dtype))
    lhs, rhs = torch.vdot(top.mv(x), y), torch.vdot(x, top.rmv(y))
    assert abs(complex(lhs - rhs)) <= tol * abs(complex(lhs)), (complex(lhs), complex(rhs))


# --------------------------------------------------------------------------
# DirectConvOperator
# --------------------------------------------------------------------------

KERNELS = {"3x3": (3, 3), "5x3": (5, 3), "even 4x4": (4, 4), "even 2x5": (2, 5)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_direct_conv_matches_jax(rng, dtype, kernel):
    """SAME padding, (k − 1)//2 before and k//2 after, where an even
    kernel is the case the two could part; rmv the flipped kernel."""
    shape = (12, 10)
    k = rng.normal(size=KERNELS[kernel]).astype(dtype)
    with _x64(dtype):
        jop = rt.DirectConvOperator(kernel=jnp.asarray(k), im_shape=shape)
        top = rtt.DirectConvOperator(k, shape, device="cpu")
        assert top.dtype == torch.from_numpy(k).dtype and top.shape == (120, 120)
        _hold(jop, top, dtype, rng)
        # convert carries the kernel
        _hold(jop, convert(jop, device="cpu"), dtype, rng, ("mv",))
    if kernel in ("3x3", "5x3"):  # exact adjoint for odd sizes
        _adjoint(top, dtype, rng, 1e3 * TOL[dtype])


def test_direct_conv_keeps_tf32_off_and_batches(rng):
    """The operator turns cuDNN's TF32 off only while it convolves, and a
    (2, 3, n) batch is each problem's own convolution (to 1e-6: the
    library may pick another algorithm for another batch)."""
    k = rng.normal(size=(3, 3)).astype(np.float32)
    top = rtt.DirectConvOperator(k, (6, 7), device="cpu")
    X = torch.from_numpy(rng.normal(size=(2, 3, 42)).astype(np.float32))
    before = torch.backends.cudnn.allow_tf32
    out = top.mv(X)
    assert torch.backends.cudnn.allow_tf32 == before
    for i in range(2):
        for j in range(3):
            _close(out[i, j], top.mv(X[i, j]), 1e-6, f"problem {i}, {j}")


def test_separable_refusal_points_at_direct_conv():
    with pytest.raises(ValueError, match="use DirectConvOperator"):
        rtt.SeparableConvOperator.from_kernel(np.eye(3), im_shape=(8, 8), device="cpu")


def test_fista_tv_on_direct_conv_matches_jax(rng):
    """The composed FISTA-TV solve on a non-separable blur, float64,
    batched, against JAX's (1e-12 relative)."""
    n = 12
    yy, xx = np.mgrid[-2:3, -2:3]
    kern = np.exp(-(yy**2 + 2 * xx**2 + yy * xx) / 3.0)
    kern /= kern.sum()
    X = np.zeros((2, n, n))
    X[0, 3:8, 2:6] = 1.0
    X[1, 6:10, 5:11] = 0.5
    with jax.enable_x64():
        jop = rt.DirectConvOperator(kernel=jnp.asarray(kern), im_shape=(n, n))
        top = rtt.DirectConvOperator(kern, (n, n), device="cpu")
        B = top.mv(torch.from_numpy(X.reshape(2, -1))).T.contiguous()
        kw = dict(iterations=6, rho=0.9)
        js = rt.FISTA.create(jop, reg=rt.TVRegularization(1e-3, shape=(n, n), iterations_tv=3),
                             **kw)
        ts = rtt.FISTA.create(top, reg=rtt.TVRegularization(1e-3, shape=(n, n), iterations_tv=3),
                              **kw)
        _close(rtt.solve_batched_unrolled(ts, B), rt.solve_batched_unrolled(js, jnp.asarray(B)),
               1e-12, "FISTA-TV")


# --------------------------------------------------------------------------
# WaveletOperator
# --------------------------------------------------------------------------


def test_wavelet_filters_and_levels():
    assert twav.WAVELET_FILTERS == JAX_FILTERS
    for name, h in twav.WAVELET_FILTERS.items():
        assert abs(sum(h) - np.sqrt(2.0)) < 1e-11 and abs(np.dot(h, h) - 1.0) < 1e-11, name
    for shape in ((64,), (16, 16), (48, 32), (6, 8)):
        for w in ("haar", "db2", "db4", "db8"):
            assert rtt.max_wavelet_levels(shape, w) == jax_max_levels(shape, w)
    with pytest.raises(ValueError, match="unknown wavelet"):
        rtt.WaveletOperator((16,), "db3", device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        rtt.WaveletOperator((12, 16), "haar", levels=3, device="cpu")


WAVELET_CASES = [((64,), "db4", None), ((16, 16), "haar", None), ((16, 32), "db2", 2),
                 ((32, 16), "sym4", 1), ((16, 16), "db1", 3)]
# each case real and complex, in float32 and float64 by turns
WAVELET_DTYPES = [(c, d) for c in range(len(WAVELET_CASES))
                  for d in (("float32", "complex128") if c % 2 else ("float64", "complex64"))]


@pytest.mark.parametrize("case,dtype", WAVELET_DTYPES)
def test_wavelet_matches_jax(rng, case, dtype):
    """Analysis and synthesis in the packed layout, 1-D and 2-D, real and
    complex, batched; synthesis inverts analysis and normal is the
    identity."""
    shape, wav, levels = WAVELET_CASES[case]
    real = "float64" if dtype in ("float64", "complex128") else "float32"
    with _x64(dtype):
        jop = rt.WaveletOperator(im_shape=shape, wavelet=wav, levels=levels,
                                 _dtype=getattr(jnp, real))
        top = rtt.WaveletOperator(shape, wav, levels=levels, dtype=getattr(torch, real),
                                  device="cpu")
        assert top.levels == jop.levels
        _hold(jop, top, dtype, rng)
        X = torch.from_numpy(_draw(rng, (2, P, top.in_size), dtype))
        _close(top.rmv(top.mv(X)), X, 10 * TOL[dtype], "rmv ∘ mv")
        assert top.normal(X) is X
        conv = convert(jop, device="cpu")
        assert (conv.im_shape, conv.wavelet, conv.levels) == (top.im_shape, wav, top.levels)
    _adjoint(top, dtype, rng, 1e3 * TOL[dtype])


# --------------------------------------------------------------------------
# FunctionOperator
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64", "complex128"])
def test_function_operator_matches_dense(rng, dtype):
    """A torch callable x ↦ A x on (n,): mv mapped over a batch, and the
    vjp adjoint equal to Aᴴ y (for complex A torch's convention already
    conjugates), against rls_tpu's linear_transpose adjoint."""
    m, n = 7, 5
    A = _draw(rng, (m, n), dtype)
    At = torch.from_numpy(A)
    with _x64(dtype):
        jop = rt.FunctionOperator(mv_fn=lambda v: jnp.asarray(A) @ v, n=n, m=m,
                                  _dtype=jnp.dtype(dtype))
        top = rtt.FunctionOperator(lambda v: At @ v, n=n, m=m, dtype=At.dtype, device="cpu")
        _hold(jop, top, dtype, rng)
    dense = rtt.DenseOperator(A, device="cpu")
    Y = torch.from_numpy(_draw(rng, (2, P, m), dtype))
    _close(top.rmv(Y), dense.rmv(Y), TOL[dtype], "vjp adjoint vs Aᴴ")
    _close(top.rmv(Y[0, 0]), dense.rmv(Y[0, 0]), TOL[dtype], "one vector")
    _adjoint(top, dtype, rng, 1e3 * TOL[dtype])
    # a hand-written adjoint replaces the vjp
    twice = rtt.FunctionOperator(lambda v: At @ v, rmv_fn=lambda w: 2 * (At.conj().T @ w),
                                 n=n, m=m, dtype=At.dtype, device="cpu")
    _close(twice.rmv(Y), 2 * dense.rmv(Y), TOL[dtype], "rmv_fn")


def test_function_operator_wraps_an_operator(rng):
    """Wrapping another operator's mv (a non-separable convolution): the
    vjp adjoint equals that operator's rmv."""
    k = rng.normal(size=(5, 5))
    conv = rtt.DirectConvOperator(k, (9, 8), device="cpu")
    fop = rtt.FunctionOperator(conv.mv, n=72, m=72, dtype=torch.float64, device="cpu")
    Y = torch.from_numpy(rng.normal(size=(4, 72)))
    _close(fop.rmv(Y), conv.rmv(Y), 1e-12, "vjp vs DirectConvOperator.rmv")
    _close(fop.mv(Y), conv.mv(Y), 1e-12, "mv")
    with pytest.raises(TypeError, match="FunctionOperator"):
        convert(rt.FunctionOperator(mv_fn=lambda v: v, n=3, m=3), device="cpu")


# --------------------------------------------------------------------------
# RadonOperator
# --------------------------------------------------------------------------

RADON_CASES = [(16, 12, 0), (20, 7, 24), (17, 9, 13)]


@pytest.mark.parametrize("case", range(len(RADON_CASES)))
def test_radon_matches_jax(rng, case):
    """Projection and backprojection against rls_tpu's map_coordinates and
    linear_transpose (float32 on both sides) at 1e-5 of max|x|; detectors
    beyond the image read zeros."""
    n, n_ang, n_det = RADON_CASES[case]
    angles = np.linspace(0.0, np.pi, n_ang, endpoint=False).astype(np.float32)
    jop = rt.RadonOperator(angles=jnp.asarray(angles), im_shape=(n, n), num_det=n_det)
    top = rtt.RadonOperator(angles, (n, n), num_det=n_det, device="cpu")
    assert top.shape == jop.shape
    _hold(jop, top, "float32", rng, tol=1e-5)
    _adjoint(top, "float32", rng, 1e-5)
    _hold(jop, convert(jop, device="cpu"), "float32", rng, ("mv",), tol=1e-5)


def test_radon_float64_holds_the_same_weights(rng):
    """An operator of dtype float64 is the same linear map: the float32
    weights, computed once on the host, held in float64."""
    angles = np.linspace(0.0, np.pi, 8, endpoint=False)
    t32 = rtt.RadonOperator(angles, (12, 12), device="cpu")
    t64 = rtt.RadonOperator(angles, (12, 12), dtype=torch.float64, device="cpu")
    assert torch.equal(t64.weights, t32.weights.double()) and torch.equal(t64.idx, t32.idx)
    X = torch.from_numpy(rng.normal(size=(2, 144)))
    _close(t64.mv(X), t32.mv(X.float()).double(), 1e-6, "mv")
    assert t64.mv(X).dtype == torch.float64
    _adjoint(t64, "float64", rng, 1e-12)
