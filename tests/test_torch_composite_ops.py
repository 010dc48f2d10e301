"""The composite operators of rls_tpu_torch against rls_tpu on the same
numpy inputs: WeightingOperator, ProdOperator (and ``A @ B``),
StackedOperator and SamplingOperator, each in float64 (JAX x64, scoped;
1e-12 relative) and float32 (1e-5 of max|x|), batched (leading axes)
against a JAX ``vmap``; their adjoint identities, ``normal`` and row
access; the weighted Kaczmarz of tests/test_kaczmarz.py:54-65 and the
stacked coils of tests/test_multicoil.py; the composite device rule;
``power_iterations`` on a composite; and ``convert`` of each."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu_torch.convert import convert

M, N, P = 12, 8, 3
DTYPES = ["float32", "float64", "complex64", "complex128"]
TOL = {"float32": 1e-5, "complex64": 1e-5, "float64": 1e-12, "complex128": 1e-12}


def _draw(rng, shape, dtype):
    v = rng.normal(size=shape)
    if dtype.startswith("complex"):
        v = v + 1j * rng.normal(size=shape)
    return v.astype(dtype)


def _close(got, want, dtype, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * max(float(np.abs(want).max()), 1e-30), (what, err)


def _hold(jop, top, dtype, rng, ops=("mv", "rmv", "normal")):
    """Each method of `top` on a (2, P, k) batch against the JAX operator
    vmapped twice, and the adjoint identity ⟨A x, y⟩ = ⟨x, Aᴴ y⟩."""
    n, m = jop.in_size, jop.out_size
    X = _draw(rng, (2, P, n), dtype)
    Y = _draw(rng, (2, P, m), dtype)
    for name in ops:
        V = Y if name == "rmv" else X
        want = jax.jit(jax.vmap(jax.vmap(getattr(jop, name))))(jnp.asarray(V))
        _close(getattr(top, name)(torch.from_numpy(V)).numpy(), want, dtype, name)
    x, y = torch.from_numpy(X[0, 0]), torch.from_numpy(Y[0, 0])
    lhs = torch.vdot(top.mv(x).to(y.dtype), y)
    rhs = torch.vdot(x, top.rmv(y).to(x.dtype))
    assert abs(complex(lhs - rhs)) <= 1e3 * TOL[dtype] * abs(complex(lhs)) + 1e-12


def _weighting(rng, dtype, m=M):
    w = _draw(rng, (m,), dtype)
    return rt.WeightingOperator(jnp.asarray(w)), rtt.WeightingOperator(w, device="cpu")


def _dense(rng, dtype, m=M, n=N):
    A = _draw(rng, (m, n), dtype)
    return rt.DenseOperator(jnp.asarray(A)), rtt.DenseOperator(A, device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_weighting_matches_jax(rng, dtype):
    with jax.enable_x64(dtype in ("float64", "complex128")):
        jop, top = _weighting(rng, dtype)
        _hold(jop, top, dtype, rng)
        _close(top.row_norms_sq().numpy(), jop.row_norms_sq(), dtype, "row_norms_sq")
        for i in (0, 5, M - 1):
            _close(top.row(i).numpy(), jop.row(i), dtype, f"row {i}")
        assert top.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_prod_matches_jax(rng, dtype):
    with jax.enable_x64(dtype in ("float64", "complex128")):
        jw, tw = _weighting(rng, dtype)
        jd, td = _dense(rng, dtype)
        jop, top = jw @ jd, tw @ td
        assert isinstance(top, rtt.ProdOperator) and top.shape == (M, N)
        assert top.dtype == td.dtype
        _hold(jop, top, dtype, rng)
        # Weighting ∘ B has row access (the reference's weighted Kaczmarz)
        _close(top.row_norms_sq().numpy(), jop.row_norms_sq(), dtype, "row_norms_sq")
        for i in (0, 7):
            _close(top.row(i).numpy(), jop.row(i), dtype, f"row {i}")
        # a dense product of two dense factors: mv through both, no rows
        jd2, td2 = _dense(rng, dtype, m=N, n=5)
        _hold(jd @ jd2, td @ td2, dtype, rng)
        with pytest.raises(NotImplementedError, match="Weighting"):
            (td @ td2).row(0)


@pytest.mark.parametrize("dtype", ["float32", "complex128"])
def test_stacked_matches_jax(rng, dtype):
    with jax.enable_x64(dtype == "complex128"):
        pairs = [_dense(rng, dtype, m=m) for m in (5, 7, 3)]
        jw, tw = _weighting(rng, dtype, m=N)
        jop = rt.StackedOperator(ops=(pairs[0][0], pairs[1][0] @ jw, pairs[2][0]))
        top = rtt.StackedOperator([pairs[0][1], pairs[1][1] @ tw, pairs[2][1]])
        assert top.shape == (15, N)
        _hold(jop, top, dtype, rng)


@pytest.mark.parametrize("dtype", ["complex64", "complex128", "float32"])
def test_sampling_matches_jax(rng, dtype):
    n = 20
    idx = rng.choice(n, size=9, replace=False).astype(np.int32)  # distinct, unsorted
    with jax.enable_x64(dtype == "complex128"):
        jop = rt.SamplingOperator(idx=jnp.asarray(idx), n=n)
        top = rtt.SamplingOperator(idx, n, device="cpu")
        assert top.dtype == torch.complex64 and top.shape == (9, n)
        _hold(jop, top, dtype, rng)


def test_prod_device_and_matmul():
    """`A @ B` builds a ProdOperator; a composite reports its factors'
    device and raises on factors on different devices."""
    a = rtt.DenseOperator(np.eye(3, dtype=np.float32), device="cpu")
    b = rtt.IdentityOperator(3, torch.float32, device="cpu")
    prod = a @ b
    assert isinstance(prod, rtt.ProdOperator) and prod.device == torch.device("cpu")
    assert torch.equal(a @ torch.ones(3), torch.ones(3))  # a tensor is still a product
    meta = rtt.DenseOperator(torch.empty(3, 3, device="meta"), device="meta")
    with pytest.raises(ValueError, match="different devices|move them"):
        rtt.ProdOperator(a, meta)
    with pytest.raises(ValueError, match="move them"):
        rtt.StackedOperator([a, meta])
    # a buffer-free part built for "cuda" lies on the card's current device
    cuda = rtt.IdentityOperator(3, torch.float32, device="cuda")
    assert rtt.ProdOperator(cuda, rtt.IdentityOperator(3, device="cuda")).device.type == "cuda"
    with pytest.raises(ValueError, match="move them"):
        rtt.ProdOperator(a, cuda)


def test_sparse_operator_moves():
    """``.to`` moves a SparseOperator's buffer (its product helper no longer
    shadows nn.Module._apply), also inside a composite."""
    op = rtt.SparseOperator.from_dense(np.eye(4, dtype=np.float32), device="cpu")
    w = rtt.WeightingOperator(np.arange(1.0, 5.0, dtype=np.float32), device="cpu")
    prod = (w @ op).to(torch.float64)
    assert prod.A.weights.dtype == torch.float64 and prod.B.mat.dtype == torch.float64
    np.testing.assert_allclose(prod.mv(torch.ones(4, dtype=torch.float64)).numpy(),
                               [1.0, 2.0, 3.0, 4.0])


def test_weighted_kaczmarz_equals_dense(rng):
    """tests/test_kaczmarz.py:54-65 in the port: Kaczmarz on Weighting ∘ A
    equals Kaczmarz on the dense weighted matrix, and both equal rls_tpu."""
    A = rng.normal(size=(12, 6)).astype(np.float32)
    xt = rng.normal(size=(6,)).astype(np.float32)
    b = A @ xt
    w = rng.uniform(0.5, 1.5, size=(12,)).astype(np.float32)
    bw = w * b
    prod = rtt.WeightingOperator(w, device="cpu") @ rtt.DenseOperator(A, device="cpu")
    dense = rtt.DenseOperator(w[:, None] * A, device="cpu")
    xs = [rtt.solve(rtt.Kaczmarz.create(op, reg=rtt.L2Regularization(1e-5), iterations=50),
                    torch.from_numpy(bw)) for op in (prod, dense)]
    np.testing.assert_allclose(xs[0].numpy(), xs[1].numpy(), atol=1e-4)
    jprod = rt.ProdOperator(rt.WeightingOperator(jnp.asarray(w)), rt.DenseOperator(jnp.asarray(A)))
    want = rt.solve(rt.Kaczmarz.create(jprod, reg=rt.L2Regularization(1e-5), iterations=50),
                    jnp.asarray(bw))
    np.testing.assert_allclose(xs[0].numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def _multicoil(rng, n=8, ncoil=3, frac=0.6, dtype=np.complex64):
    """tests/test_multicoil.py's operator, [S·F·C₁; S·F·C₂; ...], in both
    packages."""
    idx = np.sort(rng.choice(n * n, size=int(n * n * frac), replace=False)).astype(np.int32)
    yy, xx = np.mgrid[0:n, 0:n] / n
    jops, tops = [], []
    for c in range(ncoil):
        sens = (0.5 + 0.5 * np.exp(-((yy - c / ncoil) ** 2 + xx**2))).astype(dtype)
        sens = sens.reshape(-1)
        jops.append(rt.ProdOperator(rt.SubsampledFFTOperator(sample_idx=jnp.asarray(idx),
                                                             im_shape=(n, n)),
                                    rt.WeightingOperator(jnp.asarray(sens))))
        tops.append(rtt.SubsampledFFTOperator(idx, (n, n), device="cpu")
                    @ rtt.WeightingOperator(sens, device="cpu"))
    return rt.StackedOperator(ops=tuple(jops)), rtt.StackedOperator(tops), n


def test_multicoil_stacked_coils(rng):
    """tests/test_multicoil.py's stacked coils: the operator against JAX,
    and a batched ADMM-L1 slice solve on it (float64) against JAX's."""
    jop, top, _ = _multicoil(rng)
    _hold(jop, top, "complex64", rng)
    with jax.enable_x64():
        jop, top, n = _multicoil(rng, dtype=np.complex128)
        imgs = np.zeros((2, n, n))
        imgs[0, 2:6, 3:7] = 1.0
        imgs[1, 1:4, 1:5] = 0.5
        X = imgs.reshape(2, -1).astype(np.complex128)
        B = top.mv(torch.from_numpy(X))
        kw = dict(iterations=6, iterations_cg=4, rho=0.01)
        got = rtt.solve_batched_unrolled(
            rtt.ADMM.create(top, reg=rtt.L1Regularization(1e-4), **kw), B.T.contiguous())
        js = rt.ADMM.create(jop, reg=rt.L1Regularization(1e-4), **kw)
        want = rt.solve_batched_unrolled(js, jnp.asarray(B.numpy().T))
        _close(got.numpy(), want, "complex128", "ADMM on the stacked coils")
    err = float(np.linalg.norm(got.numpy().T - X) / np.linalg.norm(X))
    assert err < 0.8


def test_power_iterations_on_composite(rng):
    """power_iterations runs on a composite (its dtype, device and mv) and
    finds the largest eigenvalue of its normal operator."""
    _, top, _ = _multicoil(rng)
    lam = float(rtt.power_iterations(rtt.NormalOperator(top, device="cpu"), maxiter=200,
                                     rtol=1e-8))
    dense = top.to_dense().numpy()
    want = float(np.linalg.eigvalsh(dense.conj().T @ dense).max())
    assert abs(lam - want) <= 1e-3 * want
    w = rtt.WeightingOperator(np.array([3.0, 1.0, 0.5], np.float32), device="cpu")
    d = rtt.DenseOperator(np.eye(3, dtype=np.float32), device="cpu")
    assert abs(float(rtt.power_iterations(rtt.NormalOperator(w @ d, device="cpu"))) - 9.0) < 1e-3


def test_convert_composites(rng):
    """convert carries each composite (and `A @ B` inside a stack) over to
    the same operator."""
    jw, _ = _weighting(rng, "complex64")
    jd, _ = _dense(rng, "complex64")
    idx = np.array([4, 0, 9, 2], np.int32)
    jops = [jw, jw @ jd, rt.StackedOperator(ops=(jd, jw @ jd)),
            rt.SamplingOperator(idx=jnp.asarray(idx), n=12)]
    for jop in jops:
        top = convert(jop, device="cpu")
        assert type(top).__name__ == type(jop).__name__
        X = _draw(rng, (2, jop.in_size), "complex64")
        want = jax.vmap(jop.mv)(jnp.asarray(X))
        _close(top.mv(torch.from_numpy(X)).numpy(), want, "complex64", type(jop).__name__)
