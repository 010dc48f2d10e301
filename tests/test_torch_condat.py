"""The exact 1-D Condat TV of rls_tpu_torch against rls_tpu on the same numpy
inputs: the 1-D prox (N = 1, 2, 64; λ = 0; λ large enough to flatten the
line), ``prox_tv_1d_axis`` along each axis of a 3-D image,
``prox_tv_condat_nd``, a per-problem λ, ``TVRegularization`` with an
integer ``dims`` (real: the Condat prox; complex: the FGP along that axis)
alone and in a FISTA solve of a 32² blur, its ``convert`` and its dispatch
(the composed fallback with a named reason). On CPU tensors the kernel
wrapper runs its plain version: the launch counter stays 0.

Tolerances: the plain version takes the events of the JAX state machine
with the same operations, so it is held bit for bit (float32 and JAX
x64); the FISTA solve (operator products in another order) to 1e-5 of
max|x| in float32 and 1e-10 in float64. The JAX loop compiles per shape,
so the tests reuse a few shapes."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.models import tv_condat as jcondat
from rls_tpu.models.prox import prox_tv_fgp as jax_prox_tv_fgp
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import auto as tauto
from rls_tpu_torch.kernels import tv_condat as kcondat
from rls_tpu_torch.models import tv_condat as tcondat

IMG3 = (5, 6, 7)
DTYPES = [("float32", False), ("float64", True)]


def _jline(c, lam, x64):
    with jax.enable_x64(x64):
        return np.asarray(jax.jit(jcondat.tv_denoise_1d_condat)(jnp.asarray(c), lam))


@pytest.mark.parametrize("dtype,x64", DTYPES)
@pytest.mark.parametrize("N", [1, 2, 64])
def test_1d_prox_matches_jax_bit_for_bit(rng, dtype, x64, N):
    """Lines of N entries at λ = 0, small, medium and flattening λ, each
    line with its own λ: bit for bit the JAX state machine."""
    C = rng.normal(size=(6, N)).astype(dtype)
    lams = np.array([0.0, 0.01, 0.2, 0.7, 50.0, 1e4], dtype)
    want = np.stack([_jline(c, lam, x64) for c, lam in zip(C, lams)])
    before = kcondat.prox_tv1d_condat.launches
    got = tcondat.tv_denoise_1d_condat(torch.from_numpy(C), torch.from_numpy(lams)).numpy()
    assert kcondat.prox_tv1d_condat.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], C[0])  # λ = 0 is the identity
    for k in (-2, -1):  # a λ past the line's total variation flattens it to its
        # mean, up to the rounding of entries offset by λ (a few ulps of λ)
        atol = 16 * np.finfo(dtype).eps * lams[k]
        np.testing.assert_allclose(got[k], np.full(N, C[k].mean()), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,x64", DTYPES)
def test_prox_tv_1d_axis_each_axis_of_a_3d_image(rng, dtype, x64):
    X = rng.normal(size=IMG3).astype(dtype)
    for axis in range(3):
        with jax.enable_x64(x64):
            want = np.asarray(jax.jit(jcondat.prox_tv_1d_axis, static_argnums=2)(
                jnp.asarray(X), 0.3, axis))
        got = tcondat.prox_tv_1d_axis(torch.from_numpy(X), 0.3, axis).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"axis {axis}")


def test_prox_tv_condat_nd_and_a_batch(rng):
    """The averaged axis sweep of one image, and of a batch with one λ per
    problem (batch_dims=1), each problem against JAX."""
    X = rng.normal(size=(3, *IMG3[:2])).astype(np.float32)
    lams = np.array([0.05, 0.4, 0.0], np.float32)
    want = np.stack([np.asarray(jax.jit(jcondat.prox_tv_condat_nd)(jnp.asarray(x), lam))
                     for x, lam in zip(X, lams)])
    one = tcondat.prox_tv_condat_nd(torch.from_numpy(X[1]), float(lams[1])).numpy()
    np.testing.assert_array_equal(one, want[1])
    got = tcondat.prox_tv_condat_nd(torch.from_numpy(X), torch.from_numpy(lams),
                                    batch_dims=1).numpy()
    np.testing.assert_array_equal(got, want)


def test_per_problem_lambda_broadcasts_to_that_problems_lines(rng):
    """λ (B,) on a (B, H, W) batch along axis 1 and axis 2: each problem's
    lines take its λ; a λ of another shape is refused by name."""
    X = rng.normal(size=(3, *IMG3[1:])).astype(np.float32)
    lams = np.array([0.2, 0.0, 1.5], np.float32)
    for axis in (1, 2):
        got = kcondat.prox_tv1d_condat(torch.from_numpy(X), torch.from_numpy(lams), axis)
        for b in range(3):
            want = np.asarray(jax.jit(jcondat.prox_tv_1d_axis, static_argnums=2)(
                jnp.asarray(X[b]), lams[b], axis - 1))
            np.testing.assert_array_equal(got[b].numpy(), want)
    with pytest.raises(ValueError, match="neither a scalar nor a prefix"):
        kcondat.prox_tv1d_condat(torch.from_numpy(X), torch.ones(2), 1)


def test_kernel_check_names_its_reasons():
    """The wrapper's check names why the kernel does not take a tensor."""
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="takes a CUDA tensor"):
        kcondat.check_tv_condat(x, 1)


def _tv1(mod, lam, dims, shape=(12, 10)):
    return mod.TVRegularization(lam, shape=shape, dims=dims, iterations_tv=5)


@pytest.mark.parametrize("dims", [0, 1])
def test_tv_regularization_integer_dims_real(rng, dims):
    """prox (a batch, one λ per problem), value and convert of TV(dims=int)
    on a real image against JAX."""
    X = rng.normal(size=(3, 120)).astype(np.float32)
    lams = np.array([0.1, 0.5, 0.0], np.float32)
    jr = _tv1(rt, 0.1, dims)
    tr = convert(jr, device="cpu")
    assert tr.dims == dims and isinstance(tr, rtt.TVRegularization)
    want = np.stack([np.asarray(jax.jit(jr.prox)(jnp.asarray(x), lam))
                     for x, lam in zip(X, lams)])
    got = tr.prox(torch.from_numpy(X), torch.from_numpy(lams)).numpy()
    np.testing.assert_array_equal(got, want)
    want_v = [float(jr.value(jnp.asarray(x))) for x in X]
    np.testing.assert_allclose(tr.value(torch.from_numpy(X)).numpy(), want_v, rtol=1e-5)


def test_tv_regularization_integer_dims_complex_falls_back_to_fgp(rng):
    """A complex image with an integer dims takes the FGP on the gradient
    along that axis alone, as rls_tpu does."""
    X = (rng.normal(size=(2, 120)) + 1j * rng.normal(size=(2, 120))).astype(np.complex64)
    jr = _tv1(rt, 0.2, 1)
    tr = convert(jr, device="cpu")
    jg = rt.GradientOperator(im_shape=(12, 10), dims=(1,), _dtype=jnp.complex64)
    want = np.stack([np.asarray(jax_prox_tv_fgp(jnp.asarray(x), 0.2, jg, 5)) for x in X])
    before = kcondat.prox_tv1d_condat.launches
    got = tr.prox(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, np.stack([np.asarray(jr.prox(jnp.asarray(x))) for x in X]),
                               rtol=0, atol=1e-5 * np.abs(want).max())
    assert kcondat.prox_tv1d_condat.launches == before


@pytest.mark.parametrize("dtype,x64", DTYPES)
def test_fista_tv_integer_dims_solve_matches_jax(rng, dtype, x64):
    """FISTA + TV(dims=1) on a 32² separable blur, batch 2, 8 iterations,
    against the JAX solve; solve_batched_fast falls back to the composed
    path with the fused rows' named reasons."""
    n = 32
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    g = g / g.sum()  # ‖AᴴA‖ ≤ 1
    X = np.zeros((2, n, n))
    X[:, 8:24, 10:20] = 1.0
    X[1, 4:12, 4:28] += 0.5
    with jax.enable_x64(x64):
        # plain f32 products (no bf16 hi/lo compensation), as the port's
        jop = rt.SeparableConvOperator.from_taps(g, g, (n, n), dtype=getattr(jnp, dtype),
                                                 compensated=False)
        js = rt.FISTA.create(jop, reg=rt.TVRegularization(2e-3, shape=(n, n), dims=1),
                             rho=0.9, iterations=8)
        B = np.asarray(jax.vmap(jop.mv)(jnp.asarray(X.reshape(2, -1).astype(dtype)))).T
        B = B + 1e-3 * rng.normal(size=B.shape).astype(dtype)
        want = np.asarray(rt.solve_batched_unrolled(js, jnp.asarray(B)))
    ts = convert(js, device="cpu")
    assert ts.reg.dims == 1
    with pytest.warns(UserWarning) as rec:
        got = tauto.solve_batched_fast(ts, torch.from_numpy(B)).numpy()
    msg = str(rec[0].message)
    assert "falling back" in msg
    if dtype == "float32":  # (a float64 operator is refused before its TV)
        assert "pgm_tv: fused path requires 2-D TV over both axes" in msg
        assert "fista_tv_tiled: tiled path requires 2-D TV over both axes" in msg
    tol = 1e-5 if dtype == "float32" else 1e-10
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_condat_kernel_launches_nothing_on_the_cpu_in_a_solve():
    """The composed FISTA with TV(dims=0) on CPU tensors: no kernel launch,
    and the same result whatever the TV backend."""
    g = np.array([0.25, 0.5, 0.25])
    op = rtt.SeparableConvOperator.from_taps(g, g, (8, 8), device="cpu")
    B = torch.from_numpy(np.random.default_rng(3).normal(size=(64, 2)).astype(np.float32))
    before = kcondat.prox_tv1d_condat.launches
    outs = []
    for backend in ("torch", "cuda"):
        tv = rtt.TVRegularization(1e-2, shape=(8, 8), dims=0, backend=backend)
        s = rtt.FISTA.create(op, reg=tv, rho=0.9, iterations=4)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            outs.append(rtt.solve_batched_fast(s, B))
    assert kcondat.prox_tv1d_condat.launches == before
    assert torch.equal(outs[0], outs[1])
