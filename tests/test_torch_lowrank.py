"""NuclearRegularization and LLRRegularization of rls_tpu_torch against
rls_tpu on the same numpy inputs: Nuclear at svt_shape (8, 6) and (6, 8),
real and complex, against JAX's XLA SVD and (real float32) its Jacobi SVD;
LLR with and without the random block shift (JAX's shifts fed through the
private ``_shifts``), fully overlapping, its ``value`` over partial blocks
and L = 2 chunks, a batch with one λ per problem in one batched SVT;
``convert`` of both; and a FISTA solve with LLR on a small dynamic
problem, whose dispatch falls back with named reasons.

Tolerances: against JAX's XLA SVD 1e-5 of max|x| in float32 and 1e-10
in float64 (two SVD implementations); against JAX's one-sided Jacobi SVD
the 5e-5 of tests/test_prox.py:130."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import auto as tauto
from rls_tpu_torch.models import prox as tprox

TOL = {"float32": 1e-5, "float64": 1e-10, "complex64": 1e-5, "complex128": 1e-10}
X64 = {"float32": False, "float64": True, "complex64": False, "complex128": True}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


def _data(rng, dtype, shape):
    x = rng.normal(size=shape)
    if dtype.startswith("complex"):
        x = x + 1j * rng.normal(size=shape)
    return x.astype(dtype)


def _jax_shifts(seed, block_size):
    """rls_tpu's shifts (prox.py:451-456), drawn in the current x64 mode, as
    its prox draws them (x64 draws other bits)."""
    key = jax.random.PRNGKey(seed)
    return tuple(int(jax.random.randint(jax.random.fold_in(key, d), (), 0, b))
                 for d, b in enumerate(block_size))


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64", "complex128"])
@pytest.mark.parametrize("svt_shape", [(8, 6), (6, 8)])
def test_nuclear_matches_jax_xla_svd(rng, dtype, svt_shape):
    """prox (a batch of 3, one λ per problem) and value of Nuclear against
    JAX's XLA SVD; convert carries svt_shape and svd_method."""
    X = _data(rng, dtype, (3, 48))
    lams = np.array([0.5, 0.0, 2.0])
    with jax.enable_x64(X64[dtype]):
        jr = rt.NuclearRegularization(0.5, svt_shape=svt_shape, svd_method="xla")
        want = np.stack([np.asarray(jr.prox(jnp.asarray(x), lam)) for x, lam in zip(X, lams)])
        want_v = [float(jr.value(jnp.asarray(x))) for x in X]
    tr = convert(jr, device="cpu")
    assert (tr.svt_shape, tr.svd_method) == (svt_shape, "xla")
    got = tr.prox(torch.from_numpy(X), torch.from_numpy(lams))
    _close(got.numpy(), want, TOL[dtype], "prox")
    np.testing.assert_allclose(tr.value(torch.from_numpy(X)).numpy(), want_v,
                               rtol=TOL[dtype] * 10)


@pytest.mark.parametrize("svt_shape", [(8, 6), (6, 8)])
def test_nuclear_matches_jax_jacobi_svd(rng, svt_shape):
    """Against JAX's one-sided Jacobi SVT (its "auto" on real float32) at
    the 5e-5 of tests/test_prox.py:130: the port runs torch.linalg.svd for
    every svd_method."""
    X = _data(rng, "float32", (2, 48))
    jr = rt.NuclearRegularization(0.3, svt_shape=svt_shape)
    want = np.stack([np.asarray(jr.prox(jnp.asarray(x))) for x in X])
    got = convert(jr, device="cpu").prox(torch.from_numpy(X))
    _close(got.numpy(), want, 5e-5, "jacobi")


SHAPE, K = (6, 5), 4  # partial blocks of 2 x 2: 6 = 3 * 2, 5 = 2 * 2 + 1


@pytest.mark.parametrize("dtype", ["float32", "complex128"])
@pytest.mark.parametrize("randshift", [False, True])
def test_llr_matches_jax(rng, dtype, randshift):
    """LLR's non-overlapping prox on a batch of 2 (one λ per problem, one
    batched SVT), with JAX's shifts fed in; the port's own shifts are a
    pure function of the seed."""
    X = _data(rng, dtype, (2, SHAPE[0] * SHAPE[1] * K))
    lams = np.array([0.3, 1.1])
    with jax.enable_x64(X64[dtype]):
        jr = rt.LLRRegularization(0.3, shape=SHAPE, block_size=(2, 2), randshift=randshift,
                                  seed=7, svd_method="xla")
        want = np.stack([np.asarray(jr.prox(jnp.asarray(x), lam)) for x, lam in zip(X, lams)])
        shifts = _jax_shifts(7, (2, 2))
    tr = convert(jr, device="cpu")
    assert (tr.seed, tr.randshift, tr._shifts) == (7, randshift, None)
    assert tr.shifts() == tprox.llr_shifts(7, (2, 2)) == tr.shifts()
    tr = dataclasses.replace(tr, _shifts=shifts)
    got = tr.prox(torch.from_numpy(X), torch.from_numpy(lams))
    _close(got.numpy(), want, TOL[dtype], "prox")


def test_llr_fully_overlapping_matches_jax(rng):
    X = _data(rng, "float64", (2, SHAPE[0] * SHAPE[1] * K))
    with jax.enable_x64(True):
        jr = rt.LLRRegularization(0.4, shape=SHAPE, block_size=(2, 3), fully_overlapping=True,
                                  svd_method="xla")
        want = np.stack([np.asarray(jr.prox(jnp.asarray(x))) for x in X])
    got = convert(jr, device="cpu").prox(torch.from_numpy(X))
    _close(got.numpy(), want, TOL["float64"], "overlapping")


@pytest.mark.parametrize("randshift", [False, True])
def test_llr_value_full_blocks_and_chunks(rng, randshift):
    """value counts full blocks only (a 6 x 5 image has no full block in its
    last column) over L = 2 chunks, each rolled by the prox's shifts."""
    X = _data(rng, "float64", (3, SHAPE[0] * SHAPE[1] * K * 2))
    with jax.enable_x64(True):
        jr = rt.LLRRegularization(0.25, shape=SHAPE, block_size=(2, 2), randshift=randshift,
                                  L=2, seed=3, svd_method="xla")
        want = [float(jr.value(jnp.asarray(x))) for x in X]
        shifts = _jax_shifts(3, (2, 2))
    tr = dataclasses.replace(convert(jr, device="cpu"), _shifts=shifts)
    got = tr.value(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # the partial blocks matter: with them the sum is larger
    full = dataclasses.replace(tr, shape=(6, 4))
    assert float(full.value(torch.from_numpy(X[:, : 6 * 4 * K * 2]))[0]) > 0


def test_llr_fista_dynamic_solve_matches_jax(rng):
    """FISTA with LLR (4 x 4 blocks, randshift) on a dynamic series: 8 x 8
    frames x 6 time points of rank-2 content, sampled by a Gaussian sensing
    matrix; batch 2, 10 iterations, against JAX in float64. The dispatch
    falls back with the fused rows' named reasons."""
    n, T = 8, 6
    U = rng.normal(size=(2, n * n, 2))
    V = rng.normal(size=(2, 2, T))
    X = np.einsum("bir,brt->bit", U, V).reshape(2, -1)
    A = rng.normal(size=(200, n * n * T)) / np.sqrt(200)
    B = (X @ A.T + 1e-3 * rng.normal(size=(2, 200))).T
    with jax.enable_x64(True):
        jr = rt.LLRRegularization(0.05, shape=(n, n), block_size=(4, 4), seed=11,
                                  svd_method="xla")
        js = rt.FISTA.create(jnp.asarray(A), reg=jr, rho=0.5, iterations=10)
        want = np.asarray(rt.solve_batched_unrolled(js, jnp.asarray(B)))
        shifts = _jax_shifts(11, (4, 4))
    ts = convert(js, device="cpu")
    ts = dataclasses.replace(ts, reg=dataclasses.replace(ts.reg, _shifts=shifts))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = tauto.solve_batched_fast(ts, torch.from_numpy(B)).numpy()
    msg = " ".join(str(w.message) for w in caught)
    assert "falling back" in msg and "pgm_dense: " in msg
    _close(got, want, 1e-10, "fista-llr")
    assert isinstance(rtt.sink(ts.reg), rtt.LLRRegularization)
