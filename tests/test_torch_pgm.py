"""The PGM-TV family of rls_tpu_torch against rls_tpu on the same numpy
inputs: the composed OptISTA and POGM solvers (f32 and f64), every
schedule of the fused kernel's plain version against the JAX fused kernel
(interpret mode, fold FGP), the OptISTA and POGM momentum tables bit for
bit, the interleave option, and the slice through solve_batched_fast.

Tolerances: composed solvers 1e-5 in f32 and 1e-10 in f64 (the same f32
or f64 ops in another order); fused schedules 1e-5 at 24², where both
sides run the exact f32 stencil Gram and the fold FGP (the JAX warm loop
runs its unrolled form, the same f32 math up to ≤ 1 ulp); 1e-4 at 64²,
where the JAX kernel's bf16 hi/lo Gram drops the lo·lo products
(~2⁻¹⁶)."""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.kernels.auto import solve_batched_fast as jax_fast
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import fista_tv_fused as tfused

jfused = importlib.import_module("rls_tpu.kernels.fista_tv_fused")
K = 3
# a well-conditioned 3-tap blur, on which the restarts fire
MILD = (0.1, 1.0, 0.1)
GAUSS5 = tuple(np.exp(-((np.arange(5) - 2) ** 2) / 2.0))


def _problem(cls, n=24, taps=MILD, dtype="float32", compensated=True,
             backend="pallas", iterations=12, rho=0.9, **kw):
    """A PGM-TV deblurring problem in rls_tpu (`cls` "FISTA", "OptISTA" or
    "POGM") with K measurement columns."""
    g = np.asarray(taps)
    kern = np.outer(g, g)
    kern /= kern.sum()
    jdt = getattr(jnp, dtype)
    op = rt.SeparableConvOperator.from_kernel(kern, im_shape=(n, n), dtype=jdt,
                                              compensated=compensated)
    reg = rt.TVRegularization(1e-3, shape=(n, n), iterations_tv=5, backend=backend)
    solver = getattr(rt, cls).create(op, reg=reg, iterations=iterations, rho=rho, **kw)
    rng = np.random.default_rng(7)
    X = rng.normal(size=(K, n * n)).astype(dtype)
    B = np.array(jax.vmap(op.mv)(jnp.asarray(X)).T)
    return solver, B


_COMPOSED = {
    "optista": ("OptISTA", {}),
    "pogm": ("POGM", {}),
    "pogm-gradient": ("POGM", {"restart": "gradient", "sigma_fac": 0.8}),
}


@pytest.mark.parametrize("case", sorted(_COMPOSED))
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
def test_composed_pgm_matches_jax(case, dtype, tol):
    cls, kw = _COMPOSED[case]
    with jax.enable_x64(dtype == "float64"):
        jsolver, B = _problem(cls, n=12, dtype=dtype, compensated=False, backend="xla",
                              iterations=8, rel_tol=1e-3,
                              normalize_reg=rt.MeasurementBasedNormalization(), **kw)
        want_u = np.asarray(rt.solve_batched_unrolled(jsolver, jnp.asarray(B)))
        want_b = np.asarray(rt.solve_batched(jsolver, jnp.asarray(B)))
    tsolver = convert(jsolver, device="cpu")
    assert type(tsolver) is getattr(rtt, cls)
    Bt = torch.from_numpy(B)
    got_u = rtt.solve_batched_unrolled(tsolver, Bt)
    got_b = rtt.solve(tsolver, Bt)
    assert got_u.dtype == got_b.dtype == Bt.dtype
    np.testing.assert_allclose(got_u.numpy(), want_u, rtol=0, atol=tol)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=tol)


def test_pogm_restart_changes_the_trajectory():
    """The composed POGM restart actually fires on the comparison's
    problem: it moves the answer away from the no-restart schedule."""
    runs = []
    for kw in ({}, {"restart": "gradient", "sigma_fac": 0.8}):
        jsolver, B = _problem("POGM", n=12, compensated=False, backend="xla",
                              iterations=8, **kw)
        tsolver = convert(jsolver, device="cpu")
        runs.append(rtt.solve_batched_unrolled(tsolver, torch.from_numpy(B)))
    assert float((runs[0] - runs[1]).abs().max()) > 1e-5


# (solver class, solver kwargs, solve kwargs)
_SCHEDULES = {
    "optista": ("OptISTA", {}, {}),
    "pogm": ("POGM", {}, {}),
    "fista-gradient": ("FISTA", {"restart": "gradient"}, {}),
    "fista-gradient_mapping": ("FISTA", {"restart": "gradient_mapping"}, {}),
    "pogm-gradient": ("POGM", {"restart": "gradient", "sigma_fac": 0.8}, {}),
    "fista-early": ("FISTA", {"rel_tol": 0.05}, {"early_exit": True}),
    "pogm-early": ("POGM", {"rel_tol": 0.05}, {"early_exit": True}),
    "pogm-early-gradient": (
        "POGM", {"rel_tol": 0.05, "restart": "gradient", "sigma_fac": 0.8},
        {"early_exit": True},
    ),
    "fista-warm": ("FISTA", {}, {"warm_tv": True}),
}


def _plain_with_counts(tsolver, B, early_exit=False, warm_tv=False):
    method = tfused.check_pgm_tv_fused(tsolver)
    restart, rel_tol, sigma_fac = tfused.solver_schedule(tsolver, method, early_exit, warm_tv)
    x0hat, lam = tfused.prepare(tsolver, B)
    return tfused.fista_tv_fused(
        x0hat, tsolver.AHA.A.taps_hw(), tsolver.rho, lam, tsolver.iterations,
        tsolver.reg.iterations_tv, method=method, restart=restart, rel_tol=rel_tol,
        sigma_fac=sigma_fac, warm_tv=warm_tv, with_counts=True,
    )[1]


@pytest.mark.parametrize("case", sorted(_SCHEDULES))
def test_fused_schedules_match_jax_fused(case):
    cls, skw, fkw = _SCHEDULES[case]
    solver, B = _problem(cls, **skw)
    want = np.asarray(jfused.solve_pgm_tv_fused(
        solver, jnp.asarray(B), interpret=True, fgp_unroll=True, **fkw))
    tsolver = convert(solver, device="cpu")
    Bt = torch.from_numpy(B)
    before = tfused.fista_tv_fused.launches
    got = rtt.solve_pgm_tv_fused(tsolver, Bt, **fkw)
    assert tfused.fista_tv_fused.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the schedule really runs on this problem: restarts fire, freezes
    # come before the last iteration
    counts = _plain_with_counts(tsolver, Bt, **fkw)
    if skw.get("restart", "none") != "none":
        assert int(counts[:, 0].sum()) > 0, counts
    if fkw.get("early_exit"):
        assert int(counts[:, 1].max()) < solver.iterations, counts
    else:
        assert counts[:, 1].tolist() == [solver.iterations] * K


@pytest.mark.parametrize("method", ["optista", "pogm"])
@pytest.mark.parametrize("iterations", [1, 8, 50])
def test_pgm_momentum_tables_match_jax_bitwise(method, iterations):
    np.testing.assert_array_equal(
        tfused._momentum_table(method, iterations),
        jfused._momentum_table(method, iterations),
    )


def test_interleave_runs_the_one_kernel():
    """interleave > 1 is accepted where the JAX function accepts it and
    gives the interleave=1 result; JAX's interleaved kernel agrees to its
    hi/lo Gram's 1e-4 (64²)."""
    solver, B = _problem("POGM", n=64, taps=GAUSS5, iterations=6)
    tsolver = convert(solver, device="cpu")
    Bt = torch.from_numpy(B[:, :2])
    one = rtt.solve_pgm_tv_fused(tsolver, Bt)
    two = rtt.solve_pgm_tv_fused(tsolver, Bt, interleave=2)
    np.testing.assert_array_equal(two.numpy(), one.numpy())
    want = np.asarray(jfused.solve_pgm_tv_fused(
        solver, jnp.asarray(B[:, :2]), interpret=True, fgp_unroll=True, interleave=2))
    np.testing.assert_allclose(two.numpy(), want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="not divisible by interleave"):
        rtt.solve_pgm_tv_fused(tsolver, torch.from_numpy(B), interleave=2)
    small, Bs = _problem("FISTA", n=24)
    with pytest.raises(ValueError, match="% 64"):
        rtt.solve_pgm_tv_fused(convert(small, device="cpu"), torch.from_numpy(Bs[:, :2]),
                               interleave=2)


@pytest.mark.parametrize("cls", ["OptISTA", "POGM"])
def test_slice_solve_batched_fast_matches_jax(cls):
    """OptISTA and POGM through both packages' dispatch: the JAX fused
    kernel (interpret mode, its default fori FGP) and the port's fused
    row (plain version on CPU, no fallback warning)."""
    solver, B = _problem(cls, taps=GAUSS5, iterations=8)
    want = np.asarray(jax_fast(solver, jnp.asarray(B), warn=False))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = rtt.solve_batched_fast(convert(solver, device="cpu"), torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
