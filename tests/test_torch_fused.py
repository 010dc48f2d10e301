"""The flagship slice of rls_tpu_torch against rls_tpu on the same numpy
inputs: the plain version of the fused FISTA-TV kernel against the JAX
fused kernel in the fold form the chip runs (interpret mode), FISTA's
restart modes and the rejections the port shares with the JAX function,
the f64 momentum table, the dispatch of solve_batched_fast with its named
rejections, and the import hygiene of the package."""

import importlib
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.kernels._fgp_common import _fgp_t2_schedule
from rls_tpu.models.solvers import solve_batched_unrolled as jax_unrolled
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import _fgp_common, auto
from rls_tpu_torch.kernels import fista_tv_fused as tfused
from rls_tpu_torch.kernels import tv_fgp

# the module, not the function rls_tpu.kernels re-exports under its name
jfused = importlib.import_module("rls_tpu.kernels.fista_tv_fused")
K = 3


def _problem(n, normalize=None, reg=None, compensated=True, **kw):
    """A FISTA-TV deblurring problem in rls_tpu (f32, compensated factors
    unless asked otherwise, the Pallas TV backend), with its
    measurements."""
    rng = np.random.default_rng(7)
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    kern = np.outer(g, g)
    kern /= kern.sum()
    op = rt.SeparableConvOperator.from_kernel(kern, im_shape=(n, n), compensated=compensated)
    if reg is None:
        reg = rt.TVRegularization(1e-3, shape=(n, n), iterations_tv=4, backend="pallas")
    solver = rt.FISTA.create(
        op, reg=reg, iterations=6, rho=0.9, rel_tol=0.0, track_residual=False,
        normalize_reg=normalize or rt.NoNormalization(), **kw,
    )
    X = rng.normal(size=(K, n * n)).astype(np.float32)
    B = np.array(jax.vmap(op.mv)(jnp.asarray(X)).T)
    return solver, B


_CASES = {
    # 24²: the JAX kernel routes to its exact-f32 stencil Gram, as the port
    "24": (24, None, 1e-5),
    # per-problem λ from the measurement-based normalization
    "24-measurement": (24, rt.MeasurementBasedNormalization(), 1e-5),
    # 64²: the JAX kernel routes to its bf16 hi/lo Gram, which drops the
    # lo·lo products at ~2⁻¹⁶ (the bar of tests/test_kernels.py:102)
    "64": (64, None, 1e-4),
}


@pytest.fixture(scope="module")
def jax_fused():
    """JAX fused results per case, in the fold form the chip runs."""
    out = {}
    for name, (n, norm, _) in _CASES.items():
        solver, B = _problem(n, norm)
        want = jfused.solve_pgm_tv_fused(
            solver, jnp.asarray(B), interpret=True, fgp_unroll=True, fgp_opt="fold"
        )
        out[name] = (solver, B, np.asarray(want))
    return out


@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_plain_matches_jax_fused(jax_fused, case):
    solver, B, want = jax_fused[case]
    tol = _CASES[case][2]
    before = tfused.fista_tv_fused.launches
    got = rtt.solve_fista_tv_fused(convert(solver, device="cpu"), torch.from_numpy(B))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert tfused.fista_tv_fused.launches == before  # CPU: plain version


def test_slice_solve_batched_fast_matches_jax(jax_fused):
    """The whole slice: the JAX problem, converted, through the port's
    dispatch. On CPU the fused row runs its plain version (no launch), and
    no fallback warning is raised."""
    solver, B, want = jax_fused["24"]
    tsolver = convert(solver, device="cpu")
    before = (tfused.fista_tv_fused.launches, tv_fgp.prox_tv2d_fgp.launches)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = rtt.solve_batched_fast(tsolver, torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # the composed driver with the TV kernel's plain version matches the
    # composed JAX driver with the Pallas TV kernel (both on plain f32
    # Gram products: the JAX operator without its bf16 hi/lo compensation)
    solver_c, _ = _problem(24, compensated=False)
    want_c = np.asarray(jax_unrolled(solver_c, jnp.asarray(B)))
    got_c = rtt.solve_batched_unrolled(convert(solver_c, device="cpu"), torch.from_numpy(B))
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-5)
    assert (tfused.fista_tv_fused.launches, tv_fgp.prox_tv2d_fgp.launches) == before


def test_solve_batched_fast_names_every_rejection():
    solver, B = _problem(12, reg=rt.L1Regularization(1e-3))
    tsolver = convert(solver, device="cpu")
    Bt = torch.from_numpy(B)
    with pytest.warns(UserWarning) as rec:
        got = rtt.solve_batched_fast(tsolver, Bt)
    msg = str(rec[0].message)
    assert "pgm_tv: fused path requires TVRegularization" in msg
    assert "fista_tv_tiled: tiled path requires TVRegularization" in msg
    assert "admm_tv: fused path requires an ADMM solver" in msg
    assert "admm_tv_tiled: tiled path requires an ADMM solver" in msg
    assert "cgnr_dense: fused CGNR path requires a CGNR solver" in msg
    assert "pgm_dense: fused dense PGM path requires a dense operator A" in msg
    for name in auto._NOT_YET_PORTED:
        assert f"{name}: not yet ported" in msg
    assert len(auto._NOT_YET_PORTED) == 6
    np.testing.assert_array_equal(got.numpy(), rtt.solve_batched_unrolled(tsolver, Bt).numpy())


@pytest.mark.parametrize("restart", ["gradient", "gradient_mapping"])
def test_fused_rejects_what_is_not_yet_ported(restart):
    """FISTA's restart modes ride the fused kernel's dynamic schedule and
    match the JAX fused kernel (fold FGP, 1e-5); what the JAX function
    rejects, the port rejects with the same reason: warm_tv or interleave
    beside a restart, early exit for OptISTA, gradient_mapping for POGM."""
    solver, B = _problem(12, restart=restart)
    tsolver = convert(solver, device="cpu")
    Bt, Bj = torch.from_numpy(B), jnp.asarray(B)
    assert tfused.check_pgm_tv_fused(tsolver) == "fista" == jfused.check_pgm_tv_fused(solver)
    want = jfused.solve_pgm_tv_fused(solver, Bj, interpret=True, fgp_unroll=True)
    got = tfused.solve_pgm_tv_fused(tsolver, Bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    cases = [
        (solver, {"warm_tv": True}, "warm_tv requires FISTA with restart='none'"),
        (solver, {"interleave": 2}, "interleave > 1 is the fixed-schedule"),
    ]
    if restart == "gradient":
        other = rt.OptISTA.create(solver.A, reg=solver.reg, rho=0.9, rel_tol=1e-3)
        cases.append((other, {"early_exit": True}, "early_exit is FISTA/POGM-only"))
    else:
        other = rt.POGM.create(solver.A, reg=solver.reg, rho=0.9, restart=restart)
        cases.append((other, {}, "gradient_mapping restart is a FISTA mode"))
    for jsolver, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            tfused.solve_pgm_tv_fused(convert(jsolver, device="cpu"), Bt, **kw)
        with pytest.raises(ValueError, match=match):
            jfused.solve_pgm_tv_fused(jsolver, Bj, interpret=True, fgp_unroll=True, **kw)


@pytest.mark.parametrize("iterations", [1, 8, 50])
def test_momentum_tables_match_jax_bitwise(iterations):
    np.testing.assert_array_equal(
        tfused._momentum_table("fista", iterations),
        jfused._momentum_table("fista", iterations),
    )
    t2 = _fgp_t2_schedule(iterations)
    want = np.asarray([[np.float32(1.0 + t), np.float32(t)] for t in t2], np.float32)
    np.testing.assert_array_equal(_fgp_common.fgp_t2_table(iterations), want)


def test_import_hygiene():
    """rls_tpu_torch and every module in it import neither jax nor rls_tpu."""
    code = (
        "import pkgutil, sys, rls_tpu_torch\n"
        "for m in pkgutil.walk_packages(rls_tpu_torch.__path__, 'rls_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'rls_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
