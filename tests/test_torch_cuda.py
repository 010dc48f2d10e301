"""rls_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU and skips without one; the
file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.) Odd sizes,
ragged row tiles and asymmetric taps cover what the flagship's symmetric
256² run cannot. Tolerance: 1e-5 of max|x| (about 1 ulp of FMA
contraction per op over a few iterations); the per-problem restart and
freeze counts, and the ADMM kernels' live CG steps, must agree exactly.
The dense kernels (CGNR, dense PGM) sum in double like their plain
versions and are held to the same 1e-5 of max|x| on small systems, with
equal restart counts."""

import numpy as np
import pytest
import torch

import rls_tpu_torch as rtt
from rls_tpu_torch.kernels import admm_tv_fused as admm_fused
from rls_tpu_torch.kernels import admm_tv_tiled as admm_tiled
from rls_tpu_torch.kernels import cgnr_fused as cgnr
from rls_tpu_torch.kernels import pgm_dense_fused as pgm_dense
from rls_tpu_torch.kernels import fista_tv_fused as fused
from rls_tpu_torch.kernels import fista_tv_tiled as tiled
from rls_tpu_torch.kernels import tv_fgp

pytestmark = pytest.mark.cuda

TAPS = ((0.1, 0.5, 0.25, -0.2, 0.05), (0.3, 0.6, 0.1))
# a well-conditioned blur (‖AᴴA‖ ≤ 1), on which the restarts fire
MILD = ((0.1 / 1.2, 1.0 / 1.2, 0.1 / 1.2),) * 2
# (method, restart, rel_tol, sigma_fac, warm_tv)
SCHEDULES = {
    "fista": ("fista", "none", None, 1.0, False),
    "optista": ("optista", "none", None, 1.0, False),
    "pogm": ("pogm", "none", None, 1.0, False),
    "fista-gradient": ("fista", "gradient", None, 1.0, False),
    "fista-gradient_mapping": ("fista", "gradient_mapping", None, 1.0, False),
    "pogm-gradient": ("pogm", "gradient", None, 0.8, False),
    "fista-early": ("fista", "none", 0.05, 1.0, False),
    "pogm-early-gradient": ("pogm", "gradient", 0.05, 0.8, False),
    "fista-warm": ("fista", "none", None, 1.0, True),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, want, rel):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()), err


@pytest.mark.parametrize("shape", [(17, 23), (64, 64), (1, 8)])
@pytest.mark.parametrize("iterations", [0, 1, 7])
def test_tv_fgp_kernel_matches_plain(dev, shape, iterations):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(3, *shape)).astype(np.float32)).to(dev)
    lam = torch.tensor([0.2, 0.0, 0.03], device=dev)
    before = tv_fgp.prox_tv2d_fgp.launches
    got = tv_fgp.prox_tv2d_fgp(x.reshape(3, -1), lam, shape, iterations).reshape(x.shape)
    assert tv_fgp.prox_tv2d_fgp.launches == before + 1
    _close(got, tv_fgp.prox_tv2d_fgp_torch(x, lam, iterations), 1e-5)


def _inputs(dev, shape, seed=4):
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.normal(size=(3, *shape)).astype(np.float32)).to(dev)
    rho = torch.tensor([0.9, 0.5, 0.7], device=dev)
    lam = torch.tensor([1e-2, 0.0, 0.1], device=dev)
    return x0, rho, lam


def _plain(x0, taps, rho, lam, iterations, tv_iterations, schedule):
    method, restart, rel_tol, sigma_fac, warm = schedule
    scal, tab, t2 = fused.kernel_args(x0, rho, lam, method, iterations, tv_iterations)
    return fused.fista_tv_fused_torch(x0, scal, tab, t2, taps, method, restart, rel_tol,
                                      sigma_fac, warm)


@pytest.mark.parametrize("shape", [(24, 20), (9, 33)])
@pytest.mark.parametrize("tv_iterations", [0, 1, 4])
def test_fused_kernel_matches_plain(dev, shape, tv_iterations):
    x0, rho, lam = _inputs(dev, shape)
    before = fused.fista_tv_fused.launches
    got = fused.fista_tv_fused(x0, TAPS, rho, lam, 8, tv_iterations)
    assert fused.fista_tv_fused.launches == before + 1
    want, _ = _plain(x0, TAPS, rho, lam, 8, tv_iterations, SCHEDULES["fista"])
    _close(got, want, 1e-5)


def _kw(schedule):
    method, restart, rel_tol, sigma_fac, warm = schedule
    return dict(method=method, restart=restart, rel_tol=rel_tol, sigma_fac=sigma_fac)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("shape,taps", [((24, 20), MILD), ((9, 33), TAPS)])
def test_fused_schedules_match_plain(dev, name, shape, taps):
    schedule = SCHEDULES[name]
    x0, rho, lam = _inputs(dev, shape)
    got, counts = fused.fista_tv_fused(
        x0, taps, rho, lam, 12, 4, warm_tv=schedule[4], with_counts=True, **_kw(schedule)
    )
    want, want_counts = _plain(x0, taps, rho, lam, 12, 4, schedule)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("name", sorted(n for n in SCHEDULES if not SCHEDULES[n][4]))
@pytest.mark.parametrize("shape,tile_rows,taps", [((40, 20), 8, MILD), ((33, 17), 5, TAPS)])
@pytest.mark.parametrize("tv_iterations", [0, 4])
def test_tiled_kernel_matches_plain(dev, name, shape, tile_rows, taps, tv_iterations):
    schedule = SCHEDULES[name]
    x0, rho, lam = _inputs(dev, shape)
    before = tiled.fista_tv_tiled.launches
    got, counts = tiled.fista_tv_tiled(
        x0, taps, rho, lam, 12, tv_iterations, tile_rows=tile_rows, with_counts=True,
        **_kw(schedule),
    )
    dynamic = schedule[1] != "none" or schedule[2] is not None
    assert tiled.fista_tv_tiled.launches == before + 12 + int(dynamic)
    want, want_counts = _plain(x0, taps, rho, lam, 12, tv_iterations, schedule)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()
    # no atomics: the same result run to run
    again = tiled.fista_tv_tiled(x0, taps, rho, lam, 12, tv_iterations,
                                 tile_rows=tile_rows, **_kw(schedule))
    assert torch.equal(again, got)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    op = rtt.SeparableConvOperator.from_taps(*TAPS, (8, 8), device="cpu")
    solver = rtt.FISTA.create(
        op, reg=rtt.TVRegularization(1e-3, shape=(8, 8), backend="cuda"), rho=0.9
    )
    with pytest.raises(ValueError, match="lives on cpu"):
        rtt.solve_batched_fast(solver, torch.zeros(64, 2, device=dev))
    with pytest.raises(ValueError, match="float32"):
        tv_fgp.prox_tv2d_fgp(torch.zeros(2, 64, device=dev, dtype=torch.float64), 0.1, (8, 8), 3)
    with pytest.raises(ValueError, match="float32"):
        tiled.fista_tv_tiled(torch.zeros(2, 8, 8, device=dev, dtype=torch.float64), TAPS,
                             0.9, 0.1, 3, 2)


# ADMM-TV: (prox, tol_inner); a tol_inner of 0.05 makes the CG freeze
ADMM_CASES = {
    "none": ("none", 1e-5),
    "positive": ("positive", 1e-5),
    "freeze": ("none", 5e-2),
    "positive-freeze": ("positive", 5e-2),
}


def _admm_inputs(dev, shape, seed=6):
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.normal(size=(3, *shape)).astype(np.float32)).to(dev)
    rho = torch.tensor([0.1, 0.0, 0.4], device=dev)
    lam = torch.tensor([1e-2, 5e-2, 0.1], device=dev)
    return x0, rho, lam


def _admm_plain(x0, taps, rho, lam, iterations, cg, tv_iterations, prox, tol):
    scal, t2 = admm_fused.kernel_args(x0, rho, lam, tv_iterations)
    return admm_fused.admm_tv_fused_torch(x0, scal, t2, taps, iterations, cg, tol, prox)


@pytest.mark.parametrize("case", sorted(ADMM_CASES))
@pytest.mark.parametrize("shape,taps", [((24, 20), MILD), ((9, 33), TAPS)])
@pytest.mark.parametrize("tv_iterations", [0, 4])
def test_admm_fused_kernel_matches_plain(dev, case, shape, taps, tv_iterations):
    prox, tol = ADMM_CASES[case]
    x0, rho, lam = _admm_inputs(dev, shape)
    before = admm_fused.admm_tv_fused.launches
    got, counts = admm_fused.admm_tv_fused(x0, taps, rho, lam, 6, 5, tv_iterations, tol,
                                           prox=prox, with_counts=True)
    assert admm_fused.admm_tv_fused.launches == before + 1
    want, want_counts = _admm_plain(x0, taps, rho, lam, 6, 5, tv_iterations, prox, tol)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()
    if case.endswith("freeze"):
        assert min(counts.tolist()) < 6 * 5


@pytest.mark.parametrize("case", sorted(ADMM_CASES))
@pytest.mark.parametrize("shape,tile_rows,taps", [((40, 20), 8, MILD), ((33, 17), 5, TAPS)])
@pytest.mark.parametrize("tv_iterations", [0, 4])
def test_admm_tiled_kernel_matches_plain(dev, case, shape, tile_rows, taps, tv_iterations):
    prox, tol = ADMM_CASES[case]
    x0, rho, lam = _admm_inputs(dev, shape)
    before = admm_tiled.admm_tv_tiled.launches
    got, counts = admm_tiled.admm_tv_tiled(x0, taps, rho, lam, 6, 5, tv_iterations, tol,
                                           prox=prox, tile_rows=tile_rows, with_counts=True)
    assert admm_tiled.admm_tv_tiled.launches == before + admm_tiled.launches_per_solve(6, 5)
    want, want_counts = _admm_plain(x0, taps, rho, lam, 6, 5, tv_iterations, prox, tol)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()
    # no atomics: the same result run to run
    again = admm_tiled.admm_tv_tiled(x0, taps, rho, lam, 6, 5, tv_iterations, tol, prox=prox,
                                     tile_rows=tile_rows)
    assert torch.equal(again, got)


def test_admm_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x64 = torch.zeros(2, 8, 8, device=dev, dtype=torch.float64)
    for fn in (admm_fused.admm_tv_fused, admm_tiled.admm_tv_tiled):
        with pytest.raises(ValueError, match="float32"):
            fn(x64, TAPS, 0.1, 0.1, 2, 2, 2, 1e-5)
        with pytest.raises(ValueError, match="unknown prox"):
            fn(x64.float(), TAPS, 0.1, 0.1, 2, 2, 2, 1e-5, prox="real")


@pytest.mark.parametrize("iterations,cg", [(0, 3), (2, 0), (1, 1)])
def test_admm_kernels_short_schedules(dev, iterations, cg):
    """No outer iteration, no CG step, one of each: both kernels give the
    plain version's result and counts."""
    x0, rho, lam = _admm_inputs(dev, (20, 12))
    want, want_counts = _admm_plain(x0, MILD, rho, lam, iterations, cg, 3, "positive", 1e-5)
    for fn, kw in ((admm_fused.admm_tv_fused, {}), (admm_tiled.admm_tv_tiled, {"tile_rows": 6})):
        got, counts = fn(x0, MILD, rho, lam, iterations, cg, 3, 1e-5, prox="positive",
                         with_counts=True, **kw)
        _close(got, want, 1e-5)
        assert counts.tolist() == want_counts.tolist()


def _dense(dev, m=40, n=24, P=3, seed=8, cplx=False):
    """A well-conditioned dense system (m × n, scaled to ‖A‖ ≈ 1 + √(n/m))
    and P right-hand sides; as (re, im) planes with `cplx`."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    A, b = draw(m, n) / np.sqrt(m), draw(P, m)
    if not cplx:
        return A, b
    return (A, draw(m, n) / np.sqrt(m)), (b, draw(P, m))


@pytest.mark.parametrize("steps", [0, 1, 24, 60])
@pytest.mark.parametrize("prox", ["none", "positive"])
def test_cgnr_kernel_matches_plain(dev, steps, prox):
    A, b = _dense(dev)
    lam = torch.tensor([1e-3, 0.0, 0.2], device=dev)
    before = cgnr.cgnr_fused.launches
    got = cgnr.cgnr_fused(b, A, lam, steps, prox)
    assert cgnr.cgnr_fused.launches == before + 1
    want = cgnr.cgnr_fused_torch(b, A, lam, steps, prox)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 1e-5)
    # no atomics: the same result run to run
    assert torch.equal(cgnr.cgnr_fused(b, A, lam, steps, prox), got)


def test_cgnr_kernel_past_convergence_is_the_identity(dev):
    """On A = I with λ = 0 one step solves exactly (r = p = 0 after it);
    the guarded divisions make every later step the identity, and b = 0
    (ζ = 0 from the start) stays at x = 0."""
    b = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 8)).astype(np.float32))
    b = b.to(dev)
    b[1] = 0.0
    eye = torch.eye(8, device=dev)
    got = cgnr.cgnr_fused(b, eye, torch.zeros(2, device=dev), 20)
    assert torch.equal(got, b)


@pytest.mark.parametrize("method,restart", [("fista", "none"), ("fista", "gradient"),
                                            ("fista", "gradient_mapping"), ("optista", "none"),
                                            ("pogm", "none")])
@pytest.mark.parametrize("kind", ["l1", "l2"])
@pytest.mark.parametrize("prox", ["none", "positive"])
def test_pgm_dense_kernel_matches_plain(dev, method, restart, kind, prox):
    A, b = _dense(dev)
    lam = torch.tensor([1e-2, 0.0, 0.1], device=dev)
    args = (lam, 0.5, 1.0, 30, method, kind, restart, prox)
    before = pgm_dense.pgm_dense_fused.launches
    got, counts = pgm_dense.pgm_dense_fused(b, A, *args, with_counts=True)
    assert pgm_dense.pgm_dense_fused.launches == before + 1
    scal, tab = pgm_dense.kernel_args(b, lam, 0.5, 1.0, method, 30)
    want, want_counts = pgm_dense.pgm_dense_fused_torch(b, A, scal, tab, 30, method, kind,
                                                        restart, prox)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()
    if restart != "none":
        assert max(counts.tolist()) > 0
    assert torch.equal(pgm_dense.pgm_dense_fused(b, A, *args), got)


@pytest.mark.parametrize("method,restart", [("fista", "none"), ("fista", "gradient"),
                                            ("fista", "gradient_mapping"), ("optista", "none"),
                                            ("pogm", "none")])
@pytest.mark.parametrize("kind", ["l1", "l2"])
@pytest.mark.parametrize("prox", ["none", "positive", "real"])
def test_pgm_dense_cplx_kernel_matches_plain(dev, method, restart, kind, prox):
    (ar, ai), (br, bi) = _dense(dev, cplx=True)
    lam = torch.tensor([1e-2, 0.0, 0.1], device=dev)
    args = (lam, 0.4, 1.0, 30, method, kind, restart, prox)
    before = pgm_dense.pgm_dense_fused_cplx.launches
    xr, xi, counts = pgm_dense.pgm_dense_fused_cplx(br, bi, ar, ai, *args, with_counts=True)
    assert pgm_dense.pgm_dense_fused_cplx.launches == before + 1
    scal, tab = pgm_dense.kernel_args(br, lam, 0.4, 1.0, method, 30)
    wr, wi, want_counts = pgm_dense.pgm_dense_fused_cplx_torch(br, bi, ar, ai, scal, tab, 30,
                                                               method, kind, restart, prox)
    _close(torch.stack([xr, xi]), torch.stack([wr, wi]), 1e-5)
    assert counts.tolist() == want_counts.tolist()
    if prox != "none":
        assert not bool(xi.any())


def test_dense_wrappers_refuse_what_the_kernels_do_not_take(dev):
    A, b = _dense(dev)
    lam = torch.zeros(3, device=dev)
    with pytest.raises(ValueError, match="device"):
        cgnr.cgnr_fused(b, A.cpu(), lam, 3)
    with pytest.raises(ValueError, match="float32"):
        cgnr.cgnr_fused(b.double(), A, lam, 3)
    with pytest.raises(ValueError, match="device"):
        pgm_dense.pgm_dense_fused(b, A.cpu(), 0.1, 0.5, 1.0, 3)
    with pytest.raises(ValueError, match="restart"):
        pgm_dense.pgm_dense_fused(b, A, 0.1, 0.5, 1.0, 3, method="pogm", restart="gradient")
    with pytest.raises(ValueError, match="float32"):
        pgm_dense.pgm_dense_fused_cplx(b, b, A.double(), A.double(), 0.1, 0.5, 1.0, 3)
