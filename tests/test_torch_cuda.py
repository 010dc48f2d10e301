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
equal restart counts. The FFT kernels (FISTA-L1-DFT, FISTA-L21-SENSE)
round every operation as their plain versions do and must agree bit for
bit on both routes; the SplitBregman kernel, whose CG sums are double
sums in another order, is held to 1e-5 of max|x| with equal live CG
steps. The PDHG,
Kaczmarz and greedy Kaczmarz kernels are held to 1e-5 of max|x| on edge
shapes (m, n off multiples of 32, n = 1, k_max = 1, complex, −1 pads, a
CSR row with a genuine column-0 entry), the PDHG kernel's resident route
bit for bit, and the greedy kernel's drawn rows must equal its plain
version's. A cluster kernel's resident route gives the same bits on
every launch (20 repeats): a race between its CTAs would show as a
launch that differs. The fused ADMM-TV kernel's resident route, whose CG
sums are double sums over its cluster in rank order, is held to 1e-5 of
max|x| with equal live CG steps at each cluster size its planner picks.
The TV prox kernel's resident route is held to 1e-5 of max|x| at each
cluster size and plane placement its planner picks, at forced sizes, and
bit for bit over 20 launches. So is row 3's cluster route (the fused
PGM-TV kernel with three planes of a band in shared memory), at every
method and schedule, with equal counts, its two placements bit for bit
alike where both fit."""

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
from rls_tpu_torch.kernels import _dft_common as dft
from rls_tpu_torch.kernels import fista_l1_dft_fused as l1dft
from rls_tpu_torch.kernels import sense_fused as sense
from rls_tpu_torch.kernels import splitbregman_fused as sb
from rls_tpu_torch.kernels import pdhg_fused as pdhg
from rls_tpu_torch.kernels import kaczmarz_streamed as kz
from rls_tpu_torch.kernels import kaczmarz_greedy as greedy
from test_torch_admm_plan import ADMM_ROUTES
from test_torch_admm_plan import H100_RESIDENT as ADMM_RESIDENT
from test_torch_tv_fgp_plan import H100_RESIDENT as TV_RESIDENT
from test_torch_tv_fgp_plan import TV_ROUTES

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


def _tv_inputs(dev, shape, B=3, seed=7):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, *shape)).astype(np.float32)).to(dev)
    lam = torch.linspace(0.0, 0.4, B, device=dev)  # λ = 0 for the first problem
    return x, lam


def _tv_launch(x, lam, iterations, clusters=None):
    """One launch on the plan the card gives x, or with its cluster size
    forced through the private ``_launch`` (and a check that the card holds
    a cluster of it), counted once on that plan's route."""
    if clusters is None:
        plan, active = tv_fgp.plan_on_card(x)
    else:
        plan, active = tv_fgp._card_plan(x.device.index or 0, *x.shape, clusters)
    assert plan.route == "global" or active >= 1
    before = dict(tv_fgp.prox_tv2d_fgp.route_launches)
    if clusters is None:
        got = tv_fgp.prox_tv2d_fgp(x.reshape(x.shape[0], -1), lam, x.shape[1:],
                                   iterations).reshape(x.shape)
    else:
        got = tv_fgp._launch(x, lam, iterations, clusters)
    before[plan.route] += 1
    assert tv_fgp.prox_tv2d_fgp.route_launches == before
    return got, plan


@pytest.mark.parametrize("iterations", [0, 1, 10])
@pytest.mark.parametrize("shape", list(TV_ROUTES))
def test_tv_fgp_routes_match_plain(dev, shape, iterations):
    """Each cluster size the planner picks (3 problems; the last band short),
    with x, pv and ph in shared or in global memory, and the global route,
    each by the route counter: the plain version to 1e-5 of max|x|."""
    x, lam = _tv_inputs(dev, shape)
    got, plan = _tv_launch(x, lam, iterations)
    assert (plan.route, plan.clusters, plan.own) == TV_ROUTES[shape]
    _close(got, tv_fgp.prox_tv2d_fgp_torch(x, lam, iterations), 1e-5)


@pytest.mark.parametrize("iterations", [0, 1, 10])
@pytest.mark.parametrize("shape,clusters", [((47, 40), c) for c in (1, 2, 4, 8, 16)]
                         + [((256, 256), c) for c in (4, 6, 8)])
def test_tv_fgp_forced_cluster_sizes_match_plain(dev, shape, clusters, iterations):
    """Forced cluster sizes on 47 × 40 (bands of 47, 24, 12, 6 and 3 rows,
    the last one short) and on 256² (64 and 43 rows with x, pv and ph in
    global memory, 32 rows with all six planes on chip)."""
    x, lam = _tv_inputs(dev, shape)
    got, plan = _tv_launch(x, lam, iterations, clusters)
    assert (plan.route, plan.clusters, plan.rows) == ("resident", clusters,
                                                      -(-shape[0] // clusters))
    assert plan.own == ("global" if shape == (256, 256) and clusters < 7 else "shared")
    _close(got, tv_fgp.prox_tv2d_fgp_torch(x, lam, iterations), 1e-5)


@pytest.mark.parametrize("iterations", [0, 1, 10])
@pytest.mark.parametrize("shape,clusters", [((256, 256), 8), ((256, 256), 16), ((47, 40), 4)])
def test_tv_fgp_placements_agree_bit_for_bit(dev, shape, clusters, iterations):
    """x, pv and ph in global memory (forced) and in shared memory, at one
    cluster size: the same operations in the same order, the same bits."""
    x, lam = _tv_inputs(dev, shape)
    on_chip, plan = _tv_launch(x, lam, iterations, clusters)
    assert plan.own == "shared"
    forced, held = tv_fgp._card_plan(dev.index or 0, *x.shape, clusters, "global")
    assert (forced.clusters, forced.own, forced.scratch) == (clusters, "global", 2)
    assert held >= 1
    got = tv_fgp._launch(x, lam, iterations, clusters, "global")
    torch.cuda.synchronize()
    assert torch.equal(got, on_chip)


@pytest.mark.parametrize("batch,shape,clusters,own", [(64, (256, 256), 8, "shared"),
                                                      (16, (512, 512), 16, "global"),
                                                      (3, (241, 256), 16, "shared")])
def test_tv_fgp_resident_route_repeats_bit_for_bit(dev, batch, shape, clusters, own):
    """20 launches of the resident route at 10 dual iterations, at the
    flagship's plan, at 512² (x, pv and ph in global memory) and on 16
    bands with a one-row last band: each equal to the first."""
    x, lam = _tv_inputs(dev, shape, batch, seed=6)
    first, plan = _tv_launch(x, lam, 10)
    assert (plan.route, plan.clusters, plan.own) == ("resident", clusters, own)
    for _ in range(20):
        got = tv_fgp.prox_tv2d_fgp(x.reshape(batch, -1), lam, shape, 10).reshape(x.shape)
        assert torch.equal(got, first)


def test_tv_fgp_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, lam = _tv_inputs(dev, (256, 256))
    with pytest.raises(ValueError, match="a cluster of 3 CTAs does not fit"):
        tv_fgp._launch(x, lam, 10, clusters=3)
    with pytest.raises(ValueError, match="takes float32"):
        tv_fgp.prox_tv2d_fgp(x.double().reshape(3, -1), lam.double(), (256, 256), 10)


@pytest.mark.parametrize("shape", [(256, 256), (512, 512), (241, 256), (47, 40), (4, 12000)])
def test_cluster_counts_of_the_tv_fgp_planner_tests(dev, shape):
    """On an H100 the card holds, for every fitting cluster size, the
    clusters of the resident TV prox kernel (with the planes its band
    holds) that tests/test_torch_tv_fgp_plan.py plans with, and counts the
    planner's shared memory."""
    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    H, W = shape
    held = dict(TV_RESIDENT)
    on_chip = tv_fgp.own_shared_sizes(H, W, *limits)
    fit = tv_fgp.fitting_sizes(H, W, *limits)
    assert fit
    for c in fit:
        rows = -(-H // c)
        smem, got = tv_fgp.resident_limits(dev.index, c, rows, W, c in on_chip)
        assert smem == tv_fgp.cluster_smem_bytes(rows, W, c in on_chip)
        assert got == held[c], (c, shape)


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


# a 63-tap column blur (radius 31, the most a kernel takes) beside 3 taps
_G63 = np.exp(-(((np.arange(63) - 31) / 9.0) ** 2)) * (1 + 0.01 * np.arange(63))
TAPS63 = (tuple((_G63 / _G63.sum()).tolist()), (0.3, 0.6, 0.1))
# the fused kernel's shapes (3 problems each) by the route and cluster size
# the planner gives them: one CTA for the small images, then 2, 4, 8 and 16
# bands (150 = 38 × 3 + 36 and 300 = 19 × 15 + 15 rows do not divide into
# their bands, and at 300² the 63-tap column pass reaches two bands past
# its own), and a row too wide for any band on the global route
FUSED_ROUTES = {
    (24, 20): ("resident", 1), (9, 33): ("resident", 1), (100, 120): ("resident", 2),
    (150, 150): ("resident", 4), (200, 250): ("resident", 8), (256, 256): ("resident", 16),
    (300, 300): ("resident", 16), (2, 10000): ("global", 1),
}


def _fused_taps(shape, taps):
    return TAPS63 if shape == (300, 300) else taps


def _fused_route(x0, taps, schedule, shape):
    """Check the plan the card gives x0 (and that it holds a cluster of
    it); returns the route."""
    method, restart, rel_tol, _, warm = schedule
    plan, active = fused.plan_on_card(x0, taps, method, restart, rel_tol, warm)
    assert (plan.route, plan.clusters) == FUSED_ROUTES[shape]
    assert plan.route == "global" or active >= 1
    return plan.route


@pytest.mark.parametrize("shape", [(256, 256), (64, 64), (24, 20), (150, 150), (4096, 16)])
def test_cluster_counts_of_the_planner_tests(dev, shape):
    """On an H100 the card holds, for every fitting cluster size and every
    kernel, the clusters that tests/test_torch_pgm_tv_plan.py plans with."""
    from test_torch_pgm_tv_plan import H100_RESIDENT

    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    H, W = shape
    held = dict(H100_RESIDENT)
    for c in fused.fitting_sizes(H, W, *limits):
        for method, dynamic in (("fista", False), ("optista", False), ("pogm", False),
                                ("fista", True), ("pogm", True)):
            got = fused.resident_limits(dev.index, c, -(-H // c), W, method, dynamic)[1]
            assert got == held[c], (c, method, dynamic)


@pytest.mark.parametrize("shape", list(FUSED_ROUTES))
@pytest.mark.parametrize("tv_iterations", [0, 1, 4])
def test_fused_kernel_matches_plain(dev, shape, tv_iterations):
    x0, rho, lam = _inputs(dev, shape)
    taps = _fused_taps(shape, TAPS)
    route = _fused_route(x0, taps, SCHEDULES["fista"], shape)
    before = fused.fista_tv_fused.launches
    on_route = fused.fista_tv_fused.route_launches[route]
    got = fused.fista_tv_fused(x0, taps, rho, lam, 8, tv_iterations)
    assert fused.fista_tv_fused.launches == before + 1
    assert fused.fista_tv_fused.route_launches[route] == on_route + 1
    want, _ = _plain(x0, taps, rho, lam, 8, tv_iterations, SCHEDULES["fista"])
    _close(got, want, 1e-5)


def _kw(schedule):
    method, restart, rel_tol, sigma_fac, warm = schedule
    return dict(method=method, restart=restart, rel_tol=rel_tol, sigma_fac=sigma_fac)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("shape,taps", [
    ((24, 20), MILD), ((9, 33), TAPS), ((100, 120), MILD), ((150, 150), TAPS),
    ((200, 250), MILD), ((256, 256), MILD), ((300, 300), TAPS), ((2, 10000), TAPS),
])
def test_fused_schedules_match_plain(dev, name, shape, taps):
    schedule = SCHEDULES[name]
    x0, rho, lam = _inputs(dev, shape)
    taps = _fused_taps(shape, taps)
    _fused_route(x0, taps, schedule, shape)
    got, counts = fused.fista_tv_fused(
        x0, taps, rho, lam, 12, 4, warm_tv=schedule[4], with_counts=True, **_kw(schedule)
    )
    want, want_counts = _plain(x0, taps, rho, lam, 12, 4, schedule)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("name", ["fista", "pogm-early-gradient", "fista-warm"])
def test_fused_phase_clocks(dev, name):
    """The resident kernel's phase timer: one launch, the same x as without
    the timer, clocks in every phase a schedule has; the global route has
    no timer and raises."""
    method, restart, rel_tol, sigma_fac, warm = SCHEDULES[name]
    x0, rho, lam = _inputs(dev, (256, 256))
    kw = dict(method=method, restart=restart, rel_tol=rel_tol, sigma_fac=sigma_fac,
              warm_tv=warm)
    before = fused.fista_tv_fused.launches
    clocks = fused.phase_clocks(x0, MILD, rho, lam, 6, 4, **kw)
    assert fused.fista_tv_fused.launches == before + 1
    assert list(clocks) == list(fused.PHASES)
    dynamic = restart != "none" or rel_tol is not None
    for phase, v in clocks.items():
        assert v > 0 or (phase == "sums" and not dynamic), (phase, v)
    with pytest.raises(ValueError, match="resident route"):
        fused.phase_clocks(_inputs(dev, (2, 10000))[0], MILD, rho, lam, 2, 2, **kw)


@pytest.mark.parametrize("batch,clusters", [(8, 8), (7, 16)])
@pytest.mark.parametrize("name", ["fista-gradient", "pogm-early-gradient"])
def test_fused_resident_route_repeats_bit_for_bit(dev, name, batch, clusters):
    """20 launches of the PGM-TV kernel's resident route on a dynamic
    schedule (its cluster sums every iteration) at 256², where batch 8
    takes clusters of 8 and batch 7 clusters of 16: each equal to the
    first, with equal counts."""
    schedule = SCHEDULES[name]
    x0 = torch.from_numpy(np.random.default_rng(6).normal(size=(batch, 256, 256))
                          .astype(np.float32)).to(dev)
    rho = torch.linspace(0.5, 0.9, batch, device=dev)
    lam = torch.linspace(0.0, 0.1, batch, device=dev)
    method, restart, rel_tol, _, warm = schedule
    plan, _ = fused.plan_on_card(x0, MILD, method, restart, rel_tol, warm)
    assert (plan.route, plan.clusters) == ("resident", clusters)
    first, first_counts = fused.fista_tv_fused(x0, MILD, rho, lam, 12, 4, with_counts=True,
                                               **_kw(schedule))
    for _ in range(20):
        got, counts = fused.fista_tv_fused(x0, MILD, rho, lam, 12, 4, with_counts=True,
                                           **_kw(schedule))
        assert torch.equal(got, first) and torch.equal(counts, first_counts)


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


# row 3's cluster route: 7 × 5 taps on an uneven shape
TAPS75 = ((0.05, 0.1, 0.2, 0.3, 0.2, 0.1, 0.05), (0.1, 0.2, 0.4, 0.2, 0.1))
# (shape, taps) of the cluster route's card tests and the plan each takes:
# 512² on c = 16 (32-row bands), 500 × 520 on c = 16 (the last band 20
# rows), both with three planes of a band in shared memory
TILED_CLUSTER = {(512, 512): (TAPS, 16), (500, 520): (TAPS75, 16)}


def _tiled_cluster(x0, taps, schedule, args, clusters=None, own=None):
    """A row-3 launch of (ρ, λ, iterations, dual iterations) `args` on the
    cluster route (its plan, or a forced size and placement), counted once
    on that route."""
    before = dict(tiled.fista_tv_tiled.route_launches)
    got = tiled._run(x0, taps, *args, method=schedule[0], restart=schedule[1],
                     rel_tol=schedule[2], sigma_fac=schedule[3], clusters=clusters, own=own)
    before["cluster"] += 1
    assert tiled.fista_tv_tiled.route_launches == before
    return got


@pytest.mark.parametrize("name", sorted(n for n in SCHEDULES if not SCHEDULES[n][4]))
@pytest.mark.parametrize("shape", list(TILED_CLUSTER))
def test_tiled_cluster_route_matches_plain(dev, name, shape):
    """Row 3's cluster route (three planes of a band in shared memory) on
    its plan, every method and schedule, against the plain version: 1e-5
    of max|x|, equal restart and live counts, one launch by the route
    counter."""
    schedule = SCHEDULES[name]
    taps, c = TILED_CLUSTER[shape]
    x0, rho, lam = _inputs(dev, shape)
    method, restart, rel_tol, _, _ = schedule
    plan, held = tiled.plan_on_card(x0, taps, method, restart, rel_tol)
    assert (plan.route, plan.clusters, plan.own) == ("cluster", c, "global")
    assert held >= 1
    got, counts = _tiled_cluster(x0, taps, schedule, (rho, lam, 12, 4))
    want, want_counts = _plain(x0, taps, rho, lam, 12, 4, schedule)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("tv_iterations", [0, 1, 10])
@pytest.mark.parametrize("clusters", [14, 15, 16])
def test_tiled_cluster_route_at_each_fitting_size(dev, clusters, tv_iterations):
    """The 512² cell's fitting sizes (bands of 37, 35 and 32 rows, the last
    short), with no dual iteration, one (p left in rv by the first sweep)
    and ten."""
    x0, rho, lam = _inputs(dev, (512, 512))
    got, _ = _tiled_cluster(x0, TAPS, SCHEDULES["fista"], (rho, lam, 6, tv_iterations),
                            clusters)
    want, _ = _plain(x0, TAPS, rho, lam, 6, tv_iterations, SCHEDULES["fista"])
    _close(got, want, 1e-5)


@pytest.mark.parametrize("name", ["fista", "optista", "pogm-early-gradient",
                                  "fista-gradient_mapping"])
@pytest.mark.parametrize("clusters", [8, 16])
def test_tiled_placements_agree_bit_for_bit(dev, name, clusters):
    """Three planes of a band in shared memory (forced) and all six, at one
    cluster size of 16 × 256²: the same operations in the same order, the
    same bits and counts."""
    schedule = SCHEDULES[name]
    x0 = torch.from_numpy(np.random.default_rng(9).normal(size=(16, 256, 256))
                          .astype(np.float32)).to(dev)
    rho = torch.linspace(0.5, 0.9, 16, device=dev)
    lam = torch.linspace(0.0, 0.1, 16, device=dev)
    six, held = tiled._card_plan(dev.index or 0, 16, 256, 256, 5, 3, schedule[:2] +
                                 (schedule[2] is not None,), None, clusters)
    assert (six.route, six.own, held >= 1) == ("cluster", "shared", True)
    three, held = tiled._card_plan(dev.index or 0, 16, 256, 256, 5, 3, schedule[:2] +
                                   (schedule[2] is not None,), None, clusters, "global")
    assert (three.own, three.scratch, held >= 1) == ("global", fused.THREE_PLANE_SCRATCH, True)
    a, ca = _tiled_cluster(x0, TAPS, schedule, (rho, lam, 12, 4), clusters)
    b, cb = _tiled_cluster(x0, TAPS, schedule, (rho, lam, 12, 4), clusters, "global")
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(ca, cb)


@pytest.mark.parametrize("batch,shape,name,iterations,tv_iterations", [
    (16, (512, 512), "fista", 50, 10), (3, (500, 520), "pogm-early-gradient", 12, 4)])
def test_tiled_cluster_route_repeats_bit_for_bit(dev, batch, shape, name, iterations,
                                                 tv_iterations):
    """20 launches of the cluster route, at the 512² cell's plan and on a
    dynamic schedule (its cluster sums every iteration) on 500 × 520: each
    equal to the first, with equal counts."""
    schedule = SCHEDULES[name]
    taps = TILED_CLUSTER[shape][0]
    x0 = torch.from_numpy(np.random.default_rng(6).normal(size=(batch, *shape))
                          .astype(np.float32)).to(dev)
    rho = torch.linspace(0.5, 0.9, batch, device=dev)
    lam = torch.linspace(0.0, 0.1, batch, device=dev)
    args = (rho, lam, iterations, tv_iterations)
    first, first_counts = _tiled_cluster(x0, taps, schedule, args)
    for _ in range(20):
        got, counts = _tiled_cluster(x0, taps, schedule, args)
        assert torch.equal(got, first) and torch.equal(counts, first_counts)


def test_tiled_phase_clocks(dev):
    """The cluster route's phase timer: one launch, clocks in every phase a
    dynamic schedule has; the tiles route has no timer and raises."""
    x0, rho, lam = _inputs(dev, (512, 512))
    before = dict(tiled.fista_tv_tiled.route_launches)
    clocks = tiled.phase_clocks(x0, TAPS, rho, lam, 4, 3, method="pogm", restart="gradient",
                                rel_tol=0.05)
    assert tiled.fista_tv_tiled.route_launches["cluster"] == before["cluster"] + 1
    assert list(clocks) == list(fused.PHASES) and all(v > 0 for v in clocks.values())
    with pytest.raises(ValueError, match="a cluster of 13 CTAs does not fit"):
        tiled._run(x0, TAPS, rho, lam, 4, 3, clusters=13)
    x1k = torch.zeros((1, 1024, 1024), device=dev)
    with pytest.raises(ValueError, match="cluster route"):
        tiled.phase_clocks(x1k, TAPS, 0.9, 0.1, 2, 2)


@pytest.mark.parametrize("shape", [(512, 512), (500, 520), (384, 384), (256, 256)])
def test_cluster_counts_of_the_tiled_planner_tests(dev, shape):
    """On an H100 the card holds, for every fitting cluster size and every
    schedule, the clusters of the cluster route (with the planes its band
    holds) that tests/test_torch_tiled_plan.py plans with (the TV prox's
    table), and counts the planner's shared memory."""
    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    H, W = shape
    held = dict(TV_RESIDENT)
    on_chip = tiled.own_shared_sizes(H, W, *limits)
    fit = tiled.fitting_sizes(H, W, *limits)
    assert fit
    for c in fit:
        rows = -(-H // c)
        for method, dynamic in (("fista", False), ("optista", False), ("pogm", False),
                                ("fista", True), ("pogm", True)):
            smem, got = fused.resident_limits(dev.index, c, rows, W, method, dynamic,
                                              c in on_chip)
            assert smem == fused.cluster_smem_bytes(rows, W, c in on_chip)
            assert got == held[c], (c, method, dynamic)


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


def _admm_launch(x0, taps, rho, lam, schedule, prox, tol, clusters=None):
    """One fused ADMM-TV launch, checked by the route counter: (x, counts,
    plan)."""
    plan, active = admm_fused.plan_on_card(x0, taps, clusters)
    assert plan.route == "global" or active >= 1
    before = dict(admm_fused.admm_tv_fused.route_launches)
    got, counts = admm_fused.admm_tv_fused(x0, taps, rho, lam, *schedule, tol, prox=prox,
                                           with_counts=True, clusters=clusters)
    before[plan.route] += 1
    assert admm_fused.admm_tv_fused.route_launches == before
    return got, counts, plan


@pytest.mark.parametrize("case", ["none", "positive-freeze"])
@pytest.mark.parametrize("shape", list(ADMM_ROUTES))
def test_admm_fused_routes_match_plain(dev, shape, case):
    """Each cluster size the planner picks (3 problems; the last band short)
    and the global route: the plain version's x to 1e-5 of max|x| and its
    live CG steps."""
    prox, tol = ADMM_CASES[case]
    x0, rho, lam = _admm_inputs(dev, shape)
    got, counts, plan = _admm_launch(x0, TAPS, rho, lam, (6, 5, 4), prox, tol)
    assert (plan.route, plan.clusters) == ADMM_ROUTES[shape]
    want, want_counts = _admm_plain(x0, TAPS, rho, lam, 6, 5, 4, prox, tol)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("taps", ["taps", "taps63"])
@pytest.mark.parametrize("clusters", [1, 6, 8, 16])
def test_admm_forced_cluster_sizes_match_plain(dev, clusters, taps):
    """Forced cluster sizes on 48 × 64 (bands of 48, 8, 6 and 3 rows); the
    63-tap column blur reaches 10 bands past its own at c = 16."""
    taps = TAPS63 if taps == "taps63" else TAPS
    x0, rho, lam = _admm_inputs(dev, (48, 64))
    got, counts, plan = _admm_launch(x0, taps, rho, lam, (6, 5, 4), "positive", 1e-5, clusters)
    assert (plan.route, plan.clusters, plan.rows) == ("resident", clusters, -(-48 // clusters))
    want, want_counts = _admm_plain(x0, taps, rho, lam, 6, 5, 4, "positive", 1e-5)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("prox", ["none", "positive"])
@pytest.mark.parametrize("iterations,cg,tv", [(0, 3, 4), (3, 0, 4), (3, 1, 4), (3, 3, 0),
                                              (2, 2, 1)])
def test_admm_resident_edge_schedules_match_plain(dev, iterations, cg, tv, prox):
    """The barrier table's edge schedules on 6 bands of 46 rows (the last
    6): no outer iteration, 0 and 1 CG steps, no and one dual iteration,
    and ρ = 0 for one problem."""
    x0, rho, lam = _admm_inputs(dev, (46, 64))
    got, counts, plan = _admm_launch(x0, TAPS, rho, lam, (iterations, cg, tv), prox, 1e-5, 6)
    assert [plan.band_rows(q) for q in range(6)] == [8] * 5 + [6]
    want, want_counts = _admm_plain(x0, TAPS, rho, lam, iterations, cg, tv, prox, 1e-5)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("batch,shape,clusters", [(16, (256, 256), 6), (3, (241, 256), 16)])
def test_admm_resident_route_repeats_bit_for_bit(dev, batch, shape, clusters):
    """20 launches of the resident route at BASELINE #3's schedule (12 × 6 ×
    8, its cluster sums three times per CG step), at the cell's plan and on
    16 bands with a one-row last band: each equal to the first, with equal
    live CG steps."""
    rng = np.random.default_rng(6)
    x0 = torch.from_numpy(rng.normal(size=(batch, *shape)).astype(np.float32)).to(dev)
    rho = torch.linspace(0.05, 0.4, batch, device=dev)
    lam = torch.linspace(1e-3, 5e-2, batch, device=dev)
    first, first_counts, plan = _admm_launch(x0, MILD, rho, lam, (12, 6, 8), "none", 1e-5)
    assert (plan.route, plan.clusters) == ("resident", clusters)
    for _ in range(20):
        got, counts = admm_fused.admm_tv_fused(x0, MILD, rho, lam, 12, 6, 8, 1e-5,
                                               with_counts=True)
        assert torch.equal(got, first) and torch.equal(counts, first_counts)


def test_admm_phase_clocks(dev):
    """The resident kernel's phase timer: one launch, the same x as without
    the timer, clocks in every phase; the global route has no timer and
    raises."""
    x0, rho, lam = _admm_inputs(dev, (91, 256))
    want = admm_fused.admm_tv_fused(x0, TAPS, rho, lam, 6, 5, 4, 1e-5, prox="positive")
    before = admm_fused.admm_tv_fused.launches
    clocks = admm_fused.phase_clocks(x0, TAPS, rho, lam, 6, 5, 4, 1e-5, "positive")
    assert admm_fused.admm_tv_fused.launches == before + 1
    assert list(clocks) == list(admm_fused.PHASES)
    assert all(v > 0 for v in clocks.values()), clocks
    assert torch.equal(admm_fused.admm_tv_fused(x0, TAPS, rho, lam, 6, 5, 4, 1e-5,
                                                prox="positive"), want)
    with pytest.raises(ValueError, match="resident route"):
        admm_fused.phase_clocks(_admm_inputs(dev, (2, 12000))[0], TAPS, rho, lam, 2, 2, 2, 1e-5)
    with pytest.raises(ValueError, match="a cluster of 5 CTAs does not fit"):
        admm_fused.admm_tv_fused(torch.zeros(16, 256, 256, device=dev), TAPS, 0.1, 0.1, 2, 2, 2,
                                 1e-5, clusters=5)


@pytest.mark.parametrize("shape", [(256, 256), (241, 256), (48, 64), (24, 20)])
def test_cluster_counts_of_the_admm_planner_tests(dev, shape):
    """On an H100 the card holds, for every fitting cluster size, the
    clusters of the resident ADMM-TV kernel that
    tests/test_torch_admm_plan.py plans with, and counts the planner's
    shared memory."""
    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    H, W = shape
    held = dict(ADMM_RESIDENT)
    fit = admm_fused.fitting_sizes(H, W, *limits)
    assert fit
    for c in fit:
        rows = -(-H // c)
        smem, got = admm_fused.resident_limits(dev.index, c, rows, W)
        assert smem == admm_fused.cluster_smem_bytes(rows, W)
        assert got == held[c], (c, shape)


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


# (m, n, P) of the CGNR kernel's cases: the small system; several slabs
# and groups with a remainder in both; P = 1; P ≥ 200 without the
# resident slab and with it; A tall and wide; and "cplx", the split-real
# embedding (512 × 1024) of a complex 256 × 512 A at batch 16
CGNR_SHAPES = [(40, 24, 3), (1000, 300, 61), (1024, 512, 1), (1024, 512, 200), (300, 200, 203),
               (3000, 16, 20), (16, 3000, 20), "cplx"]


def _cgnr_system(dev, shape):
    """A, b and λ of a CGNR case. A wide A (m < n) has singular normal
    equations: with λ = 0 the f32 CG past step m divides by ~0 and the
    plain version itself moves by O(1) of max|x| under a 1-ulp change of
    b. So a wide A is scaled to unit-size rows (AAᴴ ≈ I) and every λ is
    positive, κ(AᴴA + λ) ≤ 7; the others take λ = 1e-3, 0, 0.2."""
    lam = [1e-3, 0.0, 0.2]
    if shape == "cplx":
        (ar, ai), (br, bi) = _dense(dev, m=256, n=512, P=16, cplx=True)
        A, b = cgnr.split_real_embedding(torch.complex(ar, ai), torch.complex(br, bi))
    else:
        m, n, _ = shape
        A, b = _dense(dev, *shape)
        if m < n:
            A, lam = A * float(np.sqrt(m / n)), [0.2, 0.5, 1.0]
    lam = torch.tensor(lam, device=dev).repeat(b.shape[0])[: b.shape[0]]
    return A.contiguous(), b.contiguous(), lam.contiguous()


@pytest.mark.parametrize("shape", CGNR_SHAPES, ids=str)
@pytest.mark.parametrize("steps", [0, 1, 24, 60])
@pytest.mark.parametrize("prox", ["none", "positive"])
def test_cgnr_kernel_matches_plain(dev, steps, prox, shape):
    A, b, lam = _cgnr_system(dev, shape)
    before = cgnr.cgnr_fused.launches
    got = cgnr.cgnr_fused(b, A, lam, steps, prox)
    assert cgnr.cgnr_fused.launches == before + 1
    want = cgnr.cgnr_fused_torch(b, A, lam, steps, prox)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 1e-5)
    # no float atomics: the same result run to run
    assert torch.equal(cgnr.cgnr_fused(b, A, lam, steps, prox), got)
    assert cgnr.cgnr_fused.launches == before + 2


def test_cgnr_kernel_raises_without_a_plan(dev):
    """A shape whose slabs cannot all be resident at once raises, naming
    the shape, and launches nothing."""
    A = torch.zeros((600_000, 2), device=dev)
    b = torch.zeros((3, 600_000), device=dev)
    before = cgnr.cgnr_fused.launches
    with pytest.raises(ValueError, match="600000x2 with 3 problems"):
        cgnr.cgnr_fused(b, A, torch.zeros(3, device=dev), 4)
    assert cgnr.cgnr_fused.launches == before


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


# (m, n, P) of the dense PGM kernel's cases and the route of each: the
# small system (one slab, one group); the LASSO cell's 256 × 512 × 16;
# several slabs and groups with a remainder in both; P = 1; more problems
# than SMs; A tall and wide (its slab streamed from L2); and a row too
# long for a group's Gram input and x in shared memory, which the planner
# sends to the per-problem kernel
PGM_DENSE_SHAPES = {(40, 24, 3): "grid", (256, 512, 16): "grid", (1000, 300, 61): "grid",
                    (256, 512, 1): "grid", (256, 512, 137): "grid", (3000, 16, 16): "grid",
                    (16, 3000, 16): "grid", (64, 4000, 3): "per_problem"}


def _pgm_dense_system(dev, shape):
    """A, b and λ (1e-2, 0, 0.1 in turn) of a dense PGM case; a wide A is
    scaled by √(m/n), so that ρ = 0.5 converges on every shape."""
    m, n, P = shape
    A, b = _dense(dev, m, n, P)
    if m < n:
        A = A * float(np.sqrt(m / n))
    lam = torch.tensor([1e-2, 0.0, 0.1], device=dev).repeat(P)[:P]
    return A.contiguous(), b, lam.contiguous()


@pytest.mark.parametrize("shape", list(PGM_DENSE_SHAPES), ids=str)
@pytest.mark.parametrize("method,restart", [("fista", "none"), ("fista", "gradient"),
                                            ("fista", "gradient_mapping"), ("optista", "none"),
                                            ("pogm", "none")])
@pytest.mark.parametrize("kind", ["l1", "l2"])
@pytest.mark.parametrize("prox", ["none", "positive"])
def test_pgm_dense_kernel_matches_plain(dev, method, restart, kind, prox, shape):
    A, b, lam = _pgm_dense_system(dev, shape)
    route = PGM_DENSE_SHAPES[shape]
    plan = pgm_dense.card_plan(b, A)
    assert plan.route == route
    if route == "grid":
        assert plan.ctas <= torch.cuda.get_device_properties(dev).multi_processor_count
    args = (lam, 0.5, 1.0, 30, method, kind, restart, prox)
    before = pgm_dense.pgm_dense_fused.launches
    routes = dict(pgm_dense.pgm_dense_fused.route_launches)
    got, counts = pgm_dense.pgm_dense_fused(b, A, *args, with_counts=True)
    assert pgm_dense.pgm_dense_fused.launches == before + 1
    assert pgm_dense.pgm_dense_fused.route_launches == {**routes, route: routes[route] + 1}
    scal, tab = pgm_dense.kernel_args(b, lam, 0.5, 1.0, method, 30)
    want, want_counts = pgm_dense.pgm_dense_fused_torch(b, A, scal, tab, 30, method, kind,
                                                        restart, prox)
    assert bool(torch.isfinite(got).all())
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()
    if restart != "none" and shape == (40, 24, 3):
        assert max(counts.tolist()) > 0
    assert torch.equal(pgm_dense.pgm_dense_fused(b, A, *args), got)


def _lasso(dev, P=16, seed=3):
    """The LASSO cell's shape (256 × 512, N(0, 1)/16, a 5 % sparse x per
    problem, λ = 1e-4, ρ = 0.95/‖A‖₂²), on which FISTA's gradient restart
    fires."""
    rng = np.random.default_rng(seed)
    A = (rng.normal(size=(256, 512)) / 16.0).astype(np.float32)
    X = (rng.normal(size=(512, P)) * (rng.uniform(size=(512, P)) < 0.05)).astype(np.float32)
    rho = 0.95 / float(np.linalg.norm(A, 2)) ** 2
    b = torch.from_numpy(np.ascontiguousarray((A @ X).T)).to(dev)
    return torch.from_numpy(A).to(dev), b, 1e-4, rho


@pytest.mark.parametrize("method,restart", [("fista", "gradient"), ("pogm", "none")])
def test_pgm_dense_grid_route_repeats_bit_for_bit(dev, method, restart):
    """20 launches of the grid route at the LASSO cell's plan (16 slabs ×
    2 groups, two group barriers per iteration), FISTA with its gradient
    restart (the restart partials summed over the slabs by every CTA) and
    POGM: each equal to the first, with equal counts, and held to the
    plain version."""
    A, b, lam, rho = _lasso(dev)
    plan = pgm_dense.card_plan(b, A)
    assert (plan.route, plan.slabs, plan.groups) == ("grid", 16, 2)
    args = (lam, rho, 1.0, 100, method, "l1", restart)
    first, first_counts = pgm_dense.pgm_dense_fused(b, A, *args, with_counts=True)
    scal, tab = pgm_dense.kernel_args(b, lam, rho, 1.0, method, 100)
    want, want_counts = pgm_dense.pgm_dense_fused_torch(b, A, scal, tab, 100, method, "l1",
                                                        restart)
    _close(first, want, 1e-5)
    assert first_counts.tolist() == want_counts.tolist()
    if restart != "none":
        assert max(first_counts.tolist()) > 0
    for _ in range(20):
        got, counts = pgm_dense.pgm_dense_fused(b, A, *args, with_counts=True)
        assert torch.equal(got, first) and torch.equal(counts, first_counts)


@pytest.mark.parametrize("shape,lam,plan", [((64, 64, 16), 1e-6, (1, 16)),
                                            ((1024, 512, 64), 1e-3, (16, 8))])
def test_cgnr_kernel_repeats_bit_for_bit(dev, shape, lam, plan):
    """20 launches of the CGNR kernel at the two CGNR cells' shapes and
    plans (one CTA per problem with no barrier; 16 slabs × 8 groups, three
    group barriers per step), 64 steps: each equal to the first."""
    m, n, P = shape
    A, b = _dense(dev, m, n, P, seed=9)
    lam_v = torch.full((P,), lam, device=dev)
    from rls_tpu_torch import _build

    got_plan = cgnr.plan_cgnr(m, n, P, *_build.device_limits(dev.index or 0))
    assert (got_plan.slabs, got_plan.groups) == plan
    first = cgnr.cgnr_fused(b, A, lam_v, 64)
    _close(first, cgnr.cgnr_fused_torch(b, A, lam_v, 64), 1e-5)
    for _ in range(20):
        assert torch.equal(cgnr.cgnr_fused(b, A, lam_v, 64), first)


@pytest.mark.parametrize("method,restart", [("fista", "gradient"), ("optista", "none")])
def test_pgm_dense_phase_clocks(dev, method, restart):
    """The grid route's phase timer: one launch on the grid route, the same
    x as without the timer, clocks in every phase; a shape with no grid
    plan raises."""
    A, b, lam, rho = _lasso(dev)
    args = (lam, rho, 1.0, 20, method, "l1", restart)
    before = (pgm_dense.pgm_dense_fused.launches,
              pgm_dense.pgm_dense_fused.route_launches["grid"])
    clocks = pgm_dense.phase_clocks(b, A, *args)
    assert (pgm_dense.pgm_dense_fused.launches,
            pgm_dense.pgm_dense_fused.route_launches["grid"]) == (before[0] + 1, before[1] + 1)
    assert list(clocks) == list(pgm_dense.GRID_PHASES)
    assert all(v > 0 for v in clocks.values()), clocks
    with pytest.raises(ValueError, match="no grid plan"):
        A4, b4, lam4 = _pgm_dense_system(dev, (64, 4000, 3))
        pgm_dense.phase_clocks(b4, A4, lam4, 0.5, 1.0, 2)


@pytest.mark.parametrize("shape", [(40, 24, 3), (256, 512, 16)], ids=str)
@pytest.mark.parametrize("method,restart", [("fista", "gradient"), ("pogm", "none")])
def test_pgm_dense_forced_per_problem_route_matches_plain(dev, shape, method, restart):
    """The per-problem kernel, forced where the planner takes the grid: held
    to the plain version like the grid route, counted on its route."""
    A, b, lam = _pgm_dense_system(dev, shape)
    scal, tab = pgm_dense.kernel_args(b, lam, 0.5, 1.0, method, 30)
    sched = (30, method, "l1", restart, "none")
    routes = dict(pgm_dense.pgm_dense_fused.route_launches)
    got, counts = pgm_dense._launch(b, A, scal, tab, sched, route="per_problem")
    assert pgm_dense.pgm_dense_fused.route_launches == {
        **routes, "per_problem": routes["per_problem"] + 1}
    want, want_counts = pgm_dense.pgm_dense_fused_torch(b, A, scal, tab, *sched)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


def test_pgm_dense_grid_route_never_falls_back(dev):
    """A grid launch the C entry point refuses (here a plan whose shared
    memory differs from the kernel's count) raises, and launches nothing on
    another route."""
    A, b, lam = _pgm_dense_system(dev, (256, 512, 16))
    scal, tab = pgm_dense.kernel_args(b, lam, 0.5, 1.0, "fista", 4)
    plan = pgm_dense.card_plan(b, A)
    bad = pgm_dense.PgmDensePlan("grid", plan.slabs, plan.rows, plan.groups, plan.group_size,
                                 plan.resident, plan.smem + 16)
    before = (pgm_dense.pgm_dense_fused.launches, dict(pgm_dense.pgm_dense_fused.route_launches))
    with pytest.raises(RuntimeError, match="pgm_dense_grid_launch"):
        pgm_dense._launch_grid(b, A, scal, tab, bad, 4, "fista", "l1", "none", "none")
    with pytest.raises(ValueError, match="no route"):
        pgm_dense._launch(b, A, scal, tab, (4, "fista", "l1", "none", "none"), route="plain")
    assert (pgm_dense.pgm_dense_fused.launches,
            pgm_dense.pgm_dense_fused.route_launches) == before


# sha256 of (xr, xi, restarts) of row 7b (the complex plane kernel, one CTA
# per problem) at `_cplx_digest_case`, as the source before the real
# kernel's grid route was added computed them on an NVIDIA H100 80GB HBM3
# (700 W): row 7b stays that kernel, bit for bit
CPLX_PARENT_SHA256 = "beff348ec5f92d2feb0e57a368d63db95cd966bd29907003ed719b5ea9ae383f"


def _cplx_digest_case(dev):
    (ar, ai), (br, bi) = _dense(dev, m=256, n=512, P=16, seed=11, cplx=True)
    lam = torch.linspace(0.0, 2e-2, 16, device=dev)
    return (br, bi, ar, ai, lam, 0.4, 1.0, 100, "fista", "l1", "gradient", "real")


def test_pgm_dense_cplx_kernel_is_bit_for_bit_the_stored_run(dev):
    """Row 7b, which the grid route of the real kernel leaves as it was."""
    import hashlib

    xr, xi, counts = pgm_dense.pgm_dense_fused_cplx(*_cplx_digest_case(dev), with_counts=True)
    h = hashlib.sha256()
    for t in (xr, xi, counts):
        h.update(t.contiguous().cpu().numpy().tobytes())
    assert h.hexdigest() == CPLX_PARENT_SHA256


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


# the FFT kernels: H ≠ W, every kernel against its plain version. Rows 8
# and 9 round every operation as the plain version does and agree bit for
# bit; the SplitBregman kernel does too, but its CG sums are double sums
# taken in another order than the plain version's (and, on its resident
# route, over a cluster's CTAs), which may round apart, so it is held to
# 1e-5 of max|x| with equal live CG steps.
# The last four shapes take several shared-memory chunks per pass
# (rows × W or columns × H above 4096 points) and reach both ends of the
# size gate: 1024 lines of 16 points and 16 lines of 1024.
FFT_SHAPES = [(16, 32), (64, 8), (2, 4), (256, 128), (1024, 16), (16, 1024), (512, 512)]


def _fft_inputs(dev, shape, C=3, seed=6):
    rng = np.random.default_rng(seed)
    H, W = shape

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    maps = rng.normal(size=(C, H, W)) + 1j * rng.normal(size=(C, H, W))
    maps /= np.sqrt((np.abs(maps) ** 2).sum(0))
    mask = t(rng.uniform(size=shape) < 0.5)
    return mask, t(maps.real), t(maps.imag), rng


@pytest.mark.parametrize("shape", FFT_SHAPES)
def test_fista_l1_dft_kernel_matches_plain(dev, shape):
    """Every FFT_SHAPES shape on its planned route (512² on the global
    route, one CTA per problem; the rest on clusters), by the route
    counter, bit for bit the plain version."""
    mask, _, _, rng = _fft_inputs(dev, shape)
    x0 = torch.from_numpy(rng.normal(size=(3, *shape)).astype(np.float32)).to(dev)
    lam = torch.tensor([1e-2, 0.0, 0.1], device=dev)
    plan, active = l1dft.plan_on_card(x0)
    assert plan.route == ("global" if shape == (512, 512) else "resident")
    assert plan.route == "global" or active >= 1
    before = l1dft.fista_l1_dft_fused.launches
    on_route = l1dft.fista_l1_dft_fused.route_launches[plan.route]
    got = l1dft.fista_l1_dft_fused(x0, mask, 0.9, lam, 9)
    assert l1dft.fista_l1_dft_fused.launches == before + 1
    assert l1dft.fista_l1_dft_fused.route_launches[plan.route] == on_route + 1
    scal = fused.problem_scalars(x0, 0.9, lam)
    tab = torch.as_tensor(fused._momentum_table("fista", 9), device=dev)
    want = l1dft.fista_l1_dft_fused_torch(x0, scal, tab, dft.dft_tables(mask))
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


# the FISTA-L1-DFT kernel at each cluster size the planner takes (shapes
# and batches of test_torch_dft_plan.L1DFT_SIZES): lines of 2 to 1024
# points, in registers only (≤ 128) or with a shared-memory stage
@pytest.mark.parametrize("size", [(3, 16, 32), (3, 2, 4), (3, 8, 256), (64, 128, 128),
                                  (16, 128, 128), (3, 16, 1024), (3, 1024, 16), (64, 256, 256),
                                  (16, 256, 256), (3, 256, 512)])
def test_fista_l1_dft_resident_route_at_each_cluster_size(dev, size):
    from test_torch_dft_plan import L1DFT_SIZES

    B, H, W = size
    mask, _, _, rng = _fft_inputs(dev, (H, W), C=1)
    x0 = torch.from_numpy(rng.normal(size=size).astype(np.float32)).to(dev)
    lam = torch.linspace(0.0, 0.1, B, device=dev)
    plan, active = l1dft.plan_on_card(x0)
    assert (plan.route, plan.clusters) == ("resident", L1DFT_SIZES[size]) and active >= 1
    on_route = l1dft.fista_l1_dft_fused.route_launches["resident"]
    got = l1dft.fista_l1_dft_fused(x0, mask, 0.9, lam, 7)
    assert l1dft.fista_l1_dft_fused.route_launches["resident"] == on_route + 1
    scal = fused.problem_scalars(x0, 0.9, lam)
    tab = torch.as_tensor(fused._momentum_table("fista", 7), device=dev)
    want = l1dft.fista_l1_dft_fused_torch(x0, scal, tab, dft.dft_tables(mask))
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


def _cs_cell_inputs(dev, B=16):
    """B distinct 256² problems on a 35 % mask, one λ each."""
    rng = np.random.default_rng(12)
    mask = torch.from_numpy((rng.uniform(size=(256, 256)) < 0.35).astype(np.float32)).to(dev)
    x0 = torch.from_numpy(rng.normal(size=(B, 256, 256)).astype(np.float32)).to(dev)
    lam = torch.linspace(1e-3, 4e-3, B, device=dev)
    return x0, mask, lam


def test_fista_l1_dft_resident_route_repeats_bit_for_bit(dev):
    """20 launches at the CS cell's shape (16 × 256², 60 iterations, c =
    16), each equal to the first and to the plain version: a race between
    a cluster's CTAs would show as a launch that differs."""
    x0, mask, lam = _cs_cell_inputs(dev)
    plan, _ = l1dft.plan_on_card(x0)
    assert (plan.route, plan.clusters) == ("resident", 16)
    first = l1dft.fista_l1_dft_fused(x0, mask, 0.95, lam, 60)
    for _ in range(20):
        assert torch.equal(l1dft.fista_l1_dft_fused(x0, mask, 0.95, lam, 60), first)
    scal = fused.problem_scalars(x0, 0.95, lam)
    tab = torch.as_tensor(fused._momentum_table("fista", 60), device=dev)
    assert torch.equal(first, l1dft.fista_l1_dft_fused_torch(x0, scal, tab,
                                                             dft.dft_tables(mask)))


@pytest.mark.parametrize("shape", [(256, 256), (64, 64)])
def test_fista_l1_dft_phase_clocks(dev, shape):
    """The resident kernel's phase timer: one launch, the same x as without
    the timer, clocks in every phase (lines of 256 points, with a
    shared-memory stage, and of 64, without); the global route has no
    timer and raises."""
    x0, mask, lam = _cs_cell_inputs(dev, B=4)
    if shape != (256, 256):
        x0, mask = x0[:, :shape[0], :shape[1]].contiguous(), mask[:shape[0], :shape[1]]
    want = l1dft.fista_l1_dft_fused(x0, mask, 0.95, lam, 6)
    before = l1dft.fista_l1_dft_fused.launches
    clocks = l1dft.phase_clocks(x0, mask, 0.95, lam, 6)
    assert l1dft.fista_l1_dft_fused.launches == before + 1
    assert list(clocks) == list(l1dft.PHASES)
    assert all(v > 0 for v in clocks.values()), clocks
    assert torch.equal(l1dft.fista_l1_dft_fused(x0, mask, 0.95, lam, 6), want)
    xg = torch.zeros(2, 512, 512, device=dev)
    with pytest.raises(ValueError, match="resident route"):
        l1dft.phase_clocks(xg, torch.ones(512, 512, device=dev), 0.95, 1e-3, 2)


@pytest.mark.parametrize("shape", [(256, 256), (128, 128), (64, 64), (1024, 16)])
def test_cluster_counts_of_the_fista_l1_dft_planner_tests(dev, shape):
    """On an H100 the card holds, for every fitting cluster size, the
    clusters of the resident FISTA-L1-DFT kernel that
    tests/test_torch_dft_plan.py plans with, and counts the planner's
    shared memory."""
    from test_torch_dft_plan import H100_RESIDENT

    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    held = dict(H100_RESIDENT)
    fit = l1dft.fitting_sizes(*shape, *limits)
    assert fit
    for c in fit:
        smem, got = l1dft.resident_limits(dev.index, c, *shape)
        assert smem == l1dft.resident_smem_bytes(*shape, c)
        assert got == held[c], (c, shape)


# FISTA-L21-SENSE's cases: every FFT_SHAPES shape at 1 and 3 coils (the
# large ones on the global route), and at 128² the resident route's cluster
# of 6 and 9 CTAs and 17 coils in two rounds on 9; 2 × 4 at 6 coils leaves
# four of the six CTAs without a row of the image
SENSE_CASES = [(shape, coils) for shape in FFT_SHAPES for coils in (1, 3)] + [
    ((128, 128), 1), ((128, 128), 6), ((128, 128), 9), ((128, 128), 17), ((2, 4), 6)]


def _sense_inputs(dev, shape, coils):
    mask, cr, ci, rng = _fft_inputs(dev, shape, C=coils)
    x0 = torch.from_numpy(rng.normal(size=(2, 2, *shape)).astype(np.float32)).to(dev)
    return x0, mask, cr, ci, torch.tensor([1e-2, 0.2], device=dev)


def _sense_plain(x0, mask, cr, ci, lam, iterations):
    scal = fused.problem_scalars(x0, 0.9, lam)
    tab = torch.as_tensor(fused._momentum_table("fista", iterations), device=x0.device)
    return sense.fista_l21_sense_fused_torch(x0, scal, tab, (cr, ci), dft.dft_tables(mask))


@pytest.mark.parametrize("shape,coils", SENSE_CASES)
def test_sense_kernel_matches_plain(dev, shape, coils):
    """Every case on its planned route (the cluster route where a coil's
    spectrum fits one CTA), by the route counter, bit for bit the plain
    version."""
    x0, mask, cr, ci, lam = _sense_inputs(dev, shape, coils)
    plan = sense.plan_on_card(x0, coils)
    fits = sense.resident_smem_bytes(*shape) <= 232_448
    assert plan.route == ("resident" if fits else "global")
    if plan.route == "resident":
        assert (plan.clusters, plan.rounds) == sense.cluster_size(coils)
        assert plan.resident_clusters >= 1
    before = sense.fista_l21_sense_fused.launches
    on_route = sense.fista_l21_sense_fused.route_launches[plan.route]
    got = sense.fista_l21_sense_fused(x0, mask, cr, ci, 0.9, lam, 9)
    assert sense.fista_l21_sense_fused.launches == before + 1
    assert sense.fista_l21_sense_fused.route_launches[plan.route] == on_route + 1
    want = _sense_plain(x0, mask, cr, ci, lam, 9)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


# the resident route's edges: no iteration, one (the spectrum's last remote
# reads meet only the final barrier), two; at H < c, and in two rounds
SENSE_EDGE_CASES = [((2, 4), 6), ((128, 128), 17), ((128, 128), 6)]


@pytest.mark.parametrize("shape,coils", SENSE_EDGE_CASES)
@pytest.mark.parametrize("iterations", [0, 1, 2])
def test_sense_kernel_edge_iterations_match_plain(dev, shape, coils, iterations):
    x0, mask, cr, ci, lam = _sense_inputs(dev, shape, coils)
    assert sense.plan_on_card(x0, coils).route == "resident"
    got = sense.fista_l21_sense_fused(x0, mask, cr, ci, 0.9, lam, iterations)
    want = _sense_plain(x0, mask, cr, ci, lam, iterations)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("shape,coils", SENSE_EDGE_CASES)
def test_sense_resident_route_repeats_bit_for_bit(dev, shape, coils):
    """A launch of the resident route gives the same bits each time: a
    cross-CTA race would show as a launch that differs."""
    x0, mask, cr, ci, lam = _sense_inputs(dev, shape, coils)
    args = (x0, mask, cr, ci, 0.9, lam, 12)
    first = sense.fista_l21_sense_fused(*args)
    for _ in range(20):
        assert torch.equal(sense.fista_l21_sense_fused(*args), first)


def test_sense_phase_clocks(dev):
    """The resident kernel's phase timer: one launch, the same x as without
    the timer, clocks in every phase; the global route has no timer and
    raises."""
    x0, mask, cr, ci, lam = _sense_inputs(dev, (128, 128), 6)
    args = (x0, mask, cr, ci, 0.9, lam, 5)
    want = sense.fista_l21_sense_fused(*args)
    before = sense.fista_l21_sense_fused.launches
    clocks = sense.phase_clocks(*args)
    assert sense.fista_l21_sense_fused.launches == before + 1
    assert list(clocks) == list(sense.PHASES)
    assert all(v > 0 for v in clocks.values()), clocks
    assert torch.equal(sense.fista_l21_sense_fused(*args), want)
    x0g, maskg, crg, cig, lamg = _sense_inputs(dev, (256, 128), 2)
    with pytest.raises(ValueError, match="resident route"):
        sense.phase_clocks(x0g, maskg, crg, cig, 0.9, lamg, 1)


@pytest.mark.parametrize("shape", [(128, 128), (1024, 16), (16, 1024), (2, 4)])
def test_cluster_counts_of_the_sense_planner_tests(dev, shape):
    """On an H100 the card holds, for every cluster size, the clusters of
    the resident FISTA-L21-SENSE kernel that tests/test_torch_sense_plan.py
    plans with, and counts the planner's shared memory."""
    from test_torch_sense_plan import H100_RESIDENT

    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    held = dict(H100_RESIDENT)
    for c in range(1, sense.MAX_CLUSTER + 1):
        smem, got = sense.resident_limits(dev.index, c, *shape)
        assert smem == sense.resident_smem_bytes(*shape)
        assert got == held[c], (c, shape)


# SplitBregman's cases: every FFT_SHAPES shape at 3 coils (the large ones on
# the global route), and at 128² the resident route's cluster of 1, 6 and 9
# CTAs and 17 coils in two rounds on 9; 2 × 4 at 6 coils leaves four of the
# six CTAs without a row of the image
SB_CASES = [(shape, 3) for shape in FFT_SHAPES] + [
    ((128, 128), 1), ((128, 128), 6), ((128, 128), 9), ((128, 128), 17), ((2, 4), 6)]


def _sb_inputs(dev, shape, coils, rho1=(0.01, 0.0, 0.05)):
    mask, cr, ci, rng = _fft_inputs(dev, shape, C=coils)
    x0 = torch.from_numpy(rng.normal(size=(3, 2, *shape)).astype(np.float32)).to(dev)
    return x0, mask, cr, ci, torch.tensor(rho1, device=dev)


@pytest.mark.parametrize("shape,coils", SB_CASES)
@pytest.mark.parametrize("tol_inner,tv_iterations", [(1e-5, 4), (5e-2, 0), (1e-5, 1)])
def test_splitbregman_kernel_matches_plain(dev, shape, coils, tol_inner, tv_iterations):
    x0, mask, cr, ci, rho1 = _sb_inputs(dev, shape, coils)
    plan = sb.plan_on_card(x0, coils)
    fits = sb.resident_smem_bytes(*shape) <= 232_448
    assert plan.route == ("resident" if fits else "global")
    if plan.route == "resident":
        assert (plan.clusters, plan.rounds) == sb.cluster_size(coils)
        assert plan.resident_clusters >= 1
    sched = (2, 3, 4, tv_iterations, tol_inner)
    before = sb.splitbregman_l1_tv_fused.launches
    on_route = sb.splitbregman_l1_tv_fused.route_launches[plan.route]
    got, counts = sb.splitbregman_l1_tv_fused(x0, mask, cr, ci, rho1, 0.02, 1e-3, 2e-3, *sched,
                                              with_counts=True)
    assert sb.splitbregman_l1_tv_fused.launches == before + 1
    assert sb.splitbregman_l1_tv_fused.route_launches[plan.route] == on_route + 1
    scal, t2 = sb.kernel_args(x0, rho1, 0.02, 1e-3, 2e-3, tv_iterations)
    want, want_counts = sb.splitbregman_l1_tv_fused_torch(
        x0, scal, t2, (cr, ci), dft.dft_tables(mask), *sched[:3], tol_inner)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


# the resident route's sums follow each other with no other cluster
# barrier (p.q then r.r; the last r.r then the next ||beta||^2 with TV
# off; with no CG steps, r.r then ||beta||^2), and with no inner
# iterations the outer updates' transforms follow each other: at H < c
# the CTAs without rows reach each sum early
SB_EDGE_CASES = [((2, 4), 6), ((128, 128), 6)]


@pytest.mark.parametrize("shape,coils", SB_EDGE_CASES)
@pytest.mark.parametrize("sched,tol_inner", [((3, 0, 4), 1e-5), ((2, 3, 0), 1e-5),
                                             ((2, 2, 5), 5e-2)])
def test_splitbregman_kernel_edge_schedules_match_plain(dev, shape, coils, sched, tol_inner):
    x0, mask, cr, ci, rho1 = _sb_inputs(dev, shape, coils)
    assert sb.plan_on_card(x0, coils).route == "resident"
    got, counts = sb.splitbregman_l1_tv_fused(x0, mask, cr, ci, rho1, 0.02, 1e-3, 2e-3, *sched,
                                              0, tol_inner, with_counts=True)
    scal, t2 = sb.kernel_args(x0, rho1, 0.02, 1e-3, 2e-3, 0)
    want, want_counts = sb.splitbregman_l1_tv_fused_torch(
        x0, scal, t2, (cr, ci), dft.dft_tables(mask), *sched, tol_inner)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("shape,coils", SB_EDGE_CASES)
def test_splitbregman_resident_route_repeats_bit_for_bit(dev, shape, coils):
    """Every sum of the resident route is taken in rank order, so a launch
    gives the same bits each time: a cross-CTA race would show as a
    launch that differs."""
    x0, mask, cr, ci, rho1 = _sb_inputs(dev, shape, coils)
    args = (x0, mask, cr, ci, rho1, 0.02, 1e-3, 2e-3, 2, 3, 6, 0, 5e-2)
    first, first_counts = sb.splitbregman_l1_tv_fused(*args, with_counts=True)
    for _ in range(20):
        got, counts = sb.splitbregman_l1_tv_fused(*args, with_counts=True)
        assert torch.equal(got, first) and torch.equal(counts, first_counts)


def test_splitbregman_phase_clocks(dev):
    """The resident kernel's phase timer: one launch, the same x and counts
    as without the timer, clocks in every phase; the global route has no
    timer and raises."""
    x0, mask, cr, ci, rho1 = _sb_inputs(dev, (128, 128), 6)
    args = (x0, mask, cr, ci, rho1, 0.02, 1e-3, 2e-3, 2, 2, 3, 2, 1e-5)
    want = sb.splitbregman_l1_tv_fused(*args)
    before = sb.splitbregman_l1_tv_fused.launches
    clocks = sb.phase_clocks(*args)
    assert sb.splitbregman_l1_tv_fused.launches == before + 1
    assert list(clocks) == list(sb.PHASES)
    assert all(v > 0 for v in clocks.values()), clocks
    assert torch.equal(sb.splitbregman_l1_tv_fused(*args), want)
    x0g, maskg, crg, cig, _ = _sb_inputs(dev, (256, 128), 2)
    with pytest.raises(ValueError, match="resident route"):
        sb.phase_clocks(x0g, maskg, crg, cig, rho1, 0.02, 1e-3, 2e-3, 1, 1, 1, 1, 1e-5)


@pytest.mark.parametrize("shape", [(128, 128), (1024, 16), (16, 1024), (2, 4)])
def test_cluster_counts_of_the_splitbregman_planner_tests(dev, shape):
    """On an H100 the card holds, for every cluster size, the clusters of
    the resident SplitBregman kernel that
    tests/test_torch_splitbregman_plan.py plans with."""
    from test_torch_splitbregman_plan import H100_RESIDENT

    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    held = dict(H100_RESIDENT)
    for c in range(1, sb.MAX_CLUSTER + 1):
        smem, got = sb.resident_limits(dev.index, c, *shape)
        assert smem == sb.resident_smem_bytes(*shape)
        assert got == held[c], (c, shape)


def test_fft_wrappers_refuse_what_the_kernels_do_not_take(dev):
    mask, cr, ci, _ = _fft_inputs(dev, (16, 16))
    x0 = torch.zeros(2, 16, 16, device=dev)
    with pytest.raises(ValueError, match="float32"):
        l1dft.fista_l1_dft_fused(x0.double(), mask.double(), 0.9, 0.1, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        l1dft.fista_l1_dft_fused(x0, mask.cpu(), 0.9, 0.1, 2)
    with pytest.raises(ValueError, match="powers of two"):
        l1dft.fista_l1_dft_fused(torch.zeros(2, 24, 24, device=dev),
                                 torch.ones(24, 24, device=dev), 0.9, 0.1, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        sense.fista_l21_sense_fused(torch.zeros(2, 2, 16, 16, device=dev), mask, cr.cpu(), ci,
                                    0.9, 0.1, 2)


# PDHG: (kind, prox) on odd shapes and on the shapes that put each cluster
# size and the global route in play (test_torch_pdhg_plan.PDHG_ROUTES); the
# kernel rounds every op as its plain version does
def _pdhg_inputs(dev, shape):
    rng = np.random.default_rng(11)
    u = torch.from_numpy(rng.normal(size=(3, *shape)).astype(np.float32)).to(dev)
    sigma = torch.tensor([0.5, 1.0, 0.0625], device=dev)
    tau = torch.tensor([0.3, 0.2, 0.9], device=dev)
    lam = torch.tensor([5e-3, 0.0, 0.1], device=dev)
    return u, sigma, tau, lam


PDHG_SHAPES = [(17, 23), (9, 33), (3, 2), (25, 256), (55, 300), (110, 300), (221, 300),
               (2, 15000)]


@pytest.mark.parametrize("kind", ["tv8", "tviso", "l1"])
@pytest.mark.parametrize("prox", ["none", "positive"])
@pytest.mark.parametrize("shape", PDHG_SHAPES)
def test_pdhg_kernel_matches_plain(dev, kind, prox, shape):
    from test_torch_pdhg_plan import PDHG_ROUTES

    u, sigma, tau, lam = _pdhg_inputs(dev, shape)
    taps = TAPS63 if shape == (221, 300) else TAPS
    plan, active = pdhg.plan_on_card(u, taps, kind)
    assert (plan.route, plan.clusters) == PDHG_ROUTES[shape][kind]
    assert plan.route == "global" or active >= 1
    before = pdhg.pdhg_fused.launches
    on_route = pdhg.pdhg_fused.route_launches[plan.route]
    got = pdhg.pdhg_fused(u, taps, sigma, tau, lam, 9, kind, prox)
    assert pdhg.pdhg_fused.launches == before + 1
    assert pdhg.pdhg_fused.route_launches[plan.route] == on_route + 1
    scal = pdhg.kernel_scalars(u, sigma, tau, lam)
    want = pdhg.pdhg_fused_torch(u, scal, taps, 9, kind, prox)
    _close(got, want, 1e-5)
    if plan.route == "resident":
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind,shape", [("tv8", (221, 300)), ("tv8", (256, 256)),
                                        ("tviso", (256, 256)), ("l1", (110, 300))])
def test_pdhg_resident_route_repeats_bit_for_bit(dev, kind, shape):
    """20 launches of the resident route, each equal to the first and to
    the plain version."""
    u, sigma, tau, lam = _pdhg_inputs(dev, shape)
    taps = TAPS63 if shape == (221, 300) else TAPS
    assert pdhg.plan_on_card(u, taps, kind)[0].route == "resident"
    first = pdhg.pdhg_fused(u, taps, sigma, tau, lam, 20, kind)
    for _ in range(20):
        assert torch.equal(pdhg.pdhg_fused(u, taps, sigma, tau, lam, 20, kind), first)
    scal = pdhg.kernel_scalars(u, sigma, tau, lam)
    assert torch.equal(first, pdhg.pdhg_fused_torch(u, scal, taps, 20, kind))


@pytest.mark.parametrize("kind", ["tv8", "tviso", "l1"])
def test_pdhg_phase_clocks(dev, kind):
    """The resident kernel's phase timer: one launch, the same x as without
    the timer, clocks in every phase; the global route has no timer and
    raises."""
    u, sigma, tau, lam = _pdhg_inputs(dev, (110, 300))
    want = pdhg.pdhg_fused(u, TAPS, sigma, tau, lam, 6, kind, "positive")
    before = pdhg.pdhg_fused.launches
    clocks = pdhg.phase_clocks(u, TAPS, sigma, tau, lam, 6, kind, "positive")
    assert pdhg.pdhg_fused.launches == before + 1
    assert list(clocks) == list(pdhg.PHASES)
    assert all(v > 0 for v in clocks.values()), clocks
    assert torch.equal(pdhg.pdhg_fused(u, TAPS, sigma, tau, lam, 6, kind, "positive"), want)
    ug = _pdhg_inputs(dev, (2, 15000))[0]
    with pytest.raises(ValueError, match="resident route"):
        pdhg.phase_clocks(ug, TAPS, sigma, tau, lam, 2, kind)


@pytest.mark.parametrize("kind", ["tv8", "tviso", "l1"])
@pytest.mark.parametrize("shape", [(256, 256), (221, 300), (64, 64), (17, 23)])
def test_cluster_counts_of_the_pdhg_planner_tests(dev, kind, shape):
    """On an H100 the card holds, for every fitting cluster size of every
    dual kind, the clusters of the resident PDHG kernel that
    tests/test_torch_pdhg_plan.py plans with, and counts the planner's
    shared memory."""
    from test_torch_pdhg_plan import H100_RESIDENT

    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    H, W = shape
    held = dict(H100_RESIDENT)
    fit = pdhg.fitting_sizes(kind, H, W, *limits)
    assert fit
    for c in fit:
        rows = -(-H // c)
        smem, got = pdhg.resident_limits(dev.index, kind, c, rows, W)
        assert smem == pdhg.cluster_smem_bytes(kind, rows, W)
        assert got == held[c], (c, kind, shape)


def _kaczmarz_case(dev, case, seed=12):
    """(rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox) of an
    edge case: m and n off multiples of 32, n = 1, k_max = 1, genuine
    column-0 entries beside CSR padding, complex planes, −1 pads."""
    rng = np.random.default_rng(seed)
    m, n, nc, csr, sweeps, reuse, prox = {
        "dense": (37, 45, 1, False, 3, True, "none"),
        "dense-n1": (9, 1, 1, False, 2, True, "positive"),
        "dense-per-sweep": (70, 300, 1, False, 4, False, "positive"),
        "complex": (37, 45, 2, False, 3, True, "real"),
        "complex-positive": (21, 13, 2, False, 2, False, "positive"),
        "csr": (50, 40, 1, True, 3, False, "positive"),
        "csr-kmax1": (30, 7, 1, True, 2, True, "none"),
        "csr-complex": (33, 20, 2, True, 2, True, "none"),
    }[case]
    A = rng.normal(size=(nc, m, n)).astype(np.float32)
    cols = None
    if csr:
        keep = rng.uniform(size=(m, n)) < (0.0 if case == "csr-kmax1" else 0.3)
        keep[:, 0] = True  # a genuine column-0 entry in every row
        if case == "csr-kmax1":
            keep[::2, 0] = False
            keep[::2, 3] = True
        L = int(keep.sum(axis=1).max())
        vals = np.zeros((nc, m, L), np.float32)
        cl = np.zeros((m, L), np.int32)
        for i in range(m):
            nz = np.nonzero(keep[i])[0]
            vals[:, i, : nz.size] = A[:, i, nz]
            cl[i, : nz.size] = nz
        A, cols = vals, torch.from_numpy(cl).to(dev)
    S = m if reuse else m // 2 + 3
    order = (rng.permutation(m)[None] if reuse
             else np.stack([rng.choice(m, size=S, replace=False) for _ in range(sweeps)]))
    order = order.astype(np.int32)
    order[:, 1::4] = -1  # skipped entries
    P = 3

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    # 1/(‖aᵢ‖² + ε²) per problem, a little under-relaxed
    eps = np.array([0.03, 0.0, 0.3])
    rn2 = (A.astype(np.float64) ** 2).sum(axis=(0, 2))
    denom = rng.uniform(0.8, 1.0, size=(P, m)) / (rn2[None] + eps[:, None] ** 2 + 1e-3)
    return (t(A), cols, torch.from_numpy(order).to(dev), t(rng.normal(size=(P, nc, n))),
            t(rng.normal(size=(P, nc, m)) * 0.1), t(rng.normal(size=(P, nc, m))),
            t(denom), t(eps), sweeps, reuse, prox)


@pytest.mark.parametrize("case", ["dense", "dense-n1", "dense-per-sweep", "complex",
                                  "complex-positive", "csr", "csr-kmax1", "csr-complex"])
def test_kaczmarz_solve_kernel_matches_plain(dev, case):
    rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox = _kaczmarz_case(dev, case)
    before = kz.kaczmarz_solve.launches
    x, vl = kz.kaczmarz_solve(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols)
    assert kz.kaczmarz_solve.launches == before + 1
    wx, wvl = kz.kaczmarz_solve_torch(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox,
                                      cols)
    _close(x, wx, 1e-5)
    _close(vl, wvl, 1e-5)
    if prox == "positive":
        assert float(x[:, 0].min()) >= 0.0


def test_kaczmarz_sweep_kernel_matches_plain(dev):
    rows, _, idx, x0, vl0, u, denom, eps, _, _, _ = _kaczmarz_case(dev, "dense")
    before = kz.kaczmarz_sweep.launches
    x, vl = kz.kaczmarz_sweep(rows[0], x0[:, 0], vl0[:, 0], u[:, 0], denom, eps, idx[0])
    assert kz.kaczmarz_sweep.launches == before + 1
    wx, wvl = kz.kaczmarz_solve_torch(rows, idx[:1], x0, vl0, u, denom, eps, 1, True)
    _close(x, wx[:, 0], 1e-5)
    _close(vl, wvl[:, 0], 1e-5)


def _greedy_inputs(dev, m=45, n=13, P=3, seed=13):
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(dev)
    lam = 1e-4
    rn2 = (A * A).sum(dim=1)
    denom = 1.0 / (rn2 + lam)
    norms = rn2 + lam
    Gt = ((A @ A.T + lam * torch.eye(m, device=dev)) * denom[:, None]).contiguous()
    fnorm = float(1.0 / (rn2.sum() + lam))
    r = torch.from_numpy(rng.normal(size=(P, m)).astype(np.float32)).to(dev)
    x = torch.zeros(P, n, device=dev)
    vl = torch.zeros(P, m, device=dev)
    eps = torch.full((P,), lam ** 0.5, device=dev)
    return A, Gt, denom, norms, x, vl, r, eps, fnorm


@pytest.mark.parametrize("theta", [None, 0.3])
@pytest.mark.parametrize("forced", [False, True])
def test_greedy_kernel_matches_plain(dev, theta, forced):
    A, Gt, denom, norms, x, vl, r, eps, fnorm = _greedy_inputs(dev)
    S = 17
    fr = None
    if forced:
        fr = torch.from_numpy(np.random.default_rng(14).integers(-1, 45, size=S)
                              .astype(np.int32)).to(dev)
    args = (A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S, 2024, 5, fr)
    before = greedy.kaczmarz_greedy_sweep.launches
    gx, gvl, gr, rows = greedy.kaczmarz_greedy_sweep(*args)
    assert greedy.kaczmarz_greedy_sweep.launches == before + 1
    wx, wvl, wr, wrows = greedy.kaczmarz_greedy_sweep_torch(*args)
    assert torch.equal(rows, wrows), (rows, wrows)
    if forced:
        keep = fr >= 0
        assert torch.equal(rows[:, keep], fr[keep].expand(3, -1))
    _close(gx, wx, 1e-5)
    _close(gvl, wvl, 1e-5)
    _close(gr, wr, 1e-5)


def test_greedy_kernel_ties_go_to_the_smallest_row(dev):
    """A zero residual leaves every weight 0 and every score −inf: both
    versions take row 0, as the JAX kernel does."""
    A, Gt, denom, norms, x, vl, r, eps, fnorm = _greedy_inputs(dev)
    r = torch.zeros_like(r)
    _, _, _, rows = greedy.kaczmarz_greedy_sweep(A, Gt, denom, norms, x, vl, r, eps, fnorm,
                                                 None, 4, 1, 0)
    _, _, _, wrows = greedy.kaczmarz_greedy_sweep_torch(A, Gt, denom, norms, x, vl, r, eps,
                                                        fnorm, None, 4, 1, 0)
    assert rows.tolist() == wrows.tolist() == [[0] * 4] * 3


def test_row_action_wrappers_count_only_launches_and_check_rows(dev):
    """A call with no problems or no steps launches nothing and counts
    nothing; a row outside [−1, m) is refused before any launch."""
    rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox = _kaczmarz_case(dev, "dense")
    before = kz.kaczmarz_solve.launches
    x, _ = kz.kaczmarz_solve(rows, idx, x0[:0], vl0[:0], u[:0], denom[:0], eps[:0], sweeps,
                             reuse, prox)
    x1, _ = kz.kaczmarz_solve(rows, idx, x0, vl0, u, denom, eps, 0, reuse, prox)
    assert kz.kaczmarz_solve.launches == before
    assert x.shape[0] == 0 and torch.equal(x1, x0)
    for bad in (rows.shape[1], -2):
        wrong = idx.clone()
        wrong[0, 0] = bad
        with pytest.raises(ValueError, match="indices must lie"):
            kz.kaczmarz_solve(rows, wrong, x0, vl0, u, denom, eps, sweeps, reuse, prox)
    assert kz.kaczmarz_solve.launches == before
    A, Gt, denom, norms, x, vl, r, eps, fnorm = _greedy_inputs(dev)
    before = greedy.kaczmarz_greedy_sweep.launches
    gx, _, _, grows = greedy.kaczmarz_greedy_sweep(A, Gt, denom, norms, x, vl, r, eps, fnorm,
                                                   None, 0, 1, 0)
    assert grows.shape == (3, 0) and torch.equal(gx, x)
    forced = torch.tensor([3, A.shape[0]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="indices must lie"):
        greedy.kaczmarz_greedy_sweep(A, Gt, denom, norms, x, vl, r, eps, fnorm, None, 2, 1, 0,
                                     forced)
    assert greedy.kaczmarz_greedy_sweep.launches == before


def test_row_action_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox = _kaczmarz_case(dev, "dense")
    with pytest.raises(ValueError, match="float32"):
        kz.kaczmarz_solve(rows.double(), idx, x0.double(), vl0.double(), u.double(),
                          denom.double(), eps.double(), sweeps, reuse, prox)
    with pytest.raises(ValueError, match="int32"):
        kz.kaczmarz_solve(rows, idx.long(), x0, vl0, u, denom, eps, sweeps, reuse, prox)
    A, Gt, denom, norms, x, vl, r, eps, fnorm = _greedy_inputs(dev)
    with pytest.raises(ValueError, match="float32"):
        greedy.kaczmarz_greedy_sweep(A.double(), Gt, denom, norms, x, vl, r, eps, fnorm, None,
                                     2, 1, 0)
    with pytest.raises(ValueError, match="float32"):
        pdhg.pdhg_fused(torch.zeros(2, 8, 8, device=dev, dtype=torch.float64), TAPS, 0.5, 0.3,
                        0.1, 3)
