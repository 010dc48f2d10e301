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
bit on both routes, at powers of two and at sides with odd factors (the
mixed-radix FFT: 24 × 40, 320², 97 × 128, 192², …), repeating bit for bit
over 20 launches; the SplitBregman kernel, whose CG sums are double
sums in another order, is held to 1e-5 of max|x| with equal live CG
steps. The PDHG,
Kaczmarz and greedy Kaczmarz kernels are held to 1e-5 of max|x| on edge
shapes (m, n off multiples of 32, n = 1, k_max = 1, complex, −1 pads, a
CSR row with a genuine column-0 entry), the PDHG kernel's resident route
bit for bit, and the greedy kernel's drawn rows must equal its plain
version's on both routes (the resident route's whole solve in one launch,
the block route a launch a sweep), sweep and solve, with the same bits
over 20 launches. A cluster kernel's resident route gives the same bits on
every launch (20 repeats): a race between its CTAs would show as a
launch that differs. The fused ADMM-TV kernel's resident route, whose CG
sums are double sums over its cluster in rank order, is held to 1e-5 of
max|x| with equal live CG steps at each cluster size its planner picks.
The TV prox kernel's resident route is held to 1e-5 of max|x| at each
cluster size and plane placement its planner picks, at forced sizes, and
bit for bit over 20 launches. So is row 3's cluster route (the fused
PGM-TV kernel with three planes of a band in shared memory), at every
method and schedule, with equal counts, its two placements bit for bit
alike where both fit; and row 5's cluster route (the fused ADMM-TV
kernel's body with three planes of a band in shared memory), with equal
live CG steps, bit for bit over 20 launches at the 512² cell and bit for
bit row 4's five-plane placement where both fit. The Kaczmarz row kernel
is held to 1e-5 of max|x| on both routes, planned and forced (the warp
route with 1, 2 and 3 problems a CTA), on every edge case (a row back
within the ring's window, a repeated row, a list of −1 only, x in shared
memory) and at the tall cell, each launch counted on its route, and its
warp and block routes give the same bits over 20 launches. The composite,
decorator, DAX and operator path (chip_smoke.py phase 11) at small sizes: a
decorated term that the dispatch reads through sink / get_lam runs its
kernel once (CGNR, PDHG, the streamed Kaczmarz) with its undecorated
twin's bits; a decorated TV falls back to the composed solve with one TV
prox launch an iteration and the undecorated solve's bits; the composite,
direct-conv, wavelet, function and Radon operators on the card hold their
CPU results to 1e-5 of max|x| (the Radon backprojection scatters with
atomics); DAX on the card holds its CPU solve to 1e-10 in float64. The
exact 1-D Condat kernel (chip_smoke.py phase 12) equals its plain version
bit for bit on the card and on the CPU (lines of 1 to 3,000 entries, along
strided and contiguous axes, float32 and float64), and refuses complex and
half data by name; FISTA with TV(dims=0) on the card runs it once an
iteration and holds the CPU solve to 1e-5 of max|x|, as Nuclear, LLR and
PnP do their CPU proxes. Its redesign (chunked walks stitched on (index,
sign)) is held bit for bit to the plain version on each route forced at
those shapes and chunks of 1, 16 and past the line
(`test_condat_routes_bit_for_bit`), on adversarial lines (λ = 0, tiny and
past the variation, constant, ramps, alternating ±1, piecewise constant;
N = 1, 2, 3, 16, 17, 33, 256; `test_condat_adversarial_lines_bit_for_bit`),
on long lines (8,192 on both routes, 65,536 against one walker a line;
`test_condat_long_lines`), over 20 calls (`test_condat_repeats_bit_for_bit`);
its timer and counts (`test_condat_phase_timer_and_counts`), its sizes
against the planner (`test_condat_sizes_match_the_planner`) and ptxas's
registers and spills (`test_condat_registers_from_the_build`) are read
too."""

import dataclasses
import re

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
        plan, active = tv_fgp.plan_on_card(x, iterations)
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


def _tv_windows(x, lam, iterations, interior=None, clusters=None, own=None):
    """One launch on the windowed route (the planner's, or forced windows
    of `interior` rows through the private ``_launch``), counted once on
    it, and its plan."""
    plan, active = tv_fgp._card_plan(x.device.index or 0, *x.shape, clusters, own, iterations,
                                     interior)
    assert plan.route == "windows" and plan.halo == iterations and active >= 1
    before = dict(tv_fgp.prox_tv2d_fgp.route_launches)
    if interior is None and clusters is None and own is None:
        got = tv_fgp.prox_tv2d_fgp(x.reshape(x.shape[0], -1), lam, x.shape[1:],
                                   iterations).reshape(x.shape)
    else:
        got = tv_fgp._launch(x, lam, iterations, clusters, own, interior)
    before["windows"] += 1
    assert tv_fgp.prox_tv2d_fgp.route_launches == before
    return got, plan


@pytest.mark.parametrize("iterations", [0, 1, 10])
@pytest.mark.parametrize("shape,interior,clusters,own", [
    ((47, 40), 5, None, None), ((47, 40), 9, 2, None), ((47, 40), 9, 2, "global"),
    ((64, 17), 6, None, None), ((256, 256), 100, 12, "global"), ((1, 8), 1, None, None)])
def test_tv_fgp_windows_match_plain(dev, shape, interior, clusters, own, iterations):
    """Forced windows (both placements, several per problem, the last one
    short) against their plain version and the whole image's, to 1e-5 of
    max|x| (the kernel contracts to FMA where the plain version rounds)."""
    x, lam = _tv_inputs(dev, shape)
    got, plan = _tv_windows(x, lam, iterations, interior, clusters, own)
    assert plan.windows == -(-shape[0] // interior)
    _close(got, tv_fgp.prox_tv2d_fgp_windows_torch(x, lam, iterations, plan), 1e-5)
    _close(got, tv_fgp.prox_tv2d_fgp_torch(x, lam, iterations), 1e-5)


@pytest.mark.parametrize("iterations", [1, 10])
@pytest.mark.parametrize("interior,clusters,own", [(100, 12, None), (100, 12, "global"),
                                                   (37, 7, None), (256, None, None)])
def test_tv_fgp_windows_are_the_resident_route_bit_for_bit(dev, interior, clusters, own,
                                                           iterations):
    """Windows with a halo of the dual iterations run each interior pixel
    through the same operations as the resident route on the whole image:
    the same bits, whatever the windows' cluster size and placement."""
    x, lam = _tv_inputs(dev, (256, 256), 4, seed=9)
    whole, plan = _tv_launch(x, lam, iterations)
    assert plan.route == "resident"
    got, _ = _tv_windows(x, lam, iterations, interior, clusters, own)
    torch.cuda.synchronize()
    assert torch.equal(got, whole)


def test_tv_fgp_windows_at_1024_match_plain_and_repeat_bit_for_bit(dev):
    """2 × 1024² at 10 dual iterations takes the planner's windows: the
    plain version to 1e-5 of max|x|, and 20 launches each equal to the
    first (overlapping windows write no common scratch)."""
    x, lam = _tv_inputs(dev, (1024, 1024), 2, seed=8)
    first, plan = _tv_windows(x, lam, 10)
    assert plan.windows > 1
    _close(first, tv_fgp.prox_tv2d_fgp_torch(x, lam, 10), 1e-5)
    for _ in range(20):
        got = tv_fgp.prox_tv2d_fgp(x.reshape(2, -1), lam, (1024, 1024), 10).reshape(x.shape)
        assert torch.equal(got, first)


@pytest.mark.parametrize("own", [None, "global"])
def test_tv_fgp_forced_windows_repeat_bit_for_bit(dev, own):
    """20 launches of overlapping windows with x, pv and ph in global
    memory (each window's own scratch) or in shared memory, each equal to
    the first."""
    x, lam = _tv_inputs(dev, (512, 512), 8, seed=5)
    first, plan = _tv_windows(x, lam, 10, 64, 8, own)
    assert plan.own == (own or "shared") and plan.windows == 8
    for _ in range(20):
        assert torch.equal(tv_fgp._launch(x, lam, 10, 8, own, 64), first)


def test_tv_fgp_windows_refuse_a_short_halo(dev):
    """The C entry point refuses windows whose halo is short of the dual
    iterations (their interiors would differ), and the planner a window
    that does not fit."""
    from rls_tpu_torch import _build

    x, lam = _tv_inputs(dev, (64, 64))
    plan, _ = tv_fgp._card_plan(dev.index, 3, 64, 64, None, None, 10, 8)
    out = torch.empty_like(x)
    lib = _build.load_library()
    for halo, ok in ((9, False), (10, True)):
        rows = -(-min(64, 8 + 2 * halo) // plan.clusters)
        code = lib.tv_fgp_windows_launch(
            x.data_ptr(), lam.data_ptr(), out.data_ptr(), None, 3, 64, 64, 10, plan.clusters,
            rows, 1, tv_fgp.cluster_smem_bytes(rows, 64, True), 8, halo,
            torch.cuda.current_stream().cuda_stream)
        assert (code == 0) == ok, (halo, code)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="windows of 0 rows do not fit"):
        tv_fgp._launch(x, lam, 10, interior=0)


def test_cluster_counts_of_the_windowed_planner(dev):
    """On an H100 the card holds, at each c's widest band of 1024 (18 rows
    of three planes, what ``_card_plan`` reads for the windowed route), the
    clusters the planner tests use."""
    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    held = dict(TV_RESIDENT)
    rows = tv_fgp.widest_band(1024, False)
    assert rows == 18
    for c in range(1, 17):
        smem, got = tv_fgp.resident_limits(dev.index, c, rows, 1024, False)
        assert smem == tv_fgp.cluster_smem_bytes(rows, 1024, False)
        assert got == held[c], c
    plan, active = tv_fgp.plan_on_card(torch.empty(8, 1024, 1024, device=dev), 10)
    assert (plan.route, plan.clusters, plan.halo, active) == ("windows", 8, 10, held[8])


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


# row 5's cluster route: (shape, taps) and the plan each takes: 512² on
# c = 16 (32-row bands), 500 × 520 on c = 16 (the last band 20 rows), both
# with three planes of a band in shared memory
ADMM_TILED_CLUSTER = {(512, 512): (TAPS, 16), (500, 520): (TAPS75, 16)}


def _admm_tiled_cluster(x0, taps, rho, lam, schedule, prox, tol, clusters=None, own=None):
    """A row-5 launch of (iterations, CG steps, dual iterations) `schedule`
    on the cluster route (its plan, or a forced size and placement), counted
    once on that route: (x, counts)."""
    before = dict(admm_tiled.admm_tv_tiled.route_launches)
    launches = admm_tiled.admm_tv_tiled.launches
    got = admm_tiled._run(x0, taps, rho, lam, *schedule, tol, prox, clusters=clusters, own=own)
    before["cluster"] += 1
    assert admm_tiled.admm_tv_tiled.route_launches == before
    assert admm_tiled.admm_tv_tiled.launches == launches + 1
    return got


@pytest.mark.parametrize("case", ["none", "positive-freeze"])
@pytest.mark.parametrize("shape", list(ADMM_TILED_CLUSTER))
def test_admm_tiled_cluster_route_matches_plain(dev, shape, case):
    """Row 5's cluster route (three planes of a band in shared memory) on
    its plan against the plain version: 1e-5 of max|x|, equal live CG
    steps, one launch by the route counter."""
    prox, tol = ADMM_CASES[case]
    taps, c = ADMM_TILED_CLUSTER[shape]
    x0, rho, lam = _admm_inputs(dev, shape)
    plan, held = admm_tiled.plan_on_card(x0, taps)
    assert (plan.route, plan.clusters, plan.own) == ("cluster", c, "global")
    assert held >= 1
    got, counts = _admm_tiled_cluster(x0, taps, rho, lam, (6, 5, 4), prox, tol)
    want, want_counts = _admm_plain(x0, taps, rho, lam, 6, 5, 4, prox, tol)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("taps", ["taps", "taps63"])
@pytest.mark.parametrize("clusters", [1, 6, 8, 16])
def test_admm_tiled_three_planes_match_plain(dev, clusters, taps):
    """Three planes forced on 48 × 64 (bands of 48, 8, 6 and 3 rows; the
    63-tap column blur reaches 10 bands past its own at c = 16)."""
    taps = TAPS63 if taps == "taps63" else TAPS
    x0, rho, lam = _admm_inputs(dev, (48, 64))
    plan, held = admm_tiled._card_plan(dev.index or 0, 3, 48, 64, len(taps[0]), len(taps[1]),
                                       None, clusters, "global")
    assert (plan.route, plan.own, plan.rows, held >= 1) == ("cluster", "global",
                                                            -(-48 // clusters), True)
    got, counts = _admm_tiled_cluster(x0, taps, rho, lam, (6, 5, 4), "positive", 1e-5,
                                      clusters, "global")
    want, want_counts = _admm_plain(x0, taps, rho, lam, 6, 5, 4, "positive", 1e-5)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("prox", ["none", "positive"])
@pytest.mark.parametrize("iterations,cg,tv", [(0, 3, 4), (3, 0, 4), (3, 1, 4), (3, 3, 0),
                                              (2, 2, 1), (3, 0, 1)])
def test_admm_tiled_three_plane_edge_schedules_match_plain(dev, iterations, cg, tv, prox):
    """The barrier table's edge schedules on three planes of 6 bands of 46
    rows (the last 6): no outer iteration, 0 and 1 CG steps, no and one
    dual iteration (p left in rv by the first dual sweep), ρ = 0 for one
    problem."""
    x0, rho, lam = _admm_inputs(dev, (46, 64))
    got, counts = _admm_tiled_cluster(x0, TAPS, rho, lam, (iterations, cg, tv), prox, 1e-5, 6,
                                      "global")
    want, want_counts = _admm_plain(x0, TAPS, rho, lam, iterations, cg, tv, prox, 1e-5)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("case", ["none", "positive-freeze"])
@pytest.mark.parametrize("clusters", [6, 16])
def test_admm_placements_agree_bit_for_bit(dev, clusters, case):
    """Three planes of a band in shared memory (forced) and all five (row
    4's placement, launched through row 5's planner), at one cluster size of
    16 × 256²: the same operations in the same order, the same bits and
    live CG steps; row 4's own launch gives them too."""
    prox, tol = ADMM_CASES[case]
    x0 = torch.from_numpy(np.random.default_rng(9).normal(size=(16, 256, 256))
                          .astype(np.float32)).to(dev)
    rho = torch.linspace(0.05, 0.4, 16, device=dev)
    lam = torch.linspace(1e-3, 5e-2, 16, device=dev)
    five, held = admm_tiled._card_plan(dev.index or 0, 16, 256, 256, 5, 3, None, clusters)
    assert (five.route, five.own, held >= 1) == ("cluster", "shared", True)
    a, ca = _admm_tiled_cluster(x0, TAPS, rho, lam, (6, 5, 4), prox, tol, clusters)
    b, cb = _admm_tiled_cluster(x0, TAPS, rho, lam, (6, 5, 4), prox, tol, clusters, "global")
    c, cc, _ = _admm_launch(x0, TAPS, rho, lam, (6, 5, 4), prox, tol, clusters)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(ca, cb)
    assert torch.equal(a, c) and torch.equal(ca, cc)


@pytest.mark.parametrize("batch,shape,schedule,tol", [
    (16, (512, 512), (10, 5, 10), 1e-5), (3, (500, 520), (12, 6, 8), 5e-2)])
def test_admm_tiled_cluster_route_repeats_bit_for_bit(dev, batch, shape, schedule, tol):
    """20 launches of the cluster route, at the 512² cell's plan and
    schedule (10 × 5 × 10) and on 500 × 520 with frozen CG steps: each
    equal to the first, with equal live CG steps."""
    taps = ADMM_TILED_CLUSTER[shape][0]
    x0 = torch.from_numpy(np.random.default_rng(6).normal(size=(batch, *shape))
                          .astype(np.float32)).to(dev)
    rho = torch.linspace(0.05, 0.4, batch, device=dev)
    lam = torch.linspace(1e-3, 5e-2, batch, device=dev)
    first, first_counts = _admm_tiled_cluster(x0, taps, rho, lam, schedule, "none", tol)
    for _ in range(20):
        got, counts = _admm_tiled_cluster(x0, taps, rho, lam, schedule, "none", tol)
        assert torch.equal(got, first) and torch.equal(counts, first_counts)


def test_admm_tiled_phase_clocks(dev):
    """The cluster route's phase timer: one launch, the same x as without
    the timer, clocks in every phase; the tiles route has no timer and
    raises, as does a forced size that does not fit."""
    x0, rho, lam = _admm_inputs(dev, (512, 512))
    want = admm_tiled.admm_tv_tiled(x0, TAPS, rho, lam, 4, 3, 4, 1e-5, prox="positive")
    before = dict(admm_tiled.admm_tv_tiled.route_launches)
    clocks = admm_tiled.phase_clocks(x0, TAPS, rho, lam, 4, 3, 4, 1e-5, "positive")
    assert admm_tiled.admm_tv_tiled.route_launches["cluster"] == before["cluster"] + 1
    assert list(clocks) == list(admm_fused.PHASES) and all(v > 0 for v in clocks.values())
    assert torch.equal(admm_tiled.admm_tv_tiled(x0, TAPS, rho, lam, 4, 3, 4, 1e-5,
                                                prox="positive"), want)
    with pytest.raises(ValueError, match="a cluster of 13 CTAs does not fit"):
        admm_tiled._run(x0, TAPS, rho, lam, 4, 3, 4, 1e-5, clusters=13)
    x1k = torch.zeros((1, 1024, 1024), device=dev)
    with pytest.raises(ValueError, match="cluster route"):
        admm_tiled.phase_clocks(x1k, TAPS, 0.1, 0.1, 2, 2, 2, 1e-5)


def test_admm_tiled_dispatch_runs_the_cluster_route(dev):
    """solve_batched_fast on a 512² ADMM-TV solver: row 5 in one launch on
    the cluster route, against its plain version; with `tile_rows` its
    row tiles."""
    op = rtt.SeparableConvOperator.from_taps(*TAPS, (512, 512), device=dev)
    solver = rtt.ADMM.create(
        op, reg=rtt.TVRegularization(1e-3, shape=(512, 512), iterations_tv=4, backend="cuda"),
        iterations=3, iterations_cg=3, unroll_cg=True, rho=0.1, tol_inner=1e-5)
    B = torch.from_numpy(np.random.default_rng(4).normal(size=(512 * 512, 2))
                         .astype(np.float32)).to(dev)
    before = dict(admm_tiled.admm_tv_tiled.route_launches)
    x = rtt.solve_batched_fast(solver, B)
    before["cluster"] += 1
    assert admm_tiled.admm_tv_tiled.route_launches == before
    tiles = admm_tiled.solve_admm_tv_tiled(solver, B, tile_rows=64)
    _close(x, tiles, 1e-5)


@pytest.mark.parametrize("shape", [(512, 512), (500, 520), (256, 256), (48, 64)])
def test_cluster_counts_of_the_admm_tiled_planner_tests(dev, shape):
    """On an H100 the card holds, for every size that fits three planes,
    the clusters of the three-plane kernel that
    tests/test_torch_admm_tiled_plan.py plans with, and counts the
    planner's shared memory."""
    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    H, W = shape
    held = dict(ADMM_RESIDENT)
    fit = admm_tiled.fitting_sizes(H, W, *limits)
    assert fit
    for c in fit:
        rows = -(-H // c)
        smem, got = admm_fused.resident_limits(dev.index, c, rows, W, False)
        assert smem == admm_fused.cluster_smem_bytes(rows, W, False)
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


# sha256 of (xr, xi, restarts) of row 7b's per-problem kernel (the complex
# plane kernel, one CTA per problem) at `_cplx_digest_case`, as the source
# before the real kernel's grid route was added computed them on an NVIDIA
# H100 80GB HBM3 (700 W): the per-problem route stays that kernel, bit for
# bit
CPLX_PARENT_SHA256 = "beff348ec5f92d2feb0e57a368d63db95cd966bd29907003ed719b5ea9ae383f"


def _cplx_digest_case(dev):
    (ar, ai), (br, bi) = _dense(dev, m=256, n=512, P=16, seed=11, cplx=True)
    lam = torch.linspace(0.0, 2e-2, 16, device=dev)
    return (br, bi, ar, ai, lam, 0.4, 1.0, 100, "fista", "l1", "gradient", "real")


def test_pgm_dense_cplx_kernel_is_bit_for_bit_the_stored_run(dev):
    """Row 7b's per-problem route (forced: the case has a grid plan), which
    the grid routes leave as it was."""
    import hashlib

    br, bi, ar, ai, lam, rho, theta, steps, method, kind, restart, prox = _cplx_digest_case(dev)
    scal, tab = pgm_dense.kernel_args(br, lam, rho, theta, method, steps)
    xr, xi, counts = pgm_dense._launch_cplx(br, bi, ar, ai, scal, tab,
                                            (steps, method, kind, restart, prox),
                                            route="per_problem")
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


# (m, n, P) of the complex dense PGM kernel's cases and the route of each:
# the small system (one slab, one group); phase 3g's complex 256 × 512 ×
# 16; several slabs and groups with a remainder in both; P = 1; more
# problems than SMs; A tall, and wide (both planes of its slab streamed
# from L2); a row too long for two planes of a group's Gram input and x in
# shared memory (the per-problem kernel); and "real A", the 256 × 512 × 16
# case with a zero im plane (a real A with a complex b)
PGM_DENSE_CPLX_SHAPES = {(40, 24, 3): "grid", (256, 512, 16): "grid", (1000, 300, 61): "grid",
                         (256, 512, 1): "grid", (256, 512, 137): "grid", (3000, 16, 16): "grid",
                         (16, 1000, 16): "grid", (64, 1600, 3): "per_problem",
                         "real A": "grid"}


def _pgm_dense_cplx_system(dev, shape):
    """(br, bi, ar, ai, λ) of a complex dense PGM case: A = (N + iN)/√(2m)
    as its planes, a wide A scaled by √(m/n) so that ρ = 0.4 converges on
    every shape, λ 1e-2, 0, 0.1 in turn."""
    real_a = shape == "real A"
    m, n, P = (256, 512, 16) if real_a else shape
    (ar, ai), (br, bi) = _dense(dev, m, n, P, seed=12, cplx=True)
    scale = float(np.sqrt(0.25 * min(1.0, m / n)))
    ar, ai = ar * scale, torch.zeros_like(ai) if real_a else ai * scale
    lam = torch.tensor([1e-2, 0.0, 0.1], device=dev).repeat(P)[:P]
    return br, bi, ar.contiguous(), ai.contiguous(), lam.contiguous()


def _cplx_case(dev):
    """Phase 3g's complex case's shape: 256 × 512 at batch 16, A = (N +
    iN)/√(2m) as its planes, ρ = 0.95/‖A‖₂², λ from 0 to 2e-2; FISTA's
    gradient restart fires on it."""
    (ar, ai), (br, bi) = _dense(dev, m=256, n=512, P=16, seed=11, cplx=True)
    ar, ai = ar * float(np.sqrt(0.5)), ai * float(np.sqrt(0.5))
    a64 = torch.complex(ar, ai).cpu().to(torch.complex128)
    rho = 0.95 / float(torch.linalg.matrix_norm(a64, ord=2)) ** 2
    return br, bi, ar, ai, torch.linspace(0.0, 2e-2, 16, device=dev), rho


def _cplx_counters():
    fn = pgm_dense.pgm_dense_fused_cplx
    return fn.launches, dict(fn.route_launches)


@pytest.mark.parametrize("shape", list(PGM_DENSE_CPLX_SHAPES), ids=str)
@pytest.mark.parametrize("method,restart", [("fista", "none"), ("fista", "gradient"),
                                            ("fista", "gradient_mapping"), ("optista", "none"),
                                            ("pogm", "none")])
@pytest.mark.parametrize("kind", ["l1", "l2"])
@pytest.mark.parametrize("prox", ["none", "positive", "real"])
def test_pgm_dense_cplx_routes_match_plain(dev, method, restart, kind, prox, shape):
    """The complex kernel on the route of its plan, at the bars of
    test_pgm_dense_kernel_matches_plain: one launch counted on that route,
    x within 1e-5 of max|x| of the plain version, equal restart counts, and
    the same bits run to run."""
    br, bi, ar, ai, lam = _pgm_dense_cplx_system(dev, shape)
    route = PGM_DENSE_CPLX_SHAPES[shape]
    plan = pgm_dense.card_plan(br, ar, cplx=True)
    assert plan.route == route
    if route == "grid":
        assert plan.ctas <= torch.cuda.get_device_properties(dev).multi_processor_count
    args = (lam, 0.4, 1.0, 30, method, kind, restart, prox)
    launches, routes = _cplx_counters()
    xr, xi, counts = pgm_dense.pgm_dense_fused_cplx(br, bi, ar, ai, *args, with_counts=True)
    assert _cplx_counters() == (launches + 1, {**routes, route: routes[route] + 1})
    scal, tab = pgm_dense.kernel_args(br, lam, 0.4, 1.0, method, 30)
    wr, wi, want_counts = pgm_dense.pgm_dense_fused_cplx_torch(br, bi, ar, ai, scal, tab, 30,
                                                               method, kind, restart, prox)
    got = torch.stack([xr, xi])
    assert bool(torch.isfinite(got).all())
    _close(got, torch.stack([wr, wi]), 1e-5)
    assert counts.tolist() == want_counts.tolist()
    if restart != "none" and shape == (40, 24, 3):
        assert max(counts.tolist()) > 0
    if prox != "none":
        assert not bool(xi.any())
    assert torch.equal(torch.stack(pgm_dense.pgm_dense_fused_cplx(br, bi, ar, ai, *args)), got)


@pytest.mark.parametrize("method,restart", [("fista", "gradient"), ("pogm", "none")])
def test_pgm_dense_cplx_grid_route_repeats_bit_for_bit(dev, method, restart):
    """20 launches of the complex grid route at phase 3g's complex case's
    plan (16 slabs × 2 groups, two group barriers per iteration, four
    partials per entry), 100 iterations of FISTA with its gradient restart
    (the restart partials of both planes summed over the slabs by every
    CTA) and of POGM: each equal to the first, with equal counts, and held
    to the plain version."""
    br, bi, ar, ai, lam, rho = _cplx_case(dev)
    plan = pgm_dense.card_plan(br, ar, cplx=True)
    assert (plan.route, plan.slabs, plan.groups) == ("grid", 16, 2)
    args = (lam, rho, 1.0, 100, method, "l1", restart)
    first = pgm_dense.pgm_dense_fused_cplx(br, bi, ar, ai, *args, with_counts=True)
    scal, tab = pgm_dense.kernel_args(br, lam, rho, 1.0, method, 100)
    want = pgm_dense.pgm_dense_fused_cplx_torch(br, bi, ar, ai, scal, tab, 100, method, "l1",
                                                restart)
    _close(torch.stack(first[:2]), torch.stack(want[:2]), 1e-5)
    assert first[2].tolist() == want[2].tolist()
    if restart != "none":
        assert max(first[2].tolist()) > 0
    for _ in range(20):
        got = pgm_dense.pgm_dense_fused_cplx(br, bi, ar, ai, *args, with_counts=True)
        assert all(torch.equal(u, v) for u, v in zip(got, first))


def test_pgm_dense_cplx_phase_clocks(dev):
    """The complex grid route's phase timer: one launch counted on the grid
    route, clocks in every phase; a shape with no grid plan raises and
    launches nothing."""
    br, bi, ar, ai, lam, rho = _cplx_case(dev)
    launches, routes = _cplx_counters()
    clocks = pgm_dense.phase_clocks_cplx(br, bi, ar, ai, lam, rho, 1.0, 20, "fista", "l1",
                                         "gradient", "real")
    assert _cplx_counters() == (launches + 1, {**routes, "grid": routes["grid"] + 1})
    assert list(clocks) == list(pgm_dense.GRID_PHASES)
    assert all(v > 0 for v in clocks.values()), clocks
    br4, bi4, ar4, ai4, lam4 = _pgm_dense_cplx_system(dev, (64, 1600, 3))
    with pytest.raises(ValueError, match="no grid plan"):
        pgm_dense.phase_clocks_cplx(br4, bi4, ar4, ai4, lam4, 0.4, 1.0, 2)
    assert _cplx_counters() == (launches + 1, {**routes, "grid": routes["grid"] + 1})


@pytest.mark.parametrize("shape", [(40, 24, 3), (256, 512, 16), "real A"], ids=str)
@pytest.mark.parametrize("method,restart", [("fista", "gradient"), ("pogm", "none")])
def test_pgm_dense_cplx_forced_per_problem_route_matches_plain(dev, shape, method, restart):
    """The complex per-problem kernel, forced where the planner takes the
    grid: held to the plain version like the grid route, counted on its
    route."""
    br, bi, ar, ai, lam = _pgm_dense_cplx_system(dev, shape)
    scal, tab = pgm_dense.kernel_args(br, lam, 0.4, 1.0, method, 30)
    sched = (30, method, "l1", restart, "real")
    launches, routes = _cplx_counters()
    xr, xi, counts = pgm_dense._launch_cplx(br, bi, ar, ai, scal, tab, sched, route="per_problem")
    assert _cplx_counters() == (launches + 1,
                                {**routes, "per_problem": routes["per_problem"] + 1})
    wr, wi, want_counts = pgm_dense.pgm_dense_fused_cplx_torch(br, bi, ar, ai, scal, tab, *sched)
    _close(torch.stack([xr, xi]), torch.stack([wr, wi]), 1e-5)
    assert counts.tolist() == want_counts.tolist()


def test_pgm_dense_cplx_grid_route_never_falls_back(dev):
    """A forced grid launch on a shape without a grid plan raises, and so
    does one the C entry point refuses (a plan whose shared memory differs
    from the kernel's count); neither launches anything on another
    route."""
    launches, routes = _cplx_counters()
    br, bi, ar, ai, lam = _pgm_dense_cplx_system(dev, (64, 1600, 3))
    scal, tab = pgm_dense.kernel_args(br, lam, 0.4, 1.0, "fista", 4)
    sched = (4, "fista", "l1", "none", "none")
    with pytest.raises(ValueError, match="no grid plan"):
        pgm_dense._launch_cplx(br, bi, ar, ai, scal, tab, sched, route="grid")
    br, bi, ar, ai, lam = _pgm_dense_cplx_system(dev, (256, 512, 16))
    scal, tab = pgm_dense.kernel_args(br, lam, 0.4, 1.0, "fista", 4)
    plan = pgm_dense.card_plan(br, ar, cplx=True)
    bad = pgm_dense.PgmDensePlan("grid", plan.slabs, plan.rows, plan.groups, plan.group_size,
                                 plan.resident, plan.smem + 16)
    with pytest.raises(RuntimeError, match="pgm_dense_grid_cplx_launch"):
        pgm_dense._launch_grid((br, bi), (ar, ai), scal, tab, bad, *sched)
    with pytest.raises(ValueError, match="no route"):
        pgm_dense._launch_cplx(br, bi, ar, ai, scal, tab, sched, route="plain")
    assert _cplx_counters() == (launches, routes)


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
    """Every FFT_SHAPES shape on its planned route (512² on the grid route,
    a team of CTAs per problem that meet in L2; the rest on clusters), by
    the route counter, bit for bit the plain version."""
    mask, _, _, rng = _fft_inputs(dev, shape)
    x0 = torch.from_numpy(rng.normal(size=(3, *shape)).astype(np.float32)).to(dev)
    lam = torch.tensor([1e-2, 0.0, 0.1], device=dev)
    plan, active = l1dft.plan_on_card(x0)
    assert plan.route == ("grid" if shape == (512, 512) else "resident")
    assert active >= 1
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


@pytest.mark.parametrize("shape", [(256, 256), (64, 64), (97, 128)])
def test_fista_l1_dft_phase_clocks(dev, shape):
    """The resident kernel's phase timer: one launch, the same x as without
    the timer, clocks in every phase (lines of 256 points, with a
    shared-memory stage, of 64, without, and uneven bands of a prime side);
    at 512² the grid route's timer, its own phases (the global route, which
    had no timer, is gone)."""
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
    grid = l1dft.phase_clocks(xg, torch.ones(512, 512, device=dev), 0.95, 1e-3, 2)
    assert list(grid) == list(l1dft.GRID_PHASES)
    with pytest.raises(ValueError, match="the phase timer runs on the card"):
        l1dft.phase_clocks(xg.cpu(), torch.ones(512, 512), 0.95, 1e-3, 2)


@pytest.mark.parametrize("shape", [(256, 256), (128, 128), (64, 64), (1024, 16), (320, 320),
                                   (24, 40), (96, 192), (97, 128), (300, 300)])
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


# Row 8's grid route (a team of CTAs a problem that meet in L2, where no
# cluster of 16 holds a band): the planner's shapes on an H100
# (test_torch_dft_plan.GRID_PLANS), and forced plans at small shapes with
# uneven teams and slots walking problems in rounds
GRID_SHAPES = [(4, 512, 512), (4, 640, 640), (4, 448, 448), (2, 1024, 1024), (2, 1024, 256)]
GRID_FORCED = [((3, 24, 40), (3, 1)), ((3, 24, 40), (7, 2)), ((3, 17, 32), (5, 3)),
               ((3, 16, 256), (6, 2)), ((5, 512, 512), (33, 2)), ((16, 512, 512), (33, 4))]


def _l1_inputs(dev, size, seed=3):
    B, H, W = size
    rng = np.random.default_rng(seed + H * W)
    mask = torch.from_numpy((rng.uniform(size=(H, W)) < 0.35).astype(np.float32)).to(dev)
    x0 = torch.from_numpy(rng.normal(size=size).astype(np.float32)).to(dev)
    return x0, mask, torch.linspace(1e-3, 4e-2, B, device=dev)


def _l1_plain(x0, mask, rho, lam, iterations):
    scal = fused.problem_scalars(x0, rho, lam)
    tab = torch.as_tensor(fused._momentum_table("fista", iterations), device=x0.device)
    return l1dft.fista_l1_dft_fused_torch(x0, scal, tab, dft.dft_tables(mask))


@pytest.mark.parametrize("size", GRID_SHAPES)
def test_fista_l1_dft_grid_route_matches_plain(dev, size):
    """Each shape on the grid route as planned, by the route counter, bit
    for bit the plain version."""
    x0, mask, lam = _l1_inputs(dev, size)
    plan, held = l1dft.plan_on_card(x0)
    assert plan.route == "grid" and plan.ctas <= held
    before = dict(l1dft.fista_l1_dft_fused.route_launches)
    got = l1dft.fista_l1_dft_fused(x0, mask, 0.9, lam, 7)
    after = l1dft.fista_l1_dft_fused.route_launches
    assert (after["grid"], after["resident"]) == (before["grid"] + 1, before["resident"])
    want = _l1_plain(x0, mask, 0.9, lam, 7)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("size,grid", GRID_FORCED)
def test_fista_l1_dft_forced_grid_plans_match_plain(dev, size, grid):
    """Forced grid plans (uneven teams, rounds of problems a slot, a
    power-of-two and a mixed-radix shape), bit for bit the plain version;
    the timer leaves x as it was."""
    x0, mask, lam = _l1_inputs(dev, size)
    plan, held = l1dft.plan_on_card(x0, grid=grid)
    assert (plan.route, plan.team, plan.slots) == ("grid", *grid) and plan.ctas <= held
    got = l1dft.fista_l1_dft_fused(x0, mask, 0.9, lam, 7, grid=grid)
    want = _l1_plain(x0, mask, 0.9, lam, 7)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())
    clocks = l1dft.phase_clocks(x0, mask, 0.9, lam, 7, grid=grid)
    assert list(clocks) == list(l1dft.GRID_PHASES)
    assert torch.equal(l1dft.fista_l1_dft_fused(x0, mask, 0.9, lam, 7, grid=grid), want)


def test_fista_l1_dft_grid_route_repeats_bit_for_bit(dev):
    """20 launches at 4 × 512² (60 iterations, 4 slots of 33 CTAs), each
    equal to the first and to the plain version: a race between a team's
    CTAs (a barrier or an L1 read of another CTA's spectrum) would show as
    a launch that differs."""
    x0, mask, lam = _l1_inputs(dev, (4, 512, 512))
    plan, _ = l1dft.plan_on_card(x0)
    assert (plan.route, plan.team, plan.slots) == ("grid", 33, 4)
    first = l1dft.fista_l1_dft_fused(x0, mask, 0.95, lam, 60)
    for _ in range(20):
        assert torch.equal(l1dft.fista_l1_dft_fused(x0, mask, 0.95, lam, 60), first)
    assert torch.equal(first, _l1_plain(x0, mask, 0.95, lam, 60))


@pytest.mark.parametrize("size", [(4, 512, 512), (4, 640, 640)])
def test_fista_l1_dft_grid_phase_clocks(dev, size):
    """The grid route's timer: one launch, clocks in every phase, the same
    x as without it."""
    x0, mask, lam = _l1_inputs(dev, size)
    want = l1dft.fista_l1_dft_fused(x0, mask, 0.95, lam, 6)
    before = l1dft.fista_l1_dft_fused.launches
    clocks = l1dft.phase_clocks(x0, mask, 0.95, lam, 6)
    assert l1dft.fista_l1_dft_fused.launches == before + 1
    assert list(clocks) == list(l1dft.GRID_PHASES)
    assert all(v > 0 for v in clocks.values()), clocks
    assert torch.equal(l1dft.fista_l1_dft_fused(x0, mask, 0.95, lam, 6), want)


@pytest.mark.parametrize("size", list(GRID_SHAPES) + [(16, 512, 512), (1, 385, 385)])
def test_the_card_holds_the_grid_planner_s_teams(dev, size):
    """On an H100 the card holds one grid CTA a SM at the route's largest
    shared memory (H100_GRID, which the CPU tests plan with), the plan is
    the CPU tests' (GRID_PLANS), and its team × slots CTAs are resident at
    once at the plan's own shared memory."""
    from test_torch_dft_plan import GRID_PLANS, H100_GRID

    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    B, H, W = size
    cap = l1dft.grid_plane_cap(H, W, limits[1])
    assert l1dft.grid_limits(dev.index, H, W, l1dft.grid_smem_bytes(H, W, cap)) == (1, H100_GRID)
    plan, held = l1dft.plan_on_card(torch.zeros(size, device=dev))
    assert (plan.team, plan.slots, plan.rows, plan.cols, plan.row_lines,
            plan.col_lines) == GRID_PLANS[size]
    assert held >= plan.ctas


def test_a_grid_plan_the_kernel_refuses_raises(dev):
    """The C entry recounts the plan: a chunk that its shared memory does
    not hold is refused (no launch, no count)."""
    x0, mask, lam = _l1_inputs(dev, (4, 512, 512))
    plan, _ = l1dft.plan_on_card(x0)
    bad = dataclasses.replace(plan, row_lines=plan.rows + 1)
    before = l1dft.fista_l1_dft_fused.launches
    with pytest.raises(RuntimeError, match="fista_l1_dft_fused"):
        l1dft._launch(x0, *l1dft._kernel_args(x0, mask, 0.9, lam, 3), plan=bad)
    assert l1dft.fista_l1_dft_fused.launches == before


# FISTA-L21-SENSE's cases: every FFT_SHAPES shape at 1 and 3 coils (256 ×
# 128 on the split route, 512² on the grid one), and at 128² the resident route's cluster
# of 6 and 9 CTAs and 17 coils in two rounds on 9; 2 × 4 at 6 coils leaves
# four of the six CTAs without a row of the image
SENSE_CASES = [(shape, coils) for shape in FFT_SHAPES for coils in (1, 3)] + [
    ((128, 128), 1), ((128, 128), 6), ((128, 128), 9), ((128, 128), 17), ((2, 4), 6)]


def _sense_route(module, shape):
    """The route of a SENSE kernel's plan at `shape` on an H100: resident
    where a coil's padded spectrum fits a CTA, split where a team's CTA
    does, else grid."""
    fits = [k for k in range(1, 17) if module.cluster_smem_bytes(*shape, k) <= 232_448]
    return "grid" if not fits else "resident" if fits[0] == 1 else "split"


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
    """Every case on its planned route (the resident route where a coil's
    spectrum fits one CTA, the split route where a team's share does, the
    grid route where none does), by the route counter, bit for bit the
    plain version."""
    x0, mask, cr, ci, lam = _sense_inputs(dev, shape, coils)
    plan = sense.plan_on_card(x0, coils)
    assert plan.route == _sense_route(sense, shape)
    if plan.route != "grid":
        assert (plan.clusters, plan.rounds) == sense.cluster_size(coils, team=plan.team)
        assert plan.resident_clusters >= 1
    else:
        assert plan.ctas <= plan.resident_clusters
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
    """The kernel's phase timer, resident (128²), split (192²) and grid
    (512², its own phases): one launch, the same x as without the timer,
    clocks in every phase."""
    for shape, coils, phases in (((128, 128), 6, sense.PHASES), ((192, 192), 6, sense.PHASES),
                                 ((512, 512), 2, sense.GRID_PHASES)):
        x0, mask, cr, ci, lam = _sense_inputs(dev, shape, coils)
        args = (x0, mask, cr, ci, 0.9, lam, 5)
        want = sense.fista_l21_sense_fused(*args)
        before = sense.fista_l21_sense_fused.launches
        clocks = sense.phase_clocks(*args)
        assert sense.fista_l21_sense_fused.launches == before + 1
        assert list(clocks) == list(phases)
        assert all(v > 0 for v in clocks.values()), clocks
        assert torch.equal(sense.fista_l21_sense_fused(*args), want)


@pytest.mark.parametrize("shape", [(128, 128), (1024, 16), (16, 1024), (2, 4), (64, 192)])
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


@pytest.mark.parametrize("module", [sense, sb], ids=["row9", "row10"])
@pytest.mark.parametrize("shape,team", [((192, 192), 3), ((256, 128), 3), ((256, 256), 5)])
def test_split_cluster_counts_of_the_planner_tests(dev, module, shape, team):
    """On an H100 the card holds, for every cluster size of a split plan,
    the clusters of the split kernel that the planner tests plan with
    (tests/test_torch_sense_split.py: 9 of 9 CTAs at 192²), and counts the
    planner's shared memory."""
    from test_torch_sense_plan import H100_RESIDENT

    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    held = dict(H100_RESIDENT)
    for c in range(team, module.MAX_CLUSTER + 1, team):
        smem, got = module.plan_limits(dev.index, c, team, *shape)
        assert smem == module.split_smem_bytes(*shape, team)
        assert got == held[c], (c, shape)


# SplitBregman's cases: every FFT_SHAPES shape at 3 coils (256 × 128 on the
# split route, 512² on the grid one), and at 128² the resident route's cluster of 1, 6 and 9
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
    assert plan.route == _sense_route(sb, shape)
    if plan.route != "grid":
        assert (plan.clusters, plan.rounds) == sb.cluster_size(coils, team=plan.team)
        assert plan.resident_clusters >= 1
    else:
        assert plan.ctas <= plan.resident_clusters
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
    """The kernel's phase timer, resident (128²), split (192²) and grid
    (512², its own phases): one launch, the same x and counts as without
    the timer, clocks in every phase."""
    for shape, coils, phases in (((128, 128), 6, sb.PHASES), ((192, 192), 6, sb.PHASES),
                                 ((512, 512), 2, sb.GRID_PHASES)):
        x0, mask, cr, ci, rho1 = _sb_inputs(dev, shape, coils)
        args = (x0, mask, cr, ci, rho1, 0.02, 1e-3, 2e-3, 2, 2, 3, 2, 1e-5)
        want = sb.splitbregman_l1_tv_fused(*args)
        before = sb.splitbregman_l1_tv_fused.launches
        clocks = sb.phase_clocks(*args)
        assert sb.splitbregman_l1_tv_fused.launches == before + 1
        assert list(clocks) == list(phases)
        assert all(v > 0 for v in clocks.values()), clocks
        assert torch.equal(sb.splitbregman_l1_tv_fused(*args), want)


def test_sense_grid_routes_repeat_bit_for_bit(dev):
    """Rows 9 and 10 at 2 × 512², 6 coils, on the grid route by the route
    counter (row 10 on a short schedule): 20 launches each give the plain
    version's bits (row 10: its live CG steps too); a race between the
    CTAs of a team would show as a launch that differs."""
    x0, mask, cr, ci, lam = _sense_inputs(dev, (512, 512), 6)
    args = (x0, mask, cr, ci, 0.9, lam, 6)
    want = _sense_plain(x0, mask, cr, ci, lam, 6)
    sense.fista_l21_sense_fused.route_launches = dict.fromkeys(
        sense.fista_l21_sense_fused.route_launches, 0)
    for _ in range(20):
        assert torch.equal(sense.fista_l21_sense_fused(*args), want)
    assert sense.fista_l21_sense_fused.route_launches == {"resident": 0, "split": 0, "grid": 20}
    x0, mask, cr, ci, rho1 = _sb_inputs(dev, (512, 512), 6)
    sched = (1, 2, 3, 2, 1e-5)
    scal, t2 = sb.kernel_args(x0, rho1, 0.02, 1e-3, 2e-3, 2)
    want, want_counts = sb.splitbregman_l1_tv_fused_torch(
        x0, scal, t2, (cr, ci), dft.dft_tables(mask), *sched[:3], sched[4])
    sb.splitbregman_l1_tv_fused.route_launches = dict.fromkeys(
        sb.splitbregman_l1_tv_fused.route_launches, 0)
    for _ in range(20):
        got, counts = sb.splitbregman_l1_tv_fused(x0, mask, cr, ci, rho1, 0.02, 1e-3, 2e-3,
                                                  *sched, with_counts=True)
        assert torch.equal(got, want) and counts.tolist() == want_counts.tolist()
    assert sb.splitbregman_l1_tv_fused.route_launches == {"resident": 0, "split": 0, "grid": 20}


def test_grid_counts_of_the_sense_grid_tests(dev):
    """On an H100 the card holds one grid CTA of rows 9 and 10 a SM (132),
    as tests/test_torch_sense_grid.py plans with, at the grid route's
    largest shared memory and at 2 × 512²'s."""
    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index)
    if "H100" not in torch.cuda.get_device_name(dev) or limits != (132, 232_448):
        pytest.skip(f"the table is an H100's, not a {torch.cuda.get_device_name(dev)}'s")
    for module, entry, head, phases in (
            (sense, "sense_grid_occupancy", 0, len(sense.GRID_PHASES)),
            (sb, "splitbregman_grid_occupancy", sb.GRID_HEAD, len(sb.GRID_PHASES))):
        cap = sense.grid_plane_cap(512, 512, limits[1], head, phases)
        assert sense.grid_limits(entry, dev.index, 512, 512,
                                 sense.grid_smem_bytes(512, 512, cap, head, phases)) == (1, 132)
        x0 = torch.zeros(2, 2, 512, 512, device=dev)
        plan = module.plan_on_card(x0, 6)
        assert plan.route == "grid" and plan.ctas == 132 == plan.resident_clusters
        assert sense.grid_limits(entry, dev.index, 512, 512, plan.smem) == (1, 132)


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
    with pytest.raises(ValueError, match="from 2 to 1024, got 1025x8"):
        l1dft.fista_l1_dft_fused(torch.zeros(2, 1025, 8, device=dev),
                                 torch.ones(1025, 8, device=dev), 0.9, 0.1, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        sense.fista_l21_sense_fused(torch.zeros(2, 2, 16, 16, device=dev), mask, cr.cpu(), ci,
                                    0.9, 0.1, 2)
    # 24² (3 · 8 a side), which the power-of-two FFT refused, launches
    before = l1dft.fista_l1_dft_fused.launches
    l1dft.fista_l1_dft_fused(torch.zeros(2, 24, 24, device=dev), torch.ones(24, 24, device=dev),
                             0.9, 0.1, 2)
    assert l1dft.fista_l1_dft_fused.launches == before + 1


# The mixed-radix FFT (sides with odd factors: the odd stages of
# csrc/fft_mixed.cuh before the radix-2 ones) on each route of rows 8, 9
# and 10. Row 8: (B, H, W) → (route, CTAs a problem) as the planner takes
# them (tests/test_torch_dft_mixed_radix.py, test_torch_dft_plan.py); 320²
# only fits c = 16 evenly, 640² takes the grid route (2 slots of 66 CTAs),
# lines of the prime
# 1021 the resident one; 97 × 128 (a prime side), 225² (an odd side) and
# 300² (no power of two of a fitting size divides it) run on uneven bands
# and blocks (33, 32, 32 rows; 19 or 18 rows on 12; 19 or 18 on 16)
MIXED_L1DFT = {(3, 24, 40): ("resident", 1), (3, 17, 32): ("resident", 1),
               (3, 96, 192): ("resident", 4), (16, 320, 320): ("resident", 16),
               (16, 64, 448): ("resident", 4), (2, 640, 640): ("grid", 66),
               (2, 97, 128): ("resident", 3), (2, 1021, 3): ("resident", 1),
               (2, 3, 1021): ("resident", 1), (4, 225, 225): ("resident", 12),
               (2, 300, 300): ("resident", 16)}
# rows 9 and 10: (H, W, coils); 64 × 192 and the small ones resident, 192²
# split (teams of 3 CTAs a coil)
MIXED_SENSE = [(24, 40, 3), (17, 24, 2), (64, 192, 6), (192, 192, 6), (96, 12, 17)]


@pytest.mark.parametrize("size", list(MIXED_L1DFT))
def test_fista_l1_dft_mixed_radix_matches_plain(dev, size):
    """Bit for bit the plain version on the route the planner takes, by the
    route counter."""
    B, H, W = size
    mask, _, _, rng = _fft_inputs(dev, (H, W), C=1)
    x0 = torch.from_numpy(rng.normal(size=size).astype(np.float32)).to(dev)
    lam = torch.linspace(0.0, 0.1, B, device=dev)
    plan, active = l1dft.plan_on_card(x0)
    assert (plan.route, plan.clusters) == MIXED_L1DFT[size]
    assert active >= 1
    on_route = l1dft.fista_l1_dft_fused.route_launches[plan.route]
    got = l1dft.fista_l1_dft_fused(x0, mask, 0.9, lam, 7)
    assert l1dft.fista_l1_dft_fused.route_launches[plan.route] == on_route + 1
    scal = fused.problem_scalars(x0, 0.9, lam)
    tab = torch.as_tensor(fused._momentum_table("fista", 7), device=dev)
    want = l1dft.fista_l1_dft_fused_torch(x0, scal, tab, dft.dft_tables(mask))
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("size", [(16, 320, 320), (3, 96, 192), (2, 97, 128), (4, 225, 225)])
def test_fista_l1_dft_mixed_radix_repeats_bit_for_bit(dev, size):
    """20 launches (60 iterations), each equal to the first and to the plain
    version: a race between a cluster's CTAs (at even parts and at uneven
    ones: 97 × 128 on 3, 225² on 12), or between the threads of an odd
    stage's waves, would show as a launch that differs."""
    B, H, W = size
    mask, _, _, rng = _fft_inputs(dev, (H, W), C=1)
    x0 = torch.from_numpy(rng.normal(size=size).astype(np.float32)).to(dev)
    lam = torch.linspace(1e-3, 4e-3, B, device=dev)
    first = l1dft.fista_l1_dft_fused(x0, mask, 0.95, lam, 60)
    for _ in range(20):
        assert torch.equal(l1dft.fista_l1_dft_fused(x0, mask, 0.95, lam, 60), first)
    scal = fused.problem_scalars(x0, 0.95, lam)
    tab = torch.as_tensor(fused._momentum_table("fista", 60), device=dev)
    assert torch.equal(first, l1dft.fista_l1_dft_fused_torch(x0, scal, tab,
                                                             dft.dft_tables(mask)))


# forced cluster sizes of row 8, as the sweep of chip_smoke.py
# --time-fista-l1-dft runs them: uneven where the planner's plan is even
# (320² on 12, 24 × 40 on 3 and 16: bands of one and two rows), and other
# sizes at the uneven shapes
L1DFT_FORCED = [((2, 97, 128), 2), ((2, 97, 128), 5), ((2, 97, 128), 16), ((2, 320, 320), 12),
                ((2, 300, 300), 10), ((3, 24, 40), 3), ((3, 24, 40), 16), ((3, 17, 12), 7),
                ((2, 13, 24), 5)]


@pytest.mark.parametrize("size,c", L1DFT_FORCED)
def test_fista_l1_dft_forced_cluster_sizes_match_plain(dev, size, c):
    """Each forced size on the resident route, by the route counter, bit
    for bit the plain version; its phase timer leaves x as it was."""
    B, H, W = size
    mask, _, _, rng = _fft_inputs(dev, (H, W), C=1)
    x0 = torch.from_numpy(rng.normal(size=size).astype(np.float32)).to(dev)
    lam = torch.linspace(0.0, 0.1, B, device=dev)
    plan, active = l1dft.plan_on_card(x0, c)
    assert (plan.route, plan.clusters) == ("resident", c) and active >= 1
    on_route = l1dft.fista_l1_dft_fused.route_launches["resident"]
    got = l1dft.fista_l1_dft_fused(x0, mask, 0.9, lam, 7, clusters=c)
    assert l1dft.fista_l1_dft_fused.route_launches["resident"] == on_route + 1
    scal = fused.problem_scalars(x0, 0.9, lam)
    tab = torch.as_tensor(fused._momentum_table("fista", 7), device=dev)
    want = l1dft.fista_l1_dft_fused_torch(x0, scal, tab, dft.dft_tables(mask))
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())
    clocks = l1dft.phase_clocks(x0, mask, 0.9, lam, 7, clusters=c)
    assert all(v > 0 for v in clocks.values()), clocks
    assert torch.equal(l1dft.fista_l1_dft_fused(x0, mask, 0.9, lam, 7, clusters=c), want)


@pytest.mark.parametrize("H,W,coils", MIXED_SENSE)
def test_sense_mixed_radix_matches_plain(dev, H, W, coils):
    x0, mask, cr, ci, lam = _sense_inputs(dev, (H, W), coils)
    plan = sense.plan_on_card(x0, coils)
    assert plan.route == ("split" if (H, W) == (192, 192) else "resident")
    on_route = sense.fista_l21_sense_fused.route_launches[plan.route]
    got = sense.fista_l21_sense_fused(x0, mask, cr, ci, 0.9, lam, 9)
    assert sense.fista_l21_sense_fused.route_launches[plan.route] == on_route + 1
    want = _sense_plain(x0, mask, cr, ci, lam, 9)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


# sha256 of rows 9 and 10 on their split routes at _sense_inputs /
# _sb_inputs (6 coils; teams of 3 CTAs: 256 × 128 in uneven bands of 86,
# 85 and 85 rows, 192² in even ones), recorded on the tree before Split
# moved from csrc/sense_split.cuh to csrc/split.cuh, which row 8 now shares
# (an NVIDIA H100 80GB HBM3, 700.00 W): the move leaves their bits
SPLIT_PARENT_SHA256 = {
    ("sense", 256, 128): "b980c42ce358ee8651d7fb2355b8e44165dc067c4ec465e5d08a8eaf1d018456",
    ("splitbregman", 256, 128): "abcf0545c01f975ab30ed49f76d097a904f8f1cc88494f667ca6f8064d46298c",
    ("sense", 192, 192): "9954eea80bf89f6881a04c434abb66d6077f3632ccdcf2bd9115d9854dff34e5",
    ("splitbregman", 192, 192): "c18db9a200e99e697d41e9aba1abc37e02f9f7cf8131e66f4ef4ef899fa243e6",
}


@pytest.mark.parametrize("row,H,W", list(SPLIT_PARENT_SHA256))
def test_the_shared_split_leaves_rows_9_and_10_as_they_were(dev, row, H, W):
    """Rows 9 and 10 on the split route (12 iterations of row 9; row 10's
    2 × 3 × 6 schedule, TV 2), their outputs (and row 10's live CG steps)
    bit for bit those of the tree before the shared csrc/split.cuh."""
    import hashlib

    h = hashlib.sha256()
    if row == "sense":
        x0, mask, cr, ci, lam = _sense_inputs(dev, (H, W), 6)
        assert sense.plan_on_card(x0, 6).route == "split"
        outs = (sense.fista_l21_sense_fused(x0, mask, cr, ci, 0.9, lam, 12),)
    else:
        x0, mask, cr, ci, rho1 = _sb_inputs(dev, (H, W), 6)
        assert sb.plan_on_card(x0, 6).route == "split"
        got, counts = sb.splitbregman_l1_tv_fused(x0, mask, cr, ci, rho1, 0.02, 1e-3, 2e-3, 2, 3,
                                                  6, 2, 5e-2, with_counts=True)
        outs = (got, counts.int())
    for t in outs:
        h.update(t.contiguous().cpu().numpy().tobytes())
    assert h.hexdigest() == SPLIT_PARENT_SHA256[(row, H, W)]


@pytest.mark.parametrize("H,W,coils", [(64, 192, 6), (96, 12, 17), (192, 192, 6),
                                       (256, 128, 6)])
def test_sense_mixed_radix_repeats_bit_for_bit(dev, H, W, coils):
    """20 launches, each equal to the first and to the plain version, on
    the resident route and on the split one (192², 256 × 128): a race
    between a cluster's CTAs would show as a launch that differs."""
    x0, mask, cr, ci, lam = _sense_inputs(dev, (H, W), coils)
    args = (x0, mask, cr, ci, 0.9, lam, 12)
    first = sense.fista_l21_sense_fused(*args)
    for _ in range(20):
        assert torch.equal(sense.fista_l21_sense_fused(*args), first)
    assert torch.equal(first, _sense_plain(x0, mask, cr, ci, lam, 12))


@pytest.mark.parametrize("H,W,coils", MIXED_SENSE)
def test_splitbregman_mixed_radix_matches_plain(dev, H, W, coils):
    """Held as at powers of two: 1e-5 of max|x| (its CG sums are double sums
    in another order) with equal live CG steps."""
    x0, mask, cr, ci, rho1 = _sb_inputs(dev, (H, W), coils)
    plan = sb.plan_on_card(x0, coils)
    assert plan.route == ("split" if (H, W) == (192, 192) else "resident")
    sched = (2, 3, 4, 4, 1e-5)
    on_route = sb.splitbregman_l1_tv_fused.route_launches[plan.route]
    got, counts = sb.splitbregman_l1_tv_fused(x0, mask, cr, ci, rho1, 0.02, 1e-3, 2e-3, *sched,
                                              with_counts=True)
    assert sb.splitbregman_l1_tv_fused.route_launches[plan.route] == on_route + 1
    scal, t2 = sb.kernel_args(x0, rho1, 0.02, 1e-3, 2e-3, 4)
    want, want_counts = sb.splitbregman_l1_tv_fused_torch(
        x0, scal, t2, (cr, ci), dft.dft_tables(mask), *sched[:3], 1e-5)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("H,W,coils", [(64, 192, 6), (24, 40, 3), (192, 192, 6),
                                       (256, 128, 6)])
def test_splitbregman_mixed_radix_repeats_bit_for_bit(dev, H, W, coils):
    x0, mask, cr, ci, rho1 = _sb_inputs(dev, (H, W), coils)
    args = (x0, mask, cr, ci, rho1, 0.02, 1e-3, 2e-3, 2, 3, 6, 2, 5e-2)
    first, first_counts = sb.splitbregman_l1_tv_fused(*args, with_counts=True)
    for _ in range(20):
        got, counts = sb.splitbregman_l1_tv_fused(*args, with_counts=True)
        assert torch.equal(got, first) and torch.equal(counts, first_counts)


# forced split plans (team, coils a round), as the sweep of chip_smoke.py
# --time-sense runs them: 192² on even teams and on uneven ones (5, 8),
# and small shapes with odd factors on uneven teams, several rounds
SPLIT_FORCED = [((192, 192, 6), (3, 3)), ((192, 192, 6), (4, 3)), ((192, 192, 6), (3, 2)),
                ((192, 192, 6), (5, 3)), ((192, 192, 6), (8, 2)), ((192, 192, 6), (6, 1)),
                ((24, 40, 3), (5, 1)), ((17, 24, 3), (2, 2)), ((96, 12, 17), (5, 3))]


@pytest.mark.parametrize("case,split", SPLIT_FORCED)
def test_sense_forced_split_plans_match_plain(dev, case, split):
    """Each forced plan on the split route, by the route counter, bit for
    bit the plain version."""
    H, W, coils = case
    x0, mask, cr, ci, lam = _sense_inputs(dev, (H, W), coils)
    plan = sense.plan_on_card(x0, coils, split)
    assert (plan.route, plan.team, plan.clusters) == ("split", split[0], split[0] * split[1])
    on_route = sense.fista_l21_sense_fused.route_launches["split"]
    got = sense.fista_l21_sense_fused(x0, mask, cr, ci, 0.9, lam, 9, split=split)
    assert sense.fista_l21_sense_fused.route_launches["split"] == on_route + 1
    want = _sense_plain(x0, mask, cr, ci, lam, 9)
    torch.cuda.synchronize()
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("case,split", SPLIT_FORCED[::2])
def test_splitbregman_forced_split_plans_match_plain(dev, case, split):
    H, W, coils = case
    x0, mask, cr, ci, rho1 = _sb_inputs(dev, (H, W), coils)
    sched = (2, 3, 4, 4, 1e-5)
    got, counts = sb.splitbregman_l1_tv_fused(x0, mask, cr, ci, rho1, 0.02, 1e-3, 2e-3, *sched,
                                              with_counts=True, split=split)
    scal, t2 = sb.kernel_args(x0, rho1, 0.02, 1e-3, 2e-3, 4)
    want, want_counts = sb.splitbregman_l1_tv_fused_torch(
        x0, scal, t2, (cr, ci), dft.dft_tables(mask), *sched[:3], 1e-5)
    _close(got, want, 1e-5)
    assert counts.tolist() == want_counts.tolist()


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
        # the warp route's edges: a row back within the ring's window (S = 5
        # < 8 slots, reused), a row repeated in one list, a list of −1 only,
        # x in shared memory (real past 512 entries, complex past 256)
        "dense-revisit": (5, 40, 1, False, 6, True, "positive"),
        "dense-repeat": (20, 33, 1, False, 3, False, "none"),
        "dense-all-skip": (12, 20, 1, False, 2, True, "positive"),
        "dense-wide": (40, 600, 1, False, 2, True, "none"),
        "complex-wide": (30, 300, 2, False, 2, False, "real"),
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
    if case == "dense-repeat":
        order[:, 2] = order[:, 3] = order[:, 0]
    if case == "dense-all-skip":
        order[:] = -1
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


KZ_CASES = ["dense", "dense-n1", "dense-per-sweep", "complex", "complex-positive", "csr",
            "csr-kmax1", "csr-complex", "dense-revisit", "dense-repeat", "dense-all-skip",
            "dense-wide", "complex-wide"]


@pytest.mark.parametrize("case", KZ_CASES)
@pytest.mark.parametrize("route, groups", [(None, None), ("block", None), ("warp", 1),
                                           ("warp", 2), ("warp", 3)])
def test_kaczmarz_routes_match_plain(dev, case, route, groups):
    """Both routes, planned and forced (the warp route with 1, 2 and 3
    problems a CTA: a last CTA with fewer problems than the others), on
    every edge case; each launch counted on its route."""
    rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox = _kaczmarz_case(dev, case)
    want_route = route or kz.card_plan(rows, x0, cols).route
    before = dict(kz.kaczmarz_solve.route_launches)
    x, vl = kz._forced(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols, groups,
                       route)
    after = kz.kaczmarz_solve.route_launches
    assert after[want_route] == before[want_route] + 1
    wx, wvl = kz.kaczmarz_solve_torch(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox,
                                      cols)
    _close(x, wx, 1e-5)
    _close(vl, wvl, 1e-5)
    if case == "dense-all-skip":
        assert torch.equal(vl, vl0)


def _kaczmarz_tall(dev, csr=False, seed=15):
    """The tall cell's shapes (1024×256, 70 % zeros, batch 16, 20 sweeps of
    64 rows drawn without replacement, Positive), dense or padded CSR."""
    rng = np.random.default_rng(seed)
    m, n, P, T, S = 1024, 256, 16, 20, 64
    A = rng.normal(size=(m, n)).astype(np.float32)
    A[rng.uniform(size=A.shape) < 0.7] = 0.0
    cols = None
    if csr:
        op = rtt.PaddedCSROperator.from_dense(A, device="cpu")
        A, cols = op.vals.numpy(), op.cols.to(dev)
    idx = np.stack([rng.choice(m, size=S, replace=False) for _ in range(T)]).astype(np.int32)
    rn2 = (A.astype(np.float64) ** 2).sum(axis=1)
    eps = np.full(P, 1e-3)
    denom = 1.0 / (rn2[None] + eps[:, None] ** 2 + 1e-6)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return (t(A[None]), cols, torch.from_numpy(idx).to(dev), torch.zeros(P, 1, n, device=dev),
            torch.zeros(P, 1, m, device=dev), t(rng.normal(size=(P, 1, m))), t(denom), t(eps), T,
            False, "positive")


@pytest.mark.parametrize("csr", [False, True])
@pytest.mark.parametrize("route", [None, "warp", "block"])
def test_kaczmarz_tall_cell_routes_match_plain(dev, csr, route):
    ops = _kaczmarz_tall(dev, csr)
    rows, cols, idx, x0 = ops[0], ops[1], ops[2], ops[3]
    if route is None:
        assert kz.card_plan(rows, x0, cols).route == "warp"
    x, vl = kz._forced(*ops[:1], *ops[2:], cols=cols, route=route)
    wx, wvl = kz.kaczmarz_solve_torch(*ops[:1], *ops[2:], cols=cols)
    _close(x, wx, 1e-5)
    _close(vl, wvl, 1e-5)


@pytest.mark.parametrize("route, groups", [("warp", None), ("warp", 4), ("warp", 16),
                                           ("block", None)])
def test_kaczmarz_routes_repeat_bit_for_bit(dev, route, groups):
    """20 launches of each route at the tall cell give the same bits: a race
    on the ring's slots would show as a launch that differs."""
    ops = _kaczmarz_tall(dev)
    run = lambda: kz._forced(*ops[:1], *ops[2:], groups=groups, route=route)  # noqa: E731
    x0, vl0 = run()
    for _ in range(19):
        x, vl = run()
        assert torch.equal(x, x0) and torch.equal(vl, vl0)


def test_kaczmarz_phase_clocks(dev):
    ops = _kaczmarz_tall(dev)
    before = kz.kaczmarz_solve.route_launches["warp"]
    clocks = kz.phase_clocks(*ops[:1], *ops[2:])
    assert kz.kaczmarz_solve.route_launches["warp"] == before + 1
    assert set(clocks) == set(kz.WARP_PHASES)
    assert all(v > 0 for v in clocks.values()), clocks
    assert clocks["total"] >= sum(v for k, v in clocks.items() if k != "total")


def test_kaczmarz_warp_launch_refuses_a_wrong_plan(dev):
    """The C entry point recounts the shared memory and refuses a plan that
    disagrees, or x in registers past 32 entries a lane."""
    rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox = _kaczmarz_case(dev, "dense")
    plan = kz.card_plan(rows, x0)
    for bad in (dataclasses.replace(plan, smem=plan.smem + 16),
                dataclasses.replace(plan, x_lanes=1)):
        with pytest.raises(RuntimeError, match="kaczmarz_warp_launch"):
            kz._launch(kz.kaczmarz_solve, rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox,
                       None, bad)


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


# the greedy kernel's shapes: (m, n, P); 300 × 300 holds two rows of r a
# thread and x in shared memory on the resident route, 2048 × 256 eight rows
# and x in registers, 4096 × 300 sixteen rows (the most) and x in shared
# memory
GREEDY_SHAPES = [(45, 13, 3), (300, 300, 2), (2048, 256, 2), (4096, 300, 2)]


def _greedy_solve_args(dev, m=45, n=13, P=3, theta=None, forced=False, S=9, T=3,
                       prox="positive"):
    A, Gt, denom, norms, _, _, r, eps, fnorm = _greedy_inputs(dev, m, n, P)
    fr = None
    if forced:
        fr = torch.from_numpy(np.random.default_rng(15).integers(-1, m, size=(T, S))
                              .astype(np.int32)).to(dev)
    return (A, Gt, denom, norms, r, eps, fnorm, theta, S, T, 2024, prox, fr)


def _hold_greedy(got, want):
    """Rows equal; x, vl and r within 1e-5 of max|x| (of max|vl|, max|r|)."""
    assert torch.equal(got[3], want[3]), (got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("route", greedy.ROUTES)
@pytest.mark.parametrize("theta", [None, 0.3])
@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("shape", GREEDY_SHAPES)
def test_greedy_solve_matches_plain(dev, route, theta, forced, shape):
    """The whole solve (Positive and the refresh after each sweep) on each
    route against kaczmarz_greedy_solve_torch; the resident route launches
    once, the block route once a sweep."""
    args = _greedy_solve_args(dev, *shape, theta=theta, forced=forced)
    before = dict(greedy.kaczmarz_greedy_solve.route_launches)
    got = greedy._forced(*args, route=route)
    launches = 1 if route == "resident" else args[9]
    assert greedy.kaczmarz_greedy_solve.route_launches == {
        **before, route: before[route] + launches}
    _hold_greedy(got, greedy.kaczmarz_greedy_solve_torch(*args))


@pytest.mark.parametrize("route", greedy.ROUTES)
@pytest.mark.parametrize("theta", [None, 0.3])
@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("shape", GREEDY_SHAPES)
def test_greedy_sweep_routes_match_plain(dev, route, theta, forced, shape):
    """One sweep from a nonzero start on each route against
    kaczmarz_greedy_sweep_torch, the launch counted on its route."""
    A, Gt, denom, norms, x, vl, r, eps, fnorm = _greedy_inputs(dev, *shape)
    x, vl = x + 0.25, vl - 0.5
    S = 17
    fr = None
    if forced:
        fr = torch.from_numpy(np.random.default_rng(14).integers(-1, shape[0], size=S)
                              .astype(np.int32)).to(dev)
    args = (A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S, 2024, 5, fr)
    before = greedy.kaczmarz_greedy_sweep.route_launches[route]
    got = greedy._sweep(*args, route=route)
    assert greedy.kaczmarz_greedy_sweep.route_launches[route] == before + 1
    _hold_greedy(got, greedy.kaczmarz_greedy_sweep_torch(*args))


@pytest.mark.parametrize("route", greedy.ROUTES)
def test_greedy_ties_go_to_row_0_on_each_route(dev, route):
    A, Gt, denom, norms, x, vl, r, eps, fnorm = _greedy_inputs(dev)
    r = torch.zeros_like(r)
    rows = greedy._sweep(A, Gt, denom, norms, x, vl, r, eps, fnorm, None, 4, 1, 0,
                         route=route)[3]
    assert rows.tolist() == [[0] * 4] * 3
    rows = greedy._forced(A, Gt, denom, norms, r, eps, fnorm, None, 4, 2, 1, route=route)[3]
    assert rows.tolist() == [[[0] * 4] * 3] * 2


def _greedy_cell(dev, T):
    """The greedy cell's system (1024 × 256, 70 % zero, L2 λ = 1e-6), 16
    problems, 64 steps a sweep, Positive."""
    rng = np.random.default_rng(22)
    A = rng.normal(size=(1024, 256)).astype(np.float32)
    A[rng.uniform(size=A.shape) < 0.7] = 0.0
    op = rtt.DenseOperator(torch.from_numpy(A).to(dev), device=dev)
    s = rtt.Kaczmarz.create(op, reg=[rtt.L2Regularization(1e-6), rtt.PositiveRegularization()],
                            iterations=T, greedy_randomized=True, sub_matrix_fraction=0.0625)
    B = torch.from_numpy(A @ rng.uniform(size=(256, 16)).astype(np.float32)).to(dev)
    return s, B


@pytest.mark.parametrize("route", greedy.ROUTES)
def test_greedy_cell_shapes_match_plain(dev, route):
    """1024 × 256 × 16 with Positive, 4 sweeps of 64 steps, sampled."""
    s, B = _greedy_cell(dev, 4)
    A, Gt, denom, norms, eps, fnorm, bt = greedy.greedy_operands(s, B)
    args = (A, Gt, denom, norms, bt, eps, fnorm, None, 64, 4, s.seed, "positive", None)
    assert greedy.card_plan(16, 1024, 256, dev).route == "resident"
    _hold_greedy(greedy._forced(*args, route=route), greedy.kaczmarz_greedy_solve_torch(*args))


def test_greedy_solve_entry_point_is_one_launch(dev):
    """solve_kaczmarz_greedy at the cell's shapes: one launch of the solve on
    the resident route, none of the sweep."""
    s, B = _greedy_cell(dev, 3)
    before = (greedy.kaczmarz_greedy_solve.launches, greedy.kaczmarz_greedy_sweep.launches,
              greedy.kaczmarz_greedy_solve.route_launches["resident"])
    x = rtt.solve_kaczmarz_greedy(s, B)
    assert (greedy.kaczmarz_greedy_solve.launches, greedy.kaczmarz_greedy_sweep.launches,
            greedy.kaczmarz_greedy_solve.route_launches["resident"]) == (
        before[0] + 1, before[1], before[2] + 1)
    want = greedy.greedy_solve(s, B, solve=greedy.kaczmarz_greedy_solve_torch)[0]
    _close(x, want, 1e-5)


@pytest.mark.parametrize("what", ["sweep", "solve"])
def test_greedy_resident_route_repeats_bit_for_bit(dev, what):
    """20 launches at the cell's shapes (one sweep of 64 steps; a solve of 20
    sweeps), sampled: the same bits every time."""
    s, B = _greedy_cell(dev, 20)
    A, Gt, denom, norms, eps, fnorm, bt = greedy.greedy_operands(s, B)
    if what == "sweep":
        z = (torch.zeros(16, 256, device=dev), torch.zeros(16, 1024, device=dev), bt)
        run = lambda: greedy.kaczmarz_greedy_sweep(A, Gt, denom, norms, *z, eps, fnorm, None,  # noqa: E731
                                                   64, s.seed, 0)
    else:
        run = lambda: greedy.kaczmarz_greedy_solve(A, Gt, denom, norms, bt, eps, fnorm, None,  # noqa: E731
                                                   64, 20, s.seed, "positive")
    first = run()
    for _ in range(20):
        again = run()
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_greedy_phase_clocks(dev):
    """The resident route's timer, on a solve whose every step draws (a
    forced step waits on no noise slot): every phase read, their sum within
    the consumer's whole run; the launch counted."""
    args = _greedy_solve_args(dev, 300, 40, 2)
    before = greedy.kaczmarz_greedy_solve.route_launches["resident"]
    clocks = greedy.phase_clocks(*args)
    assert list(clocks) == list(greedy.PHASES)
    assert all(v > 0 for v in clocks.values()), clocks
    assert sum(v for k, v in clocks.items() if k != "total") <= clocks["total"]
    assert greedy.kaczmarz_greedy_solve.route_launches["resident"] == before + 1


def test_greedy_resident_route_registers_from_the_build(dev):
    """ptxas's account of every instantiation of the resident route (rows
    of r a thread × x placement × timer): each within the launch bound's
    168 registers a thread; no spill up to 4 rows a thread (m ≤ 1024, the
    cell's plan), nor at 8 without the timer. 16 rows (m ≤ 4096) spill, and
    PERF.md records how much."""
    from rls_tpu_torch import _build

    got = {}
    for name, v in _build.ptxas_report("kaczmarz_greedy.cu").items():
        m = re.search(r"kaczmarz_greedy_resident_kernelILi(\d+)ELb([01])ELb([01])E", name)
        if m:
            got[tuple(int(g) for g in m.groups())] = v
    assert sorted(got) == sorted((rows, xreg, prof) for rows in (1, 2, 4, 8, 16)
                                 for xreg in (0, 1) for prof in (0, 1))
    assert all(v["registers"] <= 65_536 // greedy.RESIDENT_THREADS // 8 * 8 for v in got.values())
    for (rows, _, prof), v in got.items():
        if rows <= 4 or (rows == 8 and not prof):
            assert v["spill_stores"] == v["spill_loads"] == 0, (rows, prof, v)


def test_greedy_entry_point_refuses_another_byte_count(dev):
    """The C entry point recounts the shared memory and refuses a plan whose
    count differs (nothing launched, nothing counted)."""
    args = _greedy_solve_args(dev)
    plan = greedy.card_plan(3, 45, 13, dev)
    before = greedy.kaczmarz_greedy_solve.launches
    for smem in (plan.smem + 16, plan.smem - 16):
        with pytest.raises(RuntimeError, match="kaczmarz_greedy_solve_launch"):
            greedy._forced(*args, plan=dataclasses.replace(plan, smem=smem))
    # more rows a thread than the kernel instantiates
    with pytest.raises(RuntimeError, match="kaczmarz_greedy_solve_launch"):
        greedy._forced(*args, plan=dataclasses.replace(plan, rows=2 * greedy.MAX_ROWS))
    assert greedy.kaczmarz_greedy_solve.launches == before


@pytest.mark.parametrize("route", greedy.ROUTES)
def test_greedy_solve_with_nothing_to_do_launches_nothing(dev, route):
    """No problems, no steps or no sweeps: no launch, nothing counted, and the
    start (x = 0, vl = 0, r = b) comes back."""
    A, Gt, denom, norms, r, eps, fnorm, theta, S, T, seed, prox, _ = _greedy_solve_args(dev)
    before = (greedy.kaczmarz_greedy_solve.launches,
              dict(greedy.kaczmarz_greedy_solve.route_launches))
    for P_, S_, T_ in ((0, S, T), (3, 0, T), (3, S, 0)):
        x, vl, rr, rows = greedy._forced(A, Gt, denom, norms, r[:P_], eps[:P_], fnorm, theta, S_,
                                         T_, seed, prox, route=route)
        assert rows.shape == (T_, P_, S_) and x.shape == (P_, 13)
        assert not x.any() and not vl.any() and torch.equal(rr, r[:P_])
    assert (greedy.kaczmarz_greedy_solve.launches,
            greedy.kaczmarz_greedy_solve.route_launches) == before


# --------------------------------------------------------------------------
# the composite, decorator, DAX and operator path (chip_smoke.py phase 11),
# at small sizes
# --------------------------------------------------------------------------


def _all_launches():
    return {fn.__name__: fn.launches for fn in (
        tv_fgp.prox_tv2d_fgp, fused.fista_tv_fused, tiled.fista_tv_tiled,
        admm_fused.admm_tv_fused, admm_tiled.admm_tv_tiled, cgnr.cgnr_fused,
        pgm_dense.pgm_dense_fused, pgm_dense.pgm_dense_fused_cplx, l1dft.fista_l1_dft_fused,
        sense.fista_l21_sense_fused, sb.splitbregman_l1_tv_fused, pdhg.pdhg_fused,
        kz.kaczmarz_sweep, kz.kaczmarz_solve, greedy.kaczmarz_greedy_solve,
        greedy.kaczmarz_greedy_sweep)}


def _launched(fn):
    """(fn's result, the launches it made by kernel, zeros left out)."""
    before = _all_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in _all_launches().items() if v != before[k]}


def _decorated_pairs(dev):
    """(name, decorated solver, its undecorated twin, B, the launches of one
    solve through solve_batched_fast): the factors are powers of two, so
    the float32 λ has the same bits."""
    rng = np.random.default_rng(21)
    A = torch.from_numpy((rng.normal(size=(96, 40)) / np.sqrt(96)).astype(np.float32)).to(dev)
    Bd = A @ torch.from_numpy(rng.normal(size=(40, 5)).astype(np.float32)).to(dev)
    op = rtt.DenseOperator(A, device=dev)
    sep = rtt.SeparableConvOperator.from_taps(*TAPS, (40, 48), device=dev)
    img = torch.from_numpy(rng.uniform(size=(3, 40 * 48)).astype(np.float32)).to(dev)
    Bs = sep.mv(img).T.contiguous()
    Ak = A.clone()
    Ak[torch.from_numpy(rng.uniform(size=(96, 40)) < 0.7).to(dev)] = 0.0
    Bk = Ak @ torch.from_numpy(np.abs(rng.normal(size=(40, 4))).astype(np.float32)).to(dev)
    opk = rtt.DenseOperator(Ak, device=dev)
    kzkw = dict(iterations=3, randomized=True, precompute_order=True, sub_matrix_fraction=0.25)
    tv = dict(shape=(40, 48), iterations_tv=4)
    return (
        ("cgnr", rtt.CGNR.create(op, reg=rtt.FixedScaledRegularization(
            rtt.L2Regularization(1e-3 / 4), 4.0), iterations=12),
         rtt.CGNR.create(op, reg=rtt.L2Regularization(1e-3), iterations=12), Bd,
         {"cgnr_fused": 1}),
        ("pdhg", rtt.PDHG.create(sep, reg=rtt.FixedScaledRegularization(
            rtt.TVRegularization(2 * 4e-3, **tv), 0.5), iterations=20, tau=0.2),
         rtt.PDHG.create(sep, reg=rtt.TVRegularization(4e-3, **tv), iterations=20, tau=0.2), Bs,
         {"pdhg_fused": 1}),
        ("kaczmarz", rtt.Kaczmarz.create(opk, reg=[
            rtt.FixedParameterRegularization(rtt.L2Regularization(1e-6)),
            rtt.PositiveRegularization()], **kzkw),
         rtt.Kaczmarz.create(opk, reg=[rtt.L2Regularization(1e-6), rtt.PositiveRegularization()],
                             **kzkw), Bk, {"kaczmarz_solve": 1}),
    )


@pytest.mark.parametrize("case", ["cgnr", "pdhg", "kaczmarz"])
def test_decorated_term_reaches_its_kernel_bit_for_bit(dev, case):
    """A decorated term that the JAX dispatch reads through sink / get_lam
    runs its kernel once and gives its undecorated twin's bits."""
    name, dec, twin, B, want = next(c for c in _decorated_pairs(dev) if c[0] == case)
    got, launched = _launched(lambda: rtt.solve_batched_fast(dec, B))
    assert launched == want
    ref, launched = _launched(lambda: rtt.solve_batched_fast(twin, B))
    assert launched == want
    assert torch.equal(got, ref)


def test_decorated_tv_falls_back_to_the_composed_solve(dev):
    """FISTA with a decorated TV: row 2 rejects it (its check asks for the
    TV type, as the JAX one does), so solve_batched_fast warns, falls back,
    runs one TV prox launch an iteration, and gives the undecorated
    composed solve's bits."""
    sep = rtt.SeparableConvOperator.from_taps(*TAPS, (40, 48), device=dev)
    B = sep.mv(torch.rand((3, 40 * 48), device=dev)).T.contiguous()
    tv = rtt.TVRegularization(2e-3, shape=(40, 48), iterations_tv=4, backend="cuda")
    kw = dict(iterations=7, rho=0.9, track_residual=False)
    dec = rtt.FISTA.create(sep, reg=rtt.FixedScaledRegularization(tv, 1.0), **kw)
    twin = rtt.FISTA.create(sep, reg=tv, **kw)
    with pytest.warns(UserWarning, match="falling back"):
        got, launched = _launched(lambda: rtt.solve_batched_fast(dec, B))
    assert launched == {"prox_tv2d_fgp": 7}
    ref, launched = _launched(lambda: rtt.solve_batched_unrolled(twin, B))
    assert launched == {"prox_tv2d_fgp": 7}
    assert torch.equal(got, ref)


def _operators_on(device):
    rng = np.random.default_rng(22)
    n = 16
    w = rng.uniform(0.5, 1.5, size=24).astype(np.float32)
    A = rng.normal(size=(24, 10)).astype(np.float32)
    maps = (rng.normal(size=(2, n * n)) + 1j * rng.normal(size=(2, n * n))).astype(np.complex64)
    idx = np.sort(rng.choice(n * n, size=100, replace=False))
    coils = [rtt.SamplingOperator(idx, n * n, device=device)
             @ rtt.FFTOperator((n, n), device=device)
             @ rtt.WeightingOperator(m, device=device) for m in maps]
    kern = rng.normal(size=(5, 4)).astype(np.float32)
    conv = rtt.DirectConvOperator(kern, (n, n), device=device)
    return {
        "weighted": (rtt.WeightingOperator(w, device=device)
                     @ rtt.DenseOperator(A, device=device), "float32"),
        "stacked_sense": (rtt.StackedOperator(coils), "complex64"),
        "direct_conv": (conv, "float32"),
        "wavelet": (rtt.WaveletOperator((n, n), "db2", device=device), "complex64"),
        "function": (rtt.FunctionOperator(conv.mv, n=n * n, m=n * n, device=device), "float32"),
        "radon": (rtt.RadonOperator(np.linspace(0, np.pi, 12, endpoint=False), (n, n),
                                    device=device), "float32"),
    }


@pytest.mark.parametrize("name", ["weighted", "stacked_sense", "direct_conv", "wavelet",
                                  "function", "radon"])
def test_new_operators_on_the_card_hold_their_cpu_results(dev, name):
    """Each new operator built on the card: mv, rmv and normal of a batch
    against the same operator on the CPU (1e-5 of max|x|; the Radon
    backprojection scatters with atomics, so its sums run in any order)."""
    gpu, dt = _operators_on(dev)[name]
    cpu, _ = _operators_on("cpu")[name]
    assert gpu.device.type == "cuda"
    rng = np.random.default_rng(23)

    def draw(k):
        v = rng.normal(size=(3, k))
        if dt == "complex64":
            v = v + 1j * rng.normal(size=(3, k))
        return torch.from_numpy(v.astype(dt))

    X, Y = draw(gpu.in_size), draw(gpu.out_size)
    for meth, V in (("mv", X), ("rmv", Y), ("normal", X)):
        _close(getattr(gpu, meth)(V.to(dev)).cpu(), getattr(cpu, meth)(V), 1e-5)


def test_dax_on_the_card_holds_its_cpu_result(dev):
    """DaxKaczmarz (rows forced to one sequence) and DaxConstrained on the
    card against the same solves on the CPU, in float64 (1e-10 relative)."""
    rng = np.random.default_rng(24)
    A = rng.normal(size=(40, 12))
    A[rng.uniform(size=A.shape) < 0.7] = 0.0
    A[:, 0] = rng.normal(size=40)
    B = A @ np.abs(rng.normal(size=(12, 4)))
    w = rng.uniform(0.5, 1.5, size=40)
    out = {}
    for device in ("cpu", dev):
        op = rtt.DenseOperator(A, device=device)
        sk = rtt.DaxKaczmarz.create(op, lam=1e-6, weights=w, enforce_real=True,
                                    enforce_positive=True)
        gen = torch.Generator().manual_seed(0)
        rows = torch.stack([rtt.models.solvers.dax.draw_rows(sk.probs.cpu(), 80, gen)
                            for _ in range(sk.iterations)])
        sk = dataclasses.replace(sk, _forced_rows=rows)
        sc = rtt.DaxConstrained.create(op, lam=1e-6, weights=w)
        Bt = torch.from_numpy(B).to(device)
        out[str(device)] = [rtt.solve_batched_fast(s, Bt, warn=False).cpu() for s in (sk, sc)]
    for got, want in zip(out[str(dev)], out["cpu"]):
        _close(got, want, 1e-10)
    assert float(out[str(dev)][1].min()) >= -1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,axis", [((3, 1), 1), ((3, 2), 1), ((2, 37, 45), 1),
                                        ((2, 37, 45), 2), ((5, 1, 3000), 2), ((4, 33), 0)])
def test_condat_kernel_bit_for_bit(dev, dtype, shape, axis):
    """The exact 1-D TV kernel against its plain version, bit for bit: lines
    of 1, 2, 37, 45 and 3,000 entries, along a strided and the contiguous
    axis, one λ per problem (one of them 0, one flattening), one launch."""
    from rls_tpu_torch.kernels import tv_condat

    rng = np.random.default_rng(60)
    x = torch.from_numpy(rng.normal(size=shape)).to(dev, dtype)
    lam = torch.from_numpy(rng.uniform(0.0, 1.0, size=shape[:1])).to(dev, dtype)
    lam[0] = 0.0
    if shape[0] > 2:
        lam[-1] = 1e3
    if axis == 0:
        lam = lam[0]
    before = tv_condat.prox_tv1d_condat.launches
    got = tv_condat.prox_tv1d_condat(x, lam, axis)
    torch.cuda.synchronize()
    assert tv_condat.prox_tv1d_condat.launches == before + 1
    want = tv_condat.prox_tv1d_condat_torch(x, lam, axis)
    assert torch.equal(got, want), float((got - want).abs().max())
    cpu = tv_condat.prox_tv1d_condat_torch(x.cpu(), lam.cpu(), axis)
    assert torch.equal(got.cpu(), cpu)


def test_condat_kernel_refuses_what_it_does_not_take(dev):
    from rls_tpu_torch.kernels import tv_condat

    with pytest.raises(ValueError, match="takes real data"):
        tv_condat.prox_tv1d_condat(torch.zeros(2, 8, dtype=torch.complex64, device=dev), 0.1, 1)
    with pytest.raises(ValueError, match="float32 or float64"):
        tv_condat.prox_tv1d_condat(torch.zeros(2, 8, dtype=torch.float16, device=dev), 0.1, 1)


def _condat_lines(kind, N, dtype, dev, lines=6, seed=0):
    """Seeded adversarial lines (lines, N) for the Condat kernel and their
    λs: noise at λ from 0 to huge, constant lines, ramps, alternating ±1,
    and piecewise-constant lines plus noise (chip_smoke.py's long signals'
    recipe)."""
    rng = np.random.default_rng(seed + N)
    lam = np.array([0.0, 1e-6, 0.05, 0.3, 2.0, 1e4] * (lines // 6 + 1))[:lines]
    if kind == "noise":
        x = rng.normal(size=(lines, N))
    elif kind == "constant":
        x = np.repeat(rng.normal(size=(lines, 1)), N, axis=1)
    elif kind == "ramp":
        x = np.arange(N)[None, :] * rng.normal(size=(lines, 1))
    elif kind == "alternating":
        x = np.tile(np.where(np.arange(N) % 2 == 0, 1.0, -1.0), (lines, 1))
        lam = np.array([0.0, 1e-6, 0.5, 0.999, 1.0, 1e4] * (lines // 6 + 1))[:lines]
    else:
        jumps = rng.uniform(size=(lines, N)) < 2e-3
        x = np.cumsum(rng.normal(size=(lines, N)) * jumps, axis=1)
        x = x + 0.1 * rng.normal(size=(lines, N))
        lam = rng.uniform(0.05, 0.5, size=lines)
    return (torch.from_numpy(x).to(dev, dtype), torch.from_numpy(lam).to(dev, dtype))


CONDAT_KINDS = ("noise", "constant", "ramp", "alternating", "phantom")


def _condat_forced(x, lam, axis, route, chunk=None, lines_per_cta=None):
    """One call on a forced plan, counted once on its route."""
    from rls_tpu_torch.kernels import tv_condat

    before = dict(tv_condat.prox_tv1d_condat.route_launches)
    got = tv_condat._prox(x, lam, axis, route=route, chunk=chunk, lines_per_cta=lines_per_cta)
    torch.cuda.synchronize()
    after = tv_condat.prox_tv1d_condat.route_launches
    assert after[route] == before[route] + 1 and sum(after.values()) == sum(before.values()) + 1
    return got


@pytest.mark.parametrize("route", ["resident", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,axis", [((3, 1), 1), ((3, 2), 1), ((2, 37, 45), 1),
                                        ((2, 37, 45), 2), ((5, 1, 3000), 2), ((4, 33), 0)])
def test_condat_routes_bit_for_bit(dev, route, dtype, shape, axis):
    """Each route forced at test_condat_kernel_bit_for_bit's shapes, at
    chunks of 1, 16 and longer than the line: bit for bit the plain
    version."""
    from rls_tpu_torch.kernels import tv_condat

    rng = np.random.default_rng(60)
    x = torch.from_numpy(rng.normal(size=shape)).to(dev, dtype)
    lam = torch.from_numpy(rng.uniform(0.0, 1.0, size=shape[:1])).to(dev, dtype)
    lam[0] = 0.0
    if axis == 0:
        lam = lam[0]
    want = tv_condat.prox_tv1d_condat_torch(x, lam, axis)
    for chunk in (1, 16, shape[axis] + 3):
        if route == "resident" and -(-shape[axis] // chunk) > 512:
            continue
        got = _condat_forced(x, lam, axis, route, chunk)
        assert torch.equal(got, want), (chunk, float((got - want).abs().max()))


@pytest.mark.parametrize("route", ["resident", "global"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", CONDAT_KINDS)
@pytest.mark.parametrize("N", [1, 2, 3, 16, 17, 33, 256])
def test_condat_adversarial_lines_bit_for_bit(dev, route, dtype, kind, N):
    """λ = 0, tiny and huge (one segment a line: no restart, the sequential
    worst case), constant lines, ramps, alternating ±1 and piecewise-constant
    lines, N = 1, 2, 3 and one more than a chunk, on each route forced at
    chunks of 1, 2 and 16: bit for bit the plain version."""
    from rls_tpu_torch.kernels import tv_condat

    x, lam = _condat_lines(kind, N, dtype, dev, lines=12)
    want = tv_condat.prox_tv1d_condat_torch(x, lam, 1)
    for chunk in (1, 2, 16):
        got = _condat_forced(x, lam, 1, route, chunk)
        assert torch.equal(got, want), (chunk, float((got - want).abs().max()))


def test_condat_long_lines(dev):
    """Long piecewise-constant lines: 4 of 8,192 on the global route (chunks
    of 32) and the resident route (chunks of 64, one line a CTA) against the
    plain version on the CPU, bit for bit; 16 of 65,536 (the planner's
    global route) against one walker a line (the sequential walk)."""
    from rls_tpu_torch.kernels import tv_condat

    x, lam = _condat_lines("phantom", 8192, torch.float32, dev, lines=4)
    want = tv_condat.prox_tv1d_condat_torch(x.cpu(), lam.cpu(), 1)
    assert torch.equal(_condat_forced(x, lam, 1, "global", 32).cpu(), want)
    assert torch.equal(_condat_forced(x, lam, 1, "resident", 64, 1).cpu(), want)
    x, lam = _condat_lines("phantom", 65536, torch.float32, dev, lines=16, seed=1)
    assert tv_condat.card_plan(16, 65536, torch.float32, x.device).route == "global"
    got = tv_condat.prox_tv1d_condat(x, lam, 1)
    assert torch.equal(got, _condat_forced(x, lam, 1, "global", 65536))


def test_condat_repeats_bit_for_bit(dev):
    """20 calls at the main path's shape (16 × 256² along axis 2, 4,096 lines
    of 256 on the resident route) and at 16 lines of 65,536 (global): the
    same bits every time, and the plain version's at the main shape."""
    from rls_tpu_torch.kernels import tv_condat

    x, lam = _condat_lines("phantom", 256, torch.float32, dev, lines=4096)
    x = x.reshape(16, 256, 256)
    lam = lam.reshape(16, 256)[:, 0].contiguous()
    first = tv_condat.prox_tv1d_condat(x, lam, 2)
    assert torch.equal(first, tv_condat.prox_tv1d_condat_torch(x, lam, 2))
    y, mu = _condat_lines("phantom", 65536, torch.float32, dev, lines=16)
    first_long = tv_condat.prox_tv1d_condat(y, mu, 1)
    for _ in range(20):
        assert torch.equal(tv_condat.prox_tv1d_condat(x, lam, 2), first)
        assert torch.equal(tv_condat.prox_tv1d_condat(y, mu, 1), first_long)


def test_condat_phase_timer_and_counts(dev):
    """The resident route's timer gives CTA 0's clocks by phase, each
    positive, their sum within the total; the run's counts cover every
    walker (stitched, long or done) at the main shape, with stitch
    distances of at most the line."""
    from rls_tpu_torch.kernels import tv_condat

    x, lam = _condat_lines("phantom", 256, torch.float32, dev, lines=4096)
    clocks = tv_condat.phase_clocks(x, lam, 1)
    assert tuple(clocks) == tv_condat.PHASES
    parts = [clocks[p] for p in tv_condat.PHASES[:-1]]
    assert all(c > 0 for c in parts) and sum(parts) <= clocks["total"], clocks
    plan = tv_condat.card_plan(4096, 256, torch.float32, x.device)
    for route in ("resident", "global"):
        counts = tv_condat.walk_counts(x, lam, 1, route=route, chunk=plan.chunk)
        assert counts["stitched"] + counts["long"] + counts["done"] == 4096 * plan.walkers, counts
        assert 0 <= counts["stitch distance max"] < 256, counts
        assert counts["stitched"] > 0.5 * 4096 * plan.walkers, counts


def test_condat_sizes_match_the_planner(dev):
    """The kernel's own counts of a walker, of two resident CTAs' shared
    memory and of a global route's scratch are the planner's."""
    import ctypes

    from rls_tpu_torch import _build
    from rls_tpu_torch.kernels import tv_condat

    out = (ctypes.c_longlong * 5)()
    assert _build.load_library().tv_condat_sizes(out) == 0
    assert list(out) == [tv_condat.WALKER_BYTES[4], tv_condat.WALKER_BYTES[8],
                         tv_condat.resident_smem_bytes(32, 256, 8, 4),
                         tv_condat.resident_smem_bytes(32, 256, 8, 8),
                         tv_condat.global_scratch_bytes(16, 65536, 2048, 4)]


def test_condat_registers_from_the_build(dev):
    """ptxas's account of csrc/tv_condat.cu: both routes' kernels in float
    and double, within 128 registers (512 threads a resident CTA; 4 blocks
    of 128 an SM on the global route), the global route's six phases each a
    kernel of its own, with no spills."""
    from rls_tpu_torch import _build

    report = _build.ptxas_report("tv_condat.cu")
    kernels = {k: v for k, v in report.items() if "tv_condat_" in k}
    assert len(kernels) == 2 + 2 * 6, sorted(report)
    for name, v in kernels.items():
        assert v["registers"] <= 128, (name, v)
        assert v["spill_stores"] == 0 and v["spill_loads"] == 0, (name, v)


def test_tv_integer_dims_solve_on_the_card_holds_its_cpu_result(dev):
    """FISTA with TV(dims=0) through solve_batched_fast's composed fallback on
    the card: one Condat launch an iteration, the CPU solve's result to
    1e-5 of max|x| (the blur's products sum in another order)."""
    from rls_tpu_torch.kernels import tv_condat

    B_np = np.random.default_rng(61).normal(size=(24 * 20, 3)).astype(np.float32)
    out = {}
    for device in ("cpu", dev):
        op = rtt.SeparableConvOperator.from_taps(*TAPS, (24, 20), device=device)
        s = rtt.FISTA.create(op, reg=rtt.TVRegularization(0.05, shape=(24, 20), dims=0),
                             rho=0.5, iterations=6)
        before = tv_condat.prox_tv1d_condat.launches
        out[str(device)] = rtt.solve_batched_fast(s, torch.from_numpy(B_np).to(device),
                                                  warn=False).cpu()
        assert tv_condat.prox_tv1d_condat.launches - before == (0 if device == "cpu" else 6)
    _close(out[str(dev)], out["cpu"], 1e-5)


def test_regularizers_of_the_last_slice_on_the_card(dev):
    """Nuclear (tall and wide), LLR (complex, randshift) and PnP on the card
    against the CPU, to 1e-5 of max|x| (cuSOLVER's gesvda SVD; cuDNN's
    convolution without TF32)."""
    from rls_tpu_torch.models import denoisers

    rng = np.random.default_rng(62)
    X = torch.from_numpy(rng.normal(size=(3, 96)).astype(np.float32))
    Z = torch.from_numpy((rng.normal(size=(2, 256)) + 1j * rng.normal(size=(2, 256)))
                         .astype(np.complex64))
    for reg, V in (
        (rtt.NuclearRegularization(0.5, svt_shape=(12, 8)), X),
        (rtt.NuclearRegularization(0.5, svt_shape=(8, 12)), X),  # wide: gesvda transposed
        (rtt.LLRRegularization(0.3, shape=(8, 8), block_size=(4, 4)), Z),
    ):
        _close(reg.prox(V.to(dev)).cpu(), reg.prox(V), 1e-5)
        _close(reg.value(V.to(dev)).cpu(), reg.value(V), 1e-5)
    params = denoisers.init_cnn_params(torch.Generator().manual_seed(0), channels=4,
                                       device="cpu")
    img = torch.from_numpy(rng.uniform(size=(2, 256)).astype(np.float32))
    out = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for device in ("cpu", dev):
            model = denoisers.make_pnp_model({k: v.to(device) for k, v in params.items()})
            reg = rtt.PnPRegularization(0.4, model=model, shape=(16, 16))
            out[str(device)] = reg.prox(img.to(device)).cpu()
    _close(out[str(dev)], out["cpu"], 1e-5)


def _sharded_cases(dev):
    """The five fused wrappers of rtt.parallel with small problems of their
    kernels: (sharded wrapper, unsharded wrapper, kernel wrapper, solver, B)."""
    from rls_tpu_torch import parallel

    rng = np.random.default_rng(63)
    op = rtt.SeparableConvOperator.from_taps(*TAPS, (24, 20), device=dev)
    imgs = torch.from_numpy(rng.normal(size=(8, 480)).astype(np.float32)).to(dev)
    B_img = op.mv(imgs).T.contiguous()
    A = torch.from_numpy((rng.normal(size=(48, 24)) / 7).astype(np.float32)).to(dev)
    B_d = (A @ torch.from_numpy(rng.normal(size=(24, 8)).astype(np.float32)).to(dev)).contiguous()
    dense = rtt.DenseOperator(A, device=dev)
    tv = rtt.TVRegularization(1e-3, shape=(24, 20), iterations_tv=3)
    return (
        (parallel.solve_fista_tv_fused_sharded, rtt.solve_pgm_tv_fused, fused.fista_tv_fused,
         rtt.FISTA.create(op, reg=tv, iterations=5, rho=0.9, rel_tol=0.0,
                          track_residual=False), B_img),
        (parallel.solve_admm_tv_fused_sharded, rtt.solve_admm_tv_fused, admm_fused.admm_tv_fused,
         rtt.ADMM.create(op, reg=tv, iterations=3, iterations_cg=3, unroll_cg=True, rho=0.1),
         B_img),
        (parallel.solve_cgnr_fused_sharded, rtt.solve_cgnr_fused, cgnr.cgnr_fused,
         rtt.CGNR.create(dense, reg=rtt.L2Regularization(1e-3), iterations=10), B_d),
        (parallel.solve_pgm_dense_fused_sharded, rtt.solve_pgm_dense_fused,
         pgm_dense.pgm_dense_fused,
         rtt.FISTA.create(dense, reg=rtt.L1Regularization(1e-3), iterations=8, rho=0.1,
                          track_residual=False), B_d),
        (parallel.solve_pdhg_fused_sharded, rtt.solve_pdhg_fused, pdhg.pdhg_fused,
         rtt.PDHG.create(op, reg=rtt.TVRegularization(1e-3, shape=(24, 20)), iterations=5),
         B_img),
    )


@pytest.mark.parametrize("case", range(5), ids=["fista_tv", "admm_tv", "cgnr", "pgm_dense",
                                                 "pdhg"])
def test_parallel_fused_shards_on_the_card(dev, case):
    """rtt.parallel's fused wrappers on a mesh naming the card twice: the
    kernel launches once per shard (in turn on the card's stream), and the
    result is the unsharded call's, bit for bit (per-problem work does not
    depend on the batch at these shapes)."""
    from rls_tpu_torch import parallel

    sharded, whole, kernel, solver, B = _sharded_cases(dev)[case]
    mesh = parallel.make_mesh(devices=[dev, dev])
    before = kernel.launches
    got = sharded(solver, B, mesh)
    assert kernel.launches - before == 2
    assert got.device == dev and torch.equal(got, whole(solver, B))


def test_parallel_composed_and_row_sharded_on_the_card(dev):
    """solve_batched_sharded (FISTA-L1, two shards on the card) equals the
    unsharded solve to 1e-5 of max|x|; a CGNR on the rows of A in two blocks
    on the card holds the dense CGNR to 1e-5 of max|x|, and
    solve_batched_fast takes the composed path with the dense check's
    reason."""
    import warnings

    from rls_tpu_torch import parallel

    rng = np.random.default_rng(64)
    A = torch.from_numpy((rng.normal(size=(64, 24)) / 8).astype(np.float32)).to(dev)
    B = (A @ torch.from_numpy(rng.normal(size=(24, 6)).astype(np.float32)).to(dev)).contiguous()
    mesh = parallel.make_mesh(devices=[dev, dev])
    s = rtt.FISTA.create(rtt.DenseOperator(A, device=dev), reg=rtt.L1Regularization(1e-4),
                         iterations=30)
    _close(parallel.solve_batched_sharded(s, B, mesh).cpu(), rtt.solve_batched(s, B).cpu(), 1e-5)
    rows = parallel.make_mesh(axis_names=("rows",), devices=[dev, dev])
    op = parallel.row_sharded_operator(A, rows, axis="rows")
    cg = rtt.CGNR.create(op, reg=rtt.L2Regularization(1e-3), iterations=24)
    want = rtt.solve_batched(rtt.CGNR.create(rtt.DenseOperator(A, device=dev),
                                             reg=rtt.L2Regularization(1e-3), iterations=24), B)
    _close(rtt.solve_batched(cg, B).cpu(), want.cpu(), 1e-5)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _close(rtt.solve_batched_fast(cg, B).cpu(), want.cpu(), 1e-5)
    assert any("requires a dense operator A" in str(w.message) for w in caught)
