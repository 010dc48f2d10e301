"""Row 5's planner (rls_tpu_torch/kernels/admm_tv_tiled.py
``plan_admm_tv_tiled``) and a Python model of its cluster route, on the
CPU.

The planner: which route, cluster size and plane placement a shape takes
on an H100 (132 SMs, 232,448 bytes of shared memory per block): 512² on a
cluster of 16 with three planes of a band in shared memory, 384² on a
cluster of 16 with all five (row 4's placement), 1024² and a caller's
`tile_rows` on row tiles; that every cluster plan covers H with its bands
and fits the card, that the shared-memory count is the kernel's, and that
a shape without a route raises and names itself.

The model: the ADMM-TV solve band by band in float64 on the three-plane
placement's homes (S0–S2 in shared memory, q in S0 after the Gram's row
pass, t3, xg's own-pixel copy, pv and ph in global memory, p left in S1 by
the last dual iteration), the
schedule of csrc/admm_tv_cluster.cuh (``resident_admm`` of
tests/test_torch_admm_plan.py, which runs the five-plane placement there).
It is held against ``admm_tv_fused_torch`` with equal live CG steps, equal
to the five-plane placement, and raises where any barrier of the header's
table is dropped. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rls_tpu_torch.kernels import _fgp_common
from rls_tpu_torch.kernels import admm_tv_fused as admm
from rls_tpu_torch.kernels import admm_tv_tiled as tiled
from rls_tpu_torch.kernels._bands import MIN_CTA_PIXELS

from test_torch_admm_plan import (BARRIERS, G5, H100_RESIDENT, TAPS63, Hazard, _problem,
                                  _resident, resident_admm)

CSRC = Path(tiled.__file__).parents[1] / "csrc"
SMS, SMEM = 132, 232_448
MILD3 = (0.3, 0.6, 0.1)


def _plan(B, H, W, kh=9, kw=9, resident=H100_RESIDENT, **kw_):
    return tiled.plan_admm_tv_tiled(B, H, W, kh, kw, resident, **kw_)


def _covers(plan, B, H, W, sms=SMS, smem=SMEM):
    """A cluster plan's bands cover H with none empty; it fits the card."""
    assert plan.route == "cluster"
    c, rows = plan.clusters, plan.rows
    assert 1 <= c <= min(admm.MAX_CLUSTER, sms)
    assert (c - 1) * rows < H <= c * rows
    assert all(plan.band_rows(q) >= 1 for q in range(c))
    assert sum(plan.band_rows(q) for q in range(c)) == H
    assert plan.ctas == B * c
    shared = plan.own == "shared"
    assert plan.smem == admm.cluster_smem_bytes(rows, W, shared) <= smem
    assert plan.scratch == (admm.RESIDENT_SCRATCH if shared else admm.THREE_PLANE_SCRATCH)


def test_the_512_cell_takes_a_cluster_of_16_with_three_planes():
    """16 × 512² (admm_tv_512_tiled_b16): three planes of 32 rows (196,608
    bytes) fit c = 14 … 16, five fit no band; c = 16 has the fewest waves ×
    rows (3 waves of 32 rows, against 3 of 35 and 37): 198,784 bytes a CTA,
    7 clusters at once on an H100."""
    assert tiled.fitting_sizes(512, 512) == (14, 15, 16)
    assert tiled.own_shared_sizes(512, 512) == ()
    plan = _plan(16, 512, 512)
    _covers(plan, 16, 512, 512)
    assert (plan.route, plan.clusters, plan.rows, plan.ctas, plan.smem, plan.own) == (
        "cluster", 16, 32, 256, 198_784, "global")
    assert plan.smem == 3 * 4 * 32 * 512 + 8 * (96 + 12) + 8 * 7 + 8 * 94 + 504
    assert admm.cluster_smem_bytes(32, 512) > SMEM  # five planes: 320 KiB
    assert dict(H100_RESIDENT)[16] == 7


def test_the_1024_cell_walks_row_tiles():
    """8 × 1024²: a band of 64 rows of 4 KiB per plane fits not even three
    planes at c = 16: the tiles route, 64-row tiles (16 per problem, 128
    CTAs on 132 SMs), its 9 global planes."""
    assert tiled.fitting_sizes(1024, 1024) == ()
    plan = _plan(8, 1024, 1024)
    assert (plan.route, plan.clusters, plan.rows, plan.ctas) == ("tiles", 16, 64, 128)
    assert (plan.smem, plan.scratch) == (tiled.GLOBAL_SMEM, tiled.TILE_SCRATCH)


@pytest.mark.parametrize("tile_rows", [6, 64, 100, 512])
def test_tile_rows_forces_the_tiles_route(tile_rows):
    """A caller's tile_rows keeps its meaning (and lets the timing mode run
    the parent's kernel): row tiles at any shape."""
    plan = _plan(16, 512, 512, tile_rows=tile_rows)
    tiles = -(-512 // tile_rows)
    assert (plan.route, plan.clusters, plan.rows, plan.ctas) == ("tiles", tiles, tile_rows,
                                                                 16 * tiles)


@pytest.mark.parametrize("n,c,rows,own", [
    # five planes fit a band up to 416² (c = 16: 26 rows, 218,448 bytes):
    # row 4's placement and the plan row 4's planner takes (256²: one wave
    # of clusters of 6); 430² fits three only
    (256, 6, 43, "shared"), (384, 16, 24, "shared"), (416, 16, 26, "shared"),
    (430, 16, 27, "global"), (512, 16, 32, "global")])
def test_small_images_keep_five_planes(n, c, rows, own):
    plan = _plan(16, n, n)
    _covers(plan, 16, n, n)
    assert (plan.clusters, plan.rows, plan.own) == (c, rows, own)
    if own == "shared":
        row4 = admm.plan_admm_tv(16, n, n, 9, 9, H100_RESIDENT)
        assert (row4.clusters, row4.rows, row4.smem) == (plan.clusters, plan.rows, plan.smem)
    assert (c in tiled.own_shared_sizes(n, n)) == (own == "shared")


@pytest.mark.parametrize("B", [1, 4, 16, 64])
@pytest.mark.parametrize("H,W", [(256, 256), (384, 384), (500, 520), (512, 512), (640, 480),
                                 (1000, 60), (33, 700), (2, 10000), (4, 19000), (700, 600),
                                 (1024, 1024), (17, 23)])
@pytest.mark.parametrize("taps", [(9, 9), (63, 3)])
def test_every_cluster_plan_covers_its_shape_and_fits(B, H, W, taps):
    """Where three planes of a band fit, the plan is on the cluster route,
    covers H and fits, with all five planes on chip where its band fits
    them; among the fitting sizes it has the least waves × priced rows.
    Elsewhere the tiles route."""
    fit = tiled.fitting_sizes(H, W)
    plan = _plan(B, H, W, *taps)
    if not fit:
        assert plan.route == "tiles"
        assert plan.rows == tiled.pick_tile_rows(H, B, SMS)
        return
    _covers(plan, B, H, W)
    on_chip = tiled.own_shared_sizes(H, W)
    assert (plan.own == "shared") == (plan.clusters in on_chip)
    held = dict(H100_RESIDENT)

    def cost(c):
        pixel = 1 if c in on_chip else tiled.GLOBAL_PIXEL
        return -(-B // held[c]) * -(-H // c) * pixel

    allowed = [c for c in fit if c == fit[0] or -(-H // c) * W >= MIN_CTA_PIXELS]
    assert plan.clusters in allowed
    assert cost(plan.clusters) == min(cost(c) for c in allowed)
    assert all(c >= plan.clusters for c in allowed if cost(c) == cost(plan.clusters))


@pytest.mark.parametrize("c,rows", [(14, 37), (15, 35), (16, 32)])
def test_a_forced_cluster_size(c, rows):
    """The timing mode's forced sizes at the 512² cell."""
    plan = _plan(16, 512, 512, clusters=c)
    _covers(plan, 16, 512, 512)
    assert (plan.clusters, plan.rows, plan.own) == (c, rows, "global")


def test_a_forced_placement():
    """The card tests' placement A/B: at 16 × 256² c = 16 holds five
    planes of 16 rows; the three-plane plan of the same c
    (``_cluster_plan``) keeps t3, xg, pv and ph in global memory."""
    five = _plan(16, 256, 256, clusters=16)
    three = tiled._cluster_plan(16, 256, 256, 16, False)
    assert (five.own, five.scratch) == ("shared", admm.RESIDENT_SCRATCH)
    assert (three.own, three.scratch, three.rows) == ("global", admm.THREE_PLANE_SCRATCH, 16)
    assert three.smem == admm.cluster_smem_bytes(16, 256, False) < five.smem


@pytest.mark.parametrize("sms,smem,route,c", [
    # cards that are not an H100, each taken to hold sms // c clusters of c
    (8, SMEM, "tiles", 1),
    (16, SMEM, "cluster", 16),
    (SMS, 120_000, "tiles", 1),
])
def test_plans_respect_the_card(sms, smem, route, c):
    held = tuple((k, sms // k) for k in range(1, 17))
    plan = _plan(16, 512, 512, resident=held, sms=sms, smem_max=smem)
    assert plan.route == route
    if route == "cluster":
        assert (plan.clusters, plan.own) == (c, "global")
        _covers(plan, 16, 512, 512, sms=sms, smem=smem)


@pytest.mark.parametrize("args,kw,match", [
    ((0, 8, 8), {}, "empty shape 0 x 8x8"),
    ((2, 0, 8), {}, "empty shape 2 x 0x8"),
    ((2, 8, 8, 64, 3), {}, "64 x 3 taps"),
    ((16, 512, 512), {"clusters": 13}, "a cluster of 13 CTAs does not fit 16 x 512x512"),
    ((16, 1024, 1024), {"clusters": 16}, "a cluster of 16 CTAs does not fit 16 x 1024x1024"),
    ((16, 512, 512), {"tile_rows": 0}, "tile_rows must be positive"),
])
def test_a_shape_without_a_route_raises_and_names_it(args, kw, match):
    with pytest.raises(ValueError, match=match):
        _plan(*args, **kw)


def test_a_plan_the_card_holds_no_cluster_of_raises():
    """No fallback: the cluster route where the card holds none of its
    clusters is an error naming the plan, not a quiet launch on the row
    tiles."""
    with pytest.raises(ValueError, match="holds no cluster of AdmmTiledPlan"):
        _plan(16, 512, 512, resident=((1, 132), (2, 66)))


def test_the_planner_reads_the_kernel_s_constants():
    """The three-plane count as csrc/admm_tv_cluster.cuh states it; the
    barriers of the model are the header's table; row 5's entry points call
    the three-plane placement and are bound."""
    src = (CSRC / "admm_tv_cluster.cuh").read_text()
    assert re.findall(r"constexpr int kSharedPlanes = (\d+);", src) == [str(admm.SHARED_PLANES)]
    header = src.split("#pragma once")[0]
    for name in BARRIERS:
        assert re.search(rf"^//\s+{name}\s", header, re.M), name
    text = (CSRC / "admm_tv_tiled.cu").read_text()
    build = (CSRC.parent / "_build.py").read_text()
    for entry in ("occupancy", "launch"):
        assert f"int admm_tv_tiled_cluster_{entry}(" in text
        assert f"rls::admm_cluster::{entry}<false>(" in text
        assert f'"admm_tv_tiled_cluster_{entry}"' in build
    assert admm.cluster_smem_bytes(3, 5, False) == 3 * 64 + 864 + 56 + 8 * 65 + 504


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain version on either route's arguments; the
    launch counters do not move; the phase timer runs on the card only."""
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(rng.normal(size=(2, 12, 10)).astype(np.float32))
    taps = ((0.2, 0.6, 0.2), (0.1, 0.8, 0.1))
    before = (tiled.admm_tv_tiled.launches, dict(tiled.admm_tv_tiled.route_launches))
    got, live = tiled.admm_tv_tiled(x0, taps, 0.1, 0.05, 3, 2, 4, 1e-5, with_counts=True)
    tiles = tiled.admm_tv_tiled(x0, taps, 0.1, 0.05, 3, 2, 4, 1e-5, tile_rows=4)
    scal, t2 = admm.kernel_args(x0, 0.1, 0.05, 4)
    want, want_live = tiled.admm_tv_tiled_torch(x0, scal, t2, taps, 3, 2, 1e-5)
    assert torch.equal(got, want) and torch.equal(tiles, want)
    assert torch.equal(live, want_live)
    assert (tiled.admm_tv_tiled.launches, tiled.admm_tv_tiled.route_launches) == before
    with pytest.raises(ValueError, match="on the card"):
        tiled.phase_clocks(x0, taps, 0.1, 0.05, 3, 2, 4, 1e-5)


# ---- the three-plane placement of the cluster route


def _three(*args, **kw):
    return resident_admm(*args, placement="three", **kw)


@pytest.mark.parametrize("prox", admm.PROXES)
@pytest.mark.parametrize("tol", [1e-5, 5e-2])
@pytest.mark.parametrize("H,W,c,taps", [
    # 20 rows in bands of 7, 7, 6; one-row bands; a 63-tap column blur over
    # 3-row bands, reaching 10 bands past its own; a single band
    (20, 28, 3, (G5, MILD3)),
    (7, 9, 7, (G5, G5)),
    (40, 10, 14, TAPS63),
    (16, 12, 1, (G5, G5)),
])
def test_the_three_plane_model_is_the_plain_version(H, W, c, taps, prox, tol):
    """The banded schedule on the three planes, its sums per band in rank
    order, against admm_tv_fused_torch in float64: the same x to 1e-12 of
    max|x| and the same live CG steps (a tol_inner of 5e-2 freezes some
    steps); and the same x as the five-plane placement, bit for bit."""
    x0, scal = _problem(3, H, W)
    plan = _resident(c, H, W)
    for tv in (0, 1, 4):
        t2 = torch.from_numpy(_fgp_common.fgp_t2_table(tv, np.float64))
        got, live = _three(x0, scal, t2, taps, 5, 4, tol, prox, plan)
        want, want_live = admm.admm_tv_fused_torch(x0, scal, t2, taps, 5, 4, tol, prox)
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        assert live.tolist() == want_live.tolist()
        five, five_live = resident_admm(x0, scal, t2, taps, 5, 4, tol, prox, plan)
        assert torch.equal(got, five) and torch.equal(live, five_live)


@pytest.mark.parametrize("iterations,cg,tv", [(0, 3, 4), (3, 0, 4), (3, 1, 4), (3, 3, 0),
                                              (2, 2, 1), (3, 0, 0), (3, 0, 1)])
def test_the_three_plane_model_at_the_edge_schedules(iterations, cg, tv):
    """No outer iteration, no CG step (xg then follows the CG start's
    column pass), one CG step, no dual iteration, one (p left in rv by the
    first dual sweep), and ρ = 0 for one problem: the plain version's x
    and live steps."""
    x0, scal = _problem(3, 20, 28)
    t2 = torch.from_numpy(_fgp_common.fgp_t2_table(tv, np.float64))
    got, live = _three(x0, scal, t2, (G5, MILD3), iterations, cg, 1e-5, "positive",
                       _resident(3, 20, 28))
    want, want_live = admm.admm_tv_fused_torch(x0, scal, t2, (G5, MILD3), iterations, cg, 1e-5,
                                               "positive")
    assert float((got - want).abs().max()) <= 1e-12 * max(float(want.abs().max()), 1.0)
    assert live.tolist() == want_live.tolist()


@pytest.mark.parametrize("dropped", BARRIERS)
def test_each_barrier_of_the_three_plane_table_is_needed(dropped):
    """Without any one barrier of the header's table a shared plane (or sum
    slot) that a band reads from another is written by some band between
    two barriers: the model raises and names it. With three planes gin, xg
    and y share S2, and p replaces rv in S1 for the z-update."""
    x0, scal = _problem(2, 20, 8)
    t2 = torch.from_numpy(_fgp_common.fgp_t2_table(3, np.float64))
    args = (x0, scal, t2, (G5, G5), 2, 3, 1e-5, "none", _resident(4, 20, 8, B=2))
    _three(*args)  # with every barrier: no hazard
    with pytest.raises(Hazard, match="read from another band and written"):
        _three(*args, dropped=(dropped,))


@pytest.mark.parametrize("placement", ["five", "three"])
def test_only_shared_planes_are_read_at_another_band(placement):
    """The model refuses a read of a global plane at another band's rows:
    t3, ph (and with three planes pv and xg's copy) are read in their own
    rows only, as the kernel reads them."""
    x0, scal = _problem(2, 20, 8)
    t2 = torch.from_numpy(_fgp_common.fgp_t2_table(3, np.float64))
    plan = _resident(4, 20, 8, B=2)
    got, _ = resident_admm(x0, scal, t2, (G5, G5), 2, 3, 1e-5, "none", plan,
                           placement=placement)
    assert torch.isfinite(got).all()
    from test_torch_admm_plan import ResidentModel

    m = ResidentModel(plan, x0, placement=placement)
    for q in m.bands:
        m.put(q, "ph", m.band(x0, q))
    with pytest.raises(AssertionError, match="ph .* read at another band's rows"):
        m.rows(0, "ph", 0, plan.rows + 1)


def test_the_three_plane_model_runs_the_planners_plan():
    """The planner's own bands at a card with little shared memory: three
    planes of a 30-row band of 16 pixels, c = 8 (4 rows each)."""
    x0, scal = _problem(2, 30, 16)
    smem = admm.cluster_smem_bytes(4, 16, False)
    plan = _plan(2, 30, 16, 5, 3, smem_max=smem)
    assert (plan.route, plan.clusters, plan.rows, plan.own) == ("cluster", 8, 4, "global")
    t2 = torch.from_numpy(_fgp_common.fgp_t2_table(3, np.float64))
    got, live = _three(x0, scal, t2, (G5, MILD3), 4, 3, 1e-5, "positive", plan)
    want, want_live = admm.admm_tv_fused_torch(x0, scal, t2, (G5, MILD3), 4, 3, 1e-5,
                                               "positive")
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert live.tolist() == want_live.tolist()
