"""The TV prox kernel's planner (rls_tpu_torch/kernels/tv_fgp.py
``plan_tv_fgp``) and a Python model of its resident route, on the CPU.

The planner: which route, cluster size and plane placement a shape takes
on an H100 (132 SMs, 232,448 bytes of shared memory per block), that every
resident plan covers H with its bands and fits the card, that every
windowed plan's windows cover each row once with their interiors and
their bands cover each window, that the row → (rank, local row) map owns
each row once, that the shared-memory count, the windows' scratch and the
constants are the kernel's, and that a shape with no route raises and
names itself.

The model: the fori FGP computed band by band in float64, as the resident
kernel's CTAs compute it (csrc/tv_fgp.cu), each band reading another
band's rows only as they stood at the last cluster barrier, on the
kernel's physical planes (S0 xtmp, S1 rv and, in the last dual iteration,
p; S2 rh; x, pv and ph in S3–S5 or in global memory as the plan places
them), on the image or on each window of a windowed plan (its interior
rows stitched). It is held against ``prox_tv2d_fgp_torch`` in float64,
and it checks the barrier table of the kernel's header: a plane that a
band reads from another band between two cluster barriers must not be
written between them, so that dropping any barrier of the table raises.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rls_tpu_torch.kernels import tv_fgp
from rls_tpu_torch.kernels._bands import MIN_CTA_PIXELS

CSRC = Path(tv_fgp.__file__).parents[1] / "csrc"
SMS, SMEM = 132, 232_448
# the clusters of c resident CTAs of 1024 threads that an H100 80GB HBM3
# holds at once, by cudaOccupancyMaxActiveClusters: the table of the other
# cluster kernels (tv_fgp.resident_limits; tests/test_torch_cuda.py checks
# it on the card)
H100_RESIDENT = tuple(zip(range(1, 17), (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7,
                                         7)))
# the main path's shapes and the global route's, at 10 dual iterations:
# (route, c, rows per band, shared memory per CTA, where x, pv and ph
# live). At 64 × 256², 16 × 256² and 16 × 512² these are the fastest of
# every size and placement measured on an H100 (PERF.md §6). 8 × 1024²
# fits no cluster: windows of 52 interior rows and a halo of 10 (72 rows,
# 8 bands of 9, six planes). 4 × 4 × 12000 fits one row of three planes
# (144,504 bytes) in a cluster of 4; a row of 20,000 pixels fits no band
MAIN_SHAPES = {
    (64, 256, 256): ("resident", 8, 32, 197_360, "shared"),
    (16, 256, 256): ("resident", 6, 43, 132_936, "global"),
    (16, 512, 512): ("resident", 16, 32, 197_360, "global"),
    (8, 1024, 1024): ("windows", 8, 9, 221_752, "shared"),
    (4, 4, 12000): ("resident", 4, 1, 144_504, "global"),
    (4, 4, 20000): ("global", 1, 4, 0, "global"),
    (1, 256, 256): ("resident", 16, 16, 98_928, "shared"),
}
# tests/test_torch_cuda.py's shapes (3 problems), one for each cluster size
# the planner picks with all six planes on chip: 15 c + 1 rows of 256 (c ≥
# 2) take bands of 16 rows with the last one short (a single row at c =
# 16); rows too long for six planes, their x, pv and ph in global memory
# (the last band short but at 4 × 12000, one row per band); a row too wide
# for any band on the global route
TV_ROUTES = {(24, 20): ("resident", 1, "shared"), (1, 1): ("resident", 1, "shared"),
             **{(15 * c + 1, 256): ("resident", c, "shared") for c in range(2, 17)},
             (34, 4000): ("resident", 12, "global"), (66, 2000): ("resident", 14, "global"),
             (145, 1000): ("resident", 15, "global"), (593, 256): ("resident", 16, "global"),
             (4, 12000): ("resident", 4, "global"), (4, 20000): ("global", 1, "global")}


def _plan(B, H, W, resident=H100_RESIDENT, iterations=10, **card):
    return tv_fgp.plan_tv_fgp(B, H, W, resident, iterations=iterations, **card)


def _covers(plan, B, H, W, sms=SMS, smem=SMEM):
    """A resident plan's bands cover H with none empty; it fits the card."""
    assert plan.route == "resident"
    c, rows = plan.clusters, plan.rows
    assert 1 <= c <= min(tv_fgp.MAX_CLUSTER, sms)
    assert (c - 1) * rows < H <= c * rows
    assert all(plan.band_rows(q) >= 1 for q in range(c))
    assert sum(plan.band_rows(q) for q in range(c)) == H
    assert plan.ctas == B * c
    shared = plan.own == "shared"
    assert plan.smem == tv_fgp.cluster_smem_bytes(rows, W, shared) <= smem
    assert plan.scratch == (0 if shared else tv_fgp.OWN_SCRATCH)


def _covers_windows(plan, B, H, W, iterations, sms=SMS, smem=SMEM):
    """A windowed plan's interiors cover every row of H once, each at least
    `halo` = `iterations` rows from any window edge inside the image; its
    bands cover each window with none empty; it fits the card."""
    assert plan.route == "windows" and plan.halo == iterations
    assert plan.H == tv_fgp.window_rows(H, plan.interior, plan.halo) < H or plan.windows == 1
    spans = plan.spans(H)
    assert len(spans) == plan.windows == -(-H // plan.interior)
    rows = []
    for lo, top, end in spans:
        assert 0 <= lo <= top < end <= lo + plan.H <= H
        assert top - lo >= plan.halo or lo == 0
        assert lo + plan.H - end >= plan.halo or lo + plan.H == H
        rows += range(top, end)
    assert rows == list(range(H))
    c, R = plan.clusters, plan.rows
    assert 1 <= c <= min(tv_fgp.MAX_CLUSTER, sms)
    assert (c - 1) * R < plan.H <= c * R
    assert sum(plan.band_rows(q) for q in range(c)) == plan.H
    assert plan.ctas == B * plan.windows * c
    shared = plan.own == "shared"
    assert plan.smem == tv_fgp.cluster_smem_bytes(R, W, shared) <= smem
    assert shared == (tv_fgp.cluster_smem_bytes(R, W, True) <= smem)
    assert plan.scratch == (0 if shared else tv_fgp.OWN_SCRATCH)


@pytest.mark.parametrize("shape", list(MAIN_SHAPES))
def test_the_main_path_shapes_take_their_routes(shape):
    route, c, rows, smem, own = MAIN_SHAPES[shape]
    plan = _plan(*shape)
    assert (plan.route, plan.clusters, plan.rows, plan.smem, plan.own) == (route, c, rows, smem,
                                                                           own)
    if route == "resident":
        _covers(plan, *shape)
    elif route == "windows":
        _covers_windows(plan, *shape, 10)
    else:
        assert (plan.ctas, plan.scratch) == (shape[0], tv_fgp.GLOBAL_SCRATCH)
        assert set(plan.places().values()) == {"global"}


def test_the_flagship_keeps_every_plane_on_chip():
    """64 × 256²: six planes of 32 rows fit (c = 7 … 16). c = 8 (5 waves of
    4,400 + 8,192) costs less than c = 16 (10 waves of 4,400 + 4,096) and
    c = 5 (3 waves of 4,400 + 1.5 × 13,312, its x, pv, ph in global
    memory)."""
    assert tv_fgp.own_shared_sizes(256, 256) == tuple(range(7, 17))
    assert tv_fgp.fitting_sizes(256, 256) == tuple(range(4, 17))
    plan = _plan(64, 256, 256)
    assert plan.places() == dict.fromkeys(tv_fgp.PLANES, "shared")
    assert tv_fgp.cluster_smem_bytes(37, 256, True) <= SMEM < tv_fgp.cluster_smem_bytes(43, 256,
                                                                                        True)


def test_the_512_shape_keeps_its_own_pixel_planes_in_global_memory():
    """16 × 512²: three planes of 32 rows (196,608 bytes) fit c = 14 … 16;
    six fit no band. x, pv and ph are read at their own pixel only."""
    assert tv_fgp.fitting_sizes(512, 512) == (14, 15, 16)
    assert tv_fgp.own_shared_sizes(512, 512) == ()
    places = _plan(16, 512, 512).places()
    assert places == {"xtmp": "shared", "rv": "shared", "rh": "shared", "pv": "global",
                      "ph": "global", "x": "global"}


@pytest.mark.parametrize("B", [1, 7, 16, 64, 137, 4096])
@pytest.mark.parametrize("H,W", [(8, 8), (1, 1), (1, 16), (17, 23), (33, 700), (128, 128),
                                 (255, 257), (256, 256), (300, 300), (512, 512), (1000, 60),
                                 (60, 1000), (1024, 1024), (4096, 16), (4, 12000),
                                 (4, 20000)])
def test_every_resident_plan_covers_its_shape_and_fits(B, H, W):
    """Where bands fit, the plan is resident, covers H and fits; x, pv and
    ph are in shared memory where its band fits six planes; among the
    fitting sizes it has the least waves × cost of a wave."""
    fit = tv_fgp.fitting_sizes(H, W)
    plan = _plan(B, H, W)
    if not fit:
        if plan.route == "windows":
            _covers_windows(plan, B, H, W, 10)
            return
        assert plan.route == "global"
        assert not tv_fgp.window_candidates(B, H, W, 10)
        assert (plan.rows, plan.ctas, plan.smem, plan.scratch) == (H, B, 0,
                                                                   tv_fgp.GLOBAL_SCRATCH)
        return
    _covers(plan, B, H, W)
    on_chip = tv_fgp.own_shared_sizes(H, W)
    assert (plan.own == "shared") == (plan.clusters in on_chip)
    held = dict(H100_RESIDENT)

    def cost(c):
        pixel = 1 if c in on_chip else tv_fgp.GLOBAL_PIXEL
        return -(-B // held[c]) * (tv_fgp.WAVE_PIXELS + -(-H // c) * W * pixel)

    allowed = [c for c in fit if c == fit[0] or -(-H // c) * W >= MIN_CTA_PIXELS]
    assert plan.clusters in allowed
    assert cost(plan.clusters) == min(cost(c) for c in allowed)
    assert all(c >= plan.clusters for c in allowed if cost(c) == cost(plan.clusters))


@pytest.mark.parametrize("c,rows,smem,own", [
    # forced sizes of 64 × 256²: 4 and 5 bands hold three planes only
    (4, 64, 196_608 + 8 * 126, "global"), (5, 52, 159_744 + 8 * 114, "global"),
    (6, 43, 132_096 + 8 * 105, "global"), (8, 32, 197_360, "shared"),
    (16, 16, 98_928, "shared"),
])
def test_a_forced_cluster_size(c, rows, smem, own):
    """The timing mode's and the tests' forced plans: any fitting size,
    its own-pixel planes in shared memory where they fit."""
    plan = _plan(64, 256, 256, clusters=c)
    _covers(plan, 64, 256, 256)
    assert (plan.clusters, plan.rows, plan.smem, plan.own) == (c, rows, smem, own)


@pytest.mark.parametrize("c,rows,smem", [
    # three planes of the band and rows + 62 row pointers
    (8, 32, 3 * 32_768 + 8 * 94), (16, 16, 3 * 16_384 + 8 * 78), (5, 52, 3 * 53_248 + 8 * 114),
])
def test_a_forced_placement(c, rows, smem):
    """The timing mode's and the card tests' placement A/B (``_card_plan``
    with own = "global"): x, pv and ph in global memory at a size where six
    planes would fit, or would not."""
    plan = tv_fgp._resident_plan(64, 256, 256, c, False)
    _covers(plan, 64, 256, 256)
    assert (plan.clusters, plan.rows, plan.smem, plan.own) == (c, rows, smem, "global")
    assert plan.places()["pv"] == "global"


def test_the_wave_cost_orders_the_measured_plans():
    """The planner's cost puts the sizes measured fastest on an H100 first
    (PERF.md §6, every size and placement at these shapes): 64 × 256² c =
    8 on chip before c = 7 on chip, c = 5 and c = 16; 16 × 256² (8 dual
    iterations) c = 6 with x, pv, ph in global memory, one wave, before c =
    8 and c = 16 on chip."""
    held = dict(H100_RESIDENT)

    def cost(B, c):
        rows = -(-256 // c)
        pixel = 1 if c in tv_fgp.own_shared_sizes(256, 256) else tv_fgp.GLOBAL_PIXEL
        return -(-B // held[c]) * (tv_fgp.WAVE_PIXELS + rows * 256 * pixel)

    assert cost(64, 8) < cost(64, 7) < cost(64, 5) < cost(64, 16)
    assert cost(16, 6) < cost(16, 8) < cost(16, 16)


@pytest.mark.parametrize("shape", list(TV_ROUTES))
def test_the_card_tests_shapes_take_their_routes(shape):
    plan = _plan(3, *shape)
    assert (plan.route, plan.clusters, plan.own) == TV_ROUTES[shape]
    if plan.route == "resident":
        _covers(plan, 3, *shape)
        if plan.clusters > 1 and shape[0] > 4:  # the last band is the short one
            assert plan.band_rows(plan.clusters - 1) < plan.rows


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
def test_the_card_tests_forced_sizes_leave_a_remainder_band(c):
    """tests/test_torch_cuda.py forces c on 3 × 47 × 40: bands of ⌈47/c⌉
    rows with a shorter last band (c ≥ 2), all six planes on chip."""
    plan = _plan(3, 47, 40, clusters=c)
    _covers(plan, 3, 47, 40)
    assert plan.own == "shared"
    if c > 1:
        assert plan.band_rows(c - 1) < plan.rows


@pytest.mark.parametrize("B,H,W,c", [(64, 256, 256, 8), (3, 47, 40, 16), (16, 512, 512, 16),
                                     (4, 4, 12000, 4), (1, 4096, 16, 16)])
def test_the_row_map_owns_every_row_once_and_reaches_its_neighbours(B, H, W, c):
    """locate(row) names the one CTA whose band holds the row; the rows
    one above and one below every band's rows (grad_t, grad_v) resolve to
    a real row of some band inside the image, and the kernel's row table
    (rows + 2·HALO entries from r0 − HALO) holds them."""
    plan = _plan(B, H, W, clusters=c)
    owned = {}
    for rank in range(c):
        for lr in range(plan.band_rows(rank)):
            row = rank * plan.rows + lr
            assert row not in owned
            owned[row] = (rank, lr)
    assert sorted(owned) == list(range(H))
    for row in range(H):
        assert plan.locate(row) == owned[row]
    for rank in range(c):
        r0 = rank * plan.rows
        for lr in range(plan.band_rows(rank)):
            for s in (-1, 1):
                r = r0 + lr + s
                if 0 <= r < H:
                    q, l = plan.locate(r)
                    assert 0 <= q < c and 0 <= l < plan.band_rows(q)
                    assert 0 <= r - (r0 - tv_fgp.HALO) < plan.rows + 2 * tv_fgp.HALO


def test_cluster_smem_bytes_counts_every_piece():
    # 32 rows of 256: six f32 planes and 32 + 62 row pointers, or three
    assert tv_fgp.cluster_smem_bytes(32, 256, True) == 6 * 32_768 + 8 * 94
    assert tv_fgp.cluster_smem_bytes(32, 256, False) == 3 * 32_768 + 8 * 94
    # each plane rounded up to 4 floats: 3 × 5 = 15 → 16
    assert tv_fgp.cluster_smem_bytes(3, 5, False) == 3 * 64 + 8 * 65


def test_the_planner_reads_the_kernel_s_constants():
    """Threads, the largest cluster, the planes and the shared-memory count
    as csrc/tv_fgp.cu states them; the barriers of the model are the
    header's table."""
    src = (CSRC / "tv_fgp.cu").read_text()
    assert re.findall(r"constexpr int kThreads = (\d+);", src) == [str(tv_fgp.THREADS)]
    assert re.findall(r"constexpr int kMaxCluster = (\d+);", src) == [str(tv_fgp.MAX_CLUSTER)]
    assert re.findall(r"constexpr int kSharedPlanes = (\d+);", src) == [
        str(tv_fgp.SHARED_PLANES)]
    assert re.findall(r"constexpr int kAllPlanes = (\d+);", src) == [str(tv_fgp.ALL_PLANES)]
    planes = re.search(r"enum \{\s*(kXtmp[^}]*)\}", src).group(1)
    names = [p.strip()[1:].lower() for p in planes.split(",") if p.strip()]
    assert names == list(tv_fgp.PLANES)
    smem = re.search(r"cluster_smem_bytes\(int rows, int W, bool own_shared\) \{(.*?)\n\}", src,
                     re.S).group(1)
    for piece in ("sizeof(float) * (own_shared ? kAllPlanes : kSharedPlanes)",
                  "rls::band_plane_floats(rows, W)",
                  "sizeof(const float*) * (rows + 2 * kHalo)"):
        assert piece in smem
    header = src.split("#include")[0]
    for name in BARRIERS:
        assert re.search(rf"^//\s+{name}\s", header, re.M), name
    for name in BARRIERS:
        assert f"sync_cluster();  // {name}" in src


@pytest.mark.parametrize("W,widest", [(19_329, 19_328), (30_000, 19_328)])
def test_a_too_wide_row_takes_the_global_route(W, widest):
    """A band of one row of more than 19,328 pixels needs more than 232,448
    bytes even with three planes: one CTA per problem on global scratch."""
    plan = _plan(4, 2, W)
    assert (plan.route, plan.clusters, plan.rows, plan.ctas) == ("global", 1, 2, 4)
    assert tv_fgp.fitting_sizes(1, widest) == (1,)
    assert tv_fgp.fitting_sizes(1, widest + 1) == ()


@pytest.mark.parametrize("sms,smem,route,c,own", [
    # cards that are not an H100, each taken to hold sms // c clusters of c:
    # fewer SMs cap the cluster size (on 2 SMs 256² fits only windows)
    (8, SMEM, "resident", 8, "shared"),
    (4, SMEM, "resident", 4, "global"),
    (2, SMEM, "windows", 2, "global"),
    # less shared memory: more bands, or none that fit; at 120,000 bytes
    # c = 8 with x, pv, ph in global memory (4 waves) beats c = 16 with six
    # planes (8 waves)
    (SMS, 120_000, "resident", 8, "global"),
    (SMS, 60_000, "resident", 16, "global"),
    # at 48 KiB no band of 256² fits, but windows of 150 rows on 10 CTAs
    # do; at 4 KiB a CTA holds one row, and 16 rows are no window at 10
    # dual iterations
    (SMS, 48 * 1024, "windows", 10, "global"),
    (SMS, 4096, "global", 1, "global"),
])
def test_plans_respect_the_card(sms, smem, route, c, own):
    held = tuple((k, sms // k) for k in range(1, 17))
    plan = _plan(64, 256, 256, resident=held, sms=sms, smem_max=smem)
    assert (plan.route, plan.clusters, plan.own) == (route, c, own)
    if route == "resident":
        _covers(plan, 64, 256, 256, sms=sms, smem=smem)
    if route == "windows":
        _covers_windows(plan, 64, 256, 256, 10, sms=sms, smem=smem)


@pytest.mark.parametrize("args,kw,match", [
    ((0, 8, 8), {}, "empty shape 0 x 8x8"),
    ((2, 0, 8), {}, "empty shape 2 x 0x8"),
    ((2, 8, 0), {}, "empty shape 2 x 8x0"),
    # a forced size whose bands do not fit, or leave a band empty
    ((64, 256, 256), {"clusters": 3}, "a cluster of 3 CTAs does not fit 64 x 256x256"),
    ((3, 47, 40), {"clusters": 17}, "a cluster of 17 CTAs does not fit 3 x 47x40"),
    ((3, 24, 20), {"clusters": 16}, "a cluster of 16 CTAs does not fit 3 x 24x20"),
    ((4, 4, 20000), {"clusters": 4}, "a cluster of 4 CTAs does not fit 4 x 4x20000"),
    # rows wider than any band and 2³¹ pixels per problem: no route
    ((1, 2, 2**30), {}, "no route for 1 x 2x1073741824"),
])
def test_a_shape_without_a_route_raises_and_names_it(args, kw, match):
    with pytest.raises(ValueError, match=match):
        _plan(*args, **kw)


def test_a_plan_the_card_holds_no_cluster_of_raises():
    """No fallback: the resident route where the card holds none of its
    clusters is an error naming the plan, not a quiet global launch."""
    with pytest.raises(ValueError, match="holds no cluster of TvFgpPlan"):
        _plan(64, 256, 256, resident=((1, 132), (2, 66)))


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain version; the launch counters do not
    move. The public wrapper takes no forced plan: that is the private
    ``_launch``'s, for the timing mode and the card tests."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(3, 9 * 7)).astype(np.float32))
    lam = torch.tensor([0.1, 0.0, 0.3])
    before = (tv_fgp.prox_tv2d_fgp.launches, dict(tv_fgp.prox_tv2d_fgp.route_launches))
    with pytest.raises(TypeError):
        tv_fgp.prox_tv2d_fgp(x, lam, (9, 7), 5, clusters=16)
    got = tv_fgp.prox_tv2d_fgp(x, lam, (9, 7), 5)
    want = tv_fgp.prox_tv2d_fgp_torch(x.reshape(3, 9, 7), lam, 5).reshape(3, -1)
    assert torch.equal(got, want)
    assert (tv_fgp.prox_tv2d_fgp.launches, tv_fgp.prox_tv2d_fgp.route_launches) == before


def _window_cost(plan, W=1024):
    held = dict(H100_RESIDENT)
    pixel = 1 if plan.own == "shared" else tv_fgp.GLOBAL_PIXEL
    return -(-plan.ctas // plan.clusters // held[plan.clusters]) * (
        tv_fgp.WAVE_PIXELS + plan.rows * W * pixel)


def test_the_1024_shape_takes_windows_with_a_halo_of_the_dual_iterations():
    """8 × 1024² at 10 dual iterations fits no cluster of 16 (its bands
    would need 64 rows of 1024); the windowed route, halo 10: 20 windows
    of 52 interior rows on clusters of 8 with all six planes on chip (11
    waves of 4,400 + 9,216), the least cost of every candidate, ties to the
    smaller c (16 CTAs on 9 windows of 144 rows cost as much)."""
    assert tv_fgp.fitting_sizes(1024, 1024) == ()
    plan = _plan(8, 1024, 1024)
    _covers_windows(plan, 8, 1024, 1024, 10)
    assert (plan.clusters, plan.rows, plan.H, plan.interior, plan.windows, plan.halo) == (
        8, 9, 72, 52, 20, 10)
    assert plan.places() == dict.fromkeys(tv_fgp.PLANES, "shared")
    costs = [_window_cost(p) for p in tv_fgp.window_candidates(8, 1024, 1024, 10)]
    assert _window_cost(plan) == min(costs) == 11 * (tv_fgp.WAVE_PIXELS + 9 * 1024)
    # the issue's first estimate: c = 16 on 18-row bands, 4 windows of 256
    wide = tv_fgp.plan_tv_fgp(8, 1024, 1024, H100_RESIDENT, iterations=10, interior=256)
    assert (wide.clusters, wide.rows, wide.smem, wide.own) == (16, 18, 221_824, "global")


@pytest.mark.parametrize("iterations", [0, 1, 5, 10, 11, 20, 60])
@pytest.mark.parametrize("B,H,W", [(8, 1024, 1024), (1, 1024, 1024), (3, 2000, 500),
                                   (2, 600, 5000), (4, 40000, 16), (1, 300, 9664)])
def test_every_windowed_plan_covers_its_shape_and_fits(B, H, W, iterations):
    """Where no band fits but a window does, the plan is windowed: its
    windows cover every row once, its halo is the dual iterations, its
    bands fit; it has the least waves × cost of a wave among the
    candidates that leave every CTA ``MIN_CTA_PIXELS``."""
    assert not tv_fgp.fitting_sizes(H, W)
    plan = _plan(B, H, W, iterations=iterations)
    candidates = tv_fgp.window_candidates(B, H, W, iterations)
    if not candidates:
        assert plan.route == "global"
        return
    _covers_windows(plan, B, H, W, iterations)
    wide = [p for p in candidates if p.rows * W >= MIN_CTA_PIXELS] or candidates
    assert plan in wide
    assert _window_cost(plan, W) == min(_window_cost(p, W) for p in wide)


@pytest.mark.parametrize("W,route", [(9664, "windows"), (9665, "global"), (19_328, "global")])
def test_the_widest_row_of_a_window_at_10_dual_iterations(W, route):
    """A window needs 2·halo + 1 rows on 16 CTAs: at 10 dual iterations,
    two rows of three planes a band (W ≤ 9,664), else the global route;
    with no dual iteration one row a band, up to 19,328 pixels."""
    assert _plan(2, 4096, W).route == route
    assert tv_fgp.widest_band(W, False) == (2 if W <= 9664 else 1)
    assert _plan(2, 4096, W, iterations=0).route == "windows"
    assert _plan(2, 4096, 19_329, iterations=0).route == "global"


@pytest.mark.parametrize("W", [1, 16, 29, 256, 1000, 1024, 9664, 19_328, 19_329])
@pytest.mark.parametrize("own_shared", [False, True])
def test_the_widest_band_is_the_most_rows_that_fit(W, own_shared):
    rows = tv_fgp.widest_band(W, own_shared)
    assert rows == 0 or tv_fgp.cluster_smem_bytes(rows, W, own_shared) <= SMEM
    assert tv_fgp.cluster_smem_bytes(rows + 1, W, own_shared) > SMEM


@pytest.mark.parametrize("B,H,W,iterations,interior,clusters", [
    (3, 37, 29, 5, 4, None), (3, 37, 29, 0, 9, None), (2, 64, 17, 10, 6, 3),
    (16, 512, 512, 10, 256, None), (16, 512, 512, 10, 512, None), (8, 1024, 1024, 10, 256, 16),
    (8, 1024, 1024, 10, 114, 8), (8, 1024, 1024, 10, 124, 16), (1, 10, 7, 3, 10, 2),
])
def test_a_forced_window(B, H, W, iterations, interior, clusters):
    """The timing mode's and the tests' forced windows: `interior` rows a
    window, the cluster size the planner takes for the window (or the one
    forced), six planes where they fit; a window as tall as the image is
    the resident plan's bands."""
    plan = _plan(B, H, W, iterations=iterations, interior=interior, clusters=clusters)
    _covers_windows(plan, B, H, W, iterations)
    whole = _plan(B * plan.windows, plan.H, W, clusters=clusters)
    assert (plan.clusters, plan.rows, plan.smem, plan.own) == (
        whole.clusters, whole.rows, whole.smem, whole.own)
    if interior == H:
        assert plan.spans(H) == [(0, 0, H)]


@pytest.mark.parametrize("args,kw,match", [
    ((3, 37, 29), {"interior": 0}, "windows of 0 rows do not fit 3 x 37x29"),
    ((3, 37, 29), {"interior": 38}, "windows of 38 rows do not fit 3 x 37x29"),
    ((2, 64, 20000), {"interior": 8}, "windows of 28 rows fit no cluster"),
    ((3, 37, 29), {"interior": 4, "clusters": 17}, "a cluster of 17 CTAs does not fit"),
    ((8, 1024, 1024), {"resident": ((1, 132),)}, "holds no cluster of TvFgpPlan"),
])
def test_a_window_that_does_not_fit_raises(args, kw, match):
    with pytest.raises(ValueError, match=match):
        _plan(*args, **kw)


@pytest.mark.parametrize("B,H,W,iterations,interior", [
    (8, 1024, 1024, 10, None), (3, 37, 29, 5, 4), (2, 64, 17, 1, 9), (16, 512, 512, 10, 256)])
def test_each_window_has_scratch_of_its_own(B, H, W, iterations, interior):
    """The kernel's pv and ph where they are not in shared memory: plane
    offsets (cluster · window rows + r0) · W in planes of B·windows ×
    window rows × W (csrc/tv_fgp.cu). Every (problem, window, band) writes
    its own pixels, disjoint from every other cluster's and inside the
    wrapper's scratch: overlapping windows never write the same rows."""
    plan = tv_fgp._placed(_plan(B, H, W, iterations=iterations, interior=interior), W, False)
    src = (CSRC / "tv_fgp.cu").read_text()
    assert "pv = a.scratch + (static_cast<size_t>(cluster) * H + r0) * W;" in src
    assert "ph = pv + static_cast<size_t>(a.B) * a.windows * H * W;" in src
    assert "torch.empty((plan.scratch, B * plan.windows, plan.H, W)" in (
        Path(tv_fgp.__file__).read_text())
    plane = B * plan.windows * plan.H * W
    seen = np.zeros(plane, dtype=np.int64)
    for cluster in range(B * plan.windows):
        for rank in range(plan.clusters):
            r0 = rank * plan.rows
            off = (cluster * plan.H + r0) * W
            seen[off:off + plan.band_rows(rank) * W] += 1
    assert (seen == 1).all()


# ---- a Python model of the resident route


class Hazard(AssertionError):
    """A plane read from another band and written between two cluster
    barriers."""


# the header's table: B0, then per dual iteration Bx and Bq, and Be
BARRIERS = ("B0", "Bx", "Bq", "Be")
SHARED = ("S0", "S1", "S2")


class ResidentModel:
    """The resident route's planes, band by band: S0–S2 in shared memory,
    and x, pv and ph in S3–S5 or in global memory as the plan places them.
    A band reads its own rows as they stand; another band's rows as they
    stood at the last cluster barrier (`barrier` publishes every band's
    planes); rows past the image as zero. Between two barriers the planes
    read from another band and the planes written must not meet (`barrier`
    raises Hazard): the kernel's rule for distributed shared memory. A
    barrier named in `dropped` is not there."""

    def __init__(self, plan, x, dropped=()):
        self.plan, self.dropped = plan, set(dropped)
        self.B, self.H, self.W = x.shape
        self.bands = range(plan.clusters)
        shared = plan.own == "shared"
        # the physical home of each plane a band holds
        self.home = {"xtmp": "S0", "rv": "S1", "rh": "S2", "pv": "S3" if shared else "Gpv",
                     "ph": "S4" if shared else "Gph", "x": "S5" if shared else "Gx"}
        self.live = [{self.home["x"]: self.band(x, q).clone()} for q in self.bands]
        self.published = [dict(planes) for planes in self.live]
        self.read_remote, self.written = set(), set()

    def band(self, plane, q):
        r0 = q * self.plan.rows
        return plane[:, r0:r0 + self.plan.band_rows(q)]

    def barrier(self, name):
        if name in self.dropped:
            return
        met = self.read_remote & self.written
        if met:
            raise Hazard(f"read from another band and written before {name}: {sorted(met)}")
        self.published = [dict(planes) for planes in self.live]
        self.read_remote, self.written = set(), set()

    def get(self, q, name):
        return self.live[q][self.home[name]]

    def put(self, q, name, value):
        self.written.add(self.home[name])
        self.live[q][self.home[name]] = value

    def rows(self, q, name, lo, hi):
        """Image rows lo … hi − 1 of plane `name` as band q sees them; only
        a shared-memory plane may be read at another band's rows."""
        home = self.home[name]
        out = []
        for r in range(lo, hi):
            if not 0 <= r < self.H:
                out.append(torch.zeros(self.B, self.W, dtype=torch.float64))
                continue
            owner, lr = self.plan.locate(r)
            if owner == q:
                out.append(self.live[q][home][:, lr])
            else:
                assert home in SHARED, f"{name} ({home}) read at another band's rows"
                self.read_remote.add(home)
                # a plane no barrier has published yet reads as garbage
                plane = self.published[owner].get(home)
                out.append(torch.full((self.B, self.W), float("nan"), dtype=torch.float64)
                           if plane is None else plane[:, lr])
        return torch.stack(out, dim=1)


def _cols(v, dc):
    """v[..., c + dc], zero past the edge."""
    out = torch.zeros_like(v)
    if dc > 0:
        out[..., :-dc] = v[..., dc:]
    elif dc < 0:
        out[..., -dc:] = v[..., :dc]
    return out


def resident_fgp(x, lam, iterations, plan, dropped=()):
    """The fori FGP by the resident route's sweeps and barriers, band by
    band, in the order of the header of csrc/tv_fgp.cu; returns out."""
    m = ResidentModel(plan, x, dropped)
    B, H, W = x.shape
    bands = list(m.bands)
    lam = lam.view(-1, 1, 1)
    inv8 = 1.0 / (8.0 * torch.where(lam > 0, lam, torch.ones_like(lam)))
    mcol = (torch.arange(W) < W - 1).to(torch.float64)

    def mrow(q):
        r0 = q * plan.rows
        return (torch.arange(r0, r0 + plan.band_rows(q)) < H - 1).to(torch.float64)[:, None]

    def grad_t(q, v, h):
        """gtᵀ(v, h) on band q: v one row up (another band's rows at the
        band's first row), h one column left."""
        n, r0 = plan.band_rows(q), q * plan.rows
        up = m.rows(q, v, r0 - 1, r0 + n - 1)
        hv = m.get(q, h)
        return (up - m.get(q, v)) + (_cols(hv, -1) - hv)

    for q in bands:  # the set-up
        zero = m.band(x, q) * 0.0
        for name in ("pv", "ph", "rv", "rh"):
            m.put(q, name, zero.clone())
    m.barrier("B0")
    t = torch.ones((), dtype=torch.float64)
    for it in range(iterations):
        for q in bands:
            m.put(q, "xtmp", m.get(q, "x") - lam * grad_t(q, "rv", "rh"))
        m.barrier("Bx")
        t_new = (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) / 2.0
        t2 = (t - 1.0) / t_new
        new = []
        for q in bands:
            n, r0 = plan.band_rows(q), q * plan.rows
            xt = m.get(q, "xtmp")
            below = m.rows(q, "xtmp", r0 + 1, r0 + n + 1)
            qv = torch.clamp(m.get(q, "rv") + (below - xt) * inv8, -1.0, 1.0) * mrow(q)
            qh = torch.clamp(m.get(q, "rh") + (_cols(xt, 1) - xt) * inv8, -1.0, 1.0) * mcol
            new.append((qv, qh))
        for q, (qv, qh) in zip(bands, new):
            last = it + 1 == iterations
            m.put(q, "rv", qv if last else (1.0 + t2) * qv - t2 * m.get(q, "pv"))
            m.put(q, "rh", (1.0 + t2) * qh - t2 * m.get(q, "ph"))
            m.put(q, "pv", qv)
            m.put(q, "ph", qh)
        m.barrier("Bq")
        t = t_new
    out = [m.get(q, "x") - lam * grad_t(q, "rv", "ph") for q in bands]
    m.barrier("Be")
    for name in SHARED:  # the CTAs exit: their shared memory goes
        m.written.add(name)
    m.barrier("exit")
    return torch.cat(out, dim=1)


def _problem(B, H, W, seed=5):
    """x in float64 and λ per problem, one of them 0 (the identity)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(B, H, W)))
    lam = torch.tensor([0.2, 0.0, 0.05, 0.6][:B], dtype=torch.float64)
    return x, lam


def _resident(c, H, W, own, B=3):
    rows = -(-H // c)
    shared = own == "shared"
    return tv_fgp.TvFgpPlan("resident", c, rows, H, B * c,
                            tv_fgp.cluster_smem_bytes(rows, W, shared),
                            0 if shared else tv_fgp.OWN_SCRATCH, own)


@pytest.mark.parametrize("own", ["shared", "global"])
@pytest.mark.parametrize("H,W,c", [
    # 20 rows in bands of 7, 7, 6; one-row bands; a one-row band last;
    # a single row and a single column; one band
    (20, 28, 3), (7, 9, 7), (10, 5, 4), (1, 12, 1), (13, 1, 5), (16, 12, 1), (47, 40, 16),
])
@pytest.mark.parametrize("iterations", [0, 1, 2, 10])
def test_the_resident_model_is_the_plain_version(H, W, c, own, iterations):
    """The banded schedule on its physical planes against
    prox_tv2d_fgp_torch in float64: the same result to 1e-12 of max|x|,
    with λ = 0 beside λ > 0 in one batch."""
    x, lam = _problem(3, H, W)
    plan = _resident(c, H, W, own)
    assert all(plan.band_rows(q) >= 1 for q in range(c))
    got = resident_fgp(x, lam, iterations, plan)
    want = tv_fgp.prox_tv2d_fgp_torch(x, lam, iterations)
    assert float((got - want).abs().max()) <= 1e-12 * float(x.abs().max())
    assert torch.equal(got[1], x[1])  # λ = 0


def test_the_resident_model_runs_the_planners_plan():
    """The planner's own bands, on a card with little shared memory."""
    x, lam = _problem(4, 60, 16)
    plan = _plan(4, 60, 16, smem_max=tv_fgp.cluster_smem_bytes(4, 16, False))
    assert (plan.route, plan.clusters, plan.rows, plan.own) == ("resident", 15, 4, "global")
    got = resident_fgp(x, lam, 10, plan)
    want = tv_fgp.prox_tv2d_fgp_torch(x, lam, 10)
    assert float((got - want).abs().max()) <= 1e-12 * float(x.abs().max())


@pytest.mark.parametrize("own", ["shared", "global"])
@pytest.mark.parametrize("iterations", [0, 1, 3])
@pytest.mark.parametrize("dropped", BARRIERS)
def test_each_barrier_of_the_table_is_needed(dropped, iterations, own):
    """Without any one barrier of the header's table a plane that a band
    reads from another is written by some band between two barriers: the
    model raises and names it (with no dual iteration, Bx and Bq are not
    there to drop)."""
    x, lam = _problem(2, 20, 8)
    plan = _resident(4, 20, 8, own, B=2)
    resident_fgp(x, lam, iterations, plan)  # with every barrier: no hazard
    if iterations == 0 and dropped in ("Bx", "Bq"):
        resident_fgp(x, lam, iterations, plan, dropped=(dropped,))
        return
    with pytest.raises(Hazard, match="read from another band and written"):
        resident_fgp(x, lam, iterations, plan, dropped=(dropped,))


def windowed_fgp(x, lam, iterations, plan, dropped=()):
    """The windowed route: the resident route's schedule on each window of
    ``plan.spans`` (a cluster each, the window taken for the image), its
    interior rows stitched."""
    out = torch.empty_like(x)
    for lo, top, end in plan.spans(x.shape[1]):
        got = resident_fgp(x[:, lo:lo + plan.H], lam, iterations, plan, dropped)
        out[:, top:end] = got[:, top - lo:end - lo]
    return out


@pytest.mark.parametrize("own", [False, True])
@pytest.mark.parametrize("H,W,interior,c", [(37, 29, 4, 2), (37, 29, 9, 3), (64, 17, 6, 2),
                                            (20, 8, 7, 3)])
@pytest.mark.parametrize("iterations", [0, 1, 2, 5])
def test_the_windowed_model_is_the_plain_version(H, W, interior, c, own, iterations):
    """The banded schedule on each window's physical planes, both
    placements, against prox_tv2d_fgp_torch in float64: the same result to
    1e-12 of max|x| (the plain windowed version is the whole image's bit
    for bit: tests/test_torch_tv_fgp_windows.py)."""
    x, lam = _problem(3, H, W)
    plan = tv_fgp._placed(_plan(3, H, W, iterations=iterations, interior=interior, clusters=c),
                          W, own)
    assert plan.windows > 1 and plan.H < H
    got = windowed_fgp(x, lam, iterations, plan)
    want = tv_fgp.prox_tv2d_fgp_torch(x, lam, iterations)
    assert float((got - want).abs().max()) <= 1e-12 * float(x.abs().max())
    assert torch.equal(got, tv_fgp.prox_tv2d_fgp_windows_torch(x, lam, iterations, plan))


@pytest.mark.parametrize("own", [False, True])
@pytest.mark.parametrize("iterations", [0, 1, 3])
@pytest.mark.parametrize("dropped", BARRIERS)
def test_each_barrier_of_the_table_is_needed_on_windows(dropped, iterations, own):
    """The same barrier table on the windowed route: without any one of
    them some window's cluster reads a plane another band writes between
    two barriers."""
    x, lam = _problem(2, 40, 8)
    plan = tv_fgp._placed(_plan(2, 40, 8, iterations=iterations, interior=7, clusters=3), 8,
                          own)
    windowed_fgp(x, lam, iterations, plan)  # with every barrier: no hazard
    if iterations == 0 and dropped in ("Bx", "Bq"):
        windowed_fgp(x, lam, iterations, plan, dropped=(dropped,))
        return
    with pytest.raises(Hazard, match="read from another band and written"):
        windowed_fgp(x, lam, iterations, plan, dropped=(dropped,))
