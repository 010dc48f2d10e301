"""The fused PGM-TV kernel's planner (rls_tpu_torch/kernels/fista_tv_fused.py
``plan_pgm_tv``), on the CPU: which route and cluster size a shape takes on
an H100 (132 SMs, 232,448 bytes of shared memory per block), that every
resident plan covers H with its bands and fits the card, that the row →
(rank, local row) map owns each row once and reaches every stencil radius
up to 31, and that a shape with no route raises. The kernel itself runs
only on the card (tests/test_torch_cuda.py)."""

import pytest

from rls_tpu_torch.kernels import fista_tv_fused as fused

SMS, SMEM = 132, 232_448
# the clusters of c resident CTAs that an H100 80GB HBM3 holds at once, by
# cudaOccupancyMaxActiveClusters: the same for every shape and schedule
# these tests plan (fista_tv_fused.resident_limits; tests/test_torch_cuda.py
# checks the table on the card)
H100_RESIDENT = ((1, 132), (2, 66), (4, 30), (8, 15), (16, 7))
FISTA = ("fista", "none", False, False)
SCHEDULES = [
    FISTA,
    ("optista", "none", False, False),
    ("pogm", "none", False, False),
    ("fista", "gradient", True, False),
    ("pogm", "gradient", False, False),
    ("fista", "none", False, True),
]


def _plan(B, H, W, kh, kw, schedule=FISTA, resident=H100_RESIDENT, **card):
    return fused.plan_pgm_tv(B, H, W, kh, kw, schedule, resident, **card)


def _covers(plan, B, H, W, sms=SMS, smem=SMEM):
    """A resident plan's bands cover H with none empty; it fits the card."""
    assert plan.route == "resident"
    c, rows = plan.clusters, plan.rows
    assert c in fused.CLUSTER_SIZES and c <= sms
    assert (c - 1) * rows < H <= c * rows
    assert all(plan.band_rows(q) >= 1 for q in range(c))
    assert sum(plan.band_rows(q) for q in range(c)) == H
    assert plan.ctas == B * c
    assert plan.smem == fused.cluster_smem_bytes(rows, W) <= smem


@pytest.mark.parametrize("shape,want", [
    # the flagship: 8 bands of 32 rows, six 32 KiB planes; the card holds
    # 15 such clusters at once, so 64 problems run in 5 waves
    ((64, 256, 256), (8, 32, 198_752)),
    # the dynamic and warm schedules' batch of 8: 16 bands would need 8
    # clusters of 16 at once and the card holds 7, so 8 bands (64 CTAs)
    ((8, 256, 256), (8, 32, 198_752)),
    # 7 problems: all 7 clusters of 16 bands of 16 rows fit in one wave
    ((7, 256, 256), (16, 16, 100_320)),
    # 16 problems: more than the 15 clusters of 8 held at once already
    ((16, 256, 256), (8, 32, 198_752)),
])
def test_plans_at_the_cells(shape, want):
    B, H, W = shape
    plan = _plan(B, H, W, 9, 9)
    _covers(plan, B, H, W)
    assert (plan.clusters, plan.rows, plan.smem) == want
    assert plan.scratch == fused.RESIDENT_SCRATCH


@pytest.mark.parametrize("B,c", [(8, 8), (7, 16), (3, 16), (64, 8)])
def test_a_batch_spreads_only_as_far_as_the_card_holds_it(B, c):
    """An H100 80GB HBM3 holds 15 clusters of 8 of these CTAs and 7 of 16
    at once (cudaOccupancyMaxActiveClusters): 8 problems in clusters of 16
    would take two waves, so they stay at 8 bands; 7 or fewer spread."""
    plan = _plan(B, 256, 256, 9, 9)
    _covers(plan, B, 256, 256)
    assert plan.clusters == c


def test_the_forced_512_plan_takes_the_global_route():
    """512² at 16 bands of 32 rows needs 384 KiB per CTA: one CTA per
    problem on global scratch, as before the resident route."""
    plan = _plan(16, 512, 512, 9, 9)
    assert (plan.route, plan.clusters, plan.ctas) == ("global", 1, 16)
    assert (plan.smem, plan.scratch) == (fused.GLOBAL_SMEM, fused.GLOBAL_SCRATCH)


@pytest.mark.parametrize("shape", [(3, 24, 20), (3, 9, 33), (3, 64, 64), (64, 64, 64), (1, 1, 1)])
def test_small_images_take_one_cta(shape):
    """The card tests' shapes and 64² fit one CTA and stay there: 2 bands
    would leave a CTA fewer than MIN_CTA_PIXELS pixels."""
    plan = _plan(*shape, 5, 3)
    _covers(plan, *shape)
    assert plan.clusters == 1 and plan.rows == shape[1]


@pytest.mark.parametrize("shape,taps,c", [
    # the card tests' shapes that force each cluster size; 150 and 300 rows
    # do not divide into their bands (38 × 3 + 36; 19 × 15 + 15), and at
    # 300² the 63-tap column pass reaches two bands past its own
    ((3, 100, 120), (5, 3), 2),
    ((3, 150, 150), (5, 3), 4),
    ((3, 200, 250), (5, 3), 8),
    ((3, 256, 256), (5, 3), 16),
    ((3, 300, 300), (63, 3), 16),
])
def test_shapes_that_force_each_cluster_size(shape, taps, c):
    plan = _plan(*shape, *taps)
    _covers(plan, *shape)
    assert plan.clusters == c


@pytest.mark.parametrize("B", [1, 7, 64, 200])
@pytest.mark.parametrize("H,W", [(1, 8), (17, 23), (33, 700), (256, 256), (255, 257),
                                 (1000, 60), (60, 1000), (4096, 16), (2, 9600)])
@pytest.mark.parametrize("schedule", SCHEDULES, ids=str)
def test_every_resident_plan_covers_its_shape_and_fits(B, H, W, schedule):
    plan = _plan(B, H, W, 9, 9, schedule)
    _covers(plan, B, H, W)
    # beyond the smallest size that fits (the plan of a batch too large to
    # spread), a batch is spread only as far as the card holds all of it
    least = _plan(SMS + 1, H, W, 9, 9, schedule).clusters
    assert plan.clusters == least or B <= dict(H100_RESIDENT)[plan.clusters]


@pytest.mark.parametrize("H,W,c", [(256, 256, 8), (300, 300, 16), (150, 150, 4), (9, 33, 1),
                                   (2, 9600, 2), (4096, 16, 8)])
def test_the_row_map_owns_every_row_once_and_reaches_every_radius(H, W, c):
    """locate(row) names the one CTA whose band holds the row; from every
    row of every band each row within 31 (the widest stencil radius)
    inside the image resolves to a real row of some band, and the
    kernel's row table (rows + 2·HALO entries from r0 − HALO) holds it."""
    plan = _plan(64, H, W, 63, 63)
    assert plan.clusters == c
    owned = {}
    for rank in range(c):
        for lr in range(plan.band_rows(rank)):
            row = rank * plan.rows + lr
            assert row not in owned
            owned[row] = (rank, lr)
    assert sorted(owned) == list(range(H))
    for row in range(H):
        assert plan.locate(row) == owned[row]
    assert fused.HALO == 31
    for rank in range(c):
        r0 = rank * plan.rows
        for lr in range(plan.band_rows(rank)):
            for s in range(-fused.HALO, fused.HALO + 1):
                r = r0 + lr + s
                if not 0 <= r < H:
                    continue
                q, l = plan.locate(r)
                assert 0 <= q < c and 0 <= l < plan.band_rows(q)
                assert 0 <= r - (r0 - fused.HALO) < plan.rows + 2 * fused.HALO


def test_cluster_smem_bytes_counts_every_piece():
    # 32 rows of 256: six f32 planes, 3 × 32 + 8 float64 sums, 7 int64
    # phase clocks, 32 + 62 row pointers, 126 f32 taps
    assert fused.cluster_smem_bytes(32, 256) == 6 * 32768 + 832 + 56 + 752 + 504
    # each plane rounded up to 4 floats: 3 × 5 = 15 → 16
    assert fused.cluster_smem_bytes(3, 5) == 6 * 64 + 832 + 56 + 8 * 65 + 504


@pytest.mark.parametrize("W", [9_700, 20_000, 65_536])
def test_a_too_wide_row_takes_the_global_route(W):
    """A band of one row of W > 9,607 pixels needs more than 232,448 bytes."""
    plan = _plan(4, 2, W, 9, 9)
    assert (plan.route, plan.rows, plan.ctas) == ("global", 2, 4)


@pytest.mark.parametrize("sms,smem,route,c", [
    # cards that are not an H100, each taken to hold sms // c clusters of c:
    # fewer SMs cap the cluster and the spreading
    (8, SMEM, "resident", 8),
    (4, SMEM, "global", 1),
    # less shared memory: more bands, or none that fit
    (SMS, 120_000, "resident", 16),
    (SMS, 48 * 1024, "global", 1),
])
def test_plans_respect_the_card(sms, smem, route, c):
    held = tuple((c, sms // c) for c in fused.CLUSTER_SIZES)
    plan = _plan(64, 256, 256, 9, 9, resident=held, sms=sms, smem_max=smem)
    assert (plan.route, plan.clusters) == (route, c)
    if route == "resident":
        _covers(plan, 64, 256, 256, sms=sms, smem=smem)


@pytest.mark.parametrize("shape,taps,match", [
    ((0, 8, 8), (3, 3), "empty shape 0 x 8x8"),
    ((2, 0, 8), (3, 3), "empty shape 2 x 0x8"),
    ((2, 8, 8), (65, 3), "65 x 3 taps"),
    # rows wider than any band and 2³¹ pixels per problem: no route
    ((1, 2, 2**30), (3, 3), "no route for 1 x 2x1073741824"),
])
def test_a_shape_without_a_route_raises_and_names_it(shape, taps, match):
    with pytest.raises(ValueError, match=match):
        _plan(*shape, *taps)


def test_the_planner_checks_the_schedule():
    with pytest.raises(ValueError, match="FISTA/POGM-only"):
        _plan(2, 8, 8, 3, 3, ("optista", "gradient", False, False))
