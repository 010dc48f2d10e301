"""The fused FISTA-L1-DFT kernel's planner (rls_tpu_torch/kernels/
fista_l1_dft_fused.py ``plan_fista_l1_dft``) and a Python model of its
resident route, on the CPU.

The planner: which route and cluster size a shape takes on an H100 (132
SMs, 232,448 bytes of shared memory per block) over shapes from 2² to
1024² and batches of 1 to 64, that every resident plan splits H into
bands and W into blocks as ``split_part`` does (evenly where a power of
two divides both sides and fits, else parts that differ by one) and fits
the card, that its cost (waves × rows per band) is the least among the
sizes it may take, that a shape with an even plan keeps it, that the
shared-memory count matches the kernel's piece by piece, that a spectrum
whose bands fit no cluster takes the grid route (its plans and model:
tests/test_torch_dft_grid.py), and that a plan the card holds no cluster
of, or a forced size that does not fit, raises.

The model: one problem's normal op and FISTA iterations computed CTA by
CTA in the resident kernel's phases (csrc/fista_l1_dft_fused.cu): rows
forward on each band, each point pushed to the block of the CTA that owns
its column, cluster barrier A, the column pass on each block with its
write-back into the bands, cluster barrier B, rows back on each band and
the pixel update. Each line runs through the register layout model of
tests/test_torch_splitbregman_plan.py. A push lands in the other CTA's
shared memory only at the next barrier, and the model raises where a CTA
touches a buffer of its own that another CTA writes between the same two
barriers. It is held bit for bit against ``_dft_common.real_normal`` and
``fista_l1_dft_fused_torch`` at even and uneven splits, and it raises
when either barrier is dropped. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rls_tpu_torch.kernels import _dft_common as dft
from rls_tpu_torch.kernels import fista_l1_dft_fused as l1dft
from rls_tpu_torch.kernels._bands import fewest_waves
from rls_tpu_torch.kernels.fista_tv_fused import MIN_CTA_PIXELS, _momentum_table
from test_torch_splitbregman_plan import LINE_MAX, line_model

SMS, SMEM = 132, 232_448
# the clusters of c resident CTAs of a kernel of 1024 threads that an H100
# 80GB HBM3 holds at once (cudaOccupancyMaxActiveClusters), as rows 10 and
# 11 measured them; tests/test_torch_cuda.py checks the table for this
# kernel on the card
H100_RESIDENT = tuple(zip(range(1, 17), (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7,
                                         7)))
SIZES = [2**k for k in range(1, 11)]
CSRC = Path(l1dft.__file__).parents[1] / "csrc"


def _plan(B, H, W, resident=H100_RESIDENT, **card):
    return l1dft.plan_fista_l1_dft(B, H, W, resident, **card)


def _resident(B, H, W, c):
    """The resident plan of c CTAs per problem (the model runs every size
    the kernel takes that fits, not only the planner's choice)."""
    assert c in l1dft.cluster_sizes(H, W)
    return l1dft.DftPlan("resident", c, -(-H // c), -(-W // c), H, W, B * c,
                         l1dft.resident_smem_bytes(H, W, c))


def band(plan, rank):
    """[r0, r1): the image rows CTA `rank` owns (its x, x_prev and spectrum
    band): H // c rows, one more for the first H % c ranks."""
    q, extra = divmod(plan.H, plan.clusters)
    r0 = rank * q + min(rank, extra)
    return r0, r0 + q + (rank < extra)


def block(plan, rank):
    """[c0, c1): the spectrum columns CTA `rank` transforms, split as the
    rows are."""
    q, extra = divmod(plan.W, plan.clusters)
    c0 = rank * q + min(rank, extra)
    return c0, c0 + q + (rank < extra)


def row_owner(plan, row):
    """The CTA whose band holds image (spectrum) row `row`: where the
    column pass writes that row back."""
    return next(q for q in range(plan.clusters) if band(plan, q)[0] <= row < band(plan, q)[1])


def column_owner(plan, col):
    """The CTA whose block holds spectrum column `col`: where the row pass
    pushes that column."""
    return next(q for q in range(plan.clusters) if block(plan, q)[0] <= col < block(plan, q)[1])


# tests/test_torch_cuda.py's FISTA-L1-DFT shapes (B, H, W) with the cluster
# size each takes on an H100 (None: the grid route): every size from 1 to
# 16, lines of 2 to 1024 points, with and without a shared-memory stage
L1DFT_SIZES = {(3, 16, 32): 1, (3, 2, 4): 1, (3, 8, 256): 1, (64, 128, 128): 2,
               (16, 128, 128): 4, (3, 16, 1024): 4, (3, 1024, 16): 4, (64, 256, 256): 8,
               (16, 256, 256): 16, (3, 256, 512): 16, (4, 512, 512): None}
# the grid CTAs an H100 80GB HBM3 holds at once: one of 1024 threads a SM
# (tests/test_torch_cuda.py checks it on the card)
H100_GRID = 132
# the grid route's shapes that chip_smoke.py and the card tests run, (B, H,
# W) → (team, slots, rows, cols, row_lines, col_lines) on an H100
# (tests/test_torch_dft_grid.py holds the planner to them)
GRID_PLANS = {(4, 512, 512): (33, 4, 16, 16, 16, 16), (4, 640, 640): (33, 4, 20, 20, 20, 20),
              (4, 448, 448): (33, 4, 14, 14, 14, 14), (2, 1024, 1024): (66, 2, 16, 16, 16, 16),
              (16, 512, 512): (8, 16, 64, 64, 32, 32), (2, 1024, 256): (66, 2, 16, 4, 16, 4),
              (1, 385, 385): (132, 1, 3, 3, 3, 3)}


def _covers(plan, B, H, W, smem=SMEM):
    """A resident plan's bands cover H and its blocks W, each CTA one of
    each, as the planner's own split gives them; evenly at a size that is a
    power of two dividing both sides; it fits the card."""
    assert plan.route == "resident"
    c = plan.clusters
    assert c in l1dft.cluster_sizes(H, W, smem_max=smem)
    bands, blocks = [band(plan, q) for q in range(c)], [block(plan, q) for q in range(c)]
    assert bands == [plan.band(q) for q in range(c)]
    assert blocks == [plan.block(q) for q in range(c)]
    assert [r for b in bands for r in range(*b)] == list(range(H))
    assert [k for b in blocks for k in range(*b)] == list(range(W))
    assert (plan.rows, plan.cols) == (max(b - a for a, b in bands), max(b - a for a, b in blocks))
    if c in l1dft.CLUSTER_SIZES and H % c == 0 and W % c == 0:
        assert (plan.rows * c, plan.cols * c) == (H, W)
    assert plan.ctas == B * c
    assert plan.smem == l1dft.resident_smem_bytes(H, W, c) <= smem


# ---- the planner


@pytest.mark.parametrize("B,want", [
    # the CS cell: 8 or 16 bands fit (200,776 or 102,472 bytes); 16 bands of
    # 16 rows take 3 waves of ≤ 7 clusters (cost 48), 8 bands of 32 rows 2
    # waves of ≤ 15 (cost 64)
    (16, (16, 16, 16, 102_472)),
    (1, (16, 16, 16, 102_472)),
    (7, (16, 16, 16, 102_472)),
    # 64 problems: 10 waves of 16 rows tie with 5 waves of 32: the smaller
    (64, (8, 32, 32, 200_776)),
])
def test_plans_at_the_cs_cell(B, want):
    plan = _plan(B, 256, 256)
    _covers(plan, B, 256, 256)
    assert (plan.clusters, plan.rows, plan.cols, plan.smem) == want


def test_the_cells_fitting_sizes():
    assert l1dft.fitting_sizes(256, 256) == (8, 16)
    assert l1dft.fitting_sizes(128, 128) == (2, 4, 8, 16)
    assert l1dft.fitting_sizes(512, 512) == ()
    assert l1dft.fitting_sizes(1024, 1024) == ()


@pytest.mark.parametrize("B", [1, 7, 16, 64])
@pytest.mark.parametrize("H", SIZES)
@pytest.mark.parametrize("W", SIZES)
def test_every_plan_covers_its_shape_and_is_the_cheapest(B, H, W):
    """Where a band fits, the plan is resident, covers H and W and fits,
    with the fewest waves × rows per band among the sizes it may take
    (ties to the smaller); where none fits, it is the grid route, a team
    of CTAs a problem that the card holds, its rounds covering B."""
    fit = l1dft.fitting_sizes(H, W)
    plan = _plan(B, H, W)
    if not fit:
        team = plan.clusters
        assert (plan.route, plan.rows, plan.cols) == ("grid", -(-H // team), -(-W // team))
        assert plan.ctas == team * plan.slots <= SMS and plan.slots * plan.rounds >= B
        assert [r for q in range(team) for r in range(*plan.band(q))] == list(range(H))
        assert [k for q in range(team) for k in range(*plan.block(q))] == list(range(W))
        assert 0 < plan.smem <= SMEM
        return
    _covers(plan, B, H, W)
    held = dict(H100_RESIDENT)

    def cost(c):
        return -(-B // held[c]) * (H // c)

    allowed = [c for c in fit if c == fit[0] or H // c * W >= MIN_CTA_PIXELS]
    assert plan.clusters in allowed
    assert cost(plan.clusters) == min(cost(c) for c in allowed)
    assert all(c >= plan.clusters for c in allowed if cost(c) == cost(plan.clusters))


@pytest.mark.parametrize("H", SIZES)
@pytest.mark.parametrize("W", SIZES)
def test_the_global_route_is_where_no_band_fits(H, W):
    """Only spectra past ~256 K points leave the clusters, for the grid
    route (the global route's place): 512 × 512 and larger, and 1024 × 256
    either way."""
    fit = l1dft.fitting_sizes(H, W)
    assert bool(fit) == (H * W <= 2**17)
    assert _plan(4, H, W).route == ("resident" if fit else "grid")
    assert all(l1dft.resident_smem_bytes(H, W, c) <= SMEM for c in fit)
    assert all(l1dft.resident_smem_bytes(H, W, c) > SMEM
               for c in l1dft.CLUSTER_SIZES if c <= min(H, W) and c not in fit)


@pytest.mark.parametrize("shape", list(L1DFT_SIZES))
def test_the_card_tests_shapes_take_their_cluster_sizes(shape):
    """The sizes tests/test_torch_cuda.py asserts on the card."""
    plan = _plan(*shape)
    if L1DFT_SIZES[shape] is None:
        assert plan.route == "grid"
    else:
        _covers(plan, *shape)
        assert plan.clusters == L1DFT_SIZES[shape]


# phase 3h's shapes of the uneven route (chip_smoke.py MIXED_L1DFT): (B, H,
# W) → (c, rows, cols, smem): BASELINE #2 at a prime side of 97 rows, an
# odd side, a side no power of two of a fitting size divides, and an 81 %
# phase field of view; each the fewest waves × rows per band that keeps
# MIN_CTA_PIXELS (97 × 128: c = 3, as 4 leaves 25 · 128 < 4096 pixels a
# CTA; 225²: 12; 300² and 320 × 260: 16, 3 waves of ≤ 7)
UNEVEN_PLANS = {(2, 97, 128): (3, 33, 43, 102_712), (4, 225, 225): (12, 19, 19, 106_296),
                (16, 300, 300): (16, 19, 19, 141_688), (16, 320, 260): (16, 20, 17, 131_688)}


@pytest.mark.parametrize("shape", list(UNEVEN_PLANS))
def test_the_uneven_plans_of_phase_3h(shape):
    plan = _plan(*shape)
    _covers(plan, *shape)
    assert (plan.clusters, plan.rows, plan.cols, plan.smem) == UNEVEN_PLANS[shape]
    fit = l1dft.fitting_sizes(*shape[1:])
    # no even size fits: every fitting size is offered
    assert fit == l1dft.cluster_sizes(*shape[1:])
    assert not any(shape[1] % c == 0 and shape[2] % c == 0 for c in fit if c in (1, 2, 4, 8, 16))
    assert plan.clusters == fewest_waves(*shape, fit, H100_RESIDENT)


EVEN_SIDES = [8, 16, 24, 40, 64, 96, 128, 160, 192, 256, 320, 448, 512]


@pytest.mark.parametrize("B", [1, 4, 16, 64])
@pytest.mark.parametrize("H", EVEN_SIDES)
@pytest.mark.parametrize("W", EVEN_SIDES + [17, 97, 704])
def test_a_shape_with_an_even_plan_keeps_it(B, H, W):
    """Where a power of two up to 16 that divides H and W fits, the plan is
    the even one the planner gave before uneven parts: among those sizes
    alone, by the same rule, with H/c-row bands and W/c-column blocks."""
    even = tuple(c for c in (1, 2, 4, 8, 16)
                 if H % c == 0 and W % c == 0 and l1dft.resident_smem_bytes(H, W, c) <= SMEM)
    plan = _plan(B, H, W)
    if not even:
        assert plan.route == "grid" or plan.clusters not in even
        return
    c = fewest_waves(B, H, W, even, H100_RESIDENT)
    assert l1dft.fitting_sizes(H, W) == even
    assert (plan.route, plan.clusters, plan.rows, plan.cols, plan.smem) == (
        "resident", c, H // c, W // c, l1dft.resident_smem_bytes(H, W, c))


@pytest.mark.parametrize("shape,sizes", [
    ((97, 128), tuple(range(2, 17))), ((300, 300), tuple(range(10, 17))),
    ((346, 346), tuple(range(13, 17))), ((3, 1021), (1, 2, 3)), ((20, 1000), tuple(range(3, 17))),
    # at powers of two only the even sizes, which the kernel's shifts need
    ((1024, 64), (8, 16)), ((512, 512), ())])
def test_the_sizes_the_kernel_takes(shape, sizes):
    """Every c from 1 to min(16, H, W) whose largest band and block fit,
    where a side is not a power of two; powers of two dividing both sides
    where both are."""
    assert l1dft.cluster_sizes(*shape) == sizes
    fit = l1dft.fitting_sizes(*shape)
    assert fit == (tuple(c for c in sizes if c in (1, 2, 4, 8, 16) and shape[0] % c == 0
                         and shape[1] % c == 0) or sizes)


@pytest.mark.parametrize("shape,c", [((16, 320, 320), 12), ((16, 320, 320), 16),
                                     ((2, 97, 128), 16), ((16, 300, 300), 10)])
def test_a_forced_size_gives_its_plan(shape, c):
    plan = _plan(*shape, clusters=c)
    _covers(plan, *shape)
    assert plan.clusters == c


@pytest.mark.parametrize("shape,c", [((16, 300, 300), 9), ((16, 256, 256), 12),
                                     ((16, 256, 256), 4), ((4, 97, 128), 17),
                                     ((4, 512, 512), 16)])
def test_a_forced_size_that_does_not_fit_raises(shape, c):
    """No fallback: a forced size the kernel does not take at the shape (a
    band too large, not a power of two at a power-of-two shape, past 16)
    is an error naming it."""
    with pytest.raises(ValueError, match=f"a cluster of {c} CTAs does not fit"):
        _plan(*shape, clusters=c)


@pytest.mark.parametrize("H,W,c", [(256, 256, 16), (256, 256, 8), (128, 128, 4), (16, 64, 2),
                                   (64, 32, 16), (2, 4, 1), (1024, 16, 4),
                                   # uneven: one side or both, bands of
                                   # one and two rows, the phase 3h shapes
                                   (13, 24, 3), (13, 24, 5), (17, 12, 7), (24, 40, 16),
                                   (97, 128, 3), (225, 225, 12), (300, 300, 16),
                                   (320, 260, 16)])
def test_every_row_and_column_has_one_owner(H, W, c):
    """The model's bands and blocks partition the rows and the columns, and
    row_owner and column_owner name the one CTA whose band and block hold
    each; no two parts differ by more than one."""
    plan = _resident(3, H, W, c)
    rows = [r for q in range(c) for r in range(*band(plan, q))]
    cols = [k for q in range(c) for k in range(*block(plan, q))]
    assert rows == list(range(H)) and cols == list(range(W))
    for q in range(c):
        assert all(row_owner(plan, r) == q for r in range(*band(plan, q)))
        assert all(column_owner(plan, k) == q for k in range(*block(plan, q)))
    for parts in ([band(plan, q) for q in range(c)], [block(plan, q) for q in range(c)]):
        sizes = [b - a for a, b in parts]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_the_shared_memory_is_counted_piece_by_piece():
    # the cell at c = 16: 512 f32 twiddles, x, x_prev and the band's (re,
    # im) of 16 × 256 f32 each, the block's (re, im) of 256 × 17 f32
    # each, 9 int64 phase clocks
    assert l1dft.resident_smem_bytes(256, 256, 16) == 4 * (512 + 4 * 4096 + 2 * 4352) + 72
    assert l1dft.resident_smem_bytes(256, 256, 8) == 4 * (512 + 4 * 8192 + 2 * 8448) + 72
    # every array rounded up to 4 floats: 2 + 4 twiddles → 8, a band of 1 ×
    # 2 → 4, a block of 2 × (2 + 1) = 6 → 8
    assert l1dft.resident_smem_bytes(2, 4, 2) == 4 * (8 + 4 * 4 + 2 * 8) + 72
    # uneven: 97 × 128 on 3 counts the largest band, 33 × 128, and the
    # largest block at its pitch, 97 × (43 + 1); 2 · (49 + 64) = 226
    # twiddles (⌊97/2⌋ + 1 at the odd side) → 228
    assert l1dft.resident_smem_bytes(97, 128, 3) == 4 * (228 + 4 * 4224 + 2 * 4268) + 72
    assert len(l1dft.PHASES) == 9


def _cu_constant(text, name):
    got = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(got) == 1, name
    return int(got[0])


def test_the_planner_and_the_model_read_the_kernel_s_constants():
    """The kernel's cluster sizes, threads, phases and shared-memory count,
    and the sub-line length the model's layout assumes, as the .cu files
    state them."""
    src = (CSRC / "fista_l1_dft_fused.cu").read_text()
    assert _cu_constant(src, "kMaxCluster") == max(l1dft.CLUSTER_SIZES) == 16
    assert _cu_constant(src, "kThreads") == 1024
    phases = re.search(r"enum \{\s*(kSetup[^}]*)\}", src).group(1)
    names = [p.strip() for p in phases.split(",") if p.strip()]
    assert names[-1] == "kPhases" and len(names) - 1 == len(l1dft.PHASES)
    smem = re.search(r"resident_smem_bytes\(int H, int W, int clusters\) \{(.*?)\n\}", src,
                     re.S).group(1)
    assert "rls::split_band_floats(H, W, clusters)" in smem
    assert "rls::split_block_floats(H, W, clusters)" in smem
    assert "ceil4(rls::twiddle_floats(H, W)) + 4 * band + 2 * block)" in smem
    split = (CSRC / "split.cuh").read_text()
    assert "ceil4(static_cast<size_t>(ceil_div(H, team)) * W)" in split
    assert "ceil4(static_cast<size_t>(H) * (ceil_div(W, team) + 1))" in split
    valid = re.search(r"bool valid_cluster\(int clusters, int H, int W\) \{(.*?)\n\}", src,
                      re.S).group(1)
    assert "clusters > kMaxCluster || clusters > H || clusters > W" in valid
    assert "!rls::pow2_shape(H, W) || (clusters & (clusters - 1)) == 0" in valid
    assert "sizeof(long long) * kPhases" in smem
    header = (CSRC / "fft_resident.cuh").read_text()
    assert _cu_constant(header, "kLineMax") == LINE_MAX


@pytest.mark.parametrize("sms,smem,route,c", [
    # fewer SMs cap the cluster size; with 4 no band fits: the grid route,
    # 4 slots of one CTA (its team) on a card that holds 4
    (8, SMEM, "resident", 8),
    (4, SMEM, "grid", 1),
    # more shared memory lets 4 bands fit (held 33 times: one wave of 64
    # rows, against 8 bands' and 16 bands' one and two waves of 32 and 16
    # rows: 8 is the smaller of the tie); less leaves 16 bands, then none
    (SMS, 400_000, "resident", 8),
    (SMS, 200_000, "resident", 16),
    # no band fits: the grid route, 16 slots of 8 CTAs
    (SMS, 100_000, "grid", 8),
])
def test_plans_respect_the_card(sms, smem, route, c):
    held = tuple((k, sms // k) for k in range(1, 17))
    plan = _plan(16, 256, 256, held, sms=sms, smem_max=smem)
    assert (plan.route, plan.clusters) == (route, c)
    if route == "resident":
        _covers(plan, 16, 256, 256, smem=smem)


@pytest.mark.parametrize("args,match", [
    ((0, 256, 256), "empty batch of 0 x 256x256"),
    ((4, 1025, 128), "from 2 to 1024, got 1025x128"),
    ((4, 256, 2048), "from 2 to 1024, got 256x2048"),
    ((4, 1, 8), "from 2 to 1024, got 1x8"),
])
def test_a_shape_without_a_plan_raises_and_names_it(args, match):
    with pytest.raises(ValueError, match=match):
        _plan(*args)


@pytest.mark.parametrize("resident", [(), ((8, 0), (16, 0)), ((1, 132),)])
def test_a_resident_plan_the_card_cannot_hold_raises(resident):
    """No fallback: the resident route where the card holds none of its
    clusters is an error naming the plan, not a quiet global launch."""
    with pytest.raises(ValueError, match=r"holds no cluster of DftPlan\(route='resident'"):
        _plan(16, 256, 256, resident)


def test_the_global_route_needs_no_residency():
    """512² leaves the clusters for the grid route, which reads no
    cluster count (its own count of CTAs, one a SM on an H100)."""
    assert _plan(4, 512, 512, ()).route == "grid"


@pytest.mark.parametrize("rho,lam", [(0.9, [1e-2, 0.0, 0.1]), (0.95, 2e-3), ([0.9, 0.8, 0.7], 1e-3),
                                     (np.float32(0.5), np.float32(3e-3)), (1, 0)])
@pytest.mark.parametrize("shape", [(16, 32), (256, 8), (2, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_kernel_s_arguments_are_the_plain_version_s(rho, lam, shape, dtype):
    """What the wrapper hands the kernel and the plain version (ρ and λ
    filled on the device where they are numbers, the shared tables) equals
    the same made afresh by host-to-device copies (here on CPU tensors),
    twice in a row, the second time with the same table tensors."""
    rng = np.random.default_rng(sum(shape))
    x0 = torch.from_numpy(rng.normal(size=(3, *shape))).to(dtype)
    mask = torch.from_numpy((rng.uniform(size=shape) < 0.4).astype(np.float32))

    def t(v):
        return torch.tensor(v) if isinstance(v, list) else v

    def per_problem(v):
        return torch.broadcast_to(torch.as_tensor(v, dtype=dtype).reshape(-1), (3,))

    np_dt = torch.empty((), dtype=dtype).numpy().dtype
    H, W = shape
    rh, rw = torch.as_tensor(dft.digit_reverse(H)), torch.as_tensor(dft.digit_reverse(W))
    want = (torch.stack([per_problem(t(rho)), per_problem(t(lam))], dim=1),
            torch.as_tensor(_momentum_table("fista", 9, dtype=np_dt)),
            (torch.as_tensor(dft.twiddles(H, np_dt)), torch.as_tensor(dft.twiddles(W, np_dt)),
             mask.to(dtype)[rh][:, rw] * (1.0 / (H * W))))
    first = l1dft._kernel_args(x0, mask, t(rho), t(lam), 9)
    for got in (first, l1dft._kernel_args(x0, mask, t(rho), t(lam), 9)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
        assert got[0].dtype == got[1].dtype == got[2][2].dtype == dtype
        assert got[1] is first[1] and got[2][0] is first[2][0] and got[2][1] is first[2][1]


def test_a_mask_of_another_shape_raises():
    with pytest.raises(ValueError, match=r"a mask of \(16, 16\) for images of 16x32"):
        l1dft.fista_l1_dft_fused(torch.zeros(2, 16, 32), torch.ones(16, 16), 0.9, 1e-3, 2)


# ---- a Python model of the resident route


class Hazard(AssertionError):
    """A CTA touched a buffer of its own that another CTA writes between
    the same two cluster barriers."""


class ClusterModel:
    """The shared memory of one problem's cluster, CTA by CTA: x, x_prev
    and the band's spectrum ("band") of the CTA's R rows, and the column
    block ("block") of all H rows of its Wc columns (R and Wc of ``band``
    and ``block``: equal for every CTA, or differing by one). A CTA reads
    and writes its own buffers as they stand; it reaches another CTA only
    by pushes, which land at the next barrier (`barrier`), as DSMEM stores
    are ordered for their reader only by a cluster barrier. Between two
    barriers a buffer that receives pushes must not be touched by its
    owner (`barrier` raises Hazard), and no point may be pushed twice in
    one window."""

    def __init__(self, plan):
        self.plan = plan
        H, W = plan.H, plan.W
        zeros = torch.zeros
        self.bufs = []
        for q in range(plan.clusters):
            (r0, r1), (c0, c1) = band(plan, q), block(plan, q)
            R, Wc = r1 - r0, c1 - c0
            self.bufs.append({"x": zeros(R, W), "x_prev": zeros(R, W),
                              "band": (zeros(R, W), zeros(R, W)),
                              "block": (zeros(H, Wc), zeros(H, Wc))})
        self.pending, self.touched = [], set()

    def touch(self, q, name):
        self.touched.add((q, name))

    def push(self, q, name, rows, cols, re, im):
        """Store (re, im) at rows × cols (two ranges) of CTA q's buffer
        `name`; it lands at the next barrier."""
        self.pending.append((q, name, rows, cols, re, im))

    def barrier(self):
        pushed = {(q, name) for q, name, *_ in self.pending}
        met = pushed & self.touched
        if met:
            raise Hazard(f"touched by its owner and pushed to between two barriers: "
                         f"{sorted(met)}")
        hits = {}
        for q, name, rows, cols, re, im in self.pending:
            shape = self.bufs[q][name][0].shape
            count = hits.setdefault((q, name), torch.zeros(shape, dtype=torch.int32))
            count[rows[0]:rows[1], cols[0]:cols[1]] += 1
            self.bufs[q][name][0][rows[0]:rows[1], cols[0]:cols[1]] = re
            self.bufs[q][name][1][rows[0]:rows[1], cols[0]:cols[1]] = im
        assert all(int(c.max()) == 1 for c in hits.values()), "a point pushed twice"
        self.pending, self.touched = [], set()


def _rows_forward(m, q, x_mom):
    """(a) on CTA q: the band's rows forward, each point pushed to the
    block of its column's owner."""
    plan = m.plan
    tw_w = m.tables[1]
    m.touch(q, "band")  # the row pass stages its spectrum in the band
    re, im = line_model(x_mom, torch.zeros_like(x_mom), tw_w)
    m.bufs[q]["band"] = (re.clone(), im.clone())
    r0, r1 = band(plan, q)
    for o in range(plan.clusters):  # columns k of CTA column_owner(k)'s block
        c0, c1 = block(plan, o)
        assert all(column_owner(plan, k) == o for k in range(c0, c1))
        m.push(o, "block", (r0, r1), (0, c1 - c0), re[:, c0:c1], im[:, c0:c1])


def _columns(m, q):
    """(b) on CTA q: its block's columns forward, the transposed weights,
    back, each point written back to the band of its row's owner."""
    plan = m.plan
    tw_h, _, weights = m.tables
    c0, c1 = block(plan, q)
    m.touch(q, "block")
    bre, bim = (t.T.contiguous() for t in m.bufs[q]["block"])  # lines are columns
    re, im = line_model(bre, bim, tw_h)
    wt = weights.T[c0:c1]
    re, im = line_model(re * wt, im * wt, tw_h, inverse=True)
    for o in range(plan.clusters):  # rows k of CTA row_owner(k)'s band
        r0, r1 = band(plan, o)
        assert all(row_owner(plan, k) == o for k in range(r0, r1))
        m.push(o, "band", (0, r1 - r0), (c0, c1), re[:, r0:r1].T, im[:, r0:r1].T)


def _rows_back(m, q):
    """(c) on CTA q: the band's rows back; the real part."""
    m.touch(q, "band")
    re, im = m.bufs[q]["band"]
    return line_model(re, im, m.tables[1], inverse=True)[0]


def cluster_normal(x, plan, tables, barriers=("A", "B")):
    """Re(Fᴴ M F x) of one real image x (H, W) by the resident route's
    phases: (a) on every CTA, barrier A, (b) on every CTA, barrier B, (c)."""
    m = ClusterModel(plan)
    m.tables = tables
    for q in range(plan.clusters):
        _rows_forward(m, q, x[slice(*band(plan, q))])
    if "A" in barriers:
        m.barrier()
    for q in range(plan.clusters):
        _columns(m, q)
    if "B" in barriers:
        m.barrier()
    out = torch.cat([_rows_back(m, q) for q in range(plan.clusters)])
    m.barrier()  # the next one (the next iteration's A), where a race shows
    return out


def cluster_fista(x0hat, scal, tab, plan, tables, barriers=("A", "B")):
    """FISTA-L1 on one problem (x0hat (H, W), scal (2,)) by the resident
    route: the set-up's barrier, then per iteration (a) from x_mom, A, (b),
    B, (c) with the pixel update on each band (x_mom recomputed from x and
    x_prev, which only their owner touches)."""
    m = ClusterModel(plan)
    m.tables = tables
    rho, lam = scal[0], scal[1]
    t = rho * lam
    eps = torch.finfo(torch.float32).eps
    m.barrier()  # the set-up's
    for i in range(tab.shape[0]):
        a = tab[i, 0]

        def mom(q):
            x, xp = m.bufs[q]["x"], m.bufs[q]["x_prev"]
            return x + a * (x - xp)

        for q in range(plan.clusters):
            _rows_forward(m, q, mom(q))
        if "A" in barriers:
            m.barrier()
        for q in range(plan.clusters):
            _columns(m, q)
        if "B" in barriers:
            m.barrier()
        for q in range(plan.clusters):
            nr = _rows_back(m, q)
            x_mom = mom(q)
            xg = x_mom - rho * (nr - x0hat[slice(*band(plan, q))])
            mag = xg.abs()
            m.bufs[q]["x_prev"] = m.bufs[q]["x"]
            m.bufs[q]["x"] = torch.clamp(mag - t, min=0.0) * (xg + eps) / (mag + eps)
    m.barrier()
    return torch.cat([m.bufs[q]["x"] for q in range(plan.clusters)])


MODEL_SHAPES = [(16, 16), (32, 32), (16, 64), (64, 32), (8, 256), (256, 8),
                # sides with odd factors: 24 = 3·8 and 40 = 5·8 (c ≤ 8 divides
                # both), 96 = 3·32 and 192 = 3·64 (bands fit from c = 2), and
                # a prime side (c = 1)
                (24, 40), (96, 192), (17, 32)]
# uneven splits: c dividing one side or neither (13 × 24 on 3 and 5, 17 ×
# 12 on 7), bands of one and two rows (24 × 40 on 16), and a prime side on
# 3, as 97 × 128 runs (23 × 32: bands of 8, 8 and 7 rows, blocks of 11, 11
# and 10 columns)
UNEVEN_CASES = [((13, 24), 3), ((13, 24), 5), ((17, 12), 7), ((24, 40), 3), ((24, 40), 16),
                ((23, 32), 3)]
MODEL_CASES = ([(shape, c) for shape in MODEL_SHAPES for c in l1dft.fitting_sizes(*shape)]
               + UNEVEN_CASES)


def _problem(H, W, B=2, seed=9):
    rng = np.random.default_rng(seed + H * W)
    x0 = torch.from_numpy(rng.normal(size=(B, H, W)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(H, W)) < 0.4).astype(np.float32))
    return x0, dft.dft_tables(mask)


def test_the_model_covers_every_cluster_size_and_a_two_stage_line():
    """Every size up to 16 at 16², 32², 16 × 64 and 64 × 32, and 256-point
    lines (one shared-memory stage: the fused first and last stages)."""
    for shape in MODEL_SHAPES[:4]:
        assert l1dft.fitting_sizes(*shape) == (1, 2, 4, 8, 16)
    assert l1dft.fitting_sizes(8, 256) == (1, 2, 4, 8)
    assert 256 > LINE_MAX


@pytest.mark.parametrize("shape,c", MODEL_CASES)
def test_the_cluster_normal_op_is_the_plain_one_bit_for_bit(shape, c):
    x0, tables = _problem(*shape)
    plan = _resident(1, *shape, c)
    got = cluster_normal(x0[0], plan, tables)
    assert torch.equal(got, dft.real_normal(x0[:1], tables)[0])


@pytest.mark.parametrize("shape,c", MODEL_CASES)
def test_the_cluster_fista_is_the_plain_version_bit_for_bit(shape, c):
    x0, tables = _problem(*shape)
    scal = torch.tensor([[0.9, 0.05], [0.7, 0.0]], dtype=torch.float32)
    tab = torch.as_tensor(_momentum_table("fista", 4))
    plan = _resident(2, *shape, c)
    want = l1dft.fista_l1_dft_fused_torch(x0, scal, tab, tables)
    for b in range(2):
        assert torch.equal(cluster_fista(x0[b], scal[b], tab, plan, tables), want[b])


@pytest.mark.parametrize("shape,c", [((16, 16), 4), ((8, 256), 8), ((64, 32), 2), ((13, 24), 5)])
@pytest.mark.parametrize("dropped,buffer", [("A", "block"), ("B", "band")])
def test_each_cluster_barrier_is_needed(shape, c, dropped, buffer):
    """Without A the column pass reads its block while the row passes push
    into it; without B the rows back read their band while the column
    passes write it back: the model names the buffer."""
    x0, tables = _problem(*shape)
    plan = _resident(1, *shape, c)
    kept = tuple(b for b in ("A", "B") if b != dropped)
    with pytest.raises(Hazard, match=buffer):
        cluster_normal(x0[0], plan, tables, barriers=kept)
    scal = torch.tensor([0.9, 0.05])
    tab = torch.as_tensor(_momentum_table("fista", 2))
    with pytest.raises(Hazard, match=buffer):
        cluster_fista(x0[0], scal, tab, plan, tables, barriers=kept)
