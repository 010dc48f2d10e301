"""The resident SplitBregman kernel's planner and register layout
(rls_tpu_torch/kernels/splitbregman_fused.py ``plan_splitbregman``;
csrc/fft_resident.cuh), on the CPU.

The planner: which route and cluster size a shape takes on an H100 (132
SMs, 232,448 bytes of shared memory per block), that every coil is
transformed exactly once and folded in coil order, that the row bands
cover H (empty where H < c), that the shared memory is counted piece by
piece, and that a shape without a plan raises.

The layout: a Python model of which lane holds which point at each stage,
as the .cu uses it (the odd stages of an n = r·2ᵃ line in shared memory,
group by group as csrc/fft_mixed.cuh indexes them; then teams of T lanes,
P points per lane, sub-lines of L points of the 2ᵃ-point runs; spans ≥ L
in shared memory, spans ≥ T in a lane's registers, spans < T across lanes
by xor shuffles, each lane computing its own output of a butterfly). A
DIF / DIT run through the model must equal ``_dft_common.fft_dif`` /
``ifft_dit`` bit for bit at every power of two from 2 to 1024 and at sizes
with odd factors (3 … 1021), and a whole SENSE normal op (rows, columns with the transposed
weights, rows back, then the banded fold in rank order, round by round)
must equal ``_dft_common.sense_normal`` bit for bit. The kernel itself runs
only on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rls_tpu_torch.kernels import _dft_common as dft
from rls_tpu_torch.kernels import splitbregman_fused as sb

SMS, SMEM = 132, 232_448
# the clusters of c resident CTAs of the kernel that an H100 80GB HBM3
# holds at once, by cudaOccupancyMaxActiveClusters (one CTA of 1024
# threads per SM): the same at every resident shape these tests plan
# (splitbregman_fused.resident_limits; tests/test_torch_cuda.py checks the
# table on the card)
H100_RESIDENT = tuple(zip(range(1, 17), (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7,
                                         7)))
# tests/test_torch_cuda.py FFT_SHAPES, with the route each takes (256 × 128
# on teams of 3 CTAs a coil)
FFT_ROUTES = {(16, 32): "resident", (64, 8): "resident", (2, 4): "resident",
              (256, 128): "split", (1024, 16): "resident", (16, 1024): "resident",
              (512, 512): "grid"}


# the longest sub-line a team of lanes keeps in registers
# (csrc/fft_resident.cuh kLineMax)
LINE_MAX = 128


def _plan(B, H, W, C, resident=H100_RESIDENT, **card):
    return sb.plan_splitbregman(B, H, W, C, resident, **card)


def coils_of(plan, rank):
    """The coils CTA `rank` transforms, round by round: coil ro·c + rank
    in round ro (csrc/splitbregman_fused.cu, the resident kernel's
    ``normal``)."""
    return tuple(range(rank, plan.C, plan.clusters))


def owner(plan, coil):
    """(rank, round) of the CTA that transforms `coil`."""
    return coil % plan.clusters, coil // plan.clusters


def line_layout(n):
    """How the resident kernel holds an n-point line (csrc/fft_resident.cuh):
    (T, P, L): sub-lines of L = min(2ᵃ, LINE_MAX) points (2ᵃ the largest
    power of two dividing n), each held by a team of T = min(32, L) lanes,
    P = L/T points per lane; lane t holds the points s·L + j·T + t (j < P)
    of sub-line s. Stages of span m < T cross lanes, spans T ≤ m < L stay
    in a lane, spans ≥ L and the odd stages go through shared memory."""
    L = min(n & -n, LINE_MAX)
    T = min(32, L)
    return T, L // T, L


def test_the_layout_model_has_the_kernel_s_line_length():
    header = Path(sb.__file__).parents[1] / "csrc" / "fft_resident.cuh"
    got = re.findall(r"constexpr int kLineMax = (\d+);", header.read_text())
    assert got == [str(LINE_MAX)]


def test_the_plan_at_baseline_4():
    """8 slices of 128², 6 coils: a cluster of 6 CTAs per slice, one coil
    each in one round, 128 rows in bands of 22, 22, 21, 21, 21, 21; the
    card holds 17 such clusters, so the 8 run in one wave."""
    plan = _plan(8, 128, 128, 6)
    assert (plan.route, plan.clusters, plan.rounds, plan.ctas) == ("resident", 6, 1, 48)
    assert [plan.band(q) for q in range(6)] == [(0, 22), (22, 44), (44, 65), (65, 86),
                                                (86, 107), (107, 128)]
    assert plan.smem == sb.resident_smem_bytes(128, 128) == 134_048
    assert plan.scratch == sb.RESIDENT_SCRATCH
    assert plan.resident_clusters == 17 >= 8


@pytest.mark.parametrize("C,c,rounds", [(1, 1, 1), (3, 3, 1), (6, 6, 1), (9, 9, 1), (16, 16, 1),
                                        (17, 9, 2), (32, 16, 2), (33, 11, 3)])
def test_every_coil_is_transformed_once_and_folded_in_order(C, c, rounds):
    plan = _plan(8, 128, 128, C)
    assert (plan.clusters, plan.rounds) == (c, rounds)
    got = sorted(k for q in range(c) for k in coils_of(plan, q))
    assert got == list(range(C))
    # round r holds coils r·c … on ranks 0 …: folding the rounds in order
    # and each round's ranks in order folds the coils in order
    order = [r * c + q for r in range(rounds) for q in range(c) if r * c + q < C]
    assert order == list(range(C))
    for k in range(C):
        q, r = owner(plan, k)
        assert k in coils_of(plan, q) and coils_of(plan, q).index(k) == r
    assert all(len(coils_of(plan, q)) <= rounds for q in range(c))


@pytest.mark.parametrize("shape", list(FFT_ROUTES))
@pytest.mark.parametrize("C", [1, 3])
def test_the_routes_of_the_card_tests_shapes(shape, C):
    H, W = shape
    plan = _plan(3, H, W, C)
    assert plan.route == FFT_ROUTES[shape]
    fits = sb.resident_smem_bytes(H, W) <= SMEM
    assert fits == (plan.route == "resident")
    if plan.route == "grid":
        # 3 slots of 44 CTAs, every coil in one round
        assert (plan.clusters, plan.rounds, plan.ctas) == (44, 1, 132)
        assert (plan.smem, plan.scratch, plan.resident_clusters) == (
            sb.GRID_HEAD + 4 * (1024 + 2 * 6156) + 8 * len(sb.GRID_PHASES), sb.GRID_SCRATCH, 132)
        assert plan.band(0) == (0, 12)


@pytest.mark.parametrize("H,C", [(2, 3), (2, 6), (4, 9), (16, 6), (128, 6), (128, 16),
                                 (1024, 3), (8, 16)])
def test_the_bands_cover_h_with_empty_ones_only_where_h_is_short(H, C):
    W = 16 if H > 64 else 32
    plan = _plan(1, H, W, C)
    c = plan.clusters
    bands = [plan.band(q) for q in range(c)]
    assert bands[0][0] == 0 and bands[-1][1] == H
    assert all(a[1] == b[0] for a, b in zip(bands, bands[1:]))
    sizes = [r1 - r0 for r0, r1 in bands]
    assert max(sizes) - min(sizes) <= 1
    assert (min(sizes) == 0) == (H < c)


def test_the_shared_memory_is_counted_piece_by_piece():
    # 128²: 3 × 32 + 2 × 4 + 4 float64 sums, 8 int64 phase clocks, 256 f32
    # twiddles, 2 × 128 · 129 f32 of spectrum
    assert sb.resident_smem_bytes(128, 128) == 864 + 64 + 1024 + 2 * 4 * 16_512
    # rounded up to 4 floats: 2 + 4 twiddles → 8, 2 · 5 = 10 → 12
    assert sb.resident_smem_bytes(2, 4) == 864 + 64 + 4 * 8 + 2 * 4 * 12
    # the largest resident shapes
    assert sb.resident_smem_bytes(1024, 16) == 144_352 <= SMEM
    assert sb.resident_smem_bytes(16, 1024) == 136_288 <= SMEM
    assert sb.resident_smem_bytes(256, 128) == 266_656 > SMEM
    assert len(sb.PHASES) == 8


@pytest.mark.parametrize("sms,smem,route,c,rounds", [
    # fewer SMs cap the cluster, and the coils go in rounds
    (4, SMEM, "resident", 3, 2),
    (2, SMEM, "resident", 2, 3),
    (1, SMEM, "resident", 1, 6),
    # less shared memory: 128² no longer fits one CTA, but a team of 3 CTAs
    # a coil does (91,040 bytes a CTA), 3 coils a round on 9 CTAs
    (SMS, 120_000, "split", 9, 2),
    (SMS, 134_048, "resident", 6, 1),
    (SMS, 134_047, "split", 9, 2),
])
def test_plans_respect_the_card(sms, smem, route, c, rounds):
    plan = _plan(8, 128, 128, 6, sms=sms, smem_max=smem)
    assert (plan.route, plan.clusters, plan.rounds) == (route, c, rounds)


@pytest.mark.parametrize("args,match", [
    ((0, 128, 128, 6), "empty shape 0 x 128x128, 6 coils"),
    ((8, 128, 128, 0), "empty shape 8 x 128x128, 0 coils"),
    ((8, 1025, 128, 6), "from 2 to 1024, got 1025x128"),
    ((8, 128, 2048, 6), "from 2 to 1024, got 128x2048"),
    ((8, 1, 8, 6), "from 2 to 1024, got 1x8"),
])
def test_a_shape_without_a_plan_raises_and_names_it(args, match):
    with pytest.raises(ValueError, match=match):
        _plan(*args)


@pytest.mark.parametrize("resident", [(), ((6, 0),), ((8, 15),)])
def test_a_resident_plan_the_card_cannot_hold_raises(resident):
    with pytest.raises(ValueError, match=r"holds no cluster of .*clusters=6.*8 x 128x128, 6 coils"):
        _plan(8, 128, 128, 6, resident)


def test_the_global_route_needs_no_residency():
    """512², once the global route's, takes the grid route: no cluster the
    card holds, but every CTA it launches resident at once."""
    plan = _plan(8, 512, 512, 6, ())
    assert (plan.route, plan.ctas, plan.resident_clusters) == ("grid", 132, 132)
    assert _plan(8, 512, 512, 6, (), grid_ctas=40).ctas <= 40


# ---- the register layout, modelled in Python --------------------------------

def _lg(n):
    return n.bit_length() - 1


def _smem_stage(re, im, tw, m, inverse):
    """One radix-2 stage of span m on lines (rows of re, im) in shared
    memory, as fft_resident.cuh smem_stage indexes it."""
    n = re.shape[-1]
    lm = _lg(m)
    step = n >> (lm + 1)
    j = np.arange(n // 2)
    k = j & (m - 1)
    i0 = ((j >> lm) << (lm + 1)) + k
    i1 = i0 + m
    wr, wi = tw[0, k * step], tw[1, k * step]
    ar, ai, br, bi = re[:, i0], im[:, i0], re[:, i1], im[:, i1]
    re, im = re.clone(), im.clone()
    if inverse:
        wi = -wi
        tr = br * wr - bi * wi
        ti = br * wi + bi * wr
        re[:, i0], im[:, i0], re[:, i1], im[:, i1] = ar + tr, ai + ti, ar - tr, ai - ti
    else:
        dr, di = ar - br, ai - bi
        re[:, i0], im[:, i0] = ar + br, ai + bi
        re[:, i1], im[:, i1] = dr * wr - di * wi, dr * wi + di * wr
    return re, im


def _to_lanes(v, T, P, L):
    """(lines, n) → (lines, sub-lines, P, T): lane t's register j of
    sub-line s holds point s·L + j·T + t."""
    lines, n = v.shape
    return v.reshape(lines, n // L, P, T)


def _twiddle(tw, n, t):
    """exp(−2πit/n) as csrc/fft_mixed.cuh twiddle_at reads it from the
    stored table: past n/2, the conjugate of entry n − t."""
    t = np.asarray(t)
    half = t <= n // 2
    src = np.where(half, t, n - t)
    wi = tw[1, src]
    return tw[0, src], torch.where(torch.as_tensor(half), wi, -wi)


def _odd_stage(re, im, tw, nb, p, inverse):
    """One odd stage of radix p on blocks of nb points of lines (rows of
    re, im) in shared memory, as csrc/fft_mixed.cuh odd_stage indexes it:
    group g = block·m + k of a line holds the points first(g) + j·m; an
    output is a sum over the group's points in order, the inverse's
    conjugate twiddles applied in place first."""
    n = re.shape[-1]
    m = nb // p
    g = np.arange(n // p)
    blk, k = g // m, g % m
    first = blk * nb + k
    re, im = re.clone(), im.clone()
    if inverse:
        for s in range(1, p):
            at = first + s * m
            wr, wi = _twiddle(tw, n, k * s * (n // nb))
            wi = -wi
            xr, xi = re[:, at], im[:, at]
            re[:, at], im[:, at] = xr * wr - xi * wi, xr * wi + xi * wr
    out = []
    for s in range(p):  # output s of every group, from the stage's inputs
        ar, ai = re[:, first], im[:, first]
        e = 0
        for j in range(1, p):
            e = (e + s) % p
            cr, ci = _twiddle(tw, n, e * (n // p))
            if inverse:
                ci = -ci
            xr, xi = re[:, first + j * m], im[:, first + j * m]
            ar = ar + (xr * cr - xi * ci)
            ai = ai + (xr * ci + xi * cr)
        if not inverse and s > 0:
            wr, wi = _twiddle(tw, n, k * s * (n // nb))
            ar, ai = ar * wr - ai * wi, ar * wi + ai * wr
        out.append((first + s * m, ar, ai))
    for at, ar, ai in out:  # the writes after every read (the wave's barrier)
        re[:, at], im[:, at] = ar, ai
    return re, im


def _odd_stages(re, im, tw, inverse):
    """Every odd stage of a pass in the kernel's order (odd_stages)."""
    n = re.shape[-1]
    primes = dft.odd_primes(n)
    if inverse:
        nb = n & -n
        for p in reversed(primes):
            nb *= p
            re, im = _odd_stage(re, im, tw, nb, p, True)
    else:
        nb = n
        for p in primes:
            re, im = _odd_stage(re, im, tw, nb, p, False)
            nb //= p
    return re, im


def _regs(re, im, tw, n, T, P, inverse):
    """The register stages of dif_regs / dit_regs on (lines, sub-lines, P,
    T) lanes: spans ≥ T pair a lane's registers j and j + h, spans < T
    pair lanes t and t ^ m (each lane computes its own output)."""
    t = torch.arange(T)
    re, im = re.clone(), im.clone()

    def in_lane(h):
        m = h * T
        step = n >> (_lg(m) + 1)
        for j in range(P):
            if j & h:
                continue
            k = (j * T + t) & (m - 1)
            wr, wi = tw[0, k * step], tw[1, k * step]
            ar, ai = re[..., j, :].clone(), im[..., j, :].clone()
            br, bi = re[..., j + h, :].clone(), im[..., j + h, :].clone()
            if inverse:
                wi = -wi
                tr, ti = br * wr - bi * wi, br * wi + bi * wr
                re[..., j, :], im[..., j, :] = ar + tr, ai + ti
                re[..., j + h, :], im[..., j + h, :] = ar - tr, ai - ti
            else:
                dr, di = ar - br, ai - bi
                re[..., j, :], im[..., j, :] = ar + br, ai + bi
                re[..., j + h, :], im[..., j + h, :] = dr * wr - di * wi, dr * wi + di * wr

    def across(m):
        nonlocal re, im
        k = t & (m - 1)
        step = n >> (_lg(m) + 1)
        wr, wi = tw[0, k * step], tw[1, k * step]
        upper = (t & m) != 0
        partner = t ^ m
        if inverse:
            wi = -wi
            sr = torch.where(upper, re * wr - im * wi, re)
            si = torch.where(upper, re * wi + im * wr, im)
            pr, pi = sr[..., partner], si[..., partner]
            re = torch.where(upper, pr - sr, re + pr)
            im = torch.where(upper, pi - si, im + pi)
        else:
            pr, pi = re[..., partner], im[..., partner]
            dr, di = pr - re, pi - im
            re = torch.where(upper, dr * wr - di * wi, re + pr)
            im = torch.where(upper, dr * wi + di * wr, im + pi)

    if inverse:
        m = 1
        while m < T:
            across(m)
            m *= 2
        h = 1
        while h < P:
            in_lane(h)
            h *= 2
    else:
        h = P // 2
        while h >= 1:
            in_lane(h)
            h //= 2
        m = T // 2
        while m >= 1:
            across(m)
            m //= 2
    return re, im


def line_model(re, im, tw, inverse=False):
    """A whole n-point pass on the lines of (re, im) through the kernel's
    layout: forward, the shared-memory stages (the odd stages, then the
    radix-2 spans 2ᵃ/2 … L) and then the register stages; inverse, the
    register stages, then spans L … 2ᵃ/2, then the odd stages."""
    lines, n = re.shape
    T, P, L = line_layout(n)
    if not inverse:
        re, im = _odd_stages(re, im, tw, False)
        m = (n & -n) // 2
        while m >= L:
            re, im = _smem_stage(re, im, tw, m, False)
            m //= 2
    re, im = _regs(_to_lanes(re, T, P, L), _to_lanes(im, T, P, L), tw, n, T, P, inverse)
    re, im = re.reshape(lines, n), im.reshape(lines, n)
    if inverse:
        m = L
        while m < n & -n:
            re, im = _smem_stage(re, im, tw, m, True)
            m *= 2
        re, im = _odd_stages(re, im, tw, True)
    return re, im


SIZES = [2**k for k in range(1, 11)]
# sizes with odd factors: odd primes, one and several odd stages, runs of
# 2ᵃ shorter and longer than a sub-line, and the JAX kernels' 64-multiples
MIXED_SIZES = [3, 5, 6, 12, 17, 24, 40, 45, 96, 97, 192, 320, 448, 704, 768, 960, 1021]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
def test_the_layout_computes_the_plain_fft_bit_for_bit(n, inverse):
    T, P, L = line_layout(n)
    assert T * P == L == min(n, LINE_MAX) and T == min(32, L) and P in (1, 2, 4)
    rng = np.random.default_rng(n)
    re, im = (torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)) for _ in range(2))
    tw = torch.from_numpy(dft.twiddles(n))
    got = line_model(re, im, tw, inverse)
    want = (dft.ifft_dit if inverse else dft.fft_dif)(re, im, tw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _normal_model(ur, ui, tables):
    """The resident transform of one coil's image: rows forward, columns
    forward, times the transposed weights wt[c, k] (column c, spectrum row
    k), columns back, rows back, each line through the layout model."""
    tw_h, tw_w, weights = tables
    wt = weights.T.contiguous()
    re, im = line_model(ur, ui, tw_w)
    re, im = line_model(re.T.contiguous(), im.T.contiguous(), tw_h)  # rows of re are columns
    re, im = re * wt, im * wt
    re, im = line_model(re, im, tw_h, inverse=True)
    return line_model(re.T.contiguous(), im.T.contiguous(), tw_w, inverse=True)


@pytest.mark.parametrize("n", MIXED_SIZES)
@pytest.mark.parametrize("inverse", [False, True], ids=["dif", "dit"])
def test_the_layout_computes_the_mixed_radix_fft_bit_for_bit(n, inverse):
    T, P, L = line_layout(n)
    assert T * P == L == min(n & -n, LINE_MAX) and n % L == 0
    rng = np.random.default_rng(n)
    re, im = (torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)) for _ in range(2))
    tw = torch.from_numpy(dft.twiddles(n))
    got = line_model(re, im, tw, inverse)
    want = (dft.ifft_dit if inverse else dft.fft_dif)(re, im, tw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("H,W,C", [(128, 128, 6), (16, 32, 3), (2, 4, 3), (64, 8, 1), (4, 2, 9),
                                   (8, 16, 17), (256, 16, 2), (16, 256, 5), (24, 40, 3),
                                   (96, 192, 2), (64, 192, 6), (17, 24, 2)])
def test_the_banded_fold_in_rank_order_is_the_plain_sense_normal(H, W, C):
    """Each coil transformed on its own (as the CTA that owns it does),
    then every rank folds its band, round by round, coils of a round in
    rank order: bit for bit the plain SENSE normal op."""
    rng = np.random.default_rng(H * W + C)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    cr, ci = t(rng.normal(size=(C, H, W))), t(rng.normal(size=(C, H, W)))
    vr, vi = t(rng.normal(size=(H, W))), t(rng.normal(size=(H, W)))
    tables = dft.dft_tables(t(rng.uniform(size=(H, W)) < 0.5))
    plan = _plan(1, H, W, C)
    assert plan.route == "resident"
    y = {}
    for q in range(plan.clusters):
        for k in coils_of(plan, q):
            y[k] = _normal_model(cr[k] * vr - ci[k] * vi, cr[k] * vi + ci[k] * vr, tables)
    assert sorted(y) == list(range(C))
    nr, ni = torch.full((H, W), float("nan")), torch.full((H, W), float("nan"))
    for q in range(plan.clusters):
        r0, r1 = plan.band(q)
        sr = si = torch.zeros((r1 - r0, W))
        for ro in range(plan.rounds):
            for k in range(ro * plan.clusters, min(C, (ro + 1) * plan.clusters)):
                yr, yi = (v[r0:r1] for v in y[k])
                a, b = cr[k, r0:r1], ci[k, r0:r1]
                sr, si = (sr + a * yr) + b * yi, (si + a * yi) - b * yr
        nr[r0:r1], ni[r0:r1] = sr, si
    want = dft.sense_normal(vr[None], vi[None], cr, ci, tables)
    assert torch.equal(nr, want[0][0]) and torch.equal(ni, want[1][0])
