"""The fused FISTA-L21-SENSE kernel's planner and its resident route's
schedule (rls_tpu_torch/kernels/sense_fused.py ``plan_sense``;
csrc/sense_fused.cu, csrc/sense_cluster.cuh), on the CPU. The split route
(a coil's spectrum over a team of CTAs) has its own tests:
tests/test_torch_sense_split.py.

The planner: which route and cluster size a shape takes on an H100 (132
SMs, 232,448 bytes of shared memory per block), that the shared memory is
counted piece by piece as the .cu counts it, that the row bands cover H
(empty where H < c), and that a plan the card cannot hold raises.

The schedule: a Python model of the resident route's iterations, band by
band in the kernel's order (the momentum step on each CTA's band; each
coil transformed whole by the CTA that owns it, through the register
layout model of tests/test_torch_splitbregman_plan.py; the round's coils
folded into each band in rank order, the sum waiting between rounds; the
gradient step and the group threshold on the band), must equal
``fista_l21_sense_fused_torch`` bit for bit. The kernel itself runs only
on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rls_tpu_torch.kernels import _dft_common as dft
from rls_tpu_torch.kernels import sense_fused as sense
from rls_tpu_torch.kernels.fista_tv_fused import _momentum_table
from test_torch_splitbregman_plan import _normal_model

CSRC = Path(sense.__file__).parents[1] / "csrc"
SMS, SMEM = 132, 232_448
# the clusters of c resident CTAs of the kernel that an H100 80GB HBM3
# holds at once, by cudaOccupancyMaxActiveClusters (one CTA of 1024
# threads per SM; sense_fused.resident_limits; tests/test_torch_cuda.py
# checks the table on the card)
H100_RESIDENT = tuple(zip(range(1, 17), (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7,
                                         7)))
# tests/test_torch_cuda.py FFT_SHAPES, with the route each takes (256 × 128
# on teams of 3 CTAs a coil)
FFT_ROUTES = {(16, 32): "resident", (64, 8): "resident", (2, 4): "resident",
              (256, 128): "split", (1024, 16): "resident", (16, 1024): "resident",
              (512, 512): "grid"}
# the card tests' SENSE cases (tests/test_torch_cuda.py SENSE_CASES): every
# FFT shape at 1 and 3 coils, and 128² at 6, 9 and 17 coils (two rounds on
# 9 CTAs) and 2 × 4 at 6 (four of the six bands empty), with the route,
# cluster size and rounds each takes
CARD_PLANS = {
    **{(shape, C): {"resident": (route, C, 1), "split": (route, 3 * C, 1),
                    "grid": (route, 66, 1)}[route]
       for shape, route in FFT_ROUTES.items() for C in (1, 3)},
    ((128, 128), 1): ("resident", 1, 1), ((128, 128), 6): ("resident", 6, 1),
    ((128, 128), 9): ("resident", 9, 1), ((128, 128), 17): ("resident", 9, 2),
    ((2, 4), 6): ("resident", 6, 1),
}


def _plan(B, H, W, C, resident=H100_RESIDENT, **card):
    return sense.plan_sense(B, H, W, C, resident, **card)


def test_the_plan_at_the_cell():
    """8 slices of 128², 6 coils: a cluster of 6 CTAs per slice, one coil
    each in one round, 128 rows in bands of 22, 22, 21, 21, 21, 21; the
    card holds 17 such clusters, so the 8 run in one wave."""
    plan = _plan(8, 128, 128, 6)
    assert (plan.route, plan.clusters, plan.rounds, plan.ctas) == ("resident", 6, 1, 48)
    assert [plan.band(q) for q in range(6)] == [(0, 22), (22, 44), (44, 65), (65, 86),
                                                (86, 107), (107, 128)]
    assert plan.smem == sense.resident_smem_bytes(128, 128) == 133_168
    assert plan.scratch == sense.RESIDENT_SCRATCH == 6
    assert plan.resident_clusters == 17 >= 8


@pytest.mark.parametrize("case", list(CARD_PLANS))
def test_the_routes_of_the_card_tests_cases(case):
    (H, W), C = case
    plan = _plan(2, H, W, C)
    assert (plan.route, plan.clusters, plan.rounds) == CARD_PLANS[case]
    assert (sense.resident_smem_bytes(H, W) <= SMEM) == (plan.route == "resident")
    if plan.route == "grid":
        # 2 slots of 66 CTAs (the card's 132), every coil in one round
        assert (plan.ctas, plan.scratch, plan.resident_clusters) == (132, sense.GRID_SCRATCH, 132)
        assert plan.smem == sense.grid_smem_bytes(H, W, 4104)
        assert plan.band(0) == (0, 8) and plan.team == 66
    else:
        assert (plan.clusters, plan.rounds) == sense.cluster_size(C, team=plan.team)
        assert (plan.team == 1) == (plan.route == "resident")
        assert plan.ctas == 2 * plan.clusters and plan.scratch == sense.RESIDENT_SCRATCH


def test_the_shared_memory_is_counted_piece_by_piece():
    # 128²: 6 int64 phase clocks, 256 f32 twiddles, 2 × 128 · 129 f32 of
    # spectrum
    assert sense.resident_smem_bytes(128, 128) == 48 + 1024 + 2 * 4 * 16_512
    # rounded up to 4 floats: 2 + 4 twiddles → 8, 2 · 5 = 10 → 12
    assert sense.resident_smem_bytes(2, 4) == 48 + 4 * 8 + 2 * 4 * 12
    # the largest resident shapes, and a grid CTA at 512² (twiddles, two
    # planes of 8 lines of 513 floats, 10 phase clocks)
    assert sense.resident_smem_bytes(1024, 16) == 143_472 <= SMEM
    assert sense.resident_smem_bytes(16, 1024) == 135_408 <= SMEM
    assert sense.resident_smem_bytes(256, 128) == 265_776 > SMEM
    assert sense.grid_smem_bytes(512, 512, 4104) == 4 * (1024 + 2 * 4104) + 80


def test_the_planner_reads_the_kernel_s_constants():
    """The cluster size, threads, phases and shared-memory count as
    csrc/sense_fused.cu states them."""
    src = (CSRC / "sense_fused.cu").read_text()
    assert re.findall(r"constexpr int kMaxCluster = (\d+);", src) == [str(sense.MAX_CLUSTER)]
    assert re.findall(r"constexpr int kThreads = (\d+);", src) == [str(sense.THREADS)]
    phases = re.search(r"enum \{\s*(kLoads[^}]*)\}", src).group(1)
    names = [p.strip() for p in phases.split(",") if p.strip()]
    assert names[-1] == "kPhases" and len(names) - 1 == len(sense.PHASES)
    smem = re.search(r"resident_smem_bytes\(int H, int W\) \{(.*?)\n\}", src, re.S).group(1)
    assert "sizeof(long long) * kPhases" in smem
    assert "rls::ceil4(rls::twiddle_floats(H, W)) +" in smem
    assert "2 * rls::ceil4(static_cast<size_t>(H) * (W + 1))" in smem


@pytest.mark.parametrize("C,c,rounds", [(1, 1, 1), (3, 3, 1), (6, 6, 1), (9, 9, 1), (16, 16, 1),
                                        (17, 9, 2), (32, 16, 2), (33, 11, 3)])
def test_the_cluster_size_is_the_splitbregman_kernel_s(C, c, rounds):
    from rls_tpu_torch.kernels import splitbregman_fused as sb

    plan = _plan(8, 128, 128, C)
    assert (plan.clusters, plan.rounds) == (c, rounds) == sense.cluster_size(C)
    assert sb.cluster_size is sense.cluster_size
    assert (sb.plan_splitbregman(8, 128, 128, C, H100_RESIDENT).clusters, plan.rounds) == (c,
                                                                                          rounds)


@pytest.mark.parametrize("H,C", [(2, 3), (2, 6), (4, 9), (16, 6), (128, 6), (128, 16),
                                 (1024, 3), (8, 16), (128, 17)])
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


@pytest.mark.parametrize("sms,smem,route,c,rounds", [
    # fewer SMs cap the cluster, and the coils go in rounds
    (4, SMEM, "resident", 3, 2),
    (1, SMEM, "resident", 1, 6),
    # less shared memory: 128² no longer fits one CTA, but a team of 3 CTAs
    # a coil does (90,160 bytes a CTA), 3 coils a round on 9 CTAs
    (SMS, 133_168, "resident", 6, 1),
    (SMS, 133_167, "split", 9, 2),
])
def test_plans_respect_the_card(sms, smem, route, c, rounds):
    plan = _plan(8, 128, 128, 6, sms=sms, smem_max=smem)
    assert (plan.route, plan.clusters, plan.rounds) == (route, c, rounds)


@pytest.mark.parametrize("args,match", [
    ((0, 128, 128, 6), "fista_l21_sense_fused: empty shape 0 x 128x128, 6 coils"),
    ((8, 128, 128, 0), "empty shape 8 x 128x128, 0 coils"),
    ((8, 1025, 128, 6), "from 2 to 1024, got 1025x128"),
    ((8, 128, 2048, 6), "from 2 to 1024, got 128x2048"),
])
def test_a_shape_without_a_plan_raises_and_names_it(args, match):
    with pytest.raises(ValueError, match=match):
        _plan(*args)


@pytest.mark.parametrize("resident", [(), ((6, 0),), ((8, 15),)])
def test_a_resident_plan_the_card_cannot_hold_raises(resident):
    with pytest.raises(ValueError, match=r"fista_l21_sense_fused: the card holds no cluster of "
                                         r"SensePlan\(route='resident', clusters=6, rounds=1.*"
                                         r"8 x 128x128, 6 coils"):
        _plan(8, 128, 128, 6, resident)


def test_the_global_route_needs_no_residency():
    """512², once the global route's, now takes the grid route, which needs
    no cluster the card holds (an empty table of clusters plans it) but
    every CTA it launches resident at once: the card's 132 grid CTAs."""
    plan = _plan(8, 512, 512, 6, ())
    assert (plan.route, plan.ctas, plan.resident_clusters) == ("grid", 132, 132)
    assert _plan(8, 512, 512, 6, (), grid_ctas=40).ctas <= 40


# ---- one banded iteration at a time, modelled in Python ---------------------

def banded_solve(x0hat, scal, tab, coils, tables, plan):
    """The resident route's solve of each slice, as csrc/sense_fused.cu
    schedules it on a cluster of `plan.clusters` CTAs: per iteration every
    CTA's momentum step on its band (barrier A), then per round each CTA's
    coil transformed whole, (barrier B) each band folding the round's coils
    in rank order, the sum kept between rounds (barrier C), and after the
    last round the gradient step and the group threshold on the band."""
    cr, ci = coils
    c, C = plan.clusters, plan.C
    out = torch.full_like(x0hat, float("nan"))
    for b in range(x0hat.shape[0]):
        rho, lam = scal[b, 0], scal[b, 1]
        t = rho * lam
        x0r, x0i = x0hat[b, 0], x0hat[b, 1]
        xr, xi = x0r * 0.0, x0i * 0.0
        pr, pi = xr.clone(), xi.clone()
        mr, mi = torch.full_like(xr, float("nan")), torch.full_like(xr, float("nan"))
        bands = [slice(*plan.band(q)) for q in range(c)]
        for it in range(tab.shape[0]):
            a = tab[it, 0]
            for band in bands:
                vr, vi = xr[band], xi[band]
                mr[band] = vr + a * (vr - pr[band])
                mi[band] = vi + a * (vi - pi[band])
            acc = [None] * c
            for ro in range(plan.rounds):
                coils_of_round = range(ro * c, min(C, (ro + 1) * c))
                y = {k: _normal_model(cr[k] * mr - ci[k] * mi, cr[k] * mi + ci[k] * mr, tables)
                     for k in coils_of_round}
                for q, band in enumerate(bands):
                    sr, si = acc[q] if ro else (torch.zeros_like(xr[band]),) * 2
                    for k in coils_of_round:
                        yr, yi = y[k][0][band], y[k][1][band]
                        ca, cb = cr[k][band], ci[k][band]
                        sr, si = (sr + ca * yr) + cb * yi, (si + ca * yi) - cb * yr
                    acc[q] = sr, si
            for q, band in enumerate(bands):
                nr, ni = acc[q]
                gr = mr[band] - rho * (nr - x0r[band])
                gi = mi[band] - rho * (ni - x0i[band])
                pr[band], pi[band] = xr[band], xi[band]
                xr[band], xi[band] = sense.group_threshold(gr, gi, t)
        out[b, 0], out[b, 1] = xr, xi
    return out


@pytest.mark.parametrize("H,W,C", [(128, 128, 6), (16, 32, 3), (2, 4, 6), (64, 8, 1),
                                   (128, 128, 17)])
def test_the_banded_iterations_are_the_plain_solve_bit_for_bit(H, W, C):
    """Two slices with their own ρ and λ, three iterations (the momentum
    at work from the second): the banded schedule gives the plain
    version's bits, bands empty at 2 × 4 with 6 coils, two rounds at 17."""
    rng = np.random.default_rng(H * W + C)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    maps = rng.normal(size=(C, H, W)) + 1j * rng.normal(size=(C, H, W))
    maps /= np.sqrt((np.abs(maps) ** 2).sum(0))
    coils = t(maps.real), t(maps.imag)
    tables = dft.dft_tables(t(rng.uniform(size=(H, W)) < 0.5))
    x0 = t(rng.normal(size=(2, 2, H, W)))
    scal = t([[0.9, 1e-2], [0.7, 0.2]])
    tab = t(_momentum_table("fista", 3))
    plan = _plan(2, H, W, C)
    assert plan.route == "resident" and plan.rounds == (2 if C > 16 else 1)
    got = banded_solve(x0, scal, tab, coils, tables, plan)
    want = sense.fista_l21_sense_fused_torch(x0, scal, tab, coils, tables)
    assert torch.equal(got, want)
    assert float(want.abs().max()) > 0  # the threshold left something
