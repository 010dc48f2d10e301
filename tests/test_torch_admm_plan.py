"""The fused ADMM-TV kernel's planner (rls_tpu_torch/kernels/admm_tv_fused.py
``plan_admm_tv``) and a Python model of its resident route, on the CPU.

The planner: which route and cluster size a shape takes on an H100 (132
SMs, 232,448 bytes of shared memory per block), that every resident plan
covers H with its bands and fits the card, that the row → (rank, local
row) map owns each row once and reaches every stencil radius up to 31,
that the shared-memory count is the kernel's, and that a shape with no
route raises and names itself.

The model: the ADMM-TV solve computed band by band in float64, as the
resident kernel's CTAs compute it (csrc/admm_tv_cluster.cuh), each band
reading another band's rows only as they stood at the last cluster
barrier, on the kernel's planes as it reuses them (five shared planes
S0–S4 here; row 5's three-plane placement in
tests/test_torch_admm_tiled_plan.py), with the CG's sums taken per band
and added in rank order through two sum slots. It is held against ``admm_tv_fused_torch`` in float64 with equal
live CG steps, and it checks the barrier table of the kernel's header:
a plane (or sum slot) that a band reads from another band between two
cluster barriers must not be written between them, so that dropping any
barrier of the table raises. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rls_tpu_torch.kernels import _fgp_common
from rls_tpu_torch.kernels import admm_tv_fused as admm
from rls_tpu_torch.kernels.fista_tv_fused import MIN_CTA_PIXELS
from rls_tpu_torch.ops.conv_direct import stencil_pass

CSRC = Path(admm.__file__).parents[1] / "csrc"
SMS, SMEM = 132, 232_448
# the clusters of c resident CTAs of 1024 threads that an H100 80GB HBM3
# holds at once, by cudaOccupancyMaxActiveClusters: the table of the PDHG,
# SENSE and SplitBregman kernels (admm_tv_fused.resident_limits;
# tests/test_torch_cuda.py checks it on the card)
H100_RESIDENT = tuple(zip(range(1, 17), (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7,
                                         7)))
# tests/test_torch_cuda.py's shapes (3 problems, 5 × 3 taps), one for each
# cluster size the planner picks: 15 c + 1 rows of 256 (c ≥ 2) take bands of
# 16 rows with the last one short (a single row at c = 16), and a row too
# wide for any band takes the global route
ADMM_ROUTES = {(1, 16): ("resident", 1), (24, 20): ("resident", 1),
               **{(15 * c + 1, 256): ("resident", c) for c in range(2, 17)},
               (2, 12000): ("global", 1)}


def _plan(B, H, W, kh=9, kw=9, resident=H100_RESIDENT, **card):
    return admm.plan_admm_tv(B, H, W, kh, kw, resident, **card)


def _covers(plan, B, H, W, sms=SMS, smem=SMEM):
    """A resident plan's bands cover H with none empty; it fits the card."""
    assert plan.route == "resident"
    c, rows = plan.clusters, plan.rows
    assert 1 <= c <= min(admm.MAX_CLUSTER, sms)
    assert (c - 1) * rows < H <= c * rows
    assert all(plan.band_rows(q) >= 1 for q in range(c))
    assert sum(plan.band_rows(q) for q in range(c)) == H
    assert plan.ctas == B * c
    assert plan.smem == admm.cluster_smem_bytes(rows, W) <= smem
    assert plan.scratch == admm.RESIDENT_SCRATCH


def test_the_plan_at_the_cell():
    """BASELINE #3, 16 problems of 256² with a 9 × 9 Gaussian: six bands of
    43 rows (the last 41), five 43 KiB planes, 222,424 bytes per CTA; the
    card holds 17 such clusters, so the 16 run in one wave on 96 SMs."""
    plan = _plan(16, 256, 256)
    _covers(plan, 16, 256, 256)
    assert (plan.clusters, plan.rows, plan.ctas, plan.smem) == (6, 43, 96, 222_424)
    assert [plan.band_rows(q) for q in range(6)] == [43] * 5 + [41]
    assert dict(H100_RESIDENT)[6] >= 16


def test_the_cells_fitting_sizes():
    """Five planes of 52 rows (c = 5) exceed a block's shared memory; 6 to
    16 bands fit."""
    assert admm.fitting_sizes(256, 256) == tuple(range(6, 17))
    assert admm.cluster_smem_bytes(52, 256) > SMEM >= admm.cluster_smem_bytes(43, 256)


@pytest.mark.parametrize("B,c,rows", [
    # waves × rows per band: 1–7 problems take one wave of 16 bands (16);
    # 8 one wave of 9 clusters of 9 (29 rows); 14–15 one wave of 15
    # clusters of 8 (32); 16–17 one wave of 17 clusters of 6 (43), against
    # three waves of 16 bands (48); 18 three waves of 16 bands (48) against
    # two of 6 (86); 64 and 137 waves of 15 clusters of 8 (32 rows) tie
    # with twice as many of 16: the smaller cluster
    (1, 16, 16), (7, 16, 16), (8, 9, 29), (14, 8, 32), (15, 8, 32), (16, 6, 43),
    (17, 6, 43), (18, 16, 16), (64, 8, 32), (137, 8, 32),
])
def test_the_cluster_size_has_the_fewest_waves_times_rows(B, c, rows):
    plan = _plan(B, 256, 256)
    _covers(plan, B, 256, 256)
    assert (plan.clusters, plan.rows) == (c, rows)


@pytest.mark.parametrize("c,rows,smem", [(6, 43, 222_424), (8, 32, 166_016),
                                         (16, 16, 83_968), (11, 24, 124_992)])
def test_a_forced_cluster_size(c, rows, smem):
    """The timing mode's and the tests' forced plans: any fitting size."""
    plan = _plan(16, 256, 256, clusters=c)
    _covers(plan, 16, 256, 256)
    assert (plan.clusters, plan.rows, plan.smem) == (c, rows, smem)


@pytest.mark.parametrize("shape", list(ADMM_ROUTES))
def test_the_card_tests_shapes_take_their_routes(shape):
    plan = _plan(3, *shape, 5, 3)
    assert (plan.route, plan.clusters) == ADMM_ROUTES[shape]
    if plan.route == "resident":
        _covers(plan, 3, *shape)
        if shape[0] > 24:  # the last band is the short one
            assert plan.band_rows(plan.clusters - 1) == 16 - (plan.clusters - 1)
    else:
        assert (plan.rows, plan.ctas, plan.smem, plan.scratch) == (
            shape[0], 3, admm.GLOBAL_SMEM, admm.GLOBAL_SCRATCH)


@pytest.mark.parametrize("B", [1, 7, 16, 64, 137])
@pytest.mark.parametrize("H,W", [(8, 8), (17, 23), (33, 700), (128, 128), (255, 257),
                                 (256, 256), (300, 300), (512, 512), (1000, 60), (60, 1000),
                                 (1024, 1024), (4096, 16)])
@pytest.mark.parametrize("taps", [(1, 1), (9, 9), (63, 3), (5, 63)])
def test_every_resident_plan_covers_its_shape_and_fits(B, H, W, taps):
    """Where bands fit, the plan is resident, covers H and fits; it has the
    fewest waves × rows per band among the sizes it may take. The taps
    change nothing: a band reads up to 31 rows of its neighbours."""
    fit = admm.fitting_sizes(H, W)
    plan = _plan(B, H, W, *taps)
    if not fit:
        assert plan.route == "global"
        return
    _covers(plan, B, H, W)
    held = dict(H100_RESIDENT)

    def cost(c):
        return -(-B // held[c]) * -(-H // c)

    allowed = [c for c in fit if c == fit[0] or -(-H // c) * W >= MIN_CTA_PIXELS]
    assert plan.clusters in allowed
    assert cost(plan.clusters) == min(cost(c) for c in allowed)
    assert all(c >= plan.clusters for c in allowed if cost(c) == cost(plan.clusters))
    assert plan == _plan(B, H, W, 9, 9)


@pytest.mark.parametrize("B,H,W,c", [(16, 256, 256, 6), (3, 241, 256, 16), (3, 31, 256, 2),
                                     (8, 256, 256, 9), (16, 4096, 16, 6), (3, 24, 20, 1)])
def test_the_row_map_owns_every_row_once_and_reaches_every_radius(B, H, W, c):
    """locate(row) names the one CTA whose band holds the row; from every
    row of every band each row within 31 (the widest stencil radius)
    inside the image resolves to a real row of some band, and the kernel's
    row table (rows + 2·HALO entries from r0 − HALO) holds it."""
    plan = _plan(B, H, W, 63, 63)
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
    assert admm.HALO == 31
    for rank in range(c):
        r0 = rank * plan.rows
        for lr in range(plan.band_rows(rank)):
            for s in range(-admm.HALO, admm.HALO + 1):
                r = r0 + lr + s
                if 0 <= r < H:
                    q, l = plan.locate(r)
                    assert 0 <= q < c and 0 <= l < plan.band_rows(q)
                    assert 0 <= r - (r0 - admm.HALO) < plan.rows + 2 * admm.HALO


def test_cluster_smem_bytes_counts_every_piece():
    # the cell, 43 rows of 256: five f32 planes, 3 × 32 + 12 float64 sums,
    # 7 int64 phase clocks, 43 + 62 row pointers, 126 f32 taps
    assert admm.cluster_smem_bytes(43, 256) == 5 * 44_032 + 864 + 56 + 8 * 105 + 504
    # each plane rounded up to 4 floats: 3 × 5 = 15 → 16
    assert admm.cluster_smem_bytes(3, 5) == 5 * 64 + 864 + 56 + 8 * 65 + 504


def test_the_planner_reads_the_kernel_s_constants():
    """Threads, planes, the largest cluster, the phases and the
    shared-memory count as csrc/admm_tv_cluster.cuh, the resident body,
    states them; row 4's entry points call its five-plane placement."""
    src = (CSRC / "admm_tv_cluster.cuh").read_text()
    assert re.findall(r"constexpr int kThreads = (\d+);", src) == [str(admm.THREADS)]
    assert re.findall(r"constexpr int kAllPlanes = (\d+);", src) == [str(admm.PLANES)]
    assert re.findall(r"constexpr int kMaxCluster = (\d+);", src) == [str(admm.MAX_CLUSTER)]
    phases = re.search(r"enum \{\s*(kSetup[^}]*)\}", src).group(1)
    names = [p.strip() for p in phases.split(",") if p.strip()]
    assert names[-1] == "kPhases" and len(names) - 1 == len(admm.PHASES)
    smem = re.search(r"cluster_smem_bytes\(int rows, int W, bool own_shared\) \{(.*?)\n\}", src,
                     re.S).group(1)
    for piece in ("sizeof(float) * (own_shared ? kAllPlanes : kSharedPlanes)",
                  "rls::band_plane_floats(rows, W)",
                  "sizeof(double) * (3 * (kThreads / 32) + 12)",
                  "sizeof(long long) * kPhases",
                  "sizeof(const float*) * (rows + 2 * kHalo)",
                  "sizeof(float) * 2 * kMaxTaps"):
        assert piece in smem
    fused = (CSRC / "admm_tv_fused.cu").read_text()
    for entry in ("occupancy", "launch"):
        assert f"rls::admm_cluster::{entry}<true>(" in fused


@pytest.mark.parametrize("W,widest", [(11_525, 11_524), (20_000, 11_524)])
def test_a_too_wide_row_takes_the_global_route(W, widest):
    """A band of one row of more than 11,524 pixels needs more than 232,448
    bytes: one CTA per problem on global scratch."""
    plan = _plan(4, 2, W)
    assert (plan.route, plan.clusters, plan.rows, plan.ctas) == ("global", 1, 2, 4)
    assert admm.fitting_sizes(1, widest) == (1,)
    assert admm.fitting_sizes(1, widest + 1) == ()


@pytest.mark.parametrize("sms,smem,route,c", [
    # cards that are not an H100, each taken to hold sms // c clusters of c:
    # fewer SMs cap the cluster size
    (8, SMEM, "resident", 8),
    (4, SMEM, "global", 1),
    # less shared memory: more bands, or none that fit
    (SMS, 120_000, "resident", 16),
    (SMS, 48 * 1024, "global", 1),
])
def test_plans_respect_the_card(sms, smem, route, c):
    held = tuple((k, sms // k) for k in range(1, 17))
    plan = _plan(16, 256, 256, resident=held, sms=sms, smem_max=smem)
    assert (plan.route, plan.clusters) == (route, c)
    if route == "resident":
        _covers(plan, 16, 256, 256, sms=sms, smem=smem)


@pytest.mark.parametrize("args,kw,match", [
    ((0, 8, 8), {}, "empty shape 0 x 8x8"),
    ((2, 0, 8), {}, "empty shape 2 x 0x8"),
    ((2, 8, 8, 64, 3), {}, "64 x 3 taps"),
    ((2, 8, 8, 3, 0), {}, "3 x 0 taps"),
    # a forced size whose bands do not fit, or leave a band empty
    ((16, 256, 256), {"clusters": 5}, "a cluster of 5 CTAs does not fit 16 x 256x256"),
    ((3, 24, 20), {"clusters": 16}, "a cluster of 16 CTAs does not fit 3 x 24x20"),
    ((3, 2, 12000), {"clusters": 1}, "a cluster of 1 CTAs does not fit 3 x 2x12000"),
    # rows wider than any band and 2³¹ pixels per problem: no route
    ((1, 2, 2**30), {}, "no route for 1 x 2x1073741824"),
])
def test_a_shape_without_a_route_raises_and_names_it(args, kw, match):
    with pytest.raises(ValueError, match=match):
        _plan(*args, **kw)


def test_a_plan_the_card_holds_no_cluster_of_raises():
    """No fallback: the resident route where the card holds none of its
    clusters is an error naming the plan, not a quiet global launch."""
    with pytest.raises(ValueError, match="holds no cluster of AdmmTvPlan"):
        _plan(16, 256, 256, resident=((1, 132), (2, 66)))


# ---- a Python model of the resident route


class Hazard(AssertionError):
    """A plane or sum slot read from another band and written between two
    cluster barriers."""


# the header's table: the barriers of one outer iteration, and Be
BARRIERS = ("Bx", "Bt", "Ss", "Sq", "Sr", "Bp", "Bf0", "Bf1", "Bf2", "Bf3", "Be")
# the physical home of each role in the two placements (the slot table of
# csrc/admm_tv_cluster.cuh): a shared-memory plane, or global memory (G…);
# x, z, u and r are global planes read at their own pixel only
HOMES = {
    "five": {"gin": "S0", "t1": "S1", "t2": "S2", "t3": "S3", "q": "Gq", "xg": "S2",
             "xg_own": "S2", "rv": "S1", "rh": "S3", "y": "S0", "pv": "S4", "ph": "Gph",
             "p": "S4"},
    "three": {"gin": "S2", "t1": "S1", "t2": "S0", "t3": "Gt3", "q": "S0", "xg": "S2",
              "xg_own": "Gxg", "rv": "S1", "rh": "S0", "y": "S2", "pv": "Gpv", "ph": "Gph",
              "p": "S1"},
}
SHARED = {"five": ("S0", "S1", "S2", "S3", "S4"), "three": ("S0", "S1", "S2")}


class ResidentModel:
    """The resident route's planes and sum slots, band by band, in one
    placement's homes (`HOMES`). A band reads its own rows as they stand;
    another band's rows as they stood at the last cluster barrier
    (`barrier` publishes every band's planes), and only of a shared-memory
    plane; rows past the image as zero. Between two barriers the planes
    read from another band and the planes written must not meet (`barrier`
    raises Hazard): the kernel's rule for distributed shared memory. A
    barrier named in `dropped` is not there."""

    def __init__(self, plan, like, dropped=(), slots=2, placement="five"):
        self.plan, self.dropped, self.slots = plan, set(dropped), slots
        self.home, self.shared = HOMES[placement], SHARED[placement]
        self.B, self.H, self.W = like.shape
        self.bands = range(plan.clusters)
        self.live = [{} for _ in self.bands]
        self.slot = [[None] * slots for _ in self.bands]
        self.parity = 0
        self.published = [{} for _ in self.bands]
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

    def get(self, q, role):
        return self.live[q][self.home[role]]

    def put(self, q, role, value):
        home = self.home[role]
        self.written.add(home)
        self.live[q][home] = value

    def rows(self, q, role, lo, hi):
        """Image rows lo … hi − 1 of `role` as band q sees them."""
        home = self.home[role]
        out = []
        for r in range(lo, hi):
            if not 0 <= r < self.H:
                out.append(torch.zeros(self.B, self.W, dtype=torch.float64))
                continue
            owner, lr = self.plan.locate(r)
            if owner == q:
                out.append(self.live[q][home][:, lr])
                continue
            assert home in self.shared, f"{role} ({home}) read at another band's rows"
            self.read_remote.add(home)
            plane = self.published[owner].get(home)
            out.append(torch.full((self.B, self.W), float("nan"), dtype=torch.float64)
                       if plane is None else plane[:, lr])
        return torch.stack(out, dim=1)

    def column_pass(self, q, role, taps, adjoint):
        """stencil_pass along the rows on band q, halo rows from the others."""
        R, n, r0 = len(taps) // 2, self.plan.band_rows(q), q * self.plan.rows
        ext = self.rows(q, role, r0 - R, r0 + n + R)
        acc = None
        for k, t in enumerate(taps):
            s = (R - k) if adjoint else (k - R)
            term = t * ext[:, R + s:R + s + n]
            acc = term if acc is None else acc + term
        return acc

    def cluster_sum(self, partials, name):
        """rls::cluster_sum3 on each band's partial sums: each CTA writes
        its slot, a cluster barrier (none on one CTA), then every CTA adds
        the slots of ranks 0 … c − 1 in order; the slots alternate."""
        slot = f"slot{self.parity}"
        for q in self.bands:
            self.slot[q][self.parity] = partials[q]
        if self.plan.clusters == 1:
            return partials[0]
        self.written.add(slot)
        self.barrier(name)
        self.read_remote.add(slot)
        total = 0
        for q in self.bands:
            total = total + self.slot[q][self.parity]
        self.parity = (self.parity + 1) % self.slots
        return total


def _cols(v, dc):
    """v[..., c + dc], zero past the edge."""
    out = torch.zeros_like(v)
    if dc > 0:
        out[..., :-dc] = v[..., dc:]
    else:
        out[..., -dc:] = v[..., :dc]
    return out


def _vsum(v):
    return v.sum(dim=(1, 2))


def resident_admm(x0hat, scal, t2tab, taps, iterations, cg, tol, prox, plan, dropped=(),
                  slots=2, placement="five"):
    """ADMM-TV by the resident route's sweeps and barriers, band by band, in
    the order of the header of csrc/admm_tv_cluster.cuh, on the planes of
    `placement` ("five": row 4's; "three": row 5's cluster route); returns
    (x, live CG steps). The global planes x, z, u and r are read and
    written at their own pixels; the rest in their homes as the kernel
    reuses them."""
    taps_h, taps_w = taps
    m = ResidentModel(plan, x0hat, dropped, slots, placement)
    B, H, W = x0hat.shape
    rho, lam = scal[:, 0].view(-1, 1, 1), scal[:, 1].view(-1, 1, 1)
    lam_z = lam / (2.0 * torch.where(rho != 0, rho, torch.ones_like(rho)))
    # a cluster's CTAs agree on the FGP; the model runs it for every
    # problem where any needs it and keeps xg where rho = 0
    fgp = (rho != 0) & (t2tab.shape[0] > 0)
    bands = list(m.bands)
    g = {n: [m.band(x0hat * 0.0, q).clone() for q in bands] for n in ("x", "z", "u", "r")}
    x0 = [m.band(x0hat, q) for q in bands]
    live = torch.zeros(B, dtype=torch.int32)
    for q in bands:  # the set-up: gin = x = 0
        m.put(q, "gin", g["x"][q])

    def gram():
        """band_gram_passes on gin (gin -> t1, Bt, t1 -> t2, t2 -> t3) and
        the last pass: A^H A gin on each band."""
        for q in bands:
            m.put(q, "t1", m.column_pass(q, "gin", taps_h, False))
        m.barrier("Bt")
        for q in bands:
            m.put(q, "t2", m.column_pass(q, "t1", taps_h, True))
        for q in bands:
            m.put(q, "t3", stencil_pass(m.get(q, "t2"), taps_w, -1, False))
        return [stencil_pass(m.get(q, "t3"), taps_w, -1, True) for q in bands]

    for _ in range(iterations):
        m.barrier("Bx")
        last = gram()
        part = []
        for q in bands:
            beta = x0[q] + rho * (g["z"][q] - g["u"][q])
            res = beta - (last[q] + rho * g["x"][q])
            g["r"][q] = res
            m.put(q, "gin", res)
            part.append(torch.stack([_vsum(beta * beta), _vsum(res * res)], dim=1))
        sums = m.cluster_sum(part, "Ss")
        target = tol * torch.sqrt(sums[:, 0])
        rz = sums[:, 1]
        for j in range(cg):
            last = gram()
            p = [m.get(q, "gin") for q in bands]
            for q in bands:
                m.put(q, "q", last[q] + rho * p[q])
            pq = m.cluster_sum([_vsum(p[q] * m.get(q, "q")) for q in bands], "Sq")
            active = torch.sqrt(rz) > target
            live += active.to(torch.int32)
            denom = torch.where(pq == 0, torch.ones_like(pq), pq)
            alpha = torch.where(active, rz / denom, torch.zeros_like(rz)).view(-1, 1, 1)
            for q in bands:
                g["x"][q] = g["x"][q] + alpha * p[q]
                g["r"][q] = g["r"][q] - alpha * m.get(q, "q")
            rz_new = m.cluster_sum([_vsum(v * v) for v in g["r"]], "Sr")
            safe = torch.where(rz == 0, torch.ones_like(rz), rz)
            beta_c = torch.where(rz == 0, torch.zeros_like(rz), rz_new / safe).view(-1, 1, 1)
            if j + 1 < cg:  # after the last step p is not read again
                for q in bands:
                    m.put(q, "gin", torch.where(active.view(-1, 1, 1),
                                                g["r"][q] + beta_c * p[q], p[q]))
                m.barrier("Bp")
            rz = rz_new
        for q in bands:  # the projection; xg = x + u (and its own-pixel copy)
            if prox == "positive":
                g["x"][q] = torch.clamp(g["x"][q], min=0.0)
            m.put(q, "xg", g["x"][q] + g["u"][q])
            m.put(q, "xg_own", g["x"][q] + g["u"][q])
        run_fgp = bool(fgp.any())
        if run_fgp:
            _fgp(m, plan, lam_z, t2tab, H, W, placement)
        for q in bands:
            xg = m.get(q, "xg_own")
            zv = xg
            if run_fgp:
                n, r0 = plan.band_rows(q), q * plan.rows
                pv, ph = m.get(q, "p"), m.get(q, "ph")
                up = m.rows(q, "p", r0 - 1, r0 + n - 1)
                zv = torch.where(fgp, xg - ((up - pv) + (_cols(ph, -1) - ph)), xg)
            g["z"][q] = zv
            g["u"][q] = (g["u"][q] + g["x"][q]) - zv
            m.put(q, "gin", g["x"][q])
    m.barrier("Be")
    for name in m.shared + ("slot0", "slot1"):  # the CTAs exit: their shared memory goes
        m.written.add(name)
    m.barrier("exit")
    return torch.cat(g["x"], dim=1), live


def _fgp(m, plan, lam_z, t2tab, H, W, placement):
    """band_fold_fgp on xg: the duals pv and ph, their momentum rv and rh,
    y; with three planes the last dual iteration writes p into rv in place
    of the momentum."""
    mcol = (torch.arange(W) < W - 1).to(torch.float64)
    bands = list(m.bands)
    tv = t2tab.shape[0]

    def clip(v, q, vertical):
        if vertical:
            r0 = q * plan.rows
            mask = (torch.arange(r0, r0 + plan.band_rows(q)) < H - 1).to(torch.float64)[:, None]
        else:
            mask = mcol
        return torch.clamp(v, -lam_z * mask, lam_z * mask)

    m.barrier("Bf0")
    for q in bands:
        n, r0 = plan.band_rows(q), q * plan.rows
        xg = m.get(q, "xg")
        y0 = xg * 0.125
        qv = clip(m.rows(q, "xg", r0 + 1, r0 + n + 1) * 0.125 - y0, q, True)
        qh = clip(_cols(xg, 1) * 0.125 - y0, q, False)
        for role, v in (("pv", qv), ("rv", qv), ("ph", qh), ("rh", qh)):
            m.put(q, role, v)
    for k in range(1, tv):
        c1, c2 = t2tab[k, 0], t2tab[k, 1]
        m.barrier("Bf1")
        for q in bands:
            n, r0 = plan.band_rows(q), q * plan.rows
            rv, rh = m.get(q, "rv"), m.get(q, "rh")
            up = m.rows(q, "rv", r0 - 1, r0 + n - 1)
            m.put(q, "y", (m.get(q, "xg_own") - ((up - rv) + (_cols(rh, -1) - rh))) * 0.125)
        m.barrier("Bf2")
        for q in bands:
            n, r0 = plan.band_rows(q), q * plan.rows
            y, rv, rh = m.get(q, "y"), m.get(q, "rv"), m.get(q, "rh")
            qv = clip(rv + (m.rows(q, "y", r0 + 1, r0 + n + 1) - y), q, True)
            qh = clip(rh + (_cols(y, 1) - y), q, False)
            p_out = placement == "three" and k + 1 == tv
            m.put(q, "rv", qv if p_out else c1 * qv - c2 * m.get(q, "pv"))
            m.put(q, "rh", c1 * qh - c2 * m.get(q, "ph"))
            m.put(q, "pv", qv)
            m.put(q, "ph", qh)
    m.barrier("Bf3")


G5 = tuple((np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
            / np.exp(-((np.arange(5) - 2) ** 2) / 2.0).sum()).tolist())
_G63 = np.exp(-(((np.arange(63) - 31) / 9.0) ** 2)) * (1 + 0.01 * np.arange(63))
TAPS63 = (tuple((_G63 / _G63.sum()).tolist()), (0.3, 0.6, 0.1))


def _problem(B, H, W, seed=5):
    """x0hat = Aᴴb of noise through a mild blur, in float64; ρ per problem
    (one 0: no prox) and λ."""
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.normal(size=(B, H, W)))
    rho = torch.tensor([0.1, 0.0, 0.4, 0.2][:B], dtype=torch.float64)
    lam = torch.tensor([2e-2, 5e-2, 0.1, 1e-2][:B], dtype=torch.float64)
    scal, _ = admm.kernel_args(x0, rho, lam, 0, dtype=np.float64)
    return x0, scal


def _resident(c, H, W, B=3):
    rows = -(-H // c)
    return admm.AdmmTvPlan("resident", c, rows, H, B * c, admm.cluster_smem_bytes(rows, W),
                           admm.RESIDENT_SCRATCH)


@pytest.mark.parametrize("prox", admm.PROXES)
@pytest.mark.parametrize("tol", [1e-5, 5e-2])
@pytest.mark.parametrize("H,W,c,taps", [
    # 20 rows in bands of 7, 7, 6; one-row bands; a 63-tap column blur over
    # 3-row bands, reaching 10 bands past its own
    (20, 28, 3, (G5, (0.3, 0.6, 0.1))),
    (7, 9, 7, (G5, G5)),
    (40, 10, 14, TAPS63),
    (16, 12, 1, (G5, G5)),
])
def test_the_resident_model_is_the_plain_version(H, W, c, taps, prox, tol):
    """The banded schedule, its sums per band in rank order, against
    admm_tv_fused_torch in float64: the same x to 1e-12 of max|x| and the
    same live CG steps (a tol_inner of 5e-2 freezes some steps)."""
    x0, scal = _problem(3, H, W)
    plan = _resident(c, H, W)
    assert all(plan.band_rows(q) >= 1 for q in range(c))
    for tv in (0, 1, 4):
        t2 = torch.from_numpy(_fgp_common.fgp_t2_table(tv, np.float64))
        got, live = resident_admm(x0, scal, t2, taps, 5, 4, tol, prox, plan)
        want, want_live = admm.admm_tv_fused_torch(x0, scal, t2, taps, 5, 4, tol, prox)
        assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
        assert live.tolist() == want_live.tolist()
        if tol > 1e-3:
            assert min(live.tolist()) < 5 * 4


@pytest.mark.parametrize("iterations,cg,tv", [(0, 3, 4), (3, 0, 4), (3, 1, 4), (3, 3, 0),
                                              (2, 2, 1)])
def test_the_resident_model_at_the_edge_schedules(iterations, cg, tv):
    """No outer iteration, no CG step, one CG step, no dual iteration, one
    dual iteration (and ρ = 0 for one problem): the schedule still gives the
    plain version's x and live steps."""
    x0, scal = _problem(3, 20, 28)
    t2 = torch.from_numpy(_fgp_common.fgp_t2_table(tv, np.float64))
    got, live = resident_admm(x0, scal, t2, (G5, (0.3, 0.6, 0.1)), iterations, cg, 1e-5,
                              "positive", _resident(3, 20, 28))
    want, want_live = admm.admm_tv_fused_torch(x0, scal, t2, (G5, (0.3, 0.6, 0.1)), iterations,
                                               cg, 1e-5, "positive")
    assert float((got - want).abs().max()) <= 1e-12 * max(float(want.abs().max()), 1.0)
    assert live.tolist() == want_live.tolist()


def test_the_resident_model_runs_the_planners_plan():
    """The planner's own bands, on a card with little shared memory."""
    x0, scal = _problem(2, 30, 16)
    plan = _plan(2, 30, 16, 5, 3, smem_max=admm.cluster_smem_bytes(4, 16))
    assert plan.route == "resident" and plan.clusters == 8 and plan.rows == 4
    taps = (G5, (0.3, 0.6, 0.1))
    t2 = torch.from_numpy(_fgp_common.fgp_t2_table(3, np.float64))
    got, live = resident_admm(x0, scal, t2, taps, 4, 3, 1e-5, "positive", plan)
    want, want_live = admm.admm_tv_fused_torch(x0, scal, t2, taps, 4, 3, 1e-5, "positive")
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert live.tolist() == want_live.tolist()


@pytest.mark.parametrize("dropped", BARRIERS)
def test_each_barrier_of_the_table_is_needed(dropped):
    """Without any one barrier of the header's table a plane (or sum slot)
    that a band reads from another is written by some band between two
    barriers: the model raises and names it."""
    x0, scal = _problem(2, 20, 8)
    t2 = torch.from_numpy(_fgp_common.fgp_t2_table(3, np.float64))
    args = (x0, scal, t2, (G5, G5), 2, 3, 1e-5, "none", _resident(4, 20, 8, B=2))
    resident_admm(*args)  # with every barrier: no hazard
    with pytest.raises(Hazard, match="read from another band and written"):
        resident_admm(*args, dropped=(dropped,))


def test_back_to_back_sums_need_two_slots():
    """p·q and r·r follow each other with no other cluster barrier: with one
    slot a CTA would rewrite it while its peers still read it."""
    x0, scal = _problem(2, 20, 8)
    t2 = torch.from_numpy(_fgp_common.fgp_t2_table(3, np.float64))
    with pytest.raises(Hazard, match="slot0"):
        resident_admm(x0, scal, t2, (G5, G5), 2, 3, 1e-5, "none", _resident(4, 20, 8, B=2),
                      slots=1)
