"""The fused PDHG kernel's planner (rls_tpu_torch/kernels/pdhg_fused.py
``plan_pdhg``) and a Python model of its resident route, on the CPU.

The planner: which route and cluster size a shape takes on an H100 (132
SMs, 232,448 bytes of shared memory per block), that every resident plan
covers H with its bands and fits the card, that the row → (rank, local
row) map owns each row once and reaches every stencil radius up to 31,
that the shared-memory count matches the kernel's piece by piece, and
that a shape with no route raises.

The model: PDHG computed band by band, as the resident kernel's CTAs
compute it (csrc/pdhg_fused.cu), each band reading another band's rows
only as they stood at the last cluster barrier, in the kernel's barrier
order. It is held bit for bit against ``pdhg_fused_torch`` in float32, and
it checks the barrier table of the kernel's header: a plane that a band
reads from another band between two cluster barriers must not be written
between them. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from rls_tpu_torch.kernels import pdhg_fused as pd
from rls_tpu_torch.models.solvers.pdhg import W8, clip_conj
from rls_tpu_torch.ops.conv_direct import stencil_pass
from rls_tpu_torch.ops.grad import DIRS8

SMS, SMEM = 132, 232_448
# the clusters of c resident CTAs of the PDHG kernel that an H100 80GB HBM3
# holds at once, by cudaOccupancyMaxActiveClusters (one CTA of 1024 threads
# per SM): the same for every kind and shape these tests plan
# (pdhg_fused.resident_limits; tests/test_torch_cuda.py checks the table on
# the card)
H100_RESIDENT = tuple(zip(range(1, 17), (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7,
                                         7)))
# tests/test_torch_cuda.py's PDHG shapes (3 problems each) with the route
# and cluster size each kind takes: one CTA for the small images, 2 bands
# (tv8 only), 4, 8 and 16 bands of 14 rows (55, 110 and 221 rows do not
# divide into them; at 221 × 300 a 63-tap column pass reaches two bands
# past its own), and a row too wide for any band
PDHG_ROUTES = {
    (17, 23): {"tv8": ("resident", 1), "tviso": ("resident", 1), "l1": ("resident", 1)},
    (9, 33): {"tv8": ("resident", 1), "tviso": ("resident", 1), "l1": ("resident", 1)},
    (3, 2): {"tv8": ("resident", 1), "tviso": ("resident", 1), "l1": ("resident", 1)},
    (25, 256): {"tv8": ("resident", 2), "tviso": ("resident", 1), "l1": ("resident", 1)},
    (55, 300): {"tv8": ("resident", 4), "tviso": ("resident", 4), "l1": ("resident", 4)},
    (110, 300): {"tv8": ("resident", 8), "tviso": ("resident", 8), "l1": ("resident", 8)},
    (221, 300): {"tv8": ("resident", 16), "tviso": ("resident", 16), "l1": ("resident", 16)},
    (2, 15000): {"tv8": ("global", 1), "tviso": ("global", 1), "l1": ("global", 1)},
}


def _plan(B, H, W, kind="tv8", kh=9, kw=9, resident=H100_RESIDENT, **card):
    return pd.plan_pdhg(B, H, W, kh, kw, kind, resident, **card)


def _covers(plan, B, H, W, kind, sms=SMS, smem=SMEM):
    """A resident plan's bands cover H with none empty; it fits the card."""
    assert plan.route == "resident"
    c, rows = plan.clusters, plan.rows
    assert 1 <= c <= min(pd.MAX_CLUSTER, sms)
    assert (c - 1) * rows < H <= c * rows
    assert all(plan.band_rows(q) >= 1 for q in range(c))
    assert sum(plan.band_rows(q) for q in range(c)) == H
    assert plan.ctas == B * c
    assert plan.smem == pd.cluster_smem_bytes(kind, rows, W) <= smem


@pytest.mark.parametrize("kind,B,want", [
    # the cell: tv8 fits only 13–16 bands (11 planes); 16 bands of 16 rows
    # take 3 waves of ≤ 7 clusters, as do 13–15 bands of 18–20 rows
    ("tv8", 16, (16, 16, 181_432)),
    ("tv8", 4, (16, 16, 181_432)),
    ("tv8", 64, (16, 16, 181_432)),
    # tviso (5 planes) and L1 (4) fit 6 bands of 43 rows, 17 clusters at
    # once: the 16 problems in one wave
    ("tviso", 16, (6, 43, 221_584)),
    ("l1", 16, (6, 43, 177_552)),
    # 64 problems: 5 waves of 15 clusters of 8 (32 rows) tie with 10 waves of
    # 7 clusters of 16 (16 rows): the smaller cluster; L1 fits 5 bands of 52
    # rows, 3 waves of 22
    ("tviso", 64, (8, 32, 165_176)),
    ("l1", 64, (5, 52, 214_488)),
])
def test_plans_at_the_cell(kind, B, want):
    plan = _plan(B, 256, 256, kind)
    _covers(plan, B, 256, 256, kind)
    assert (plan.clusters, plan.rows, plan.smem) == want


def test_the_cells_fitting_sizes():
    assert pd.fitting_sizes("tv8", 256, 256) == (13, 14, 15, 16)
    assert pd.fitting_sizes("tviso", 256, 256) == tuple(range(6, 17))
    assert pd.fitting_sizes("l1", 256, 256) == tuple(range(5, 17))


@pytest.mark.parametrize("shape", list(PDHG_ROUTES))
@pytest.mark.parametrize("kind", pd.KINDS)
def test_the_card_tests_shapes_take_their_routes(shape, kind):
    """The routes tests/test_torch_cuda.py asserts on the card."""
    plan = _plan(3, *shape, kind, 5, 3)
    assert (plan.route, plan.clusters) == PDHG_ROUTES[shape][kind]
    if plan.route == "resident":
        _covers(plan, 3, *shape, kind)
    else:
        assert (plan.rows, plan.ctas, plan.smem) == (shape[0], 3, 0)


@pytest.mark.parametrize("shape,kind,c,bands", [
    # each cluster size, with uneven bands (the last shorter) and bands
    # shorter than a 63-tap stencil's radius of 31
    ((17, 23), "tv8", 1, [17]),
    ((25, 256), "tv8", 2, [13, 12]),
    ((55, 300), "l1", 4, [14, 14, 14, 13]),
    ((110, 300), "tviso", 8, [14] * 7 + [12]),
    ((221, 300), "tv8", 16, [14] * 15 + [11]),
    ((256, 256), "tv8", 16, [16] * 16),
])
def test_shapes_that_force_each_cluster_size(shape, kind, c, bands):
    plan = _plan(3, *shape, kind, 63, 3)
    _covers(plan, 3, *shape, kind)
    assert plan.clusters == c
    assert [plan.band_rows(q) for q in range(c)] == bands


@pytest.mark.parametrize("B", [1, 7, 16, 200])
@pytest.mark.parametrize("H,W", [(1, 8), (17, 23), (33, 700), (256, 256), (255, 257), (1000, 60),
                                 (60, 1000), (4096, 16), (2, 5000), (300, 300)])
@pytest.mark.parametrize("kind", pd.KINDS)
def test_every_resident_plan_covers_its_shape_and_fits(B, H, W, kind):
    """Where bands fit, the plan is resident, covers H and fits; it has the
    fewest waves × rows per band among the sizes it may take."""
    fit = pd.fitting_sizes(kind, H, W)
    if not fit:
        assert _plan(B, H, W, kind).route == "global"
        return
    plan = _plan(B, H, W, kind)
    _covers(plan, B, H, W, kind)
    held = dict(H100_RESIDENT)

    def cost(c):
        return -(-B // held[c]) * -(-H // c)

    allowed = [c for c in fit if c == fit[0] or -(-H // c) * W >= pd.MIN_CTA_PIXELS]
    assert plan.clusters in allowed
    assert cost(plan.clusters) == min(cost(c) for c in allowed)
    assert all(c >= plan.clusters for c in allowed if cost(c) == cost(plan.clusters))


@pytest.mark.parametrize("H,W,c", [(256, 256, 16), (221, 300, 16), (110, 300, 8), (55, 300, 4),
                                   (25, 256, 2), (17, 23, 1)])
def test_the_row_map_owns_every_row_once_and_reaches_every_radius(H, W, c):
    """locate(row) names the one CTA whose band holds the row; from every
    row of every band each row within 31 (the widest stencil radius)
    inside the image resolves to a real row of some band, and the kernel's
    row table (rows + 2·HALO entries from r0 − HALO) holds it."""
    plan = _plan(3, H, W, "tv8", 63, 3)
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
    assert pd.HALO == 31
    for rank in range(c):
        r0 = rank * plan.rows
        for lr in range(plan.band_rows(rank)):
            for s in range(-pd.HALO, pd.HALO + 1):
                r = r0 + lr + s
                if 0 <= r < H:
                    q, l = plan.locate(r)
                    assert 0 <= q < c and 0 <= l < plan.band_rows(q)
                    assert 0 <= r - (r0 - pd.HALO) < plan.rows + 2 * pd.HALO


def test_cluster_smem_bytes_counts_every_piece():
    # the cell, 16 rows of 256: 11 f32 planes (x, y1, t1, 8 duals), 6 int64
    # phase clocks, 16 + 62 row pointers, 126 f32 taps and 8 weights
    assert pd.cluster_smem_bytes("tv8", 16, 256) == 11 * 16384 + 48 + 8 * 78 + 4 * 134
    assert pd.cluster_smem_bytes("tviso", 16, 256) == 5 * 16384 + 48 + 8 * 78 + 4 * 134
    assert pd.cluster_smem_bytes("l1", 16, 256) == 4 * 16384 + 48 + 8 * 78 + 4 * 134
    # each plane rounded up to 4 floats: 3 × 5 = 15 → 16
    assert pd.cluster_smem_bytes("tv8", 3, 5) == 11 * 64 + 48 + 8 * 65 + 4 * 134
    assert pd.PHASES == ("set-up", "A x pass", "dual update", "Aᴴ y₁ pass", "primal update",
                         "cluster barriers")


@pytest.mark.parametrize("kind,W,widest", [("tv8", 5_257, 5_256), ("tv8", 9_000, 5_256),
                                           ("tviso", 11_569, 11_568), ("l1", 14_461, 14_460),
                                           ("l1", 65_536, 14_460)])
def test_a_too_wide_row_takes_the_global_route(kind, W, widest):
    """A band of one row needs more than 232,448 bytes: tv8 past 5,256
    pixels, tviso past 11,568, L1 past 14,460."""
    plan = _plan(4, 2, W, kind)
    assert (plan.route, plan.clusters, plan.rows, plan.ctas, plan.smem) == ("global", 1, 2, 4, 0)
    assert pd.fitting_sizes(kind, 1, W) == ()
    assert pd.fitting_sizes(kind, 1, widest) == (1,)
    assert pd.fitting_sizes(kind, 1, widest + 1) == ()


@pytest.mark.parametrize("sms,smem,kind,route,c", [
    # cards that are not an H100, each taken to hold sms // c clusters of c:
    # fewer SMs cap the cluster size
    (8, SMEM, "tviso", "resident", 8),
    (8, SMEM, "tv8", "global", 1),
    # less shared memory: more bands, or none that fit
    (SMS, 120_000, "tviso", "resident", 16),
    (SMS, 48 * 1024, "tv8", "global", 1),
])
def test_plans_respect_the_card(sms, smem, kind, route, c):
    held = tuple((k, sms // k) for k in range(1, 17))
    plan = _plan(16, 256, 256, kind, resident=held, sms=sms, smem_max=smem)
    assert (plan.route, plan.clusters) == (route, c)
    if route == "resident":
        _covers(plan, 16, 256, 256, kind, sms=sms, smem=smem)


@pytest.mark.parametrize("args,match", [
    ((0, 8, 8, "tv8", 3, 3), "empty shape 0 x 8x8"),
    ((2, 0, 8, "tv8", 3, 3), "empty shape 2 x 0x8"),
    ((2, 8, 8, "tv8", 65, 3), "65 x 3 taps"),
    ((2, 8, 8, "tv9", 3, 3), "unknown PDHG kind 'tv9'"),
    # rows wider than any band and 2³¹ pixels per problem: no route
    ((1, 2, 2**30, "l1", 3, 3), "no route for 1 x 2x1073741824"),
])
def test_a_shape_without_a_route_raises_and_names_it(args, match):
    with pytest.raises(ValueError, match=match):
        _plan(*args)


def test_a_plan_the_card_holds_no_cluster_of_raises():
    """No fallback: the resident route where the card holds none of its
    clusters is an error naming the plan, not a quiet global launch."""
    with pytest.raises(ValueError, match="holds no cluster of PdhgPlan"):
        _plan(16, 256, 256, "tv8", resident=((1, 132), (8, 15)))


# ---- a Python model of the resident route


class Hazard(AssertionError):
    """A plane read from another band and written between two cluster
    barriers."""


class ResidentModel:
    """The resident route's planes, band by band. A band reads its own rows
    as they stand; another band's rows as they stood at the last cluster
    barrier (`barrier` publishes every band's planes); rows past the image
    as zero. Between two barriers the planes read from another band and
    the planes written must not meet (`barrier` raises Hazard): that is the
    kernel's rule for distributed shared memory."""

    def __init__(self, plan, u, kind):
        self.plan, self.kind = plan, kind
        self.B, self.H, self.W = u.shape
        self.bands = range(plan.clusters)
        zero = u * 0.0
        names = ["x", "y1", "t1"] + [f"y2_{k}" for k in range(pd._PLANES[kind])]
        self.live = [{n: self.band(zero, q).clone() for n in names} for q in self.bands]
        self.published = None
        self.read_remote, self.written = set(), set()

    def band(self, plane, q):
        r0 = q * self.plan.rows
        return plane[:, r0:r0 + self.plan.band_rows(q)]

    def barrier(self):
        met = self.read_remote & self.written
        if met:
            raise Hazard(f"read from another band and written between two barriers: {met}")
        self.published = [{n: t.clone() for n, t in planes.items()} for planes in self.live]
        self.read_remote, self.written = set(), set()

    def write(self, q, name, value):
        self.written.add(name)
        self.live[q][name] = value

    def rows(self, q, name, lo, hi):
        """Image rows lo … hi − 1 of plane `name` as band q sees them."""
        out = []
        for r in range(lo, hi):
            if not 0 <= r < self.H:
                out.append(torch.zeros(self.B, self.W, dtype=torch.float32))
                continue
            owner, lr = self.plan.locate(r)
            if owner == q:
                out.append(self.live[q][name][:, lr])
            else:
                self.read_remote.add(name)
                out.append(self.published[owner][name][:, lr])
        return torch.stack(out, dim=1)

    def column_pass(self, q, name, taps, adjoint):
        """stencil_pass along the rows on band q, halo rows from the others."""
        R, n, r0 = len(taps) // 2, self.plan.band_rows(q), q * self.plan.rows
        ext = self.rows(q, name, r0 - R, r0 + n + R)
        acc = None
        for k, t in enumerate(taps):
            s = (R - k) if adjoint else (k - R)
            term = t * ext[:, R + s:R + s + n]
            acc = term if acc is None else acc + term
        return acc

    def mask(self, q, lo, hi, dr, dc):
        """Where x[r, c] − x[r + dr, c + dc] is defined, image rows lo … hi − 1."""
        r = torch.arange(lo, hi)[:, None]
        c = torch.arange(self.W)[None, :]
        m = (r >= 0) & (r < self.H - dr) & ((c < self.W - dc) if dc >= 0 else (c >= -dc))
        return m.to(torch.float32)


def _shift_cols(v, dc):
    """v[..., c + dc], zero past the edge."""
    out = torch.zeros_like(v)
    W = v.shape[-1]
    if dc >= 0:
        out[..., :W - dc] = v[..., dc:]
    else:
        out[..., -dc:] = v[..., :W + dc]
    return out


def resident_pdhg(u, scal, taps, iterations, kind, prox, plan, barriers=("B1", "B2")):
    """PDHG by the resident route's phases and barriers: set-up, then per
    iteration (a) t1 = column pass of A on x, (b) the dual update, B1,
    (c) t1 = column pass of Aᴴ on y₁, (d) the primal update, B2."""
    taps_h, taps_w = taps
    m = ResidentModel(plan, u, kind)
    B, H, W = u.shape
    sigma, tau, lam = (scal[:, k].view(-1, 1, 1) for k in range(3))
    inv1s = 1.0 / (1.0 + sigma)
    np_ = pd._PLANES[kind]
    m.barrier()  # the set-up's
    for _ in range(iterations):
        for q in m.bands:  # (a)
            m.write(q, "t1", m.column_pass(q, "x", taps_h, False))
        for q in m.bands:  # (b)
            n, r0 = plan.band_rows(q), q * plan.rows
            own = m.live[q]
            x = own["x"]
            ax = stencil_pass(own["t1"], taps_w, -1, False)
            m.write(q, "y1", (own["y1"] + sigma * (ax - m.band(u, q))) * inv1s)
            if kind == "tv8":
                ext = m.rows(q, "x", r0, r0 + n + 2)  # x up to 2 rows down
                p = [own[f"y2_{k}"] + sigma * ((x - _shift_cols(ext[:, dr:dr + n], dc))
                                               * m.mask(q, r0, r0 + n, dr, dc))
                     for k, (dr, dc) in enumerate(DIRS8)]
                for k in range(8):
                    gnorm = torch.sqrt(sum(v * v for v in p))
                    p[k] = W8[k] * torch.sign(p[k]) * torch.minimum(gnorm, lam)
            elif kind == "tviso":
                below = m.rows(q, "x", r0 + 1, r0 + n + 1)
                gv = (below - x) * m.mask(q, r0, r0 + n, 1, 0)
                gh = (_shift_cols(x, 1) - x) * m.mask(q, r0, r0 + n, 0, 1)
                p = [clip_conj(own["y2_0"] + sigma * gv, lam),
                     clip_conj(own["y2_1"] + sigma * gh, lam)]
            else:
                p = [clip_conj(own["y2_0"] + sigma * x, lam)]
            for k in range(np_):
                m.write(q, f"y2_{k}", p[k])
        if "B1" in barriers:
            m.barrier()
        for q in m.bands:  # (c)
            m.write(q, "t1", m.column_pass(q, "y1", taps_h, True))
        for q in m.bands:  # (d)
            n, r0 = plan.band_rows(q), q * plan.rows
            own = m.live[q]
            aty = stencil_pass(own["t1"], taps_w, -1, True)
            if kind == "tv8":
                d = None
                for k, (dr, dc) in enumerate(DIRS8):
                    qk = own[f"y2_{k}"] * m.mask(q, r0, r0 + n, dr, dc)
                    ext = m.rows(q, f"y2_{k}", r0 - 2, r0 + n)  # up to 2 rows up
                    ext = ext * m.mask(q, r0 - 2, r0 + n, dr, dc)
                    term = qk - _shift_cols(ext[:, 2 - dr:2 - dr + n], -dc)
                    d = term if d is None else d + term
            elif kind == "tviso":
                up = m.rows(q, "y2_0", r0 - 1, r0 + n - 1)
                d = (up - own["y2_0"] + _shift_cols(own["y2_1"], -1)) - own["y2_1"]
            else:
                d = own["y2_0"]
            x = own["x"] - tau * (aty + d)
            if prox == "positive":
                x = torch.clamp(x, min=0.0)
            m.write(q, "x", x)
        if "B2" in barriers:
            m.barrier()
    m.barrier()  # what the kernel's last B2 orders before its CTAs exit
    return torch.cat([m.live[q]["x"] for q in m.bands], dim=1)


G5 = tuple((np.exp(-((np.arange(5) - 2) ** 2) / 2.0) / np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
            .sum()).tolist())
_G63 = np.exp(-(((np.arange(63) - 31) / 9.0) ** 2)) * (1 + 0.01 * np.arange(63))
TAPS63 = (tuple((_G63 / _G63.sum()).tolist()), (0.3, 0.6, 0.1))


def _problem(B, H, W, seed=5):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.normal(size=(B, H, W)).astype(np.float32))
    sigma = torch.tensor([0.5, 1.0, 0.0625][:B])
    tau = torch.tensor([0.3, 0.2, 0.9][:B])
    lam = torch.tensor([5e-2, 0.0, 0.1][:B])
    return u, pd.kernel_scalars(u, sigma, tau, lam)


@pytest.mark.parametrize("prox", pd.PROXES)
@pytest.mark.parametrize("kind", pd.KINDS)
@pytest.mark.parametrize("H,W,c,taps", [
    # uneven bands (7, 7, 6), one-row bands, and a 63-tap column blur over
    # 3-row bands: its pass reaches 10 bands past its own
    (20, 12, 3, (G5, (0.3, 0.6, 0.1))),
    (7, 9, 7, (G5, G5)),
    (40, 10, 14, TAPS63),
])
def test_the_resident_model_is_bitwise_the_plain_version(kind, prox, H, W, c, taps):
    u, scal = _problem(3, H, W)
    rows = -(-H // c)
    plan = pd.PdhgPlan("resident", c, rows, H, 3 * c, pd.cluster_smem_bytes(kind, rows, W))
    assert [plan.band_rows(q) >= 1 for q in range(c)] == [True] * c
    got = resident_pdhg(u, scal, taps, 6, kind, prox, plan)
    want = pd.pdhg_fused_torch(u, scal, taps, 6, kind, prox)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", pd.KINDS)
def test_the_resident_model_runs_the_planners_plan(kind):
    """The planner's own bands, on a card with little shared memory."""
    u, scal = _problem(2, 30, 16)
    plan = _plan(2, 30, 16, kind, 5, 3, smem_max=pd.cluster_smem_bytes(kind, 4, 16))
    assert plan.route == "resident" and plan.clusters == 8 and plan.rows == 4
    taps = (G5, (0.3, 0.6, 0.1))
    got = resident_pdhg(u, scal, taps, 5, kind, "positive", plan)
    assert torch.equal(got, pd.pdhg_fused_torch(u, scal, taps, 5, kind, "positive"))


@pytest.mark.parametrize("dropped", ["B1", "B2"])
@pytest.mark.parametrize("kind", pd.KINDS)
def test_each_cluster_barrier_is_needed(kind, dropped):
    """Without B1 the column pass of Aᴴ reads y₁ that other bands write in
    the same window, without B2 the next A x pass reads x that way: the
    model names the plane."""
    u, scal = _problem(2, 20, 8)
    plan = pd.PdhgPlan("resident", 4, 5, 20, 8, pd.cluster_smem_bytes(kind, 5, 8))
    kept = tuple(b for b in ("B1", "B2") if b != dropped)
    with pytest.raises(Hazard, match="y1" if dropped == "B1" else "x"):
        resident_pdhg(u, scal, (G5, G5), 3, kind, "none", plan, barriers=kept)
