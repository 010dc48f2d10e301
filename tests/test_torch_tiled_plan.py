"""Row 3's planner (rls_tpu_torch/kernels/fista_tv_tiled.py
``plan_fista_tv_tiled``), a Python model of the cluster route, and the
JAX VMEM-carry variant against the port, on the CPU.

The planner: which route, cluster size and plane placement a shape takes
on an H100 (132 SMs, 232,448 bytes of shared memory per block): 512² on
a cluster of 16 with three planes of a band in shared memory, 1024² on
row tiles, a caller's `tile_rows` on row tiles; that every cluster plan
covers H with its bands and fits the card, that the shared-memory count
is the kernel's, and that a shape without a route raises and names
itself.

The model: a PGM-TV solve computed band by band in float64, as the
resident kernel's CTAs compute it (csrc/pgm_tv_cluster.cuh), each band
reading another band's rows only as they stood at the last cluster
barrier, on the kernel's physical planes in either placement (six planes
A–F in shared memory; or S0–S2, with t3, xg's own-pixel copy, pv and ph
in global memory and p left in S1 by the last dual iteration). It is held
against ``fista_tv_fused_torch`` in float64, and it checks the barrier
table of the kernel's header: a plane that a band reads from another band
between two cluster barriers must not be written between them, so that
dropping any barrier of the table raises. The kernel itself runs only on
the card (tests/test_torch_cuda.py).

The JAX side: ``rls_tpu.kernels.fista_tv_tiled.fista_tv_tiled`` with
``mode="vmem"`` in interpret mode (its fori FGP; the port runs the fold
form, the same f32 math up to ≤ 1 ulp per iteration) against the port's
wrapper on CPU tensors, which runs the plain version."""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rls_tpu_torch.kernels import _fgp_common
from rls_tpu_torch.kernels import fista_tv_fused as fused
from rls_tpu_torch.kernels import fista_tv_tiled as tiled
from rls_tpu_torch.kernels._bands import MIN_CTA_PIXELS
from rls_tpu_torch.ops.conv_direct import stencil_pass

from test_torch_tv_fgp_plan import H100_RESIDENT

jtiled = importlib.import_module("rls_tpu.kernels.fista_tv_tiled")

CSRC = Path(tiled.__file__).parents[1] / "csrc"
SMS, SMEM = 132, 232_448
FISTA = ("fista", "none", False)
SCHEDULES = [FISTA, ("optista", "none", False), ("pogm", "none", False),
             ("fista", "gradient", True), ("pogm", "gradient", False),
             ("fista", "gradient_mapping", False)]


def _plan(B, H, W, kh=9, kw=9, schedule=FISTA, resident=H100_RESIDENT, **kw_):
    return tiled.plan_fista_tv_tiled(B, H, W, kh, kw, schedule, resident, **kw_)


def _covers(plan, B, H, W, sms=SMS, smem=SMEM):
    """A cluster plan's bands cover H with none empty; it fits the card."""
    assert plan.route == "cluster"
    c, rows = plan.clusters, plan.rows
    assert 1 <= c <= min(fused.MAX_CLUSTER, sms)
    assert (c - 1) * rows < H <= c * rows
    assert all(plan.band_rows(q) >= 1 for q in range(c))
    assert sum(plan.band_rows(q) for q in range(c)) == H
    assert plan.ctas == B * c
    shared = plan.own == "shared"
    assert plan.smem == fused.cluster_smem_bytes(rows, W, shared) <= smem
    assert plan.scratch == (fused.RESIDENT_SCRATCH if shared else fused.THREE_PLANE_SCRATCH)


@pytest.mark.parametrize("schedule", SCHEDULES, ids=str)
def test_the_512_cell_takes_a_cluster_of_16_with_three_planes(schedule):
    """16 × 512²: three planes of 32 rows (196,608 bytes) fit c = 14 … 16,
    six fit no band; c = 16 has the fewest waves × rows (3 waves of 32
    rows, against 3 of 35 and 37): 198,752 bytes a CTA, 7 clusters at once
    on an H100."""
    assert tiled.fitting_sizes(512, 512) == (14, 15, 16)
    assert tiled.own_shared_sizes(512, 512) == ()
    plan = _plan(16, 512, 512, schedule=schedule)
    _covers(plan, 16, 512, 512)
    assert (plan.route, plan.clusters, plan.rows, plan.smem, plan.own) == (
        "cluster", 16, 32, 198_752, "global")
    assert plan.smem == 3 * 4 * 32 * 512 + 832 + 56 + 8 * 94 + 504


def test_the_1024_cell_walks_row_tiles():
    """8 × 1024²: a band of 64 rows of 4 KiB per plane fits not even three
    planes at c = 16: the tiles route, 64-row tiles (16 per problem, 128
    CTAs on 132 SMs)."""
    assert tiled.fitting_sizes(1024, 1024) == ()
    plan = _plan(8, 1024, 1024)
    assert (plan.route, plan.clusters, plan.rows, plan.ctas) == ("tiles", 16, 64, 128)
    assert (plan.smem, plan.scratch) == (fused.GLOBAL_SMEM, tiled.TILE_SCRATCH)


@pytest.mark.parametrize("tile_rows", [8, 64, 100, 512])
def test_tile_rows_forces_the_tiles_route(tile_rows):
    """A caller's tile_rows keeps today's meaning (and lets the timing mode
    run the parent's kernel): row tiles at any shape."""
    plan = _plan(16, 512, 512, tile_rows=tile_rows)
    tiles = -(-512 // tile_rows)
    assert (plan.route, plan.clusters, plan.rows, plan.ctas) == ("tiles", tiles, tile_rows,
                                                                 16 * tiles)


def test_the_boundary_384():
    """384² is the largest square image whose bands fit six planes at c =
    16 (24 rows, 223,264 bytes): the dispatch sends it to row 2, and row
    3's planner takes the same plan; 385² fits three planes only."""
    assert fused.fitting_sizes(384, 384) == (16,)
    assert fused.fitting_sizes(385, 385) == ()
    assert tiled.own_shared_sizes(384, 384) == (16,)
    assert tiled.fitting_sizes(384, 384) == tuple(range(8, 17))
    plan = _plan(16, 384, 384)
    _covers(plan, 16, 384, 384)
    assert (plan.clusters, plan.rows, plan.smem, plan.own) == (16, 24, 223_264, "shared")
    row2 = fused.plan_pgm_tv(16, 384, 384, 9, 9, ("fista", "none", False, False),
                             ((1, 132), (2, 66), (4, 30), (8, 15), (16, 7)))
    assert (row2.clusters, row2.rows, row2.smem) == (plan.clusters, plan.rows, plan.smem)
    three = _plan(16, 385, 385)
    _covers(three, 16, 385, 385)
    assert three.own == "global"


@pytest.mark.parametrize("B", [1, 4, 16, 64])
@pytest.mark.parametrize("H,W", [(384, 384), (500, 520), (512, 512), (640, 480), (1000, 60),
                                 (33, 700), (2, 10000), (4, 19000), (700, 600), (1024, 1024),
                                 (4, 20000), (17, 23)])
@pytest.mark.parametrize("schedule", [FISTA, ("pogm", "gradient", True)], ids=str)
def test_every_cluster_plan_covers_its_shape_and_fits(B, H, W, schedule):
    """Where three planes of a band fit, the plan is on the cluster route,
    covers H and fits, with all six planes on chip where its band fits
    them; among the fitting sizes it has the least waves × priced rows.
    Elsewhere the tiles route."""
    fit = tiled.fitting_sizes(H, W)
    plan = _plan(B, H, W, schedule=schedule)
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


@pytest.mark.parametrize("c,rows,own", [(14, 37, "global"), (15, 35, "global"),
                                        (16, 32, "global")])
def test_a_forced_cluster_size(c, rows, own):
    """The timing mode's forced sizes at the 512² cell (c = 15 against 16)."""
    plan = _plan(16, 512, 512, clusters=c)
    _covers(plan, 16, 512, 512)
    assert (plan.clusters, plan.rows, plan.own) == (c, rows, own)


def test_a_forced_placement():
    """The card tests' placement A/B at 16 × 256²: c = 16 holds six planes
    of 16 rows; the three-plane plan of the same c (``_cluster_plan``)
    keeps t3, xg, pv and ph in global memory."""
    six = _plan(16, 256, 256, clusters=16)
    three = tiled._cluster_plan(16, 256, 256, 16, False)
    assert (six.own, six.scratch) == ("shared", fused.RESIDENT_SCRATCH)
    assert (three.own, three.scratch, three.rows) == ("global", fused.THREE_PLANE_SCRATCH, 16)
    assert three.smem == fused.cluster_smem_bytes(16, 256, False) < six.smem


@pytest.mark.parametrize("sms,smem,route,c,own", [
    # cards that are not an H100, each taken to hold sms // c clusters of c
    (8, SMEM, "tiles", 1, "global"),
    (16, SMEM, "cluster", 16, "global"),
    (SMS, 120_000, "tiles", 1, "global"),
])
def test_plans_respect_the_card(sms, smem, route, c, own):
    held = tuple((k, sms // k) for k in range(1, 17))
    plan = _plan(16, 512, 512, resident=held, sms=sms, smem_max=smem)
    assert plan.route == route
    if route == "cluster":
        assert (plan.clusters, plan.own) == (c, own)
        _covers(plan, 16, 512, 512, sms=sms, smem=smem)


@pytest.mark.parametrize("args,kw,match", [
    ((0, 8, 8), {}, "empty shape 0 x 8x8"),
    ((2, 0, 8), {}, "empty shape 2 x 0x8"),
    ((2, 8, 8, 65, 3), {}, "65 x 3 taps"),
    ((16, 512, 512), {"clusters": 13}, "a cluster of 13 CTAs does not fit 16 x 512x512"),
    ((16, 1024, 1024), {"clusters": 16}, "a cluster of 16 CTAs does not fit 16 x 1024x1024"),
    ((16, 512, 512), {"tile_rows": 0}, "tile_rows must be positive"),
    ((2, 8, 8), {"schedule": ("optista", "gradient", False)}, "FISTA/POGM-only"),
    ((2, 8, 8), {"schedule": ("pogm", "gradient_mapping", False)}, "gradient_mapping"),
])
def test_a_shape_without_a_route_raises_and_names_it(args, kw, match):
    with pytest.raises(ValueError, match=match):
        _plan(*args, **kw)


def test_a_plan_the_card_holds_no_cluster_of_raises():
    """No fallback: the cluster route where the card holds none of its
    clusters is an error naming the plan, not a quiet launch on the row
    tiles."""
    with pytest.raises(ValueError, match="holds no cluster of TiledPlan"):
        _plan(16, 512, 512, resident=((1, 132), (2, 66)))


def test_the_planner_reads_the_kernel_s_constants():
    """Threads, the largest cluster, the two placements' planes and the
    shared-memory count as csrc/pgm_tv_cluster.cuh states them; the
    barriers of the model are the header's table; the planner's entry
    points are bound."""
    src = (CSRC / "pgm_tv_cluster.cuh").read_text()
    assert re.findall(r"constexpr int kThreads = (\d+);", src) == [str(fused.THREADS)]
    assert re.findall(r"constexpr int kMaxCluster = (\d+);", src) == [str(fused.MAX_CLUSTER)]
    assert re.findall(r"constexpr int kAllPlanes = (\d+);", src) == [str(fused.ALL_PLANES)]
    assert re.findall(r"constexpr int kSharedPlanes = (\d+);", src) == [
        str(fused.SHARED_PLANES)]
    smem = re.search(r"cluster_smem_bytes\(int rows, int W, bool own_shared\) \{(.*?)\n\}", src,
                     re.S).group(1)
    for piece in ("sizeof(float) * (own_shared ? kAllPlanes : kSharedPlanes)",
                  "band_plane_floats(rows, W)", "sizeof(double) * (3 * (kThreads / 32) + 8)",
                  "sizeof(long long) * kPhases", "sizeof(const float*) * (rows + 2 * kHalo)",
                  "sizeof(float) * 2 * kMaxTaps"):
        assert piece in smem
    phases = re.search(r"enum \{\s*(kSetup[^}]*)\}", src).group(1)
    assert len([p for p in phases.split(",") if p.strip()]) == len(fused.PHASES) + 1
    header = src.split("#pragma once")[0]
    for name in BARRIERS:
        assert re.search(rf"^//\s+{name}\s", header, re.M), name
    for cu, entry in (("fista_tv_fused.cu", "fista_tv_cluster"),
                      ("fista_tv_tiled.cu", "fista_tv_tiled_cluster")):
        text = (CSRC / cu).read_text()
        for suffix in ("_occupancy", "_launch"):
            assert f"int {entry}{suffix}(" in text
            assert f'"{entry}{suffix}"' in (CSRC.parent / "_build.py").read_text()


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU tensor runs the plain version on either route's arguments; the
    launch counters do not move."""
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(rng.normal(size=(2, 12, 10)).astype(np.float32))
    taps = ((0.2, 0.6, 0.2), (0.1, 0.8, 0.1))
    before = (tiled.fista_tv_tiled.launches, dict(tiled.fista_tv_tiled.route_launches))
    got = tiled.fista_tv_tiled(x0, taps, 0.9, 0.05, 4, 3)
    tiles = tiled.fista_tv_tiled(x0, taps, 0.9, 0.05, 4, 3, tile_rows=4)
    scal, tab, t2 = fused.kernel_args(x0, 0.9, 0.05, "fista", 4, 3)
    want = tiled.fista_tv_tiled_torch(x0, scal, tab, t2, taps)[0]
    assert torch.equal(got, want) and torch.equal(tiles, want)
    assert (tiled.fista_tv_tiled.launches, tiled.fista_tv_tiled.route_launches) == before


# ---- the JAX VMEM-carry variant against the port

_JAX_TAPS = ((0.1, 0.5, 0.25, -0.2, 0.05), (0.3, 0.6, 0.1))


@pytest.mark.parametrize("method,restart,sigma_fac", [("fista", False, 1.0),
                                                      ("optista", False, 1.0),
                                                      ("pogm", "gradient", 0.8)])
def test_the_jax_vmem_variant_is_the_port(method, restart, sigma_fac):
    """``fista_tv_tiled(mode="vmem", interpret=True)`` of the JAX package,
    the TPU kernel whose H100 counterpart is the cluster route, against the
    port on the same numpy inputs: within 2e-6 of max|x| (its fori FGP
    against the port's fold FGP)."""
    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(2, 32, 24)).astype(np.float32)
    lam = np.array([0.05, 0.1], np.float32)
    want = np.asarray(jtiled.fista_tv_tiled(
        jnp.asarray(x0), _JAX_TAPS, 0.9, lam, 6, 3, interpret=True, mode="vmem",
        method=method, restart=restart, sigma_fac=sigma_fac))
    got = tiled.fista_tv_tiled(torch.from_numpy(x0), _JAX_TAPS, 0.9, torch.from_numpy(lam), 6,
                               3, method=method, restart=restart or "none",
                               sigma_fac=sigma_fac)
    assert float(np.abs(got.numpy() - want).max()) <= 2e-6 * float(np.abs(want).max())


# ---- a Python model of the cluster route


class Hazard(AssertionError):
    """A plane read from another band and written between two cluster
    barriers."""


# the header's table: Bm, Bt, the FGP's Bf0-Bf3, and Be (a dynamic
# schedule's sum barrier Bs adds ordering the planes do not need)
BARRIERS = ("Bm", "Bt", "Bf0", "Bf1", "Bf2", "Bf3", "Be")
# the physical home of each role: a shared-memory plane, or global memory
HOMES = {
    "six": {"gin": "F", "t1": "D", "t2": "C", "t3": "E", "xg": "C", "xg_own": "C", "rv": "D",
            "rh": "E", "y": "F", "pv": "A", "ph": "B", "p": "A"},
    "three": {"gin": "S2", "t1": "S1", "t2": "S0", "t3": "Gt3", "xg": "S2", "xg_own": "Gxg",
              "rv": "S1", "rh": "S0", "y": "S2", "pv": "Gpv", "ph": "Gph", "p": "S1"},
}
SHARED = {"six": "ABCDEF", "three": ("S0", "S1", "S2")}


class ClusterModel:
    """A cluster's planes, band by band. A band reads its own rows as they
    stand; another band's rows as they stood at the last cluster barrier
    (`barrier` publishes every band's planes); rows past the image as
    zero. Between two barriers the planes read from another band and the
    planes written must not meet (`barrier` raises Hazard): the kernel's
    rule for distributed shared memory. A barrier named in `dropped` is
    not there."""

    def __init__(self, H, W, c, placement, dropped=()):
        self.H, self.W, self.R = H, W, -(-H // c)
        self.bands = range(c)
        self.home, self.shared = HOMES[placement], SHARED[placement]
        self.dropped = set(dropped)
        self.live = [{} for _ in self.bands]
        self.published = [{} for _ in self.bands]
        self.read_remote, self.written = set(), set()

    def band_rows(self, q):
        return min(self.R, self.H - q * self.R)

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
        self.written.add(self.home[role])
        self.live[q][self.home[role]] = value

    def rows(self, q, role, lo, hi):
        """Image rows lo … hi − 1 of `role` as band q sees them; only a
        shared-memory plane may be read at another band's rows."""
        home = self.home[role]
        out = []
        for r in range(lo, hi):
            if not 0 <= r < self.H:
                out.append(torch.zeros(self.B, self.W, dtype=torch.float64))
                continue
            owner, lr = divmod(r, self.R)
            if owner == q:
                out.append(self.live[q][home][:, lr])
                continue
            assert home in self.shared, f"{role} ({home}) read at another band's rows"
            self.read_remote.add(home)
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


def cluster_solve(x0hat, scal, tab, t2tab, taps, c, placement, method="fista", warm=False,
                  dropped=()):
    """The fixed-schedule solve by the resident route's sweeps and
    barriers, band by band, in the order of the header of
    csrc/pgm_tv_cluster.cuh; returns x."""
    B, H, W = x0hat.shape
    m = ClusterModel(H, W, c, placement, dropped)
    m.B = B
    bands = list(m.bands)
    taps_h, taps_w = taps
    rh_, rw_ = len(taps_h) // 2, len(taps_w) // 2
    rho = scal[:, 0].view(-1, 1, 1)
    lam = scal[:, 1].view(-1, 1, 1)
    tv = t2tab.shape[0]

    def band(v, q):
        return v[:, q * m.R:q * m.R + m.band_rows(q)]

    def span(q, role, before, after):
        r0 = q * m.R
        return m.rows(q, role, r0 - before, r0 + m.band_rows(q) + after)

    def vpass(q, role, adjoint):
        win = stencil_pass(span(q, role, rh_, rh_), taps_h, -2, adjoint)
        return win[:, rh_:rh_ + m.band_rows(q)]

    carry = [{"x": band(x0hat, q) * 0.0, "m1": band(x0hat, q) * 0.0,
              "m2": band(x0hat, q) * 0.0} for q in bands]
    for q in bands:
        if warm:
            m.put(q, "pv", band(x0hat, q) * 0.0)
            m.put(q, "ph", band(x0hat, q) * 0.0)
    for it in range(tab.shape[0]):
        a, bc, g, e = (tab[it, k] for k in range(4))
        for q in bands:
            x, m1 = carry[q]["x"], carry[q]["m1"]
            if method == "fista":
                m.put(q, "gin", x + a * (x - m1))
                carry[q]["m1"] = x
            else:
                m.put(q, "gin", x)
        m.barrier("Bm")
        for q in bands:
            m.put(q, "t1", vpass(q, "gin", False))
        m.barrier("Bt")
        for q in bands:
            m.put(q, "t2", vpass(q, "t1", True))
        for q in bands:
            m.put(q, "t3", stencil_pass(m.get(q, "t2"), taps_w, -1, False))
        pogm = {}
        for q in bands:
            res = stencil_pass(m.get(q, "t3"), taps_w, -1, True) - band(x0hat, q)
            x, m1, m2 = (carry[q][k] for k in ("x", "m1", "m2"))
            if method == "fista":
                xg = m.get(q, "gin") - rho * res
            elif method == "optista":
                xg = m1 - (rho * g) * res
            else:
                yn = x - rho * res
                xg = ((1.0 + a + bc) * yn - a * m1) - (bc + e) * x + e * m2
                pogm[q] = yn
            m.put(q, "xg", xg)
            m.put(q, "xg_own", xg)
        lt = rho * lam if method == "fista" else (rho * g * lam)
        if tv > 0:
            m.barrier("Bf0")
            for q in bands:
                n, r0 = m.band_rows(q), q * m.R
                mrow = (torch.arange(r0, r0 + n) < H - 1).to(torch.float64)[:, None]
                mcol = (torch.arange(W) < W - 1).to(torch.float64)
                if warm:
                    m.put(q, "rv", m.get(q, "pv"))
                    m.put(q, "rh", m.get(q, "ph"))
                    continue
                xs = m.get(q, "xg")
                y0 = xs * 0.125
                below = span(q, "xg", -1, 1)
                qv = torch.clamp(below * 0.125 - y0, -lt, lt) * mrow
                qh = torch.clamp(_cols(xs, 1) * 0.125 - y0, -lt, lt) * mcol
                for role, v in (("pv", qv), ("rv", qv), ("ph", qh), ("rh", qh)):
                    m.put(q, role, v)
            for k in range(0 if warm else 1, tv):
                c1, c2 = t2tab[k, 0], t2tab[k, 1]
                m.barrier("Bf1")
                for q in bands:
                    rv, rh = m.get(q, "rv"), m.get(q, "rh")
                    up = span(q, "rv", 1, -1)
                    gt = (up - rv) + (_cols(rh, -1) - rh)
                    m.put(q, "y", (m.get(q, "xg_own") - gt) * 0.125)
                m.barrier("Bf2")
                for q in bands:
                    n, r0 = m.band_rows(q), q * m.R
                    mrow = (torch.arange(r0, r0 + n) < H - 1).to(torch.float64)[:, None]
                    mcol = (torch.arange(W) < W - 1).to(torch.float64)
                    y = m.get(q, "y")
                    below = span(q, "y", -1, 1)
                    qv = torch.clamp(m.get(q, "rv") + (below - y), -lt, lt) * mrow
                    qh = torch.clamp(m.get(q, "rh") + (_cols(y, 1) - y), -lt, lt) * mcol
                    p_out = placement == "three" and k + 1 == tv
                    m.put(q, "rv", qv if p_out else c1 * qv - c2 * m.get(q, "pv"))
                    m.put(q, "rh", c1 * qh - c2 * m.get(q, "ph"))
                    m.put(q, "pv", qv)
                    m.put(q, "ph", qh)
            m.barrier("Bf3")
        for q in bands:
            xgv = m.get(q, "xg_own")
            if tv > 0:
                ph = m.get(q, "ph")
                up = span(q, "p", 1, -1)
                xn = xgv - ((up - m.get(q, "p")) + (_cols(ph, -1) - ph))
            else:
                xn = xgv
            x, m1, m2 = (carry[q][k] for k in ("x", "m1", "m2"))
            if method == "fista":
                carry[q]["x"] = xn
            elif method == "optista":
                zn = x + (xn - m1) * e
                carry[q].update(x=(1.0 + a + bc) * zn - a * m2 - bc * x, m1=xn, m2=zn)
            else:
                carry[q].update(x=xn, m1=pogm[q], m2=xgv)
    m.barrier("Be")
    m.written.update(m.shared)  # the CTAs exit: their shared memory goes
    m.barrier("exit")
    return torch.cat([carry[q]["x"] for q in bands], dim=1)


def _model_problem(B, H, W, iterations, tv, method, seed=5):
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.normal(size=(B, H, W)))
    lam = torch.tensor([0.05, 0.0, 0.2][:B], dtype=torch.float64)
    scal, tab, t2 = fused.kernel_args(x0, 0.9, lam, method, iterations, tv, dtype=np.float64)
    return x0, scal, tab, t2


MODEL_TAPS = ((0.1, 0.5, 0.25, -0.2, 0.05), (0.3, 0.6, 0.1))


@pytest.mark.parametrize("placement", ["six", "three"])
@pytest.mark.parametrize("method,warm", [("fista", False), ("optista", False), ("pogm", False),
                                         ("fista", True)])
@pytest.mark.parametrize("H,W,c", [(20, 12, 3), (7, 9, 7), (10, 5, 4), (13, 6, 1), (16, 8, 8)])
@pytest.mark.parametrize("tv", [0, 1, 3])
def test_the_cluster_model_is_the_plain_version(H, W, c, placement, method, warm, tv):
    """The banded schedule on either placement's planes against
    fista_tv_fused_torch in float64: the same x to 1e-12 of max|x|, with
    λ = 0 beside λ > 0 in one batch; bands of 7, 7, 6 rows, one-row bands
    (a 5-tap column pass reaching two bands away), a one-row last band, a
    single band."""
    x0, scal, tab, t2 = _model_problem(3, H, W, 3, tv, method)
    got = cluster_solve(x0, scal, tab, t2, MODEL_TAPS, c, placement, method, warm)
    want = fused.fista_tv_fused_torch(x0, scal, tab, t2, MODEL_TAPS, method, warm_tv=warm)[0]
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("placement", ["six", "three"])
@pytest.mark.parametrize("tv", [0, 1, 3])
@pytest.mark.parametrize("dropped", BARRIERS)
def test_each_barrier_of_the_table_is_needed(dropped, tv, placement):
    """Without any one barrier of the header's table a plane that a band
    reads from another is written by some band between two barriers: the
    model raises and names it (with fewer than two dual iterations Bf1
    and Bf2 are not there to drop, with none the FGP's barriers)."""
    x0, scal, tab, t2 = _model_problem(2, 20, 8, 2, tv, "fista")
    cluster_solve(x0, scal, tab, t2, MODEL_TAPS, 4, placement)  # every barrier: no hazard
    absent = (tv < 2 and dropped in ("Bf1", "Bf2")) or (tv == 0 and dropped.startswith("Bf"))
    if absent:
        cluster_solve(x0, scal, tab, t2, MODEL_TAPS, 4, placement, dropped=(dropped,))
        return
    with pytest.raises(Hazard, match="read from another band and written"):
        cluster_solve(x0, scal, tab, t2, MODEL_TAPS, 4, placement, dropped=(dropped,))


def test_the_model_runs_the_planners_plan():
    """The planner's own bands at a card with little shared memory: three
    planes of a 20-row band of 30 pixels, c = 4 (5 rows each)."""
    smem = fused.cluster_smem_bytes(5, 30, False)
    plan = _plan(2, 20, 30, 5, 3, resident=H100_RESIDENT, smem_max=smem)
    assert (plan.route, plan.clusters, plan.rows, plan.own) == ("cluster", 4, 5, "global")
    x0, scal, tab, t2 = _model_problem(2, 20, 30, 3, 4, "pogm")
    got = cluster_solve(x0, scal, tab, t2, MODEL_TAPS, plan.clusters, "three", "pogm")
    want = fused.fista_tv_fused_torch(x0, scal, tab, t2, MODEL_TAPS, "pogm")[0]
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


def test_the_model_reaches_two_bands_away():
    """A 5-tap column pass on one-row bands reads rows two bands away; the
    window rule of the row tiles (``tiled_halo``) is not needed here: the
    cluster reads every row it needs."""
    assert _fgp_common.tiled_halo(3, 5) > 1
    x0, scal, tab, t2 = _model_problem(2, 6, 4, 2, 3, "fista")
    got = cluster_solve(x0, scal, tab, t2, MODEL_TAPS, 6, "three")
    want = fused.fista_tv_fused_torch(x0, scal, tab, t2, MODEL_TAPS)[0]
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
