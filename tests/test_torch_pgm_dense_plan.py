"""The dense PGM kernel's grid route (rls_tpu_torch/kernels/pgm_dense_fused.py
``plan_pgm_dense``, csrc/pgm_dense_fused.cu ``pgm_dense_grid_kernel``), on
the CPU.

The planner: which route and cut a shape takes on an H100 (132 SMs,
232,448 bytes of shared memory per block) and on other cards, that every
grid plan covers its shape and fits the card, that the shared-memory count
is the kernel's, and where the per-problem kernel is left.

The model: the grid route's schedule in float64, CTA by CTA as the kernel
runs it: the slabs' partial v summed in slab order by the owner of each
column chunk, y | x_prev and z | x_mid kept by the owner at its own
columns, the restart partials summed in slab order by every CTA (each
taking the same decision), the group's new x published by the owners and
read back by every CTA. It is held against ``pgm_dense_fused_torch`` in
float64, and it checks the barrier table of the kernel's source: a buffer
that a CTA reads from another CTA between two group barriers must not be
written between them, so that dropping either barrier raises. The kernel
itself runs only on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rls_tpu_torch.kernels import pgm_dense_fused as pd

CSRC = Path(pd.__file__).parents[1] / "csrc"
SMS, SMEM = 132, 232_448


def _covers(plan, m, n, P, sms=SMS, smem=SMEM):
    assert plan.route == "grid"
    assert (plan.slabs - 1) * plan.rows < m <= plan.slabs * plan.rows
    assert (plan.groups - 1) * plan.group_size < P <= plan.groups * plan.group_size
    assert plan.ctas <= sms
    assert plan.smem == pd.grid_smem_bytes(n, plan.slabs, plan.rows, plan.group_size,
                                           plan.resident) <= smem


def test_the_plan_at_the_lasso_cell():
    """256 × 512, 16 problems: 16 slabs of 16 rows × 2 groups of 8 (one
    tile each), the slab resident, 32 CTAs."""
    plan = pd.plan_pgm_dense(256, 512, 16, SMS, SMEM)
    _covers(plan, 256, 512, 16)
    assert (plan.slabs, plan.rows, plan.groups, plan.group_size, plan.resident) == (
        16, 16, 2, 8, True)
    assert plan.smem == 79_072


# tests/test_torch_cuda.py's shapes (its PGM_DENSE_SHAPES), each with its
# route and whether A's slab stays in shared memory
CARD_SHAPES = {(40, 24, 3): ("grid", True), (256, 512, 16): ("grid", True),
               (1000, 300, 61): ("grid", True), (256, 512, 1): ("grid", True),
               (256, 512, 137): ("grid", True), (3000, 16, 16): ("grid", True),
               (16, 3000, 16): ("grid", False), (64, 4000, 3): ("per_problem", False)}


@pytest.mark.parametrize("shape", list(CARD_SHAPES), ids=str)
def test_the_card_tests_shapes_take_their_routes(shape):
    m, n, P = shape
    route, resident = CARD_SHAPES[shape]
    plan = pd.plan_pgm_dense(m, n, P, SMS, SMEM)
    assert (plan.route, plan.resident) == (route, resident)
    if route == "grid":
        _covers(plan, m, n, P)
    else:
        assert (plan.slabs, plan.groups, plan.group_size, plan.ctas) == (1, P, 1, P)


@pytest.mark.parametrize("shape,kind", [
    ((256, 512, 1), "one problem"),  # the SMs share one problem's rows
    ((256, 512, 137), "more problems than SMs"),
    ((1000, 300, 61), "remainders"),  # 16 slabs of 63 rows (the last 55), 8 groups of 8 (5)
    ((3000, 16, 16), "tall"),  # more slabs than columns: some owners own none
    ((16, 3000, 16), "wide"),  # one row a slab, the slab read from L2
])
def test_plans_at_the_edges(shape, kind):
    m, n, P = shape
    plan = pd.plan_pgm_dense(m, n, P, SMS, SMEM)
    _covers(plan, m, n, P)
    if kind == "one problem":
        assert (plan.groups, plan.group_size) == (1, 1) and plan.slabs > 1
    elif kind == "more problems than SMs":
        assert plan.groups * plan.group_size >= P > SMS and plan.slabs >= 1
    elif kind == "remainders":
        assert m % plan.rows and P % plan.group_size
    elif kind == "tall":
        assert plan.slabs > n and plan.resident
    else:
        assert plan.rows == 1 and not plan.resident and plan.group_size <= 8


@pytest.mark.parametrize("m", [1, 7, 64, 129, 1025, 5000])
@pytest.mark.parametrize("n", [1, 33, 512, 1000])
@pytest.mark.parametrize("P", [1, 9, 133, 250])
def test_every_grid_plan_covers_its_shape_and_fits(m, n, P):
    plan = pd.plan_pgm_dense(m, n, P, SMS, SMEM)
    assert plan.route == "grid"
    _covers(plan, m, n, P)


@pytest.mark.parametrize("n", [3_700, 4_000, 36_000])
@pytest.mark.parametrize("P", [1, 16])
def test_a_row_too_long_for_shared_memory_takes_the_per_problem_kernel(n, P):
    """A tile's Gram input and x (64 bytes a column) past the block's
    shared memory even with A streamed: the per-problem kernel."""
    assert pd.grid_smem_bytes(n, 1, 1, 1, False) > SMEM
    plan = pd.plan_pgm_dense(64, n, P, SMS, SMEM)
    assert plan == pd.PgmDensePlan("per_problem", 1, 64, P, 1, False, 0)


@pytest.mark.parametrize("sms,smem,want", [
    # cards that are not an H100: fewer SMs cap slabs × groups; less shared
    # memory streams the slab, then leaves the per-problem kernel
    (8, SMEM, ("grid", 4, 2, True)),
    (32, SMEM, ("grid", 16, 2, True)),
    (SMS, 100_000, ("grid", 16, 2, True)),
    (SMS, 48 * 1024, ("grid", 26, 2, False)),
    (SMS, 40_000, ("per_problem", 1, 16, False)),
    (0, SMEM, ("per_problem", 1, 16, False)),
])
def test_plans_respect_the_card(sms, smem, want):
    plan = pd.plan_pgm_dense(256, 512, 16, sms, smem)
    assert (plan.route, plan.slabs, plan.groups, plan.resident) == want
    if plan.route == "grid":
        _covers(plan, 256, 512, 16, sms=sms, smem=smem)


def test_grid_smem_bytes_counts_every_piece():
    # the LASSO cell's CTA: q 16 × 8 float64, 5 × 8 four-byte scalars, 8 × 8
    # float64 reductions, 7 int64 phase clocks (16-byte aligned), 8 × 128
    # float64 split sums, gin and x (512 × 8 f32 each), the owner's x0hat,
    # m1, m2 (3 × 32 × 8 f32), the 16 × 520 f32 slab
    always = 1024 + 160 + 512 + 64 + 8192 + 16384 + 16384 + 3072
    assert pd.grid_smem_bytes(512, 16, 16, 8, False) == always
    assert pd.grid_smem_bytes(512, 16, 16, 8, True) == always + 4 * 16 * 520
    # rows rounded up to 16, columns to 8 (gin) and slab_ld (A), problems to
    # 8, each piece aligned to 16 bytes: 3 rows × 5 columns, 3 problems, 2
    # slabs (a chunk of 3 columns)
    assert pd.grid_smem_bytes(5, 2, 3, 3, True) == (
        1024 + 64 + 512 + 64 + 8192 + 256 + 160 + 288 + 4 * 16 * 40)


def test_the_planner_reads_the_kernel_s_constants():
    """Threads, the tile, the phases and the shared-memory count as the
    kernel's sources state them; the barriers of the model are the table
    of csrc/pgm_dense_fused.cu, each at its group_sync."""
    header = (CSRC / "dense_grid.cuh").read_text()
    assert re.findall(r"constexpr int kThreads = (\d+);", header) == [str(32 * pd.WARPS)]
    assert re.findall(r"constexpr int kTile = (\d+);", header) == [str(pd.TILE)]
    src = (CSRC / "pgm_dense_fused.cu").read_text()
    phases = re.search(r"enum \{\s*(kSetup[^}]*)\}", src).group(1)
    assert len([p for p in phases.split(",") if p.strip()]) == len(pd.GRID_PHASES) + 1
    smem = re.search(r"grid_smem_bytes\(int n, int slabs, int rows, int group_size,\s*"
                     r"bool resident\) \{(.*?)\n\}", src, re.S).group(1)
    for piece in ("sizeof(double) * kTile * rows16", "align16(5 * 4 * group_size)",
                  "sizeof(double) * grid::kWarps * kTile", "sizeof(long long) * kGridPhases",
                  "sizeof(double) * grid::kWarps * 128",
                  "sizeof(float) * kTile * tiles * grid::round_up(n, 8)",
                  "sizeof(float) * kTile * tiles * n", "3 * sizeof(float) * kTile * tiles * chunk",
                  "sizeof(float) * rows16 * grid::slab_ld(n)"):
        assert piece in smem, piece
    for name in BARRIERS:
        assert re.search(rf"^//\s+{name}\s", src, re.M), name
        assert re.search(rf"group_sync\(ctr, target, S\);  // {name}\n", src), name


def test_empty_shapes_raise():
    with pytest.raises(ValueError, match="empty"):
        pd.plan_pgm_dense(0, 4, 2, SMS, SMEM)


def test_the_model_prefers_fewer_problems_per_cta_over_more_traffic():
    """At the LASSO cell one tile per CTA (2 groups of 8) costs less than
    two tiles (one group of 16) and than 8 groups of 2 (four times the
    grid's L2 traffic for the same work per CTA)."""
    clocks = pd.step_clocks
    best = clocks(512, 16, 16, 8, True, 32)
    assert best < clocks(512, 16, 16, 16, True, 16)
    assert best < clocks(512, 16, 16, 2, True, 128)
    assert best < clocks(512, 16, 16, 8, False, 32)


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(1)
    A = torch.from_numpy((rng.normal(size=(30, 20)) / 6).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4, 30)).astype(np.float32))
    before = (pd.pgm_dense_fused.launches, dict(pd.pgm_dense_fused.route_launches))
    got = pd.pgm_dense_fused(b, A, 1e-2, 0.5, 1.0, 10, restart="gradient")
    scal, tab = pd.kernel_args(b, 1e-2, 0.5, 1.0, "fista", 10)
    assert torch.equal(got, pd.pgm_dense_fused_torch(b, A, scal, tab, 10, restart="gradient")[0])
    assert (pd.pgm_dense_fused.launches, pd.pgm_dense_fused.route_launches) == before


# ---- a float64 model of the grid route


class Hazard(AssertionError):
    """A buffer read from another CTA and written between two group
    barriers."""


# the table of csrc/pgm_dense_fused.cu: B1 (the partial v), B2 (the new x
# and the restart partials), twice per iteration and once each in the set-up
BARRIERS = ("B1", "B2")


class GroupModel:
    """The L2 buffers of one group of the grid (`part`, `xpub`, `rdots`),
    one slot per writing CTA. A CTA reads its own slot as it stands and
    another CTA's as it stood at the last group barrier (`barrier`
    publishes every slot; a slot no barrier has published reads as NaN).
    Between two barriers the buffers read from another CTA and the buffers
    written must not meet (`barrier` raises Hazard). A barrier named in
    `dropped` is not there."""

    def __init__(self, slabs, dropped=()):
        self.dropped = set(dropped)
        self.live = {name: [None] * slabs for name in ("part", "xpub", "rdots")}
        self.published = {name: list(v) for name, v in self.live.items()}
        self.read_remote, self.written = set(), set()

    def put(self, name, s, value):
        self.written.add(name)
        self.live[name][s] = value

    def get(self, name, reader, writer, like):
        if reader == writer:
            return self.live[name][writer]
        self.read_remote.add(name)
        value = self.published[name][writer]
        return torch.full_like(like, float("nan")) if value is None else value

    def barrier(self, name):
        if name in self.dropped:
            return
        met = self.read_remote & self.written
        if met:
            raise Hazard(f"read from another CTA and written before {name}: {sorted(met)}")
        self.published = {k: list(v) for k, v in self.live.items()}
        self.read_remote, self.written = set(), set()


def grid_solve(b, A, scal, tab, steps, method, kind, restart, prox, plan, dropped=()):
    """The grid route's solve in float64, group by group and CTA by CTA in
    the order of the kernel (csrc/pgm_dense_fused.cu); returns (x,
    restarts)."""
    P, m = b.shape
    n = A.shape[1]
    S, chunk = plan.slabs, -(-n // plan.slabs)
    rows = [slice(s * plan.rows, min(m, (s + 1) * plan.rows)) for s in range(S)]
    cols = [slice(min(n, s * chunk), min(n, s * chunk + chunk)) for s in range(S)]
    out = torch.zeros((P, n), dtype=torch.float64)
    counts = torch.zeros(P, dtype=torch.int32)
    fista = method == "fista"
    for g in range(plan.groups):
        p0 = g * plan.group_size
        G = min(plan.group_size, P - p0)
        lam, rho, th = (scal[p0:p0 + G, k].clone() for k in range(3))
        mom = (th - 1.0) / th
        fires = torch.zeros(G, dtype=torch.int32)
        model = GroupModel(S, dropped)
        gin, sx, own = [None] * S, [None] * S, [None] * S
        like = torch.zeros((G, n), dtype=torch.float64)

        def slab_sum(s):
            # the owner s: the slabs' partials at its columns, in slab order
            v = torch.zeros((G, cols[s].stop - cols[s].start), dtype=torch.float64)
            for t in range(S):
                v = v + model.get("part", s, t, like)[:, cols[s]]
            return v

        def reload(s, first):
            xn = torch.cat([model.get("xpub", s, t, like[:, cols[t]]) for t in range(S)], 1)
            if fista:
                xo = xn if first else sx[s]
                sx[s] = xn
                gin[s] = xn + mom[:, None] * (xn - xo)
            else:
                gin[s] = xn

        # the set-up: x0hat = Aᵀb through the slabs' partials, then x = m1 =
        # m2 = x0hat · 0 from its owners
        for s in range(S):
            model.put("part", s, b[p0:p0 + G, rows[s]] @ A[rows[s]])
        model.barrier("B1")
        for s in range(S):
            x0 = slab_sum(s)
            zero = x0 * 0.0
            own[s] = {"x0": x0, "m1": zero, "m2": zero}
            model.put("xpub", s, zero)
            out[p0:p0 + G, cols[s]] = zero
        model.barrier("B2")
        for s in range(S):
            reload(s, True)
        for it in range(steps):
            last = it + 1 == steps
            for s in range(S):  # (a)
                model.put("part", s, (gin[s] @ A[rows[s]].T) @ A[rows[s]])
            model.barrier("B1")
            for s in range(S):  # (b) the owner's columns
                o, c = own[s], cols[s]
                res = slab_sum(s) - o["x0"]
                gv = gin[s][:, c]
                if fista:
                    xn = pd._prox_pair(gv - rho[:, None] * res, None, rho * lam, kind, prox)[0]
                    d = xn - sx[s][:, c]
                    part = (res * d if restart == "gradient" else (gv - xn) * d).sum(1)
                    if restart != "none":
                        model.put("rdots", s, part)
                else:
                    a, bc, gm, e = tab[it]
                    cy = (1.0 + a) + bc
                    if method == "optista":
                        step = rho * gm
                        yn = pd._prox_pair(o["m1"] - step[:, None] * res, None, step * lam, kind,
                                           prox)[0]
                        zn = gv + (yn - o["m1"]) * e
                        xn = cy * zn - a * o["m2"] - bc * gv
                        o["m1"], o["m2"] = yn, zn
                    else:
                        yn = gv - rho[:, None] * res
                        xmid = cy * yn - a * o["m1"] - (bc + e) * gv + e * o["m2"]
                        o["m1"], o["m2"] = yn, xmid
                        xn = pd._prox_pair(xmid, None, rho * gm * lam, kind, prox)[0]
                model.put("xpub", s, xn)
                if last:
                    out[p0:p0 + G, c] = xn
            model.barrier("B2")
            if fista:  # (c) every CTA's restart decision, which must agree
                if restart != "none":
                    decided = []
                    for s in range(S):
                        d = torch.zeros(G, dtype=torch.float64)
                        for t in range(S):
                            d = d + model.get("rdots", s, t, d)
                        decided.append(d > 0)
                    assert all(torch.equal(f, decided[0]) for f in decided)
                    fire = decided[0]
                    fires += fire.to(torch.int32)
                    th = torch.where(fire, torch.ones_like(th), th)
                th_new = (1.0 + torch.sqrt(1.0 + 4.0 * th * th)) / 2.0
                mom, th = (th - 1.0) / th_new, th_new
            if not last:
                for s in range(S):
                    reload(s, False)
        # the CTAs exit: no buffer may still be read and written unordered
        model.barrier("exit")
        counts[p0:p0 + G] = fires
    return out, counts


def _problem(m, n, P, seed=4):
    """A dense system whose FISTA restarts fire (N(0, 1)/√m, ρ = 0.5) and λ
    per problem (one of them 0), in float64."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.normal(size=(m, n)) / np.sqrt(m))
    b = torch.from_numpy(rng.normal(size=(P, m)))
    lam = torch.tensor([1e-2, 0.0, 0.1] * P, dtype=torch.float64)[:P]
    return A, b, lam


# plans the model runs: 3 slabs of 14 rows (the last 12) × 2 groups of 3
# (the last 2), the owners' chunks 8, 8, 8 of 24 columns; one CTA (one slab,
# one group); 8 slabs of 5 rows over 5 columns (owners of one column and of
# none) × 3 groups of 2
MODEL_PLANS = {
    "3x2": ((40, 24, 5), pd.PgmDensePlan("grid", 3, 14, 2, 3, True, 0)),
    "1x1": ((40, 24, 5), pd.PgmDensePlan("grid", 1, 40, 1, 5, True, 0)),
    "8x3": ((40, 5, 5), pd.PgmDensePlan("grid", 8, 5, 3, 2, False, 0)),
}
SCHEDULES = [("fista", "none"), ("fista", "gradient"), ("fista", "gradient_mapping"),
             ("optista", "none"), ("pogm", "none")]


@pytest.mark.parametrize("plan", list(MODEL_PLANS))
@pytest.mark.parametrize("method,restart", SCHEDULES)
@pytest.mark.parametrize("kind", ["l1", "l2"])
@pytest.mark.parametrize("prox", ["none", "positive"])
def test_the_grid_model_is_the_plain_version(plan, method, restart, kind, prox):
    """The grid schedule against pgm_dense_fused_torch in float64: the same
    x to 1e-12 of max|x| and the same restart counts, for every method,
    restart, prox kind and projection."""
    shape, cut = MODEL_PLANS[plan]
    A, b, lam = _problem(*shape)
    scal, tab = pd.kernel_args(b, lam, 0.5, 1.0, method, 30, dtype=np.float64)
    sched = (30, method, kind, restart, prox)
    got, counts = grid_solve(b, A, scal, tab, *sched, cut)
    want, want_counts = pd.pgm_dense_fused_torch(b, A, scal, tab, *sched)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    assert counts.tolist() == want_counts.tolist()
    if restart != "none" and plan == "3x2":
        assert max(want_counts.tolist()) > 0


@pytest.mark.parametrize("steps", [0, 1, 7])
def test_the_grid_model_runs_the_planners_plan(steps):
    """The planner's own cut of a 120 × 400 system of 12 problems on a card
    of 8 SMs (4 slabs of 30 rows × 2 groups of 6), FISTA with its gradient
    restart."""
    plan = pd.plan_pgm_dense(120, 400, 12, 8, SMEM)
    assert (plan.route, plan.slabs, plan.groups) == ("grid", 4, 2)
    A, b, lam = _problem(120, 400, 12)
    scal, tab = pd.kernel_args(b, lam, 0.5, 1.0, "fista", steps, dtype=np.float64)
    sched = (steps, "fista", "l1", "gradient", "none")
    got, counts = grid_solve(b, A, scal, tab, *sched, plan)
    want, want_counts = pd.pgm_dense_fused_torch(b, A, scal, tab, *sched)
    assert float((got - want).abs().max()) <= 1e-12 * max(float(want.abs().max()), 1e-300)
    assert counts.tolist() == want_counts.tolist()


@pytest.mark.parametrize("method,restart", [("fista", "gradient"), ("fista", "none"),
                                            ("pogm", "none")])
@pytest.mark.parametrize("steps", [0, 1, 3])
@pytest.mark.parametrize("dropped", BARRIERS)
def test_each_barrier_of_the_table_is_needed(dropped, steps, method, restart):
    """Without either barrier of the table a buffer that a CTA reads from
    another is written by some CTA between two barriers: the model raises
    and names it, from the set-up on."""
    shape, plan = MODEL_PLANS["3x2"]
    A, b, lam = _problem(*shape)
    scal, tab = pd.kernel_args(b, lam, 0.5, 1.0, method, steps, dtype=np.float64)
    sched = (steps, method, "l1", restart, "none")
    grid_solve(b, A, scal, tab, *sched, plan)  # with every barrier: no hazard
    with pytest.raises(Hazard, match="read from another CTA and written"):
        grid_solve(b, A, scal, tab, *sched, plan, dropped=(dropped,))
