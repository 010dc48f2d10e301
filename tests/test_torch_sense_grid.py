"""The grid route of the SENSE kernels (rows 9 and 10: csrc/sense_grid.cuh,
the grid kernels of csrc/sense_fused.cu and csrc/splitbregman_fused.cu,
``plan_grid`` in rls_tpu_torch/kernels/sense_fused.py), on the CPU.

The planner: the route at every square side from 2 to 1024 at 6 coils
(resident, split, or grid exactly where no team of 16 fits), the grid
plans of the card's shapes (2 × 512² on 2 slots of 66 CTAs with every coil
in one round, 1 × 1024² on 132 CTAs in two rounds of 3), the rule among
the slots, forced grids, raises that name the plan, the shared memory
counted piece by piece, and the planner's constants as the .cu files and
csrc/sense_grid.cuh state them.

The model: one slot's shared buffers in global memory (the coils' spectra
S_k; for row 10 also the team's sums, the TV input v and the FGP's planes
that a neighbour band reads) with a log of which CTA of the team read and
wrote each element since the last team barrier; the kernels' passes run
CTA by CTA, chunk by chunk ((R) of a round's coils, T1, (C), T2, (R') with
the coil fold and the next (R)), each line through the register layout
model of tests/test_torch_splitbregman_plan.py, the CG's sums as each
CTA's float64 band sum added over the team in rank order, and the fold FGP
swept band by band. An element that one CTA writes and another reads or
writes between the same two barriers raises Hazard. Both models are held
bit for bit against ``fista_l21_sense_fused_torch`` and
``splitbregman_l1_tv_fused_torch`` (with equal live CG steps) on uneven
teams, slots walking slices in rounds, and one to three coils a round, and
each raises when any one team barrier is dropped. Then rows 9 and 10's
plain versions past the JAX kernels' VMEM gate, against the JAX package's
composed solves in float64. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
from rls_tpu.kernels import sense_fused as jsense
from rls_tpu.kernels import splitbregman_fused as jsb
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import _dft_common as dft
from rls_tpu_torch.kernels import sense_fused as sense
from rls_tpu_torch.kernels import splitbregman_fused as sb
from rls_tpu_torch.kernels.fista_tv_fused import _momentum_table
from test_torch_sense_plan import H100_RESIDENT, SMEM
from test_torch_splitbregman_plan import line_model

CSRC = Path(sense.__file__).parents[1] / "csrc"
# the grid CTAs an H100 holds at once: one of 1024 threads a SM
H100_GRID = 132
MODULES = {"row9": sense, "row10": sb}


def _plan(module, B, H, W, C, **kw):
    plan = sense.plan_sense if module is sense else sb.plan_splitbregman
    return plan(B, H, W, C, H100_RESIDENT, **kw)


def _head(module):
    return (0, len(sense.GRID_PHASES)) if module is sense else (sb.GRID_HEAD,
                                                                len(sb.GRID_PHASES))


def _covers(plan, module, B, H, W, C, held=H100_GRID, smem=SMEM):
    """A grid plan's bands cover H and its blocks W, once each, over its
    team; its slots' rounds cover B, its rounds of coils C; the card holds
    its CTAs; its chunks fit a plane of its CTA's shared memory, which fits
    the card."""
    assert plan.route == "grid" and plan.clusters == plan.team and plan.W == W
    team = plan.team
    assert 1 <= team <= min(H, W)
    assert [r for q in range(team) for r in range(*plan.band(q))] == list(range(H))
    assert [k for q in range(team) for k in range(*plan.block(q))] == list(range(W))
    assert plan.ctas == team * plan.slots <= held and 1 <= plan.slots <= B
    assert 1 <= plan.per_round <= C and plan.rounds == -(-C // plan.per_round)
    assert 1 <= plan.row_lines <= -(-H // team) and 1 <= plan.col_lines <= -(-W // team)
    head, phases = _head(module)
    plane = (plan.smem - sense.grid_smem_bytes(H, W, 0, head, phases)) // 8
    assert sense.grid_smem_bytes(H, W, plane, head, phases) == plan.smem <= smem
    assert plane % 4 == 0
    assert plan.row_lines * (W | 1) <= plane and plan.col_lines * (H | 1) <= plane
    assert plan.resident_clusters == held
    assert plan.scratch == module.GRID_SCRATCH


# ---- the planner


@pytest.mark.parametrize("module", MODULES.values(), ids=MODULES)
def test_every_square_side_takes_its_route(module):
    """Resident or split wherever ``coil_plan`` finds a team of at most 16
    (as before), grid at every other side: from 469 on at 6 coils for row
    9, from 467 for row 10 (its CTA holds its sums besides)."""
    sides = {"resident": [], "split": [], "grid": []}
    for n in range(2, 1025):
        plan = _plan(module, 2, n, n, 6)
        sides[plan.route].append(n)
        cluster = sense.coil_plan("k", n, n, 6, 132, SMEM, module.cluster_smem_bytes)
        assert (plan.route == "grid") == (cluster is None), n
        if plan.route == "grid":
            _covers(plan, module, 2, n, n, 6)
    assert sides["grid"] == list(range(469 if module is sense else 467, 1025))
    assert 448 in sides["split"] and 384 in sides["split"]


@pytest.mark.parametrize("module", MODULES.values(), ids=MODULES)
@pytest.mark.parametrize("shape,want", [
    # 2 × 512², 6 coils: 2 slots of 66 CTAs (8- and 7-row bands, one chunk),
    # all 6 coils in one round: 24 MiB of spectra
    ((2, 512, 512, 6), (66, 2, 6, 1, 8, 8)),
    # 1 × 1024²: one slot of 132 CTAs, two rounds of 3 coils (24 MiB)
    ((1, 1024, 1024, 6), (132, 1, 3, 2, 8, 8)),
    # 8 × 512²: 4 slots of 33, 3 coils a round (the spectra of 8 slots would
    # leave 1 coil a round)
    ((8, 512, 512, 6), (33, 4, 3, 2, 16, 16)),
    # 2 × 1024², 17 coils: one slot of 132 (six rounds of 3 a slice, 12 in
    # all) costs as much as 2 slots of 66 (17 rounds of one coil)
    ((2, 1024, 1024, 17), (132, 1, 3, 6, 8, 8)),
])
def test_the_grid_plans_of_the_card_s_shapes(module, shape, want):
    plan = _plan(module, *shape)
    _covers(plan, module, *shape)
    assert (plan.team, plan.slots, plan.per_round, plan.rounds, plan.row_lines,
            plan.col_lines) == want


@pytest.mark.parametrize("B", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("n,C", [(512, 6), (640, 3), (1024, 6), (1021, 2), (481, 9)])
def test_the_grid_plan_is_the_cheapest(B, n, C):
    """The least cost over the slots the card allows, then the fewest coil
    rounds one after the other, then more slots; each slot's coils a round
    from the L2 budget."""
    plan = _plan(sense, B, n, n, C)
    _covers(plan, sense, B, n, n, C)

    def key(s):
        t, p = min(H100_GRID // s, n), sense.coils_per_round(n, n, C, s)
        return sense.grid_cost(B, n, n, C, t, s), -(-B // s) * -(-C // p), -s

    assert key(plan.slots) == min(key(s) for s in range(1, min(B, H100_GRID) + 1))
    assert plan.team == min(H100_GRID // plan.slots, n)
    assert plan.per_round == sense.coils_per_round(n, n, C, plan.slots)


def test_the_coils_a_round_keep_the_spectra_in_the_l2_budget():
    for n, C, slots, want in ((512, 6, 2, 6), (1024, 6, 1, 3), (512, 6, 8, 1), (512, 6, 4, 3),
                              (1024, 6, 2, 1), (512, 17, 1, 17), (640, 6, 1, 6)):
        per = sense.coils_per_round(n, n, C, slots)
        assert per == want, (n, C, slots)
        if per > 1:
            assert slots * (8 * per + 4 * sense.GRID_OP_PLANES) * n * n <= sense.GRID_L2


@pytest.mark.parametrize("held,smem,want", [
    # a card of 8 grid CTAs: 2 slots of 4 (as cheap as 1 of 8, and one
    # round of coils after the other in place of two), 128-row bands in 3
    # chunks of 43 at 56 lines a plane
    (8, SMEM, (4, 2, 6, 43, 43)),
    # 64: 2 slots of 32
    (64, SMEM, (32, 2, 6, 16, 16)),
    # less shared memory: more chunks of fewer lines
    (132, 20_000, (66, 2, 6, 3, 3)),
])
def test_grid_plans_respect_the_card(held, smem, want):
    for module in MODULES.values():
        plan = _plan(module, 2, 512, 512, 6, sms=held, smem_max=smem, grid_ctas=held)
        _covers(plan, module, 2, 512, 512, 6, held=held, smem=smem)
        assert (plan.team, plan.slots, plan.per_round, plan.row_lines, plan.col_lines) == want


@pytest.mark.parametrize("module", MODULES.values(), ids=MODULES)
def test_the_grid_plan_respects_the_card_s_resident_grid_ctas(module):
    """The grid route needs every CTA it launches resident at once (one
    cooperative launch): its team × slots never exceeds the card's count of
    resident grid CTAs, whatever the card holds, and a card that holds none
    raises, naming the plan."""
    for held in (1, 2, 7, 33, 100, 132, 264):
        for B in (1, 2, 5):
            plan = _plan(module, B, 512, 512, 6, grid_ctas=held)
            _covers(plan, module, B, 512, 512, 6, held=held)
    with pytest.raises(ValueError, match=r"the card holds 0 CTAs, not the team of SensePlan\("
                                         r"route='grid'"):
        _plan(module, 2, 512, 512, 6, grid_ctas=0)


@pytest.mark.parametrize("module", MODULES.values(), ids=MODULES)
@pytest.mark.parametrize("grid", [(66, 2, 6), (33, 4, 3), (132, 1, 2), (8, 16, 1), (5, 3, 4)])
def test_a_forced_grid_gives_its_plan(module, grid):
    plan = _plan(module, 16, 512, 512, 6, grid=grid)
    _covers(plan, module, 16, 512, 512, 6)
    assert (plan.team, plan.slots, plan.per_round) == grid


def test_a_forced_grid_runs_at_a_cluster_shape_too():
    plan = _plan(sense, 3, 24, 40, 3, grid=(7, 2, 2))
    _covers(plan, sense, 3, 24, 40, 3)
    assert (plan.team, plan.slots, plan.rounds) == (7, 2, 2)


@pytest.mark.parametrize("module", MODULES.values(), ids=MODULES)
@pytest.mark.parametrize("grid,match", [
    ((0, 1, 1), "a grid of 0 CTAs a slice in 1 slots, 1 coils a round does not fit"),
    ((513, 1, 1), "a grid of 513 CTAs a slice in 1 slots, 1 coils a round does not fit"),
    ((4, 17, 1), "a grid of 4 CTAs a slice in 17 slots"),
    ((4, 1, 7), "a grid of 4 CTAs a slice in 1 slots, 7 coils a round does not fit 16 x "
                "512x512 with 6 coils"),
    ((33, 5, 1), r"the card holds 132 CTAs, not the team of SensePlan\(route='grid'"),
])
def test_a_forced_grid_that_does_not_fit_raises(module, grid, match):
    with pytest.raises(ValueError, match=match):
        _plan(module, 16, 512, 512, 6, grid=grid)


def test_a_line_no_grid_cta_holds_raises():
    with pytest.raises(ValueError, match="a line of 2 x 1024x1024 fits no grid CTA"):
        _plan(sense, 2, 1024, 1024, 6, smem_max=12_000)
    with pytest.raises(ValueError, match="a forced split plan and a forced grid plan"):
        _plan(sense, 2, 512, 512, 6, split=(2, 1), grid=(4, 1, 1))


def test_the_grid_shared_memory_is_counted_piece_by_piece():
    # row 9 at 2 × 512²: 2 · (256 + 256) twiddles, two planes of 8 lines of
    # 513 floats (4,104, a multiple of 4), 10 int64 phase clocks
    assert _plan(sense, 2, 512, 512, 6).smem == 4 * (1024 + 2 * 4104) + 80 == 37_008
    # row 10: the block sums and the team's (100 float64) first, 13 clocks
    assert sb.GRID_HEAD == 800 and len(sb.GRID_PHASES) == 13
    assert _plan(sb, 2, 512, 512, 6).smem == 800 + 4 * (1024 + 2 * 4104) + 104 == 37_832
    # 481² (13 · 37): 2 · (241 + 241) twiddles; 8 lines of 481 (odd: its own
    # pitch) = 3848 floats
    assert _plan(sense, 2, 481, 481, 6).smem == 4 * (964 + 2 * 3848) + 80
    assert sense.grid_plane_cap(512, 512, SMEM) == 28_532
    assert sense.GRID_SCRATCH == 6 and sb.GRID_SCRATCH == 32
    assert sense.grid_scratch(_plan(sense, 2, 512, 512, 6), 512, 512, 6) == 2 * 18 * 512 * 512


def _cu_function(src, signature):
    return re.search(re.escape(signature) + r" \{(.*?)\n\}", src, re.S).group(1)


def test_the_planners_read_the_kernels_constants():
    """The grid kernels' threads, phases, pitch, shared-memory count, plan
    checks and per-slot planes as the .cu files and csrc/sense_grid.cuh
    state them."""
    header = (CSRC / "sense_grid.cuh").read_text()
    phases = re.search(r"enum \{\s*(kSetup[^}]*)\}", header).group(1)
    names = [p.strip() for p in phases.split(",") if p.strip()]
    assert names[-1] == "kPhases" and len(names) - 1 == len(sense.GRID_PHASES)
    assert "return n | 1;" in _cu_function(header, "__host__ __device__ inline int pitch(int n)")
    smem = _cu_function(header, "__host__ __device__ inline size_t smem_bytes(int H, int W, "
                                "size_t plane, size_t head,\n                                 "
                                "            int phases)")
    assert "head + sizeof(float) * (ceil4(twiddle_floats(H, W)) + 2 * plane) +" in smem
    assert "sizeof(long long) * phases" in smem
    valid = _cu_function(header, "inline bool valid_plan(int B, int H, int W, int C, int team, "
                                 "int slots, int per_round,\n                       int "
                                 "row_lines, int col_lines, int smem, size_t head, int phases)")
    for piece in ("team > H", "team > W", "slots > B", "per_round > C",
                  "row_lines > ceil_div(H, team)", "col_lines > ceil_div(W, team)",
                  "plane % 4 == 0", "static_cast<size_t>(row_lines) * pitch(W) <= plane",
                  "static_cast<size_t>(col_lines) * pitch(H) <= plane"):
        assert piece in valid, piece
    # two team barriers a round, the table in the header
    assert header.count("grid::group_sync(s.ctr, target, s.team);  // T") == 2
    for name in ("T1", "T2"):
        assert re.search(rf"^//\s+team barrier {name};", header, re.M), name
    for name, module, head, planes in (("sense_fused.cu", sense, "0, sg::kPhases", 6),
                                       ("splitbregman_fused.cu", sb,
                                        "kGridHead, kGridPhases", 32)):
        src = (CSRC / name).read_text()
        assert re.findall(r"constexpr int kThreads = (\d+);", src) == ["1024"]
        assert f"constexpr int kGridPlanes = {planes};" in src
        assert planes == module.GRID_SCRATCH
        assert f"return sg::smem_bytes(H, W, plane, {head});" in src
        assert "cudaLaunchCooperativeKernel(fn, dim3(team * slots), dim3(kThreads)" in src
        # the global route is gone
        assert "_fused_kernel(" not in src and "_fused_launch(" not in src
    src = (CSRC / "splitbregman_fused.cu").read_text()
    assert "sizeof(double) * (3 * (kThreads / 32) + 4)" in src
    extra = re.search(r"enum \{ (kGridVector = sg::kPhases[^}]*)\}", src).group(1)
    assert len([p for p in extra.split(",") if p.strip()]) - 1 == len(sb.GRID_PHASES) - len(
        sense.GRID_PHASES)
    # the chunked one-CTA passes are gone with the global route
    assert "FftShared" not in (CSRC / "dft_common.cuh").read_text()


# ---- a Python model of the grid route


class Hazard(AssertionError):
    """An element of a team's shared buffer that one CTA wrote and another
    read or wrote between the same two team barriers."""


class SenseGridModel:
    """One slot's buffers in global memory that its team shares, by name,
    and which CTA read and wrote each element since the last barrier.
    Writes land at once (global memory); a barrier checks the window."""

    def __init__(self, team):
        self.team, self.bufs, self.reads, self.writes = team, {}, {}, {}

    def add(self, name, value):
        self.bufs[name] = value
        self.reads[name] = torch.zeros((self.team, *value.shape), dtype=torch.bool)
        self.writes[name] = torch.zeros((self.team, *value.shape), dtype=torch.bool)

    def read(self, q, name, idx):
        self.reads[name][(q, *idx)] = True
        return self.bufs[name][idx].clone()

    def write(self, q, name, idx, value):
        self.writes[name][(q, *idx)] = True
        self.bufs[name][idx] = value

    def barrier(self):
        met = []
        for name in self.bufs:
            reads, writes = self.reads[name], self.writes[name]
            readers, writers = reads.sum(0), writes.sum(0)
            for q in range(self.team):
                mine = writes[q]
                others = (readers - reads[q].int() > 0) | (writers - mine.int() > 0)
                if bool((mine & others).any()):
                    met.append(f"{name}: CTA {q} wrote elements another CTA touched")
            reads.zero_()
            writes.zero_()
        if met:
            raise Hazard(f"between two barriers: {'; '.join(met)}")


def _chunks(part, lines):
    """[a, b) chunks of `lines` of a CTA's part [p0, p1)."""
    p0, p1 = part
    return [(a, min(a + lines, p1)) for a in range(p0, p1, lines)]


ALL = slice(None)


class GridNormal:
    """sense_grid.cuh's normal op on one slot: the spectra S_k (per_round,
    2, H, W) in the model's buffers, the coil sum between rounds in each
    CTA's own rows."""

    def __init__(self, m, plan, coils, tables, barriers):
        self.m, self.plan, self.coils, self.tables = m, plan, coils, tables
        self.barriers = barriers
        H, W = plan.H, plan.W
        m.add("S", torch.zeros(plan.per_round, 2, H, W))
        self.acc = torch.zeros(2, H, W)

    def forward(self, q, ro, rows, v):
        """(R) of round ro's coils on the rows [a, b) of CTA q's band."""
        p, (cr, ci) = self.plan, self.coils
        a, b = rows
        for c in range(ro * p.per_round, min(p.C, (ro + 1) * p.per_round)):
            ca, cb, vr, vi = cr[c, a:b], ci[c, a:b], v[0][a:b], v[1][a:b]
            re, im = line_model(ca * vr - cb * vi, ca * vi + cb * vr, self.tables[1])
            self.m.write(q, "S", (c - ro * p.per_round, ALL, slice(a, b), ALL),
                         torch.stack([re, im]))

    def forward_band(self, v):
        for q in range(self.plan.team):
            for rows in _chunks(self.plan.band(q), self.plan.row_lines):
                self.forward(q, 0, rows, v)

    def run(self, v, finish, next_=None):
        """Every round: T1, (C), T2, (R') with the fold (finish(q, rows, nr,
        ni) after the last coil) and the next (R) on each chunk; next_(q,
        rows) where this was the last round."""
        p, (cr, ci), m = self.plan, self.coils, self.m
        H = p.H
        tw_h, tw_w, weights = self.tables
        for ro in range(p.rounds):
            k0, k1 = ro * p.per_round, min(p.C, (ro + 1) * p.per_round)
            if "T1" in self.barriers:
                m.barrier()
            for q in range(p.team):
                for cols in _chunks(p.block(q), p.col_lines):
                    for c in range(k0, k1):
                        idx = (c - k0, ALL, ALL, slice(*cols))
                        s = m.read(q, "S", idx)
                        re, im = line_model(s[0].T.contiguous(), s[1].T.contiguous(), tw_h)
                        wt = weights.T[cols[0]:cols[1]]
                        re, im = line_model(re * wt, im * wt, tw_h, inverse=True)
                        m.write(q, "S", idx, torch.stack([re.T, im.T]))
            if "T2" in self.barriers:
                m.barrier()
            for q in range(p.team):
                for a, b in _chunks(p.band(q), p.row_lines):
                    for c in range(k0, k1):
                        s = m.read(q, "S", (c - k0, ALL, slice(a, b), ALL))
                        yr, yi = line_model(s[0], s[1], tw_w, inverse=True)
                        ca, cb = cr[c, a:b], ci[c, a:b]
                        if c == 0:
                            sr, si = torch.zeros_like(yr), torch.zeros_like(yr)
                        else:
                            sr, si = self.acc[0, a:b], self.acc[1, a:b]
                        sr, si = (sr + ca * yr) + cb * yi, (si + ca * yi) - cb * yr
                        if c + 1 == p.C:
                            finish(q, (a, b), sr, si)
                        else:
                            self.acc[0, a:b], self.acc[1, a:b] = sr, si
                    if ro + 1 < p.rounds:
                        self.forward(q, ro + 1, (a, b), v)
                    elif next_ is not None:
                        next_(q, (a, b))
        assert H == p.H


def grid_sense_fista(x0hat, scal, tab, coils, tables, plan, barriers=("T1", "T2")):
    """FISTA-L21 on B slices by sense_fused.cu's grid kernel: slot s solves
    slices s, s + slots, … on its own spectra; per slice x = x_prev = 0 and
    m on each band, (R) of the first round, then per iteration the normal
    op of m whose last fold forms the gradient step, the group threshold,
    x_prev and the next m, and whose last (R') is followed on each chunk by
    the next iteration's (R)."""
    B = x0hat.shape[0]
    out = torch.full_like(x0hat, float("nan"))
    for s in range(plan.slots):
        m = SenseGridModel(plan.team)
        op = GridNormal(m, plan, coils, tables, barriers)
        for b in range(s, B, plan.slots):
            rho, t = scal[b, 0], scal[b, 0] * scal[b, 1]
            x0r, x0i = x0hat[b, 0], x0hat[b, 1]
            x = torch.stack([x0r * 0.0, x0r * 0.0])
            xp = x.clone()
            a0 = tab[0, 0] if tab.shape[0] else torch.tensor(0.0)
            mm = x + a0 * (x - xp)
            if tab.shape[0]:
                op.forward_band(mm)
            for it in range(tab.shape[0]):
                more = it + 1 < tab.shape[0]

                def finish(q, rows, nr, ni, more=more, it=it):
                    a, b_ = rows
                    gr = mm[0, a:b_] - rho * (nr - x0r[a:b_])
                    gi = mm[1, a:b_] - rho * (ni - x0i[a:b_])
                    xr, xi = sense.group_threshold(gr, gi, t)
                    xp[:, a:b_] = x[:, a:b_]
                    x[0, a:b_], x[1, a:b_] = xr, xi
                    if more:
                        an = tab[it + 1, 0]
                        mm[:, a:b_] = x[:, a:b_] + an * (x[:, a:b_] - xp[:, a:b_])

                def next_(q, rows, more=more):
                    if more:
                        op.forward(q, 0, rows, mm)

                op.run(mm, finish, next_)
            out[b] = x
        m.barrier()  # the next one, where a race shows
    return out


def grid_splitbregman(x0hat, scal, t2tab, coils, tables, plan, iterations, inner, cg, tol,
                      barriers=("T1", "T2", "sum", "v", "rv", "y", "pv")):
    """SplitBregman L21 + TV on B slices by splitbregman_fused.cu's grid
    kernel: the vector phases on each CTA's band, the normal ops of
    :class:`GridNormal`, the CG's sums as each CTA's float64 band sum
    written to its entry of the team's sums (two entries a CTA, in turn), a
    barrier ("sum"), the team's entries added in rank order and rounded
    once; the fold FGP of both planes swept band by band, with barriers
    before the first sweep ("v"), before each y sweep ("rv"), before each
    duals sweep ("y") and after the last ("pv"). Returns (x, live CG
    steps)."""
    B, _, H, W = x0hat.shape
    out = torch.full_like(x0hat, float("nan"))
    counts = torch.zeros(B, dtype=torch.int32)
    team = plan.team
    bands = [slice(*plan.band(q)) for q in range(team)]
    for s in range(plan.slots):
        m = SenseGridModel(team)
        op = GridNormal(m, plan, coils, tables, barriers)
        m.add("sums", torch.zeros(2, team, dtype=torch.float64))
        for name in ("v", "pv", "rv", "y"):
            m.add(name, torch.zeros(2, H, W))
        parity = [0]

        def team_sum(parts):
            """parts[q]: CTA q's float64 band sum; the team's sum, rounded
            once to float32."""
            if team == 1:
                return parts[0].float()
            for q in range(team):
                m.write(q, "sums", (parity[0], q), parts[q])
            if "sum" in barriers:
                m.barrier()
            total = None
            for q in range(team):
                entries = m.read(q, "sums", (parity[0], ALL))
                t = torch.zeros((), dtype=torch.float64)
                for e in entries:
                    t = t + e
                total = t
            parity[0] ^= 1
            return total.float()

        def dsq(*planes):
            return sum((p.double() * p.double()).sum() for p in planes)

        for b in range(s, B, plan.slots):
            rho1, rho2, lam1, lam2 = scal[b]
            rho_sum = rho1 + rho2
            t1 = lam1 / (rho1 if rho1 != 0 else torch.ones_like(rho1))
            t2 = lam2 / (rho2 if rho2 != 0 else torch.ones_like(rho2))
            tv = bool(rho2 != 0) and t2tab.shape[0] > 0
            x0 = x0hat[b]
            x = torch.stack([x0[0] * 0.0, x0[0] * 0.0])
            by = x0.clone()
            z1, u1, z2, u2 = (torch.zeros(2, H, W) for _ in range(4))
            beta, r, p, q_ = (torch.zeros(2, H, W) for _ in range(4))
            live = 0
            parts = [None] * team

            def normal(v, site):
                def finish(q, rows, nr, ni):
                    a, b_ = rows
                    if site == "start":
                        vr = beta[0, a:b_] - (nr + rho_sum * x[0, a:b_])
                        vi = beta[1, a:b_] - (ni + rho_sum * x[1, a:b_])
                        r[0, a:b_], r[1, a:b_] = vr, vi
                        p[0, a:b_], p[1, a:b_] = vr, vi
                        parts[q] = parts[q] + dsq(vr, vi)
                    elif site == "matvec":
                        vr = nr + rho_sum * p[0, a:b_]
                        vi = ni + rho_sum * p[1, a:b_]
                        q_[0, a:b_], q_[1, a:b_] = vr, vi
                        parts[q] = parts[q] + (p[0, a:b_].double() * vr.double()).sum() + (
                            p[1, a:b_].double() * vi.double()).sum()
                    else:
                        by[0, a:b_] = (by[0, a:b_] + x0[0, a:b_]) - nr
                        by[1, a:b_] = (by[1, a:b_] + x0[1, a:b_]) - ni

                op.forward_band(v)
                op.run(v, finish)

            def clear():
                for q in range(team):
                    parts[q] = torch.zeros((), dtype=torch.float64)

            for _ in range(iterations):
                z1.copy_(x), z2.copy_(x), u1.copy_(x * 0.0), u2.copy_(x * 0.0)
                for _ in range(inner):
                    clear()
                    for q, band in enumerate(bands):
                        beta[:, band] = (by[:, band] + rho1 * (z1[:, band] - u1[:, band])) + rho2 * (
                            z2[:, band] - u2[:, band])
                        parts[q] = parts[q] + dsq(beta[0, band], beta[1, band])
                    target = tol * torch.sqrt(team_sum(parts))
                    clear()
                    normal(x, "start")
                    rz = team_sum(parts)
                    for _ in range(cg):
                        clear()
                        normal(p, "matvec")
                        pq = team_sum(parts)
                        active = bool(torch.sqrt(rz) > target)
                        live += int(active)
                        alpha = (rz / (pq if pq != 0 else torch.ones_like(pq)) if active
                                 else torch.zeros_like(rz))
                        clear()
                        for q, band in enumerate(bands):
                            x[:, band] = x[:, band] + alpha * p[:, band]
                            r[:, band] = r[:, band] - alpha * q_[:, band]
                            parts[q] = parts[q] + dsq(r[0, band], r[1, band])
                        rz_new = team_sum(parts)
                        beta_c = (torch.zeros_like(rz) if rz == 0 else rz_new / rz)
                        if active:
                            for band in bands:
                                p[:, band] = r[:, band] + beta_c * p[:, band]
                        rz = rz_new
                    # z1, u1 and v = x + u2 (shared: a neighbour band reads it)
                    for q, band in enumerate(bands):
                        ar, ai = x[0, band] + u1[0, band], x[1, band] + u1[1, band]
                        sr, si = sense.group_threshold(ar, ai, t1)
                        zr, zi = (sr, si) if rho1 != 0 else (ar, ai)
                        z1[0, band], z1[1, band] = zr, zi
                        u1[0, band] = (u1[0, band] + x[0, band]) - zr
                        u1[1, band] = (u1[1, band] + x[1, band]) - zi
                        m.write(q, "v", (ALL, band, ALL), x[:, band] + u2[:, band])
                    ph = _grid_fgp(m, bands, t2, t2tab, H, W, barriers) if tv else None
                    for q, band in enumerate(bands):
                        v = m.read(q, "v", (ALL, band, ALL))
                        zv = v
                        if tv and band.stop > band.start:
                            pv, up = _with_above(m, q, "pv", band, W)
                            left = torch.zeros_like(v)
                            left[:, :, 1:] = ph[:, band, :-1]
                            zv = v - ((up - pv) + (left - ph[:, band]))
                        z2[:, band] = zv
                        u2[:, band] = (u2[:, band] + x[:, band]) - zv
                clear()
                normal(x, "bregman")
            out[b] = x
            counts[b] = live
        m.barrier()  # the next one, where a race shows
    return out, counts


def _with_above(m, q, name, band, W):
    """CTA q's band of plane `name` (2, R, W) and the row above each of its
    rows (zero above the image)."""
    r0, r1 = band.start, band.stop
    if r0 == 0:
        own = m.read(q, name, (ALL, slice(0, r1), ALL))
        return own, torch.cat([torch.zeros(2, 1, W), own[:, :-1]], 1)
    both = m.read(q, name, (ALL, slice(r0 - 1, r1), ALL))
    return both[:, 1:], both[:, :-1]


def _grid_fgp(m, bands, lt, t2tab, H, W, barriers):
    """The fold FGP of both planes of v, swept band by band (the kernel's
    sweeps, rls::fold_fgp's operations): v (read one row below in the first
    sweep), y (one row below), rv and pv (one row above) in the team's
    shared buffers; ph and rh read in the band's own rows. Returns ph."""
    ph, rh = torch.zeros(2, H, W), torch.zeros(2, H, W)

    def with_below(q, name, band):
        """The band's rows of plane `name` and, where there is one, the row
        below them."""
        return m.read(q, name, (ALL, slice(band.start, min(band.stop + 1, H)), ALL))

    def clip(v):
        return torch.clamp(v, -lt, lt)

    def sync(name):
        if name in barriers:
            m.barrier()

    sync("v")
    for q, band in enumerate(bands):
        R = band.stop - band.start
        if R == 0:
            continue
        xs = with_below(q, "v", band)
        nb = xs.shape[1] - 1  # rows with a row below
        y0 = xs[:, :R] * 0.125
        qv, qh = torch.zeros(2, R, W), torch.zeros(2, R, W)
        qv[:, :nb] = clip(xs[:, 1:] * 0.125 - y0[:, :nb])
        qh[:, :, :W - 1] = clip(xs[:, :R, 1:] * 0.125 - y0[:, :, :W - 1])
        m.write(q, "pv", (ALL, band, ALL), qv)
        m.write(q, "rv", (ALL, band, ALL), qv)
        ph[:, band], rh[:, band] = qh, qh
    for k in range(1, t2tab.shape[0]):
        c1, c2 = t2tab[k, 0], t2tab[k, 1]
        sync("rv")
        for q, band in enumerate(bands):
            if band.stop == band.start:
                continue
            rv, up = _with_above(m, q, "rv", band, W)
            left = torch.zeros_like(rv)
            left[:, :, 1:] = rh[:, band, :-1]
            gt = (up - rv) + (left - rh[:, band])
            v = m.read(q, "v", (ALL, band, ALL))
            m.write(q, "y", (ALL, band, ALL), (v - gt) * 0.125)
        sync("y")
        for q, band in enumerate(bands):
            R = band.stop - band.start
            if R == 0:
                continue
            y = with_below(q, "y", band)
            nb = y.shape[1] - 1
            rv = m.read(q, "rv", (ALL, band, ALL))
            pv = m.read(q, "pv", (ALL, band, ALL))
            qv, qh = torch.zeros(2, R, W), torch.zeros(2, R, W)
            qv[:, :nb] = clip(rv[:, :nb] + (y[:, 1:] - y[:, :nb]))
            qh[:, :, :W - 1] = clip(rh[:, band, :W - 1] + (y[:, :R, 1:] - y[:, :R, :W - 1]))
            m.write(q, "rv", (ALL, band, ALL), c1 * qv - c2 * pv)
            rh[:, band] = c1 * qh - c2 * ph[:, band]
            m.write(q, "pv", (ALL, band, ALL), qv)
            ph[:, band] = qh
    sync("pv")
    return ph


def _case(B, H, W, C, seed=0):
    rng = np.random.default_rng(seed + H * W + C)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    maps = rng.normal(size=(C, H, W)) + 1j * rng.normal(size=(C, H, W))
    maps /= np.sqrt((np.abs(maps) ** 2).sum(0))
    tables = dft.dft_tables(t(rng.uniform(size=(H, W)) < 0.45))
    return (t(maps.real), t(maps.imag)), tables, t(rng.normal(size=(B, 2, H, W)))


@pytest.fixture
def one_thread():
    """One intra-op thread for a bit-for-bit comparison (as in
    tests/test_torch_sense_split.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _forced(B, H, W, C, grid, smem=SMEM, module=sense):
    return _plan(module, B, H, W, C, grid=grid, smem_max=smem)


# (B, H, W, C) and the forced grid (team, slots, coils a round), the shared
# memory: even and uneven teams, a prime side, lines with a shared-memory
# stage (256 > 128 points), several chunks a band and a block (a small
# shared memory), slots walking slices in rounds, one to three coils a
# round, a band of one row
GRID_CASES = [((2, 12, 10, 3), (3, 1, 3), SMEM), ((3, 12, 10, 3), (4, 2, 2), SMEM),
              ((2, 9, 7, 3), (2, 1, 1), SMEM), ((2, 9, 7, 3), (4, 2, 2), SMEM),
              ((2, 16, 256, 2), (3, 2, 1), SMEM), ((3, 12, 10, 3), (2, 2, 3), 420),
              ((1, 12, 10, 3), (10, 1, 2), SMEM)]


def test_the_model_s_cases_take_several_chunks_rounds_and_uneven_teams():
    plans = [_forced(*shape, grid, smem) for shape, grid, smem in GRID_CASES]
    assert any(p.row_lines < -(-p.H // p.team) for p in plans)
    assert any(p.rounds > 1 for p in plans) and any(p.slots > 1 for p in plans)
    assert any(p.H % p.team and p.W % p.team for p in plans)
    assert any(p.per_round == 1 for p in plans) and any(p.per_round == 3 for p in plans)


@pytest.mark.parametrize("shape,grid,smem", GRID_CASES)
def test_the_grid_normal_op_is_the_plain_one_bit_for_bit(shape, grid, smem, one_thread):
    B, H, W, C = shape
    coils, tables, x = _case(1, H, W, C)
    plan = _forced(1, H, W, C, (grid[0], 1, grid[2]), smem)
    m = SenseGridModel(plan.team)
    op = GridNormal(m, plan, coils, tables, ("T1", "T2"))
    got = torch.full((2, H, W), float("nan"))

    def finish(q, rows, nr, ni):
        got[0, rows[0]:rows[1]], got[1, rows[0]:rows[1]] = nr, ni

    op.forward_band((x[0, 0], x[0, 1]))
    op.run((x[0, 0], x[0, 1]), finish)
    m.barrier()
    want = dft.sense_normal(x[:, 0], x[:, 1], *coils, tables)
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[1][0])


@pytest.mark.parametrize("shape,grid,smem", GRID_CASES)
def test_the_grid_fista_is_the_plain_version_bit_for_bit(shape, grid, smem, one_thread):
    B, H, W, C = shape
    coils, tables, x0 = _case(B, H, W, C)
    scal = torch.tensor([[0.9, 1e-2], [0.7, 0.2], [0.95, 0.0]])[:B]
    tab = torch.as_tensor(_momentum_table("fista", 3))
    plan = _forced(B, H, W, C, grid, smem)
    want = sense.fista_l21_sense_fused_torch(x0, scal, tab, coils, tables)
    assert torch.equal(grid_sense_fista(x0, scal, tab, coils, tables, plan), want)
    assert float(want.abs().max()) > 0  # the threshold left something


SB_SCHED = (1, 2, 2, 1e-5)  # iterations, inner, CG steps, tol_inner


@pytest.mark.parametrize("shape,grid,smem", [GRID_CASES[i] for i in (1, 2, 4, 6)])
def test_the_grid_splitbregman_is_the_plain_version_bit_for_bit(shape, grid, smem, one_thread):
    """One outer × two inner iterations of two CG steps, TV at three dual
    iterations; one slice with TV off (ρ₂ = 0) where there are three: slots
    in rounds, uneven bands and a prime side, lines with a shared-memory
    stage, one-row bands. (The normal op's chunks and rounds of 3 coils
    are row 9's, held above.)"""
    B, H, W, C = shape
    coils, tables, x0 = _case(B, H, W, C, seed=1)
    rho2 = [0.05, 0.02, 0.0][:B]
    scal, t2 = sb.kernel_args(x0, 0.05, torch.tensor(rho2), 1e-2, 2e-2, 3)
    plan = _forced(B, H, W, C, grid, smem, sb)
    want, live = sb.splitbregman_l1_tv_fused_torch(x0, scal, t2, coils, tables, *SB_SCHED)
    got, counts = grid_splitbregman(x0, scal, t2, coils, tables, plan, *SB_SCHED)
    assert counts.tolist() == live.tolist()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dropped,buffer", [("T1", "S"), ("T2", "S")])
@pytest.mark.parametrize("shape,grid", [((1, 12, 10, 3), (3, 1, 2)),
                                        ((1, 9, 7, 2), (2, 1, 1))])
def test_each_team_barrier_of_the_normal_op_is_needed(shape, grid, dropped, buffer):
    """Without T1 the column pass reads rows the row pass writes; without
    T2 the rows back read columns the column pass writes."""
    B, H, W, C = shape
    coils, tables, x0 = _case(B, H, W, C)
    plan = _forced(B, H, W, C, grid)
    kept = tuple(b for b in ("T1", "T2") if b != dropped)
    tab = torch.as_tensor(_momentum_table("fista", 2))
    with pytest.raises(Hazard, match=f"{buffer}: CTA"):
        grid_sense_fista(x0, torch.tensor([[0.9, 1e-2]]), tab, coils, tables, plan, kept)


SB_BARRIERS = ("T1", "T2", "sum", "v", "rv", "y", "pv")


@pytest.mark.parametrize("dropped,buffer", [
    ("T1", "S"), ("T2", "S"),
    ("sum", "sums"),   # a CTA reads the team's entries as they are written
    ("v", "v"),        # the first sweep reads v below as it is written
    ("rv", "rv"),      # the y sweep reads rv above as the duals write it
    ("y", "y"),        # the duals sweep reads y below as it is written
    ("pv", "pv"),      # the z2 update reads pv above as the duals write it
])
def test_each_team_barrier_of_the_splitbregman_kernel_is_needed(dropped, buffer):
    coils, tables, x0 = _case(1, 9, 7, 2, seed=1)
    scal, t2 = sb.kernel_args(x0, 0.05, 0.05, 1e-2, 2e-2, 3)
    plan = _forced(1, 9, 7, 2, (3, 1, 1), module=sb)
    kept = tuple(b for b in SB_BARRIERS if b != dropped)
    with pytest.raises(Hazard, match=f"{buffer}: CTA"):
        grid_splitbregman(x0, scal, t2, coils, tables, plan, 1, 1, 2, 1e-5, kept)


def test_a_team_of_one_needs_no_barrier(one_thread):
    """With one CTA a slice nothing is shared: group_sync returns at once,
    the sums are the block's, and the model finds no hazard without
    barriers."""
    coils, tables, x0 = _case(1, 9, 7, 2)
    plan = _forced(1, 9, 7, 2, (1, 1, 1))
    tab = torch.as_tensor(_momentum_table("fista", 2))
    scal = torch.tensor([[0.9, 1e-2]])
    assert torch.equal(grid_sense_fista(x0, scal, tab, coils, tables, plan, ()),
                       sense.fista_l21_sense_fused_torch(x0, scal, tab, coils, tables))
    scal, t2 = sb.kernel_args(x0, 0.05, 0.05, 1e-2, 2e-2, 3)
    got, counts = grid_splitbregman(x0, scal, t2, coils, tables, _forced(1, 9, 7, 2, (1, 1, 1),
                                                                          module=sb),
                                    1, 1, 2, 1e-5, ())
    want, live = sb.splitbregman_l1_tv_fused_torch(x0, scal, t2, coils, tables, 1, 1, 2, 1e-5)
    assert torch.equal(got, want) and counts.tolist() == live.tolist()


# ---- past the JAX kernels' gate


def _sense_problem64(n, C, seed):
    rng = np.random.default_rng(seed)
    maps = rng.normal(size=(C, n, n)) + 1j * rng.normal(size=(C, n, n))
    maps /= np.sqrt((np.abs(maps) ** 2).sum(0))
    mask = (rng.uniform(size=(n, n)) < 0.4).astype(np.float32)
    op64 = rt.SenseDFT2RealOperator.from_maps(maps, mask, (n, n), dtype=jnp.float64)
    X = rng.normal(size=(1, 2 * n * n))
    B64 = np.asarray(jax.vmap(op64.mv)(jnp.asarray(X))).T
    return op64, B64


def test_row9_plain_version_past_the_jax_gate_matches_jax_composed():
    """1 × 320², 2 coils: past the JAX kernel's VMEM check (it passes
    squares up to ~305² at 2 coils), so the JAX package solves it on its
    composed path. Row 9's plain version (which its routes match bit for
    bit on the card) in float64 on the operator's Aᴴb, against
    ``rt.solve_batched_unrolled`` on the float64 operator, 5 iterations,
    to 1e-10."""
    n = 320
    jsense._check_vmem_sense(304, 304, 2)
    with pytest.raises(ValueError, match="exceeds VMEM"):
        jsense._check_vmem_sense(n, n, 2)
    with jax.enable_x64(True):
        op64, B64 = _sense_problem64(n, 2, 320)
        s64 = rt.FISTA.create(op64, reg=rt.L21Regularization(1e-3, slices=2), iterations=5,
                              rho=0.9, rel_tol=0.0, track_residual=False)
        want = np.asarray(rt.solve_batched_unrolled(s64, jnp.asarray(B64)))
    tsolver = convert(s64, device="cpu")
    op = tsolver.A
    bt = torch.from_numpy(np.array(B64)).T
    assert float(dft.normalization_factor(tsolver.normalize_reg, op, bt)) == 1.0
    x0 = op.rmv(bt).reshape(1, 2, n, n)
    assert x0.dtype == torch.float64
    before = sense.fista_l21_sense_fused.launches
    got = sense.fista_l21_sense_fused(x0, op.mask, op.coils_r, op.coils_i, tsolver.rho,
                                      tsolver.reg.lam, tsolver.iterations)
    assert sense.fista_l21_sense_fused.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.reshape(1, -1).T.numpy(), want, rtol=0, atol=1e-10)


def test_row10_plain_version_past_the_jax_gate_matches_jax_composed():
    """1 × 320², 2 coils: past the JAX kernel's VMEM check (it passes
    squares up to ~262² at 2 coils). Row 10's plain version in float64
    against ``rt.solve_batched_unrolled`` of the JAX SplitBregman on the
    float64 operator, 1 × 2 × 3 CG steps, TV 2, to 1e-9 of max|x| (the
    composed CG's sums run in another order)."""
    n = 320
    jsb._check_vmem_splitbregman(262, 262, 2)
    with pytest.raises(ValueError, match="exceeds VMEM"):
        jsb._check_vmem_splitbregman(n, n, 2)
    with jax.enable_x64(True):
        op64, B64 = _sense_problem64(n, 2, 321)
        N = n * n
        s64 = rt.SplitBregman.create(
            op64,
            reg=[rt.L21Regularization(1e-3, slices=2),
                 rt.TVRegularization(1e-3, shape=(2, n, n), dims=(1, 2), iterations_tv=2)],
            reg_trafo=[rt.IdentityOperator(2 * N, jnp.float64),
                       rt.IdentityOperator(2 * N, jnp.float64)],
            rho0=[0.05, 0.05], iterations=1, iterations_inner=2, iterations_cg=3,
            tol_inner=1e-12)
        want = np.asarray(rt.solve_batched_unrolled(s64, jnp.asarray(B64)))
    tsolver = convert(s64, device="cpu")
    op = tsolver.A
    bt = torch.from_numpy(np.array(B64)).T
    assert float(dft.normalization_factor(tsolver.normalize_reg, op, bt)) == 1.0
    x0 = op.rmv(bt).reshape(1, 2, n, n)
    assert x0.dtype == torch.float64
    l21, tv = tsolver.reg
    before = sb.splitbregman_l1_tv_fused.launches
    got = sb.splitbregman_l1_tv_fused(x0, op.mask, op.coils_r, op.coils_i, *tsolver.rho0, l21.lam,
                                      tv.lam, tsolver.iterations, tsolver.iterations_inner,
                                      tsolver.iterations_cg, tv.iterations_tv, tsolver.tol_inner)
    assert sb.splitbregman_l1_tv_fused.launches == before  # CPU: the plain version
    got = got.reshape(1, -1).T.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())
