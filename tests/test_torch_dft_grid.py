"""Row 8's grid route (rls_tpu_torch/kernels/fista_l1_dft_fused.py
``plan_grid``, csrc/fista_l1_dft_fused.cu ``fista_l1_dft_grid_kernel``) on
the CPU: its plans, the kernel's constants as the .cu states them, a
Python model of its schedule, and the plain version against the JAX
package at a shape past the JAX kernel's VMEM gate.

The plans: every shape whose bands fit no cluster of 16 takes the grid
route, with team × slots no more than the card holds, every row and column
owned by one CTA of a team, every problem by one slot in some round, the
chunks of a band and a block inside a CTA's shared memory, and the least
cost among the slots the card allows; smaller cards and shapes no grid
CTA fits; forced plans.

The model: one slot's spectrum S in global memory with a log of which CTA
of the team read and wrote each point since the last team barrier; the
passes of the kernel run CTA by CTA, chunk by chunk ((R) rows forward, T1,
(C) the block's columns forward, weighted and back, T2, (R') rows back,
the pixel update and the next iteration's (R)), each line through the
register layout model of tests/test_torch_splitbregman_plan.py. A point
that one CTA writes and another reads or writes between the same two
barriers raises Hazard. It is held bit for bit against
``_dft_common.real_normal`` and ``fista_l1_dft_fused_torch`` at small
shapes on uneven teams, with slots walking problems in rounds, and it
raises when either team barrier is dropped. The kernel itself runs only on
the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import _dft_common as dft
from rls_tpu_torch.kernels import fista_l1_dft_fused as l1dft
from rls_tpu_torch.kernels.fista_tv_fused import _momentum_table
from test_torch_dft_plan import GRID_PLANS, H100_GRID, H100_RESIDENT
from test_torch_splitbregman_plan import line_model

SMS, SMEM = 132, 232_448
CSRC = Path(l1dft.__file__).parents[1] / "csrc"


def _plan(B, H, W, **kw):
    return l1dft.plan_fista_l1_dft(B, H, W, H100_RESIDENT, **kw)


def _covers(plan, B, H, W, held=H100_GRID, smem=SMEM):
    """A grid plan's bands cover H and its blocks W, once each, over its
    team; its rounds cover B; the card holds its CTAs; its chunks fit a
    plane of its CTA's shared memory, which fits the card."""
    assert plan.route == "grid"
    team = plan.team
    assert plan.clusters == team and 1 <= team <= min(H, W)
    rows = [r for q in range(team) for r in range(*plan.band(q))]
    cols = [k for q in range(team) for k in range(*plan.block(q))]
    assert rows == list(range(H)) and cols == list(range(W))
    assert (plan.rows, plan.cols) == (-(-H // team), -(-W // team))
    assert plan.ctas == team * plan.slots <= held
    assert 1 <= plan.slots <= B and plan.rounds == -(-B // plan.slots)
    assert sorted(s + r * plan.slots for s in range(plan.slots) for r in range(plan.rounds)
                  if s + r * plan.slots < B) == list(range(B))
    assert 1 <= plan.row_lines <= plan.rows and 1 <= plan.col_lines <= plan.cols
    plane = (plan.smem - l1dft.grid_smem_bytes(H, W, 0)) // 8
    assert l1dft.grid_smem_bytes(H, W, plane) == plan.smem <= smem and plane % 4 == 0
    assert plan.row_lines * l1dft.grid_pitch(W) <= plane
    assert plan.col_lines * l1dft.grid_pitch(H) <= plane
    # the fewest chunks that fit, as even as possible
    cap = l1dft.grid_plane_cap(H, W, smem)
    for lines, total, pitch in ((plan.row_lines, plan.rows, W | 1),
                                (plan.col_lines, plan.cols, H | 1)):
        assert -(-total // lines) == -(-total // (cap // pitch))


# ---- the planner


@pytest.mark.parametrize("shape", list(GRID_PLANS))
def test_the_grid_plans_of_the_card_s_shapes(shape):
    plan = _plan(*shape)
    _covers(plan, *shape)
    assert (plan.team, plan.slots, plan.rows, plan.cols, plan.row_lines,
            plan.col_lines) == GRID_PLANS[shape]


SIDES = [2**k for k in range(1, 11)]


@pytest.mark.parametrize("B", [1, 4, 16, 64])
@pytest.mark.parametrize("H", SIDES + [385, 448, 640, 704, 1021])
@pytest.mark.parametrize("W", SIDES + [385, 448, 640])
def test_every_shape_past_a_cluster_takes_the_cheapest_grid_plan(B, H, W):
    """The grid route exactly where no cluster of 16 fits, with the least
    cost over the slots the card allows (ties to more slots); the resident
    route everywhere else, as before."""
    plan = _plan(B, H, W)
    if l1dft.fitting_sizes(H, W):
        assert plan.route == "resident"
        return
    _covers(plan, B, H, W)

    def cost(s):
        return l1dft.grid_cost(B, H, W, min(H100_GRID // s, H, W), s)

    best = min(cost(s) for s in range(1, min(B, H100_GRID) + 1))
    assert cost(plan.slots) == best
    assert all(s <= plan.slots for s in range(1, min(B, H100_GRID) + 1) if cost(s) == best)
    assert plan.team == min(H100_GRID // plan.slots, H, W)


def test_every_square_side_from_385_takes_the_grid_route():
    for n in range(380, 1025):
        plan = _plan(4, n, n)
        assert (plan.route == "grid") == (n >= 385), n
        if n >= 385:
            assert (plan.team, plan.slots) == (33, 4)


@pytest.mark.parametrize("held,smem,want", [
    # a card of 8 SMs: 8 CTAs, 4 slots of 2 (bands of 256 rows in 5 chunks
    # of 52 at most: 55 lines of 513 floats fit a plane); 4 SMs: 4 slots of
    # one CTA (512 rows in 10 chunks)
    (8, SMEM, (2, 4, 1, 52, 52)),
    (4, SMEM, (1, 4, 1, 52, 52)),
    # less shared memory: more chunks of fewer lines
    (132, 60_000, (33, 4, 1, 8, 8)),
    (132, 10_000, (33, 4, 1, 1, 1)),
])
def test_grid_plans_respect_the_card(held, smem, want):
    plan = _plan(4, 512, 512, sms=held, smem_max=smem, grid_ctas=held)
    _covers(plan, 4, 512, 512, held=held, smem=smem)
    assert (plan.team, plan.slots, plan.rounds, plan.row_lines, plan.col_lines) == want


def test_the_grid_route_on_a_card_with_fewer_ctas_walks_problems_in_rounds():
    plan = _plan(16, 512, 512, grid_ctas=20)
    _covers(plan, 16, 512, 512, held=20)
    assert plan.rounds > 1 and plan.ctas <= 20


@pytest.mark.parametrize("grid", [(33, 4), (8, 16), (66, 2), (132, 1), (4, 3)])
def test_a_forced_grid_gives_its_plan(grid):
    plan = _plan(16, 512, 512, grid=grid)
    _covers(plan, 16, 512, 512)
    assert (plan.team, plan.slots) == grid


def test_a_forced_grid_runs_at_a_resident_shape_too():
    plan = _plan(3, 24, 40, grid=(7, 2))
    _covers(plan, 3, 24, 40)
    assert (plan.team, plan.slots, plan.rounds) == (7, 2, 2)


@pytest.mark.parametrize("grid,match", [
    ((0, 1), "a grid of 0 CTAs a problem in 1 slots does not fit"),
    ((513, 1), "a grid of 513 CTAs a problem in 1 slots does not fit"),
    ((4, 17), "a grid of 4 CTAs a problem in 17 slots does not fit"),
    ((33, 5), r"the card holds 132 CTAs, not the team of DftPlan\(route='grid'"),
])
def test_a_forced_grid_that_does_not_fit_raises(grid, match):
    with pytest.raises(ValueError, match=match):
        _plan(16, 512, 512, grid=grid)


def test_a_grid_plan_the_card_cannot_hold_raises():
    """No fallback: a card that holds no grid CTA, or a line no CTA's shared
    memory holds, is an error naming it."""
    with pytest.raises(ValueError, match=r"the card holds 0 CTAs, not the team of DftPlan"):
        _plan(4, 512, 512, grid_ctas=0)
    with pytest.raises(ValueError, match="a line of 4 x 1024x1024 fits no grid CTA"):
        _plan(4, 1024, 1024, smem_max=16_000)


def test_the_grid_shared_memory_is_counted_piece_by_piece():
    # 512²: 2 · (256 + 256) twiddles, two planes of 16 lines of 513 floats
    # (8,208, a multiple of 4), 10 int64 phase clocks
    assert l1dft.grid_smem_bytes(512, 512, 8208) == 4 * (1024 + 2 * 8208) + 80
    assert _plan(4, 512, 512).smem == 4 * (1024 + 2 * 8208) + 80
    # 385²: 2 · (193 + 193) = 772 twiddles; 3 lines of 385 (odd: its own
    # pitch) = 1155 → 1156 floats
    assert _plan(1, 385, 385).smem == 4 * (772 + 2 * 1156) + 80
    assert l1dft.grid_pitch(512) == 513 and l1dft.grid_pitch(385) == 385
    assert l1dft.grid_chunk(64, 513, 28532) == 32 and l1dft.grid_chunk(55, 513, 28532) == 55
    assert l1dft.grid_chunk(56, 513, 28532) == 28
    assert l1dft.grid_chunk(16, 1025, 1000) == 0
    assert len(l1dft.GRID_PHASES) == 10


def _cu_function(src, signature):
    return re.search(re.escape(signature) + r" \{(.*?)\n\}", src, re.S).group(1)


def test_the_planner_reads_the_grid_kernel_s_constants():
    """The grid kernel's threads, phases, pitch, shared-memory count and
    plan checks as csrc/fista_l1_dft_fused.cu states them."""
    src = (CSRC / "fista_l1_dft_fused.cu").read_text()
    assert re.findall(r"constexpr int kThreads = (\d+);", src) == ["1024"]
    phases = re.search(r"enum \{\s*(kGridSetup[^}]*)\}", src).group(1)
    names = [p.strip() for p in phases.split(",") if p.strip()]
    assert names[-1] == "kGridPhases" and len(names) - 1 == len(l1dft.GRID_PHASES)
    assert "return n | 1;" in _cu_function(src, "__host__ __device__ inline int grid_pitch(int n)")
    smem = _cu_function(src, "__host__ __device__ inline size_t grid_smem_bytes(int H, int W, "
                             "size_t plane)")
    assert "sizeof(float) * (rls::ceil4(rls::twiddle_floats(H, W)) + 2 * plane)" in smem
    assert "sizeof(long long) * kGridPhases" in smem
    valid = _cu_function(src, "bool valid_grid(int B, int H, int W, int team, int slots, "
                              "int row_lines, int col_lines,\n                int smem)")
    for piece in ("team > H", "team > W", "slots > B", "row_lines > rls::ceil_div(H, team)",
                  "col_lines > rls::ceil_div(W, team)", "plane % 4 == 0",
                  "static_cast<size_t>(row_lines) * grid_pitch(W) <= plane",
                  "static_cast<size_t>(col_lines) * grid_pitch(H) <= plane"):
        assert piece in valid, piece
    # the launch is one cooperative grid of team × slots CTAs
    assert "cudaLaunchCooperativeKernel(fn, dim3(team * slots), dim3(kThreads)" in src
    # two team barriers an iteration, the counter's table in the header
    assert src.count("rls::grid::group_sync(ctr, target, team);  // T") == 2
    for name in ("T1", "T2"):
        assert re.search(rf"^//\s+team barrier {name}[ ;]", src, re.M), name
    # no one-CTA-a-problem kernel of row 8 is left
    assert "fista_l1_dft_fused_kernel" not in src and "fista_l1_dft_fused_launch" not in src


# ---- a Python model of the grid route


class Hazard(AssertionError):
    """A point of the slot's spectrum that one CTA wrote and another read
    or wrote between the same two team barriers."""


class GridModel:
    """One slot's spectrum S (H × W, re and im) in global memory, and which
    CTA of the team read and wrote each point since the last barrier.
    Writes land at once (global memory); a barrier checks the window."""

    def __init__(self, plan):
        self.plan = plan
        H, W, team = plan.H, plan.W, plan.team
        self.re, self.im = torch.zeros(H, W), torch.zeros(H, W)
        self.reads = torch.zeros(team, H, W, dtype=torch.bool)
        self.writes = torch.zeros(team, H, W, dtype=torch.bool)

    def read(self, q, rows, cols):
        self.reads[q, rows[0]:rows[1], cols[0]:cols[1]] = True
        return (self.re[rows[0]:rows[1], cols[0]:cols[1]].clone(),
                self.im[rows[0]:rows[1], cols[0]:cols[1]].clone())

    def write(self, q, rows, cols, re, im):
        self.writes[q, rows[0]:rows[1], cols[0]:cols[1]] = True
        self.re[rows[0]:rows[1], cols[0]:cols[1]] = re
        self.im[rows[0]:rows[1], cols[0]:cols[1]] = im

    def barrier(self):
        readers, writers = self.reads.sum(0), self.writes.sum(0)
        for q in range(self.plan.team):
            mine = self.writes[q]
            others = (readers - self.reads[q].int() > 0) | (writers - mine.int() > 0)
            if bool((mine & others).any()):
                raise Hazard(f"S: CTA {q} wrote points another CTA touched between two "
                             f"barriers")
        self.reads.zero_()
        self.writes.zero_()


def _chunks(part, lines):
    """[a, b) chunks of `lines` of a CTA's part [p0, p1)."""
    p0, p1 = part
    return [(a, min(a + lines, p1)) for a in range(p0, p1, lines)]


def grid_fista(x0hat, scal, tab, plan, tables, barriers=("T1", "T2")):
    """FISTA-L1 on B problems (x0hat (B, H, W), scal (B, 2)) by the grid
    route's schedule: slot s solves problems s, s + slots, … in turn on its
    own spectrum; per problem the set-up's (R) on every CTA's band, then
    per iteration T1, (C) on every CTA's block, T2, (R') with the pixel
    update and the next iteration's (R). x and x_prev are each CTA's own
    rows; S is shared by the team."""
    B, H, W = x0hat.shape
    tw_h, tw_w, weights = tables
    eps = torch.finfo(torch.float32).eps
    out = torch.empty_like(x0hat)
    for s in range(plan.slots):
        m = GridModel(plan)
        for b in range(s, B, plan.slots):
            rho, lam = scal[b, 0], scal[b, 1]
            t = rho * lam
            x, xp = x0hat[b] * 0.0, x0hat[b] * 0.0

            def mom(rows, a):
                return x[rows[0]:rows[1]] + a * (x[rows[0]:rows[1]] - xp[rows[0]:rows[1]])

            def rows_forward(q, rows, xm):
                re, im = line_model(xm, torch.zeros_like(xm), tw_w)
                m.write(q, rows, (0, W), re, im)

            for q in range(plan.team):
                for rows in _chunks(plan.band(q), plan.row_lines):
                    rows_forward(q, rows, mom(rows, tab[0, 0]))
            for i in range(tab.shape[0]):
                if "T1" in barriers:
                    m.barrier()
                for q in range(plan.team):
                    for cols in _chunks(plan.block(q), plan.col_lines):
                        re, im = m.read(q, (0, H), cols)
                        re, im = line_model(re.T.contiguous(), im.T.contiguous(), tw_h)
                        wt = weights.T[cols[0]:cols[1]]
                        re, im = line_model(re * wt, im * wt, tw_h, inverse=True)
                        m.write(q, (0, H), cols, re.T, im.T)
                if "T2" in barriers:
                    m.barrier()
                for q in range(plan.team):
                    for rows in _chunks(plan.band(q), plan.row_lines):
                        re, im = m.read(q, rows, (0, W))
                        nr = line_model(re, im, tw_w, inverse=True)[0]
                        xm = mom(rows, tab[i, 0])
                        xg = xm - rho * (nr - x0hat[b, rows[0]:rows[1]])
                        mag = xg.abs()
                        xn = torch.clamp(mag - t, min=0.0) * (xg + eps) / (mag + eps)
                        xp[rows[0]:rows[1]] = x[rows[0]:rows[1]]
                        x[rows[0]:rows[1]] = xn
                        if i + 1 < tab.shape[0]:
                            rows_forward(q, rows, mom(rows, tab[i + 1, 0]))
            out[b] = x
        m.barrier()  # the next one, where a race shows
    return out


def grid_normal(x, plan, tables, barriers=("T1", "T2")):
    """Re(Fᴴ M F x) of one real image x (H, W) by the grid route's passes:
    (R) on every band, T1, (C) on every block, T2, (R') on every band."""
    H, W = x.shape
    tw_h, tw_w, weights = tables
    m = GridModel(plan)
    for q in range(plan.team):
        for rows in _chunks(plan.band(q), plan.row_lines):
            xm = x[rows[0]:rows[1]]
            m.write(q, rows, (0, W), *line_model(xm, torch.zeros_like(xm), tw_w))
    if "T1" in barriers:
        m.barrier()
    for q in range(plan.team):
        for cols in _chunks(plan.block(q), plan.col_lines):
            re, im = m.read(q, (0, H), cols)
            re, im = line_model(re.T.contiguous(), im.T.contiguous(), tw_h)
            wt = weights.T[cols[0]:cols[1]]
            re, im = line_model(re * wt, im * wt, tw_h, inverse=True)
            m.write(q, (0, H), cols, re.T, im.T)
    if "T2" in barriers:
        m.barrier()
    out = torch.empty(H, W)
    for q in range(plan.team):
        for rows in _chunks(plan.band(q), plan.row_lines):
            out[rows[0]:rows[1]] = line_model(*m.read(q, rows, (0, W)), tw_w, inverse=True)[0]
    m.barrier()
    return out


def _problem(H, W, B=3, seed=4):
    rng = np.random.default_rng(seed + H * W)
    x0 = torch.from_numpy(rng.normal(size=(B, H, W)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(H, W)) < 0.4).astype(np.float32))
    return x0, dft.dft_tables(mask)


def _forced(B, H, W, team, slots, smem=SMEM):
    return l1dft.plan_fista_l1_dft(B, H, W, (), smem_max=smem, grid=(team, slots))


# uneven teams (bands and blocks that differ by one), a prime side, lines
# with and without a shared-memory stage (256 > 128 points), several
# chunks a band and a block (a small shared memory), and slots walking
# problems in rounds
GRID_CASES = [((24, 40), 3, 1, SMEM), ((24, 40), 7, 2, SMEM), ((17, 32), 5, 3, SMEM),
              ((16, 256), 6, 2, SMEM), ((24, 40), 5, 2, 1_200), ((32, 24), 4, 3, 1_100)]


def test_the_model_s_cases_take_several_chunks_and_rounds():
    plans = [_forced(3, *shape, team, slots, smem) for shape, team, slots, smem in GRID_CASES]
    assert any(p.rows > p.row_lines and p.cols > p.col_lines for p in plans)
    assert any(p.rounds > 1 for p in plans)
    assert any(p.H % p.team and p.W % p.team for p in plans)


@pytest.mark.parametrize("shape,team,slots,smem", GRID_CASES)
def test_the_grid_normal_op_is_the_plain_one_bit_for_bit(shape, team, slots, smem):
    x0, tables = _problem(*shape)
    plan = _forced(1, *shape, team, 1, smem)
    _covers(plan, 1, *shape, smem=smem)
    assert torch.equal(grid_normal(x0[0], plan, tables), dft.real_normal(x0[:1], tables)[0])


@pytest.mark.parametrize("shape,team,slots,smem", GRID_CASES)
def test_the_grid_fista_is_the_plain_version_bit_for_bit(shape, team, slots, smem):
    x0, tables = _problem(*shape)
    scal = torch.tensor([[0.9, 0.05], [0.7, 0.0], [0.95, 0.01]], dtype=torch.float32)
    tab = torch.as_tensor(_momentum_table("fista", 4))
    plan = _forced(3, *shape, team, slots, smem)
    _covers(plan, 3, *shape, smem=smem)
    want = l1dft.fista_l1_dft_fused_torch(x0, scal, tab, tables)
    assert torch.equal(grid_fista(x0, scal, tab, plan, tables), want)


@pytest.mark.parametrize("shape,team", [((24, 40), 3), ((17, 32), 5), ((24, 40), 7)])
@pytest.mark.parametrize("dropped", ["T1", "T2"])
def test_each_team_barrier_is_needed(shape, team, dropped):
    """Without T1 the column pass reads rows the row passes write; without
    T2 the rows back read columns the column pass writes: the model
    raises."""
    x0, tables = _problem(*shape)
    kept = tuple(b for b in ("T1", "T2") if b != dropped)
    plan = _forced(1, *shape, team, 1)
    with pytest.raises(Hazard, match="S: CTA"):
        grid_normal(x0[0], plan, tables, barriers=kept)
    scal = torch.tensor([[0.9, 0.05]])
    tab = torch.as_tensor(_momentum_table("fista", 2))
    with pytest.raises(Hazard, match="S: CTA"):
        grid_fista(x0[:1], scal, tab, plan, tables, barriers=kept)


def test_a_team_of_one_needs_no_barrier():
    """With one CTA a problem nothing is shared: the kernel's group_sync
    returns at once, and the model finds no hazard without barriers."""
    x0, tables = _problem(24, 40)
    plan = _forced(1, 24, 40, 1, 1)
    got = grid_normal(x0[0], plan, tables, barriers=())
    assert torch.equal(got, dft.real_normal(x0[:1], tables)[0])


# ---- past the JAX kernel's gate


def test_the_plain_version_past_the_jax_gate_matches_jax_composed():
    """1 × 385² (5 · 7 · 11 a side), the first square side no cluster of
    16 holds and past the JAX kernel's VMEM check, so the JAX package
    solves it on its composed path: row 8's plain version (which its grid
    route matches bit for bit on the card) in float64 on the operator's
    Aᴴb and λ, against ``rt.solve_batched_unrolled`` on the uncompensated
    float64 operator, 10 iterations, at test_composed_fista_matches_jax's
    tolerance."""
    n = 385
    assert l1dft.plan_fista_l1_dft(1, n, n, ()).route == "grid"
    rng = np.random.default_rng(385)
    mask = (rng.uniform(size=(n, n)) < 0.35).astype(np.float32)
    X = rng.normal(size=(1, n * n))
    with jax.enable_x64(True):
        op64 = rt.SubsampledDFT2RealOperator.from_mask(mask, (n, n), dtype=jnp.float64)
        s64 = rt.FISTA.create(op64, reg=rt.L1Regularization(2e-3), iterations=10, rho=0.95,
                              rel_tol=0.0, track_residual=False)
        B64 = np.asarray(jax.vmap(op64.mv)(jnp.asarray(X))).T
        want = np.asarray(rt.solve_batched_unrolled(s64, jnp.asarray(B64)))
    tsolver = convert(s64, device="cpu")
    op = tsolver.A
    bt = torch.from_numpy(np.array(B64)).T
    # no normalization: λ as given, in float64 (``effective_lam`` rounds
    # the kernel's λ to float32)
    assert float(dft.normalization_factor(tsolver.normalize_reg, op, bt)) == 1.0
    x0 = op.rmv(bt).reshape(1, n, n)
    assert x0.dtype == torch.float64
    before = l1dft.fista_l1_dft_fused.launches
    got = l1dft.fista_l1_dft_fused(x0, op.mask, tsolver.rho, tsolver.reg.lam, tsolver.iterations)
    assert l1dft.fista_l1_dft_fused.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.reshape(1, n * n).T.numpy(), want, rtol=0, atol=1e-10)
