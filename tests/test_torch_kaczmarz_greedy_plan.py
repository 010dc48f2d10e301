"""The greedy Kaczmarz kernel's routes (rls_tpu_torch/kernels/kaczmarz_greedy.py
``plan_kaczmarz_greedy``, csrc/kaczmarz_greedy.cu), on the CPU.

The planner: which route, ring slots, rows of r a thread and placement of x
each shape takes on an H100 (232,448 bytes of shared memory a block), at
the cell of PERF.md §4 and at the edges; that every plan fits the card's
shared memory, and the hand count of a thread's live state its registers;
that its counts are the kernel's.

The model: the resident route in Python, CTA by CTA. Four producer warps
each write the Gumbel noise of their rows (k mod 128 in [32 w, 32 w + 32))
for every step that draws into a ring of R slots and arrive on the slot's
"full" barrier; eight consumer warps (rows 32 w + l + 256 i on lane l) wait
for it, read their rows' noise and release the slot on its "empty"
barrier. A consumer warp's step: r −= r_row·Gt[row] on its rows, each
lane's |r|² summed in double in row order, the xor tree, the partial into
its slot, barrier B1, the 8 partials combined in warp order, the draw (the
rows past the threshold scored logf(w) + G, the warp's argmax, the
candidate {score, row, r_row, denom_row} written by the lane that owns the
row; a forced row's owner writes candidate 0), barrier B2, the candidates
combined;
after a sweep the projection, x in double (barrier B3) and the refresh's
dots (eight lanes a row, each lane's columns 4 (l & 7) + 32 q + {0..3} in
order, the tree over the eight), rounded once. A seeded scheduler
interleaves the agents. The ring raises where a slot is refilled before
its 8 releases or read before its fill; a shared slot raises where a warp
reads another step's value, so dropping a wait or a barrier raises. The
model is held to the plain version (rows equal, 1e-6 of max|x|) and, with
forced rows, to the JAX solve in interpret mode at the 2e-5 of
tests/test_torch_kaczmarz.py. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu_torch as rtt
from rls_tpu.kernels.kaczmarz_greedy import solve_kaczmarz_greedy as jax_greedy
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import kaczmarz_greedy as kg
from test_torch_cuda import _greedy_inputs
from test_torch_kaczmarz import _greedy_problem

CSRC = Path(kg.__file__).parents[1] / "csrc"
SMEM = 232_448
CPU = torch.device("cpu")
WARPS = kg.THREADS // 32


# ---------------------------------------------------------------------------
# The planner.


def _fits(plan, P, m, n, smem=SMEM):
    assert plan.ctas == P and plan.smem <= smem
    if plan.route == "block":
        assert (plan.threads, plan.smem, plan.ring) == (kg.THREADS, 0, 0)
        return
    assert plan.threads == kg.RESIDENT_THREADS
    assert 1 <= plan.ring <= kg.RING and 1 <= plan.rows <= kg.MAX_ROWS
    assert kg.THREADS * plan.rows >= m and (plan.rows == 1 or kg.THREADS * plan.rows < 2 * m)
    assert plan.x_in == ("shared" if n > kg.THREADS else "registers")
    assert plan.smem == kg.resident_smem_bytes(m, n, plan.ring, plan.x_in == "shared")


def test_the_plan_at_the_cell():
    """kaczmarz_greedy_tall_b16: 16 problems of the 1024×256 system."""
    plan = kg.plan_kaczmarz_greedy(16, 1024, 256, SMEM)
    _fits(plan, 16, 1024, 256)
    assert (plan.route, plan.ring, plan.rows, plan.x_in, plan.threads) == (
        "resident", 8, 4, "registers", 384)


def test_the_shared_memory_count():
    """The cell's CTA, counted by hand: 8 full and 8 empty barriers (128 B),
    the partials (64 + 32 B), 8 candidates (128 B), 8 noise slots of 1,024
    floats, vl and the dots (4,096 B each), x in double (2,048 B)."""
    plan = kg.plan_kaczmarz_greedy(16, 1024, 256, SMEM)
    assert plan.smem == 128 + 96 + 128 + 8 * 4096 + 2 * 4096 + 2048 == 43_360
    # 45 rows, 13 columns, 2 slots: every piece rounded up to 16 bytes
    assert kg.resident_smem_bytes(45, 13, 2, False) == 32 + 96 + 128 + 2 * 192 + 2 * 192 + 112
    # x in shared memory: 300 floats beside its 300 doubles
    assert kg.resident_smem_bytes(50, 300, 1, True) == 16 + 96 + 128 + 208 + 2 * 208 + 2400 + 1200


def test_the_constants_are_the_kernels():
    src = (CSRC / "kaczmarz_greedy.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") == kg.THREADS
    assert const("kProducerWarps") == kg.PRODUCER_WARPS
    assert const("kMaxRows") == kg.MAX_ROWS
    phases = re.search(r"enum \{\s*(kPhStats[^}]*)\};", src).group(1).replace("\n", " ")
    phases = [p.strip() for p in phases.split(",") if p.strip()]
    assert phases[-1] == "kGreedyPhases" and len(phases) - 1 == len(kg.PHASES)
    # the rows a thread holds that the kernel instantiates
    for rows in (1, 2, 4, 8, 16):
        assert f"case {rows}: return resident_go<{rows}, kXReg>" in src
    # the layout's pieces, in the planner's order
    for piece in ("g.part = align16(16 * static_cast<size_t>(R));",
                  "g.cand = g.part + align16(12 * static_cast<size_t>(kWarps));",
                  "g.ring = g.cand + align16(sizeof(Cand) * kWarps);",
                  "g.slot = align16(4 * static_cast<size_t>(m));",
                  "g.ax = g.vl + align16(4 * static_cast<size_t>(m));",
                  "g.xd = g.ax + align16(4 * static_cast<size_t>(m));",
                  "g.xs = g.xd + align16(8 * static_cast<size_t>(n));"):
        assert piece in src, piece


def test_a_thread_holds_its_rows_in_registers():
    """The hand count of the state a consumer thread keeps live at
    MAX_ROWS: r, denom, norms and u of its rows for the whole solve, and
    |r|² and the noise for a step (6 registers a row), or the four and the
    refresh's 16 float4 loads; with ~32 more for addresses and scalars both
    stay under the launch bound's cap of 65,536 registers over 384 threads.
    This is the design's count, not the build's: ptxas's own account (no
    spill up to 8 rows a thread, spills at 16) is read on the card by
    tests/test_torch_cuda.py::test_greedy_resident_route_registers_from_the_build."""
    cap = 65_536 // kg.RESIDENT_THREADS // 8 * 8
    assert max(6 * kg.MAX_ROWS, 4 * kg.MAX_ROWS + 64) + 32 <= cap == 168


@pytest.mark.parametrize("shape, route, rows, x_in", [
    ((3, 1, 1), "resident", 1, "registers"),
    ((3, 256, 256), "resident", 1, "registers"),
    ((3, 257, 257), "resident", 2, "shared"),
    ((1, 4096, 256), "resident", 16, "registers"),
    ((1, 4097, 256), "block", 0, "global"),
    ((5, 45, 13), "resident", 1, "registers"),
    ((1, 2048, 2048), "resident", 8, "shared"),
    ((1, 2049, 2048), "block", 0, "global"),
    ((1, 4096, 1024), "resident", 16, "shared"),
    ((1, 4096, 1025), "block", 0, "global"),
    ((2, 1024, 12_000), "block", 0, "global"),
    ((2, 1024, 20_000), "block", 0, "global"),
])
def test_the_plans_at_the_edges(shape, route, rows, x_in):
    plan = kg.plan_kaczmarz_greedy(*shape, SMEM)
    _fits(plan, *shape)
    assert (plan.route, plan.rows, plan.x_in) == (route, rows, x_in)


def test_the_ring_shrinks_before_the_route_changes():
    """The resident route forced at n = 15,000, m = 4096 (past
    RESIDENT_MAX_ENTRIES, where the planner alone takes the block route): x
    (60 KB) and its doubles (120 KB) leave room for one slot of 16 KB, not
    two; at 1024 × 12,000 for 8 slots of 4 KB."""
    plan = kg.plan_kaczmarz_greedy(2, 4096, 15_000, SMEM, route="resident")
    _fits(plan, 2, 4096, 15_000)
    assert (plan.route, plan.ring) == ("resident", 1)
    assert kg.plan_kaczmarz_greedy(2, 4096, 15_000, SMEM).route == "block"
    plan = kg.plan_kaczmarz_greedy(2, 1024, 12_000, SMEM, route="resident")
    _fits(plan, 2, 1024, 12_000)
    assert (plan.rows, plan.x_in, plan.ring) == (4, "shared", 8)


@pytest.mark.parametrize("P", [0, 1, 16, 133])
@pytest.mark.parametrize("smem", [SMEM, 101_376])
def test_every_plan_fits(P, smem):
    for m in (1, 31, 256, 1000, 2048, 4096, 5000):
        for n in (1, 13, 256, 257, 4000, 9000, 30_000):
            _fits(kg.plan_kaczmarz_greedy(P, m, n, smem), P, m, n, smem)


def test_forced_routes_and_refusals():
    assert kg.plan_kaczmarz_greedy(16, 1024, 256, route="block").route == "block"
    assert kg.plan_kaczmarz_greedy(16, 1024, 256, route="resident").route == "resident"
    with pytest.raises(ValueError, match="no route"):
        kg.plan_kaczmarz_greedy(16, 1024, 256, route="warp")
    with pytest.raises(ValueError, match="no resident plan"):
        kg.plan_kaczmarz_greedy(1, 5000, 256, route="resident")


# ---------------------------------------------------------------------------
# The model of the resident route.


class ModelError(AssertionError):
    pass


class Barrier:
    """An mbarrier: `count` arrivals complete a phase; ``done(parity)`` is
    ``try_wait.parity``."""

    def __init__(self, count):
        self.count, self.pending, self.phases = count, count, 0

    def arrive(self):
        self.pending -= 1
        if self.pending == 0:
            self.phases += 1
            self.pending = self.count

    def done(self, parity):
        return self.phases % 2 != parity


class BlockBarrier:
    """bar.sync among the consumer warps: a warp's wait ends once all have
    arrived at its generation."""

    def __init__(self, count):
        self.count, self.arrived, self.gen = count, 0, 0

    def arrive(self):
        gen = self.gen
        self.arrived += 1
        if self.arrived == self.count:
            self.arrived, self.gen = 0, self.gen + 1
        return gen

    def passed(self, gen):
        return self.gen > gen


class Slots:
    """Shared-memory slots, each write tagged with its step; a read for
    another step than the slot holds raises."""

    def __init__(self, k):
        self.tag, self.val = [None] * k, [None] * k

    def write(self, i, tag, v):
        self.tag[i], self.val[i] = tag, v

    def read(self, i, tag):
        if self.tag[i] != tag:
            raise ModelError(f"slot {i} read at {tag} holds {self.tag[i]}")
        return self.val[i]


class NoiseRing:
    """R slots of m floats; a fill is one part a producer warp, each part
    arriving on the slot's full barrier; the consumers' releases arrive on
    its empty barrier. Raises where a slot is refilled before its releases
    or read before every part of its fill."""

    def __init__(self, R, m, producers, consumers):
        self.producers, self.consumers = producers, consumers
        self.full = [Barrier(producers) for _ in range(R)]
        self.empty = [Barrier(consumers) for _ in range(R)]
        self.step = [None] * R
        self.parts = [set() for _ in range(R)]
        self.releases = [consumers] * R
        self.g = [np.zeros(m, np.float32) for _ in range(R)]

    def fill(self, slot, step, part, rows, values):
        if self.step[slot] != step:
            if self.releases[slot] < self.consumers:
                raise ModelError(f"slot {slot} refilled for draw {step} after "
                                 f"{self.releases[slot]} of {self.consumers} releases")
            self.step[slot], self.parts[slot], self.releases[slot] = step, set(), 0
        self.g[slot][rows] = values
        self.parts[slot].add(part)
        self.full[slot].arrive()

    def read(self, slot, step, rows):
        if self.step[slot] != step or len(self.parts[slot]) < self.producers:
            raise ModelError(f"slot {slot} read for draw {step} before its fill")
        return self.g[slot][rows]

    def release(self, slot):
        self.releases[slot] += 1
        self.empty[slot].arrive()


def xor_tree(s, offsets=(16, 8, 4, 2, 1)):
    """The xor butterfly over the last axis (lanes): every lane ends with
    the same sum (IEEE addition commutes)."""
    lanes = np.arange(s.shape[-1])
    for o in offsets:
        s = s + s[..., lanes ^ o]
    return s


def wins(a, ia, b, ib):
    return a > b or (a == b and ia < ib)


def gumbel(seed, sweep, p, step, m):
    """The noise of problem p's rows at a step: −log(−log U), as the plain
    version draws it."""
    u = kg.uniforms(seed, sweep, p + 1, step, m, CPU)[p]
    return (-torch.log(-torch.log(u))).numpy()


def resident_model(A, Gt, denom, norms, u, eps, fnorm, theta, S, T, seed, sweep0=0, x0=None,
                   vl0=None, positive=False, refresh=True, forced=None, ring=kg.RING, sched=0,
                   drop=None):
    """The resident route on float32 operands (torch or numpy): P = u.shape[0]
    CTAs, each its own agents interleaved by a scheduler seeded with
    `sched`; `drop` names a wait or barrier the consumers skip ("full",
    "empty" for the producers, "B1", "B2", "B3"). Returns (x, vl, r, rows
    (T, P, S)) as numpy arrays."""
    f32 = np.float32
    A, Gt, denom, norms, u, eps = (np.array(t.numpy() if torch.is_tensor(t) else t, f32)
                                   for t in (A, Gt, denom, norms, u, eps))
    forced = None if forced is None else np.asarray(
        forced.numpy() if torch.is_tensor(forced) else forced)
    P, m = u.shape
    n = A.shape[1]
    fnorm = f32(fnorm)
    theta = None if theta is None else f32(theta)
    kr = 1
    while kg.THREADS * kr < m:
        kr *= 2
    X = np.zeros((P, n), f32) if x0 is None else np.array(x0, f32)
    VL = np.zeros((P, m), f32) if vl0 is None else np.array(vl0, f32)
    R_ = np.array(u, f32)
    rows_out = np.zeros((T, P, S), np.int32)
    steps = [(t, j) for t in range(T) for j in range(S)]
    draws = [q for q, (t, j) in enumerate(steps) if forced is None or forced[t, j] < 0]
    rng = np.random.default_rng(sched)

    for p in range(P):
        x, vl, r = X[p], VL[p], R_[p]
        e = eps[p]
        noise = NoiseRing(ring, m, kg.PRODUCER_WARPS, WARPS)
        part, cand, xd = Slots(WARPS), Slots(WARPS), Slots(n)
        bars = {b: BlockBarrier(WARPS) for b in ("B1", "B2", "B3")}

        def producer(pw):
            mine = np.array([k for k in range(m) if (k % 128) // 32 == pw], np.int64)
            for d, q in enumerate(draws):
                slot, phase = d % ring, (d // ring) % 2
                if drop != "empty":
                    yield lambda s=slot, ph=phase: noise.empty[s].done(ph ^ 1)
                t, j = steps[q]
                noise.fill(slot, d, pw, mine, gumbel(seed, sweep0 + t, p, j, m)[mine])
                yield None

        def consumer(w):
            # lane l's rows 32 w + l + 256 i, as a (kr, 32) table (−1 past m)
            own = np.array([[kg.THREADS * i + 32 * w + l for l in range(32)] for i in range(kr)])
            own = np.where(own < m, own, -1)
            live = own >= 0
            ko = own[live]
            xcols = np.array([c for c in range(n) if (c % kg.THREADS) // 32 == w], np.int64)
            d = 0  # the draws taken
            prow, pr, palpha = -1, f32(0), f32(0)

            def barrier(name):
                gen = bars[name].arrive()
                if drop != name:
                    yield lambda: bars[name].passed(gen)

            for q, (t, j) in enumerate(steps):
                fj = -1 if forced is None else int(forced[t, j])
                if prow >= 0:
                    r[ko] = r[ko] - pr * Gt[prow, ko]
                r2 = np.where(live, r[np.maximum(own, 0)] * r[np.maximum(own, 0)], f32(0))
                dsum = np.zeros(32)
                mx = np.full(32, -np.inf, f32)
                for i in range(kr):
                    dsum = np.where(live[i], dsum + r2[i].astype(np.float64), dsum)
                    mx = np.where(live[i], np.maximum(mx, r2[i] * denom[np.maximum(own[i], 0)]),
                                  mx)
                part.write(w, q, (xor_tree(dsum)[0], np.max(mx)))
                if prow >= 0:
                    x[xcols] = x[xcols] + palpha * A[prow, xcols]
                yield from barrier("B1")
                dn64, mxa = 0.0, f32(-np.inf)
                for v in range(WARPS):
                    ps, pm = part.read(v, q)
                    dn64, mxa = dn64 + ps, max(mxa, pm)
                dn = f32(dn64)
                safe = dn if dn > 0 else f32(1)
                qq = mxa / safe
                ek = (f32(0.5) * (qq + fnorm) if theta is None
                      else theta * qq + (f32(1) - theta) * fnorm)
                lower = ek * safe
                if fj < 0:
                    slot, phase = d % ring, (d // ring) % 2
                    if drop != "full":
                        yield lambda s=slot, ph=phase: noise.full[s].done(ph)
                    g = noise.read(slot, d, ko)
                    noise.release(slot)
                    d += 1
                    r2l = r2[live]
                    wts = np.where(r2l >= lower * norms[ko], r2l, f32(0))
                    logw = torch.log(torch.from_numpy(np.where(wts > 0, wts, f32(1)))).numpy()
                    score = np.where(wts > 0, logw + g, f32(-np.inf))
                    best, bk = f32(-np.inf), 2**31 - 1
                    for sc, k in zip(score, ko):  # the warp's tree: the unique max
                        if wins(sc, k, best, bk):
                            best, bk = sc, k
                    cand.write(w, q, (best, bk, r[bk] if bk < m else f32(0),
                                      denom[bk] if bk < m else f32(0)))
                elif (fj % kg.THREADS) // 32 == w:
                    cand.write(0, q, (f32(0), fj, r[fj], denom[fj]))
                yield from barrier("B2")
                c = cand.read(0, q)
                if fj < 0:
                    for v in range(1, WARPS):
                        o = cand.read(v, q)
                        if wins(o[0], o[1], c[0], c[1]):
                            c = o
                row, rr, dd = int(c[1]), f32(c[2]), f32(c[3])
                alpha = dd * rr
                if (row % kg.THREADS) // 32 == w:
                    vl[row] = vl[row] + alpha * e
                if w == 0:
                    rows_out[t, p, j] = row
                prow, pr, palpha = row, rr, alpha
                if j < S - 1:
                    continue
                # the sweep's end
                if not refresh:
                    r[ko] = r[ko] - pr * Gt[prow, ko]
                x[xcols] = x[xcols] + palpha * A[prow, xcols]
                prow = -1
                if positive:
                    x[xcols] = np.maximum(x[xcols], f32(0))
                if not refresh:
                    continue
                for c_ in xcols:
                    xd.write(c_, t, np.float64(x[c_]))
                yield from barrier("B3")
                xv = np.array([xd.read(c_, t) for c_ in range(n)])
                # eight lanes a row: lane j8's columns 4 j8 + 32 q + {0..3}
                order = [[c_ for q0 in range(0, n, 32) for c_ in range(q0 + 4 * j8, q0 + 4 * j8 + 4)
                          if c_ < n] for j8 in range(8)]
                s = np.zeros((ko.size, 8))
                for j8, cols in enumerate(order):
                    for c_ in cols:
                        s[:, j8] = s[:, j8] + A[ko, c_].astype(np.float64) * xv[c_]
                ax = xor_tree(s, (4, 2, 1))[:, 0].astype(f32)
                r[ko] = (u[p, ko] - e * vl[ko]) - ax
                yield None

        agents = {("p", k): producer(k) for k in range(kg.PRODUCER_WARPS)}
        agents.update({("c", w): consumer(w) for w in range(WARPS)})
        waits = {k: None for k in agents}
        while agents:
            ready = [k for k in agents if waits[k] is None or waits[k]()]
            if not ready:
                raise ModelError("deadlock: every agent waits")
            pick = ready[rng.integers(len(ready))]
            try:
                waits[pick] = next(agents[pick])
            except StopIteration:
                del agents[pick], waits[pick]
    return X, VL, R_, rows_out


def _close(got, want, rel):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() if want.size else 0.0
    assert err <= rel * max(np.abs(want).max() if want.size else 0.0, 1e-30), err


def _inputs(m=45, n=13, P=3, seed=13):
    return _greedy_inputs(CPU, m, n, P, seed)


def _forced_rows(T, S, m, seed=14):
    return torch.from_numpy(np.random.default_rng(seed).integers(-1, m, size=(T, S))
                            .astype(np.int32))


@pytest.mark.parametrize("theta", [None, 0.3])
@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("shape", [(45, 13, 3), (300, 300, 2)])
def test_the_model_sweep_matches_the_plain_sweep(theta, forced, shape):
    """One sweep from a nonzero start (T = 1, no refresh): 45 × 13 (one row a
    thread, x in registers) and 300 × 300 (two rows a thread, x in shared
    memory)."""
    A, Gt, denom, norms, x, vl, r, eps, fnorm = _inputs(*shape)
    x = x + 0.25
    vl = vl - 0.5
    S = 17
    fr = _forced_rows(1, S, shape[0]) if forced else None
    want = kg.kaczmarz_greedy_sweep_torch(A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S,
                                          2024, 5, None if fr is None else fr[0])
    got = resident_model(A, Gt, denom, norms, r, eps, fnorm, theta, S, 1, 2024, sweep0=5, x0=x,
                         vl0=vl, refresh=False, forced=fr, ring=3, sched=1)
    np.testing.assert_array_equal(got[3][0], want[3].numpy())
    for g, w_ in zip(got[:3], want[:3]):
        _close(g, w_.numpy(), 1e-6)


@pytest.mark.parametrize("theta", [None, 0.3])
@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("positive", [False, True])
def test_the_model_solve_matches_the_plain_solve(theta, forced, positive):
    A, Gt, denom, norms, _, _, r, eps, fnorm = _inputs()
    S, T = 9, 3
    fr = _forced_rows(T, S, 45) if forced else None
    want = kg.kaczmarz_greedy_solve_torch(A, Gt, denom, norms, r, eps, fnorm, theta, S, T, 7,
                                          "positive" if positive else "none", fr)
    got = resident_model(A, Gt, denom, norms, r, eps, fnorm, theta, S, T, 7, positive=positive,
                         forced=fr, ring=2, sched=3)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    for g, w_ in zip(got[:3], want[:3]):
        _close(g, w_.numpy(), 1e-6)


def test_ties_go_to_row_0_on_a_zero_residual():
    A, Gt, denom, norms, x, vl, r, eps, fnorm = _inputs()
    got = resident_model(A, Gt, denom, norms, torch.zeros_like(r), eps, fnorm, None, 4, 1, 1,
                         refresh=False)
    assert got[3].tolist() == [[[0] * 4] * 3]


@pytest.mark.parametrize("ring, sched", [(1, 0), (2, 5), (8, 6), (3, 7)])
def test_the_schedule_does_not_change_the_bits(ring, sched):
    """Any ring, any interleaving: the same bits."""
    A, Gt, denom, norms, _, _, r, eps, fnorm = _inputs(300, 40, 2)
    fr = _forced_rows(2, 6, 300, seed=4)
    base = resident_model(A, Gt, denom, norms, r, eps, fnorm, None, 6, 2, 3, positive=True,
                          forced=fr, ring=8, sched=99)
    got = resident_model(A, Gt, denom, norms, r, eps, fnorm, None, 6, 2, 3, positive=True,
                         forced=fr, ring=ring, sched=sched)
    for g, b in zip(got, base):
        np.testing.assert_array_equal(g, b)


@pytest.mark.parametrize("drop, match", [("empty", "refilled"), ("full", "before its fill"),
                                         ("B1", "read at"), ("B2", "read at"),
                                         ("B3", "read at")])
def test_a_dropped_wait_or_barrier_raises(drop, match):
    """Without the producers' empty wait a slot is refilled before its
    releases; without the consumers' full wait a slot is read before its
    fill; without B1, B2 or B3 a warp reads a partial, a candidate or x in
    double of another step."""
    A, Gt, denom, norms, _, _, r, eps, fnorm = _inputs(45, 13, 1)
    with pytest.raises(ModelError, match=match):
        for sched in range(30):
            resident_model(A, Gt, denom, norms, r, eps, fnorm, None, 8, 2, 1, ring=1,
                           sched=sched, drop=drop)


def test_the_model_at_the_cells_widths():
    """The cell's system and widths (1024 × 256, four rows a thread, x in
    registers, 8 slots), cut to 2 problems × 2 sweeps of 6 steps, Positive,
    against the plain solve."""
    rng = np.random.default_rng(21)
    A = rng.normal(size=(1024, 256)).astype(np.float32)
    A[rng.uniform(size=A.shape) < 0.7] = 0.0
    op = rtt.DenseOperator(torch.from_numpy(A), device="cpu")
    s = rtt.Kaczmarz.create(op, reg=[rtt.L2Regularization(1e-6), rtt.PositiveRegularization()],
                            iterations=2, greedy_randomized=True, sub_matrix_fraction=6 / 1024)
    B = torch.from_numpy(A @ rng.uniform(size=(256, 2)).astype(np.float32))
    ops = kg.greedy_operands(s, B)
    Ag, Gt, denom, norms, eps, fnorm, bt = ops
    assert kg.plan_kaczmarz_greedy(2, 1024, 256).rows == 4
    want = kg.kaczmarz_greedy_solve_torch(Ag, Gt, denom, norms, bt, eps, fnorm, None, 6, 2,
                                          s.seed, "positive")
    got = resident_model(Ag, Gt, denom, norms, bt, eps, fnorm, None, 6, 2, s.seed,
                         positive=True, ring=8, sched=2)
    np.testing.assert_array_equal(got[3], want[3].numpy())
    for g, w_ in zip(got[:3], want[:3]):
        _close(g, w_.numpy(), 1e-6)


@pytest.mark.parametrize("positive", [False, True])
def test_the_model_matches_jax_with_forced_rows(positive):
    """The modelled solve on solve_kaczmarz_greedy's operands against the
    JAX greedy solve in interpret mode with every row forced, at λ = 1e-4
    (tests/test_torch_kaczmarz.py's problem and bar)."""
    js, B, _ = _greedy_problem()
    if positive:
        import rls_tpu as rt

        js = rt.Kaczmarz.create(js.A, reg=[rt.L2Regularization(1e-4),
                                           rt.PositiveRegularization()],
                                iterations=3, greedy_randomized=True,
                                sub_matrix_fraction=6 / 40)
    forced = np.random.default_rng(9).integers(0, 40, size=(3, 6)).astype(np.int32)
    want = np.asarray(jax_greedy(js, jnp.asarray(B), forced_rows=jnp.asarray(forced)))
    ts = convert(js, device="cpu")
    A, Gt, denom, norms, eps, fnorm, bt = kg.greedy_operands(ts, torch.from_numpy(B))
    x, _, _, rows = resident_model(A, Gt, denom, norms, bt, eps, fnorm, ts.theta,
                                   ts.sub_matrix_size, ts.iterations, ts.seed,
                                   positive=positive, forced=forced, ring=2, sched=4)
    np.testing.assert_array_equal(rows[:, 0], forced)
    np.testing.assert_allclose(x.T, want, rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# The wrappers on the CPU (the plain version).


def test_the_solve_is_the_sweeps_with_projection_and_refresh():
    """kaczmarz_greedy_solve on CPU tensors: T plain sweeps, each followed
    by Positive and the refresh whose A x is summed in float64 and rounded
    once; greedy_solve and solve_kaczmarz_greedy on it."""
    js, B, _ = _greedy_problem()
    ts = convert(js, device="cpu")
    A, Gt, denom, norms, eps, fnorm, bt = kg.greedy_operands(ts, torch.from_numpy(B))
    x, vl, r, rows = kg.kaczmarz_greedy_solve(A, Gt, denom, norms, bt, eps, fnorm, ts.theta, 6,
                                              3, ts.seed, "positive")
    x0, _, _, rows0 = kg.kaczmarz_greedy_solve(A, Gt, denom, norms, bt, eps, fnorm, ts.theta, 6,
                                               3, ts.seed)
    xs, vls, rs = torch.zeros(1, 12), torch.zeros(1, 40), bt.clone()
    for t in range(3):
        xs, vls, rs, rw = kg.kaczmarz_greedy_sweep(A, Gt, denom, norms, xs, vls, rs, eps, fnorm,
                                                   ts.theta, 6, ts.seed, t)
        assert torch.equal(rw, rows[t])
        xs = torch.clamp(xs, min=0.0)
        rs = (bt - eps[:, None] * vls) - (xs.double() @ A.double().T).float()
    for got, want in ((x, xs), (vl, vls), (r, rs)):
        assert torch.equal(got, want)
    xg, rg = kg.greedy_solve(ts, torch.from_numpy(B))  # no Positive term
    assert torch.equal(rg, rows0) and torch.equal(xg, x0.T)
    assert torch.equal(rtt.solve_kaczmarz_greedy(ts, torch.from_numpy(B)), x0.T)


def test_zero_steps_or_sweeps_leave_the_start():
    A, Gt, denom, norms, x, vl, r, eps, fnorm = _inputs()
    x0, vl0, r0, rows = kg.kaczmarz_greedy_solve(A, Gt, denom, norms, r, eps, fnorm, None, 5, 0,
                                                 1)
    assert rows.shape == (0, 3, 5) and torch.equal(r0, r) and not x0.any() and not vl0.any()
    _, _, r1, rows1 = kg.kaczmarz_greedy_solve(A, Gt, denom, norms, r, eps, fnorm, None, 0, 2, 1)
    assert rows1.shape == (2, 3, 0) and torch.equal(r1, r)


def test_the_solve_checks_its_forced_rows():
    A, Gt, denom, norms, x, vl, r, eps, fnorm = _inputs()
    fr = _forced_rows(2, 4, 45)
    with pytest.raises(ValueError, match="forced_rows of shape"):
        kg.kaczmarz_greedy_solve(A, Gt, denom, norms, r, eps, fnorm, None, 4, 3, 1,
                                 forced_rows=fr)
    fr[1, 2] = 45
    with pytest.raises(ValueError, match=r"forced row.*must lie in \[-1, 45\)"):
        kg.kaczmarz_greedy_solve(A, Gt, denom, norms, r, eps, fnorm, None, 4, 2, 1,
                                 forced_rows=fr)
    with pytest.raises(ValueError, match="unknown prox"):
        kg.kaczmarz_greedy_solve(A, Gt, denom, norms, r, eps, fnorm, None, 4, 2, 1, "l1")
