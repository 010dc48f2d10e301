"""The Kaczmarz row kernel's routes (rls_tpu_torch/kernels/kaczmarz_streamed.py
``plan_kaczmarz``, csrc/kaczmarz.cu), on the CPU.

The planner: which route, problems a CTA (g), ring slots (R) and placement
of x and vl each shape takes on an H100 (132 SMs, 232,448 bytes of shared
memory a block), at the cells of PERF.md §4 and at the edges; that every
plan fits and covers each problem once; that its shared-memory count is the
kernel's.

The model: the warp route in Python, CTA by CTA. A producer stages each
visited row and the problems' d_i, u_i into a ring of R slots; each fill
lands later (in order) and completes the slot's "full" barrier; g consumer
warps each wait for the slot's full barrier, sum the row's dot lane by lane
(lane l over entries l, l + 32, … in double) and close it with the xor
butterfly, form alpha and the updates in f32 (float64 in float64 mode),
and arrive on the slot's "empty" barrier, which the producer waits for
before refilling it. A seeded scheduler interleaves the agents; the ring
raises when a slot is refilled before its g releases or read before its
fill, so dropping either wait raises. The model is held to the plain
version (``kaczmarz_solve_torch``) at 1e-6 relative in float32 and 1e-12 in
float64, and to the JAX kernels in interpret mode at the 1e-5 of
tests/test_torch_kaczmarz.py. The kernel itself runs only on the card
(tests/test_torch_cuda.py).

Also here: the Kaczmarz solver checks its row orders once, at
construction, and its sweeps on the kernel read nothing back to the host."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.kernels.kaczmarz_pallas import kaczmarz_sweep_pallas
from rls_tpu.kernels.kaczmarz_pallas import solve_kaczmarz_streamed as jax_streamed
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import kaczmarz_streamed as ks
from test_torch_cuda import KZ_CASES, _kaczmarz_case, _kaczmarz_tall
from test_torch_kaczmarz import _STREAMED, _kaczmarz, _operator, _rel, _system

CSRC = Path(ks.__file__).parents[1] / "csrc"
SMS, SMEM = 132, 232_448
CPU = torch.device("cpu")

# (P, m, n, L, nc, csr) of the cells of PERF.md §4 (the tall CSR cell's
# k_max is its own draw's) and the plan each takes
CELLS = {
    "12a: 1024x256, batch 16": ((16, 1024, 256, 256, 1, False), ("warp", 1, 8, 8, "shared")),
    "12b tall dense, batch 16": ((16, 1024, 256, 256, 1, False), ("warp", 1, 8, 8, "shared")),
    "12b tall CSR, batch 16": ((16, 1024, 256, 101, 1, True), ("warp", 1, 8, 0, "shared")),
    "12b 64 MiB, batch 4": ((4, 8192, 2048, 2048, 1, False), ("block", 1, 0, 0, "global")),
    "12b complex 512x128, batch 4": ((4, 512, 128, 128, 2, False), ("warp", 1, 8, 4, "shared")),
    "12b real A, complex b, batch 4": ((8, 1024, 256, 256, 1, False),
                                       ("warp", 1, 8, 8, "shared")),
}


def _fits(plan, P, m, n, L, nc, csr, smem=SMEM):
    """A plan fits the card and covers every problem once."""
    assert plan.smem <= smem
    assert (plan.ctas - 1) * plan.groups < P <= plan.ctas * plan.groups
    if plan.route == "block":
        assert plan.smem == 4 * nc * n and plan.ctas == P
        return
    assert 1 <= plan.groups <= ks.MAX_GROUPS and 1 <= plan.ring <= ks.RING
    assert plan.smem == ks.warp_smem_bytes(m, n, L, nc, csr, plan.groups, plan.ring,
                                           plan.x_lanes, plan.vl_in == "shared")
    if plan.x_in == "registers":
        assert not csr and 32 * plan.x_lanes >= n and plan.x_lanes <= ks.REG_LANES[nc]
    else:
        assert plan.x_lanes == 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_plans_at_the_cells(cell):
    shape, (route, groups, ring, lanes, vl_in) = CELLS[cell]
    plan = ks.plan_kaczmarz(*shape, SMS, SMEM)
    _fits(plan, *shape)
    assert (plan.route, plan.groups, plan.ring, plan.x_lanes, plan.vl_in) == (
        route, groups, ring, lanes, vl_in)


def test_the_shared_memory_count():
    """12a's CTA, counted by hand: 8 full and 8 empty barriers (128 B), 8
    slots of one problem's d, u (16 B) and a row of 256 floats (1,024 B),
    vl of 1,024 rows (4,096 B); x in registers."""
    plan = ks.plan_kaczmarz(16, 1024, 256, 256, 1, False, SMS, SMEM)
    assert plan.smem == 128 + 8 * (16 + 1024) + 4096 == 12_544
    # complex CSR, 3 problems, 4 slots, x and vl in shared memory: rows of
    # 7 entries take 8 floats a plane and 8 columns
    assert ks.warp_smem_bytes(10, 9, 7, 2, True, 3, 4, 0, True) == (
        64 + 4 * (48 + 4 * 3 * 8) + 224 + 240)
    # x in registers, 2 entries a lane: a row of 45 entries takes 64 floats,
    # its entries past 45 zero
    assert ks.warp_smem_bytes(37, 45, 45, 1, False, 1, 8, 2, False) == 128 + 8 * (16 + 256)


def test_the_constants_are_the_kernels():
    src = (CSRC / "kaczmarz.cu").read_text()
    assert int(re.search(r"constexpr int kMaxGroups = (\d+);", src).group(1)) == ks.MAX_GROUPS
    phases = re.search(r"enum \{ (kPhWait[^}]*) \};", src).group(1).split(", ")
    assert phases[-1] == "kWarpPhases" and len(phases) - 1 == len(ks.WARP_PHASES)
    # the register placements the kernel instantiates: 16 lanes real, 8 complex
    assert "case 16:" in src and "if constexpr (!kCplx) return warp_go<false, false, 16>" in src
    assert ks.REG_LANES == {1: 16, 2: 8}


@pytest.mark.parametrize("shape, route, lanes", [
    ((3, 9, 1, 1, 1, False), "warp", 1),          # n = 1
    ((3, 30, 7, 1, 1, True), "warp", 0),          # k_max = 1
    ((3, 40, 512, 512, 1, False), "warp", 16),    # the widest real row in registers
    ((3, 40, 513, 513, 1, False), "block", 0),
    ((3, 40, 256, 256, 2, False), "warp", 8),     # the widest complex row in registers
    ((3, 40, 257, 257, 2, False), "block", 0),
    ((1, 16, 9000, ks.WARP_MAX_L, 1, True), "warp", 0),      # the widest CSR row
    ((1, 16, 9000, ks.WARP_MAX_L + 1, 1, True), "block", 0),
    ((1, 16, 300, ks.WARP_MAX_L, 2, True), "warp", 0),
    ((2, 64, ks.MAX_N_REAL, ks.MAX_N_REAL, 1, False), "block", 0),
    ((2, 64, ks.MAX_N_REAL // 2, ks.MAX_N_REAL // 2, 2, False), "block", 0),
])
def test_the_plans_at_the_edges(shape, route, lanes):
    plan = ks.plan_kaczmarz(*shape, SMS, SMEM)
    _fits(plan, *shape)
    assert (plan.route, plan.x_lanes) == (route, lanes)


def test_a_wide_csr_row_falls_back_to_the_block_route():
    """CSR keeps x in shared memory: at `MAX_N_REAL` columns x leaves no
    room for one slot, and the block route takes the shape, short as its
    rows are."""
    shape = (4, 100, ks.MAX_N_REAL, 64, 1, True)
    plan = ks.plan_kaczmarz(*shape, SMS, SMEM)
    assert plan.route == "block"
    with pytest.raises(ValueError, match="no warp plan fits"):
        ks.plan_kaczmarz(*shape, SMS, SMEM, route="warp")


def test_vl_leaves_shared_memory_before_the_ring_shrinks_below_half():
    """The 64 MiB rows on the warp route with 16 problems forced into a CTA:
    x (16 × 8 KiB) and vl (16 × 32 KiB) do not both fit; vl goes to global
    memory, and 8 slots of 8 KiB fit beside x."""
    plan = ks.plan_kaczmarz(64, 8192, 2048, 2048, 1, False, SMS, SMEM, groups=16,
                            route="warp")
    _fits(plan, 64, 8192, 2048, 2048, 1, False)
    assert (plan.groups, plan.vl_in, plan.x_in, plan.ring) == (16, "global", "shared", ks.RING)


SWEEP_SHAPES = [(P, m, n, L, nc, csr) for P in (1, 3, 16, 137, 300) for m in (1, 50, 8192)
                for n, L, csr in ((1, 1, False), (45, 45, False), (300, 300, False),
                                  (2048, 2048, False), (5000, 5000, False), (300, 17, True),
                                  (20_000, 200, True)) for nc in (1, 2)]


@pytest.mark.parametrize("groups", [None, 1, 5, 16])
def test_every_plan_fits_and_covers(groups):
    for shape in SWEEP_SHAPES:
        P, m, n, L, nc, csr = shape
        # an H100, and a smaller card: fewer SMs, less shared memory
        for sms, smem in ((SMS, SMEM), (20, 101_376)):
            try:
                plan = ks.plan_kaczmarz(*shape, sms, smem, groups=groups)
            except ValueError:
                # only where x of one problem fits no block's shared memory
                assert 4 * nc * n > smem, shape
                continue
            _fits(plan, *shape, smem=smem)
            if groups is not None and plan.route == "warp":
                assert plan.groups == groups


def test_forced_routes_and_refusals():
    shape = (16, 1024, 256, 256, 1, False)
    assert ks.plan_kaczmarz(*shape, route="block").route == "block"
    assert ks.plan_kaczmarz(*shape, route="warp", groups=4).ctas == 4
    with pytest.raises(ValueError, match="no route"):
        ks.plan_kaczmarz(*shape, route="grid")
    for g in (0, ks.MAX_GROUPS + 1):
        with pytest.raises(ValueError, match="groups must lie"):
            ks.plan_kaczmarz(*shape, groups=g)


# ---------------------------------------------------------------------------
# The model of the warp route.


class RingError(AssertionError):
    pass


class Barrier:
    """An mbarrier: `count` arrivals complete a phase; ``done(parity)`` is
    ``try_wait.parity``: the phase of that parity (the current one or the
    one before) has completed."""

    def __init__(self, count):
        self.count, self.pending, self.phases = count, count, 0

    def arrive(self):
        self.pending -= 1
        if self.pending == 0:
            self.phases += 1
            self.pending = self.count

    def done(self, parity):
        return self.phases % 2 != parity


class Ring:
    """R slots, each with its full barrier (one arrival: the fill landing)
    and its empty barrier (g arrivals: the consumers' releases); it raises
    where a slot is refilled before its g releases or read before its fill
    has landed."""

    def __init__(self, R, g):
        self.g = g
        self.full = [Barrier(1) for _ in range(R)]
        self.empty = [Barrier(g) for _ in range(R)]
        self.visit = [None] * R
        self.data = [None] * R
        self.landed = [False] * R
        self.releases = [g] * R

    def fill(self, slot, visit, data):
        if self.releases[slot] < self.g:
            raise RingError(f"slot {slot} refilled with visit {visit} after "
                            f"{self.releases[slot]} of {self.g} releases of visit "
                            f"{self.visit[slot]}")
        self.visit[slot], self.data[slot] = visit, data
        self.landed[slot], self.releases[slot] = False, 0

    def land(self, slot):
        self.landed[slot] = True
        self.full[slot].arrive()

    def read(self, slot, visit):
        if self.visit[slot] != visit or not self.landed[slot]:
            raise RingError(f"slot {slot} read for visit {visit} before its fill")
        return self.data[slot]

    def release(self, slot):
        self.releases[slot] += 1
        self.empty[slot].arrive()


def lane_dot(a, v):
    """Σ a·v as a warp of the kernel sums it: lane l over entries l, l + 32,
    … in order, in double (the f32 products are exact), then the xor
    butterfly; every lane ends with the same double."""
    prods = a.astype(np.float64) * v.astype(np.float64)
    K = max(1, -(-prods.size // 32))
    lanes = np.zeros(32 * K)
    lanes[:prods.size] = prods
    s = np.zeros(32)
    for row in lanes.reshape(K, 32):
        s = s + row
    for o in (16, 8, 4, 2, 1):
        s = s + s[np.arange(32) ^ o]
    assert (s == s[0]).all() or np.isnan(s).all()
    return s[0]


def warp_model(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox="none", cols=None,
               groups=1, ring=8, seed=0, drop_empty_wait=False, drop_full_wait=False):
    """The warp route on the operands of ``kaczmarz_solve_torch`` (numpy or
    torch, float32 or float64): CTA by CTA, `groups` problems a CTA, a ring
    of `ring` slots, the agents interleaved by a scheduler seeded with
    `seed`. Returns (x, vl) as numpy arrays."""
    rows, x, vl, u, denom, eps = (np.array(t.numpy() if torch.is_tensor(t) else t)
                                  for t in (rows, x0, vl0, u, denom, eps))
    idx = np.asarray(idx.numpy() if torch.is_tensor(idx) else idx)
    cols = None if cols is None else np.asarray(cols.numpy() if torch.is_tensor(cols) else cols)
    ft = rows.dtype.type
    P, nc, n = x.shape
    order = [int(i) for t in range(sweeps) for i in idx[0 if reuse else t]]
    S = idx.shape[1]
    valid = [i for i in order if i >= 0]
    def step(p, i, a, c, d, uu, e):
        keep = slice(None) if c is None else (a != 0).any(axis=0)
        cc = np.arange(n) if c is None else c
        xr, ar_ = x[p, 0], a[0]
        if nc == 1:
            tau = ft(lane_dot(ar_, xr[cc]))
            al = d * ((ft(uu[0]) - tau) - e * vl[p, 0, i])
            vl[p, 0, i] = vl[p, 0, i] + al * e
            ck = cc[keep]
            xr[ck] = xr[ck] + al * ar_[keep]
            return
        xi, ai_ = x[p, 1], a[1]
        taur = ft(lane_dot(ar_, xr[cc])) - ft(lane_dot(ai_, xi[cc]))
        taui = ft(lane_dot(ar_, xi[cc])) + ft(lane_dot(ai_, xr[cc]))
        alr = d * ((ft(uu[0]) - taur) - e * vl[p, 0, i])
        ali = d * ((ft(uu[1]) - taui) - e * vl[p, 1, i])
        vl[p, 0, i] = vl[p, 0, i] + alr * e
        vl[p, 1, i] = vl[p, 1, i] + ali * e
        ck = cc[keep]
        a_, b_ = ar_[keep], ai_[keep]
        xr_old = xr[ck].copy()
        xr[ck] = (xr_old + alr * a_) + ali * b_
        xi[ck] = (xi[ck] + ali * a_) - alr * b_

    rng = np.random.default_rng(seed)
    for p0 in range(0, P, groups):
        probs = list(range(p0, min(P, p0 + groups)))
        ring_ = Ring(ring, len(probs))
        inflight = []

        def producer():
            slot, phase = 0, 0
            for visit, i in enumerate(valid):
                if not drop_empty_wait:
                    yield lambda s=slot, ph=phase: ring_.empty[s].done(ph ^ 1)
                ring_.fill(slot, visit, (rows[:, i].copy(), None if cols is None else cols[i],
                                         denom[probs, i].copy(), u[probs, :, i].copy()))
                inflight.append(slot)
                slot, phase = (0, phase ^ 1) if slot + 1 == ring else (slot + 1, phase)
                yield None

        def consumer(q):
            p = probs[q]
            e = ft(eps[p])
            slot, phase, visit = 0, 0, 0
            for j, i in enumerate(order):
                if i >= 0:
                    if not drop_full_wait:
                        yield lambda s=slot, ph=phase: ring_.full[s].done(ph)
                    a, c, d, uu = ring_.read(slot, visit)
                    step(p, i, a, c, ft(d[q]), uu[q], e)
                    ring_.release(slot)
                    slot, phase = (0, phase ^ 1) if slot + 1 == ring else (slot + 1, phase)
                    visit += 1
                    yield None
                if (j + 1) % S == 0:
                    if prox == "positive":
                        x[p, 0] = np.maximum(x[p, 0], ft(0))
                    if nc == 2 and prox != "none":
                        x[p, 1] = x[p, 1] * ft(0)

        agents = {0: producer(), **{q + 1: consumer(q) for q in range(len(probs))}}
        waits = {k: None for k in agents}
        while agents:
            ready = [k for k in agents if waits[k] is None or waits[k]()]
            choices = ready + (["land"] if inflight else [])
            if not choices:
                raise RingError("deadlock: every agent waits and no fill is in flight")
            pick = choices[rng.integers(len(choices))]
            if pick == "land":
                ring_.land(inflight.pop(0))  # one thread's copies land in order
                continue
            try:
                waits[pick] = next(agents[pick])
            except StopIteration:
                del agents[pick], waits[pick]

    return x, vl


def _close(got, want, rel):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max() if want.size else 0.0
    assert err <= rel * max(np.abs(want).max() if want.size else 0.0, 1e-30), err


def _case(case, dtype=torch.float32):
    ops = list(_kaczmarz_case(CPU, case))
    for k in (0, 3, 4, 5, 6, 7):
        ops[k] = ops[k].to(dtype)
    return ops


@pytest.mark.parametrize("dtype, rel", [(torch.float32, 1e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", KZ_CASES)
def test_the_model_matches_the_plain_version(case, dtype, rel):
    rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox = _case(case, dtype)
    want = ks.kaczmarz_solve_torch(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols)
    got = warp_model(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols, groups=2,
                     ring=3, seed=1)
    for g, w in zip(got, want):
        _close(g, w.numpy(), rel)


@pytest.mark.parametrize("groups, ring", [(1, 1), (1, 8), (3, 2), (2, 8), (16, 4)])
def test_the_schedule_does_not_change_the_bits(groups, ring):
    """Any g, any R, any interleaving: the same bits (each problem's steps
    run in visit order whatever the ring does)."""
    for case in ("dense-revisit", "csr", "complex"):
        ops = _case(case)
        x1, vl1 = warp_model(*ops[:1], *ops[2:], cols=ops[1], groups=groups, ring=ring, seed=2)
        x2, vl2 = warp_model(*ops[:1], *ops[2:], cols=ops[1], groups=1, ring=8, seed=3)
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(vl1, vl2)


def test_the_model_at_the_tall_cell():
    """The tall cell's shapes (16 problems, 20 sweeps of 64 rows), dense and
    padded CSR, the default plan's g and R."""
    for csr in (False, True):
        ops = _kaczmarz_tall(CPU, csr)
        rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox = ops
        plan = ks.plan_kaczmarz(16, 1024, 256, rows.shape[-1], 1, csr, SMS, SMEM)
        want = ks.kaczmarz_solve_torch(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox,
                                       cols)
        got = warp_model(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols,
                         groups=plan.groups, ring=plan.ring)
        for g, w in zip(got, want):
            _close(g, w.numpy(), 1e-6)


@pytest.mark.parametrize("drop", ["empty", "full"])
def test_a_dropped_wait_raises(drop):
    """Without the producer's wait for the empty barrier a slot is refilled
    before its consumers release it; without a consumer's wait for the full
    barrier a slot is read before its fill lands."""
    ops = _case("dense-repeat")
    kw = {"drop_empty_wait": drop == "empty", "drop_full_wait": drop == "full"}
    with pytest.raises(RingError, match="refilled" if drop == "empty" else "before its fill"):
        for seed in range(20):
            warp_model(*ops[:1], *ops[2:], cols=ops[1], groups=3, ring=2, seed=seed, **kw)


@pytest.mark.parametrize("ring", [1, 8])
def test_one_row_a_sweep(ring):
    """S = 1 with reuse: every visit is the same row, so the ring holds it
    in every slot (R > S) and vl_i of the last visit is always the one to
    read."""
    rows, cols, idx, x0, vl0, u, denom, eps, _, _, prox = _case("dense")
    one = idx[:, 2:3].clone()
    want = ks.kaczmarz_solve_torch(rows, one, x0, vl0, u, denom, eps, 7, True, prox)
    got = warp_model(rows, one, x0, vl0, u, denom, eps, 7, True, prox, ring=ring, seed=4)
    for g, w in zip(got, want):
        _close(g, w.numpy(), 1e-6)


def test_an_all_skipped_list_takes_no_slot():
    ops = _case("dense-all-skip")
    x, vl = warp_model(*ops[:1], *ops[2:], cols=ops[1], ring=1)
    np.testing.assert_array_equal(vl, ops[4].numpy())
    np.testing.assert_array_equal(x, np.maximum(ops[3].numpy(), 0))  # Positive after each sweep


def _solution(ts, x):
    x = torch.from_numpy(x)
    sol = torch.complex(x[:, 0], x[:, 1]) if x.shape[1] == 2 else x[:, 0]
    if ts.tikhonov_inv_sqrt is not None:
        sol = sol * ts.tikhonov_inv_sqrt.to(sol.dtype)[None, :]
    return sol.T


@pytest.mark.parametrize("name", sorted(_STREAMED))
def test_the_model_matches_jax_streamed(name):
    """12b: the model on solve_kaczmarz_streamed's operands against the JAX
    streamed kernel in interpret mode (tests/test_torch_kaczmarz.py's
    harness: three sweeps, block_rows 8)."""
    kind, dtype, case = _STREAMED[name]
    A, B = _system(dtype, sparse=kind == "csr")
    js = _kaczmarz(_operator(A, kind), case, iterations=3)
    want = np.asarray(jax_streamed(js, jnp.asarray(B), block_rows=8, interpret=True))
    ts = convert(js, device="cpu")
    rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse = ks.solver_operands(
        ts, torch.from_numpy(B))
    x, _ = warp_model(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse,
                      ks.sweep_projection(ts), cols, groups=2, ring=4)
    assert _rel(_solution(ts, x), want) < 1e-5


def test_the_model_matches_jax_sweep():
    """12a: one sweep of the model against kaczmarz_sweep_pallas in
    interpret mode."""
    A, B = _system()
    m, n = A.shape
    rng = np.random.default_rng(7)
    x = rng.normal(size=n).astype(np.float32)
    vl = rng.normal(size=m).astype(np.float32)
    denom = rng.uniform(0.02, 0.1, size=m).astype(np.float32)
    idx = rng.permutation(m).astype(np.int32)
    want = kaczmarz_sweep_pallas(jnp.asarray(A), jnp.asarray(x), jnp.asarray(vl),
                                 jnp.asarray(B[:, 0]), jnp.asarray(denom), 0.03,
                                 jnp.asarray(idx), interpret=True)
    got = warp_model(A[None], idx[None], x[None, None], vl[None, None], B[None, None, :, 0],
                     denom[None], np.array([0.03], np.float32), 1, True, ring=2)
    assert _rel(got[0][0, 0], want[0]) < 1e-5 and _rel(got[1][0, 0], want[1]) < 1e-5


# ---------------------------------------------------------------------------
# The solver's sweeps on the kernel: row orders checked once.


def _solver(**kw):
    rng = np.random.default_rng(21)
    A = rng.normal(size=(40, 12)).astype(np.float32)
    B = rng.normal(size=(40, 3)).astype(np.float32)
    op = rtt.DenseOperator(torch.from_numpy(A), device="cpu")
    return rtt.Kaczmarz.create(op, reg=rtt.L2Regularization(1e-3), iterations=5, **kw), B


@pytest.mark.parametrize("field, bad", [("perm", 40), ("perm", -1),
                                        ("precomputed_order", 40)])
def test_a_row_order_out_of_range_raises_at_construction(field, bad):
    import dataclasses

    s, _ = _solver(randomized=field == "precomputed_order", precompute_order=True,
                   sub_matrix_fraction=0.25)
    rows = getattr(s, field).clone()
    rows.view(-1)[3] = bad
    with pytest.raises(ValueError, match=f"Kaczmarz {field}: rows must lie in"):
        dataclasses.replace(s, **{field: rows})


@pytest.mark.parametrize("shuffle", [False, True])
def test_the_solver_sweeps_read_nothing_back(monkeypatch, shuffle):
    """backend="cuda" (the plain version on CPU tensors) makes no aminmax
    call in its sweeps, and gives what the public sweep gives sweep by
    sweep; the public sweep still refuses a row out of range."""
    s, B = _solver(shuffle_rows=shuffle, backend="cuda")
    calls = []
    real = torch.aminmax
    monkeypatch.setattr(torch, "aminmax", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = rtt.solve_batched_unrolled(s, torch.from_numpy(B))
    assert calls == []
    st = s.init(torch.from_numpy(B).T)
    x, vl = st.x, st.vl
    for _ in range(s.iterations):
        x, vl = ks.kaczmarz_sweep(s.A.mat, x, vl, st.u, st.denom, st.eps_w, s.perm)
    assert len(calls) == s.iterations  # the public sweep checks its rows
    np.testing.assert_array_equal(got.numpy(), x.T.numpy())
    bad = s.perm.clone()
    bad[0] = 40
    with pytest.raises(ValueError, match="indices must lie"):
        ks.kaczmarz_sweep(s.A.mat, x, vl, st.u, st.denom, st.eps_w, bad)
