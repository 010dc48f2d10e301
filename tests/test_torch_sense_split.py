"""The split route of the SENSE kernels (rows 9 and 10: csrc/sense_split.cuh,
the planners in rls_tpu_torch/kernels/sense_fused.py and
splitbregman_fused.py), on the CPU.

The planner: which shapes leave the resident route for the split one and
on which team (the smallest whose CTA fits, every side from 2 to 1024),
how many coils a round and rounds, that the shared memory is counted
piece by piece as the .cu files count it, and that a forced plan that
does not fit raises, naming it.

The schedule: a Python model of the split normal op and the fold, CTA by
CTA, in the manner of row 8's ClusterModel (tests/test_torch_dft_plan.py):
each CTA's band and block, and the normal op's input v by fold band, with
every access recorded between two cluster barriers. A push to another
CTA's buffer lands at the next barrier, as a DSMEM store is ordered for
its reader only by a cluster barrier; within one window a buffer that
receives pushes may be touched by nobody else, and a buffer one CTA
writes may be read by no other. The model must give
``_dft_common.sense_normal`` and ``fista_l21_sense_fused_torch`` bit for
bit, and dropping any one of its barriers must raise a hazard naming the
buffer. The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rls_tpu_torch.kernels import _dft_common as dft
from rls_tpu_torch.kernels import sense_fused as sense
from rls_tpu_torch.kernels import splitbregman_fused as sb
from rls_tpu_torch.kernels.fista_tv_fused import _momentum_table
from test_torch_sense_plan import H100_RESIDENT, SMEM
from test_torch_splitbregman_plan import line_model

CSRC = Path(sense.__file__).parents[1] / "csrc"
BARRIERS = ("A", "S1", "S2", "S3", "S4")


def _plan(B, H, W, C, split=None, module=sense):
    plan = module.plan_sense if module is sense else module.plan_splitbregman
    return plan(B, H, W, C, H100_RESIDENT, split=split)


# ---- the planner


@pytest.mark.parametrize("module", [sense, sb], ids=["row9", "row10"])
def test_the_plan_at_192_squared(module):
    """8 slices of 192², 6 coils: a coil's padded spectrum (296,448 bytes)
    fits no CTA, nor does a team of 2 (its band and block together hold as
    much); a team of 3 does (64-row bands, 64-column blocks), so 3 coils a
    round on clusters of 9 CTAs, in 2 rounds; the card holds 9 clusters of
    9, so the 8 slices run in one wave on 72 SMs."""
    plan = _plan(8, 192, 192, 6, module=module)
    assert (plan.route, plan.team, plan.clusters, plan.rounds, plan.ctas) == ("split", 3, 9, 2,
                                                                             72)
    assert plan.resident_clusters == 9 >= 8
    assert module.resident_smem_bytes(192, 192) > SMEM
    assert module.split_smem_bytes(192, 192, 2) == module.resident_smem_bytes(192, 192)
    assert plan.smem == module.split_smem_bytes(192, 192, 3) <= SMEM
    assert plan.scratch == module.RESIDENT_SCRATCH
    assert [sense.split_part(192, 3, j) for j in range(3)] == [(0, 64), (64, 128), (128, 192)]


@pytest.mark.parametrize("shape,want", [
    # 256 × 128: 86, 85, 85-row bands and 43, 43, 42-column blocks
    ((256, 128), ("split", 3, 9, 2)),
    # 256²: teams of 3 and 4 hold too much (356,400 and 266,288 bytes)
    ((256, 256), ("split", 5, 15, 2)),
    # 320²: 16 CTAs, 2 coils a round
    ((320, 320), ("split", 8, 16, 3)),
    # 512² fits no team of 16 (270,384 bytes): the grid route, 4 slots of 33
    # CTAs, 3 coils a round
    ((512, 512), ("grid", 33, 33, 2)),
    # a coil's padded spectrum fits one CTA: the resident route, unchanged
    ((128, 128), ("resident", 1, 6, 1)),
    ((64, 192), ("resident", 1, 6, 1)),
])
def test_the_routes_beside_192_squared(shape, want):
    for module in (sense, sb):
        plan = _plan(8, *shape, 6, module=module)
        assert (plan.route, plan.team, plan.clusters, plan.rounds) == want
    assert sense.split_smem_bytes(512, 512, 16) == 270_384 > SMEM


SIDES = [2, 3, 17, 64, 97, 128, 192, 256, 320, 448, 512, 640, 1021, 1024]


@pytest.mark.parametrize("H", SIDES)
def test_the_planner_s_choice_at_every_side(H):
    """Resident where a coil's padded spectrum fits a CTA; else the smallest
    team (2 … 16, no larger than a side) whose split CTA fits, on the
    fewest rounds of at most ⌊16/team⌋ coils; else grid, where no team
    fits. A team need not divide a side: its bands and blocks differ by at
    most a line."""
    for W in SIDES:
        for module in (sense, sb):
            plan = _plan(2, H, W, 6, module=module)
            fits = [k for k in range(1, min(16, H, W) + 1)
                    if module.cluster_smem_bytes(H, W, k) <= SMEM]
            if not fits:
                assert plan.route == "grid", (H, W)
                continue
            team = fits[0]
            assert plan.route == ("resident" if team == 1 else "split"), (H, W)
            assert plan.team == team and plan.smem == module.cluster_smem_bytes(H, W, team)
            per = 16 // team
            rounds = -(-6 // per)
            assert (plan.clusters, plan.rounds) == (team * -(-6 // rounds), rounds)
            for n in (H, W):
                parts = [sense.split_part(n, team, j) for j in range(team)]
                assert parts[0][0] == 0 and parts[-1][1] == n
                assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
                sizes = [b - a for a, b in parts]
                assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_the_split_shared_memory_is_counted_piece_by_piece():
    # 192² on teams of 3: 6 int64 phase clocks, 2 · (97 + 97) f32
    # twiddles, a band of 64 · 192 and a block of 192 · 65 f32 each for re
    # and im
    assert sense.split_smem_bytes(192, 192, 3) == 48 + 4 * 388 + 2 * 4 * (64 * 192 + 192 * 65)
    assert sense.split_smem_bytes(192, 192, 3) == 199_744
    # rows 10: the block sums (3 × 32 float64), the cluster's sums (12
    # float64) and 8 phase clocks in place of 6
    assert sb.split_smem_bytes(192, 192, 3) == 864 + 64 + 4 * 388 + 2 * 4 * (64 * 192 + 192 * 65)
    # uneven: 256 × 128 on 3 (86-row bands, 43-column blocks); each array
    # rounded up to 4 floats: 17 × 24 on 2 is 2 · (9 + 13) = 44 twiddles, a
    # 9 · 24 band and a 17 · 13 = 221 → 224 block
    assert sense.split_smem_bytes(256, 128, 3) == 48 + 4 * 384 + 2 * 4 * (86 * 128 + 256 * 44)
    assert sense.split_smem_bytes(17, 24, 2) == 48 + 4 * 44 + 2 * 4 * (9 * 24 + 224)
    for module in (sense, sb):
        assert module.cluster_smem_bytes(128, 128, 1) == module.resident_smem_bytes(128, 128)


def test_the_planners_read_the_kernels_constants():
    """The split CTA's shared memory as csrc/sense_fused.cu,
    csrc/splitbregman_fused.cu and csrc/split.cuh (which sense_split.cuh
    includes) count it, and the plan's validity as both .cu files check
    it."""
    assert '#include "split.cuh"' in (CSRC / "sense_split.cuh").read_text()
    header = (CSRC / "split.cuh").read_text()
    band = re.search(r"split_band_floats\(int H, int W, int team\) \{(.*?)\n\}", header,
                     re.S).group(1)
    block = re.search(r"split_block_floats\(int H, int W, int team\) \{(.*?)\n\}", header,
                      re.S).group(1)
    assert "ceil4(static_cast<size_t>(ceil_div(H, team)) * W)" in band
    assert "ceil4(static_cast<size_t>(H) * (ceil_div(W, team) + 1))" in block
    for name, extra in (("sense_fused.cu", ""),
                        ("splitbregman_fused.cu", "sizeof(double) * (3 * (kThreads / 32) + 12)")):
        src = (CSRC / name).read_text()
        smem = re.search(r"split_smem_bytes\(int H, int W, int team\) \{(.*?)\n\}", src,
                         re.S).group(1)
        assert extra in smem and "sizeof(long long) * kPhases" in smem
        assert "rls::ceil4(rls::twiddle_floats(H, W)) +" in smem
        assert "2 * rls::split_band_floats(H, W, team) +" in smem
        assert "2 * rls::split_block_floats(H, W, team)" in smem
        valid = re.search(r"bool valid_plan\(int clusters, int team, int H, int W, int C\) \{"
                          r"(.*?)\n\}", src, re.S).group(1)
        assert "clusters <= kMaxCluster && clusters % team == 0" in valid
        assert "clusters / team <= C && team <= H && team <= W" in valid


@pytest.mark.parametrize("split,match", [
    ((17, 1), "teams of 17 CTAs, 1 coils a round"),
    ((3, 6), "teams of 3 CTAs, 6 coils a round"),   # 18 CTAs
    ((3, 7), "teams of 3 CTAs, 7 coils a round"),   # more than C
    ((2, 3), r"teams of 2 CTAs.*298048 B of shared memory a CTA, 232448 on the card"),
    ((1, 3), "teams of 1 CTAs"),                    # the resident CTA does not fit
])
def test_a_forced_plan_that_does_not_fit_raises_and_names_it(split, match):
    with pytest.raises(ValueError, match="fista_l21_sense_fused: no plan of " + match):
        _plan(8, 192, 192, 6, split)


@pytest.mark.parametrize("split,want", [((3, 3), (9, 2)), ((4, 3), (12, 2)), ((3, 2), (6, 3)),
                                        ((4, 2), (8, 3)), ((8, 2), (16, 3)), ((5, 3), (15, 2)),
                                        ((6, 1), (6, 6))])
def test_forced_plans_at_192_squared(split, want):
    """The sweep's plans: (team, coils a round) → (clusters, rounds)."""
    for module in (sense, sb):
        plan = _plan(8, 192, 192, 6, split, module)
        assert (plan.route, plan.team, plan.clusters, plan.rounds) == ("split", split[0], *want)
        assert plan.smem == module.split_smem_bytes(192, 192, split[0])


# ---- the split normal op and the fold, CTA by CTA


@pytest.fixture
def one_thread():
    """One intra-op thread for a bit-for-bit comparison: in this suite
    (JAX loaded beside torch) the plain version's batched ops, spread over
    the intra-op pool, gave other bits in about one process in eight at
    192² with 6 coils; on one thread every run gives the same."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Hazard(AssertionError):
    """Two CTAs met at a buffer between the same two cluster barriers: a
    push beside any other access, or a write beside another CTA's read."""


class SplitModel:
    """One slice's cluster on the split route: each CTA's band (its rows of
    its team's coil spectrum, re and im) and block (every row of its
    columns), and the normal op's input v, owned by fold band. Accesses
    are recorded by window; pushes land at the barrier that closes it."""

    def __init__(self, plan, W):
        self.plan, self.W = plan, W
        k, H = plan.team, plan.H
        self.bufs = []
        for rank in range(plan.clusters):
            r0, r1 = sense.split_part(H, k, rank % k)
            c0, c1 = sense.split_part(W, k, rank % k)
            self.bufs.append({"band": [torch.zeros(r1 - r0, W), torch.zeros(r1 - r0, W)],
                              "block": [torch.zeros(H, c1 - c0), torch.zeros(H, c1 - c0)]})
        self.pending, self.access = [], {}

    def _note(self, cta, q, name, kind):
        self.access.setdefault((q, name), set()).add((cta, kind))

    def touch(self, q, name, write=True):
        """CTA q reads (and with `write` writes) its own buffer."""
        self._note(q, q, name, "w" if write else "r")

    def read(self, cta, q, name, rows):
        """CTA `cta` reads rows [r0, r1) of CTA q's buffer as it stands."""
        self._note(cta, q, name, "r")
        re, im = self.bufs[q][name]
        return re[rows[0]:rows[1]], im[rows[0]:rows[1]]

    def push(self, cta, q, name, rows, cols, re, im):
        self._note(cta, q, name, "push")
        self.pending.append((q, name, rows, cols, re.clone(), im.clone()))

    def barrier(self):
        met = []
        for (q, name), acc in sorted(self.access.items()):
            ctas = {cta for cta, _ in acc}
            others = {cta for cta, kind in acc if kind != "push"}
            writers = {cta for cta, kind in acc if kind == "w"}
            if len(others) < len(ctas) and others:
                met.append(f"{name} of CTA {q}: pushed to and touched by {sorted(others)}")
            elif writers and len(ctas) > 1:
                met.append(f"{name} of CTA {q}: written by {sorted(writers)} and read by "
                           f"{sorted(ctas - writers)}")
        if met:
            raise Hazard(f"between two barriers: {'; '.join(met)}")
        hits = {}
        for q, name, rows, cols, re, im in self.pending:
            count = hits.setdefault((q, name), torch.zeros(self.bufs[q][name][0].shape,
                                                           dtype=torch.int32))
            count[rows[0]:rows[1], cols[0]:cols[1]] += 1
            self.bufs[q][name][0][rows[0]:rows[1], cols[0]:cols[1]] = re
            self.bufs[q][name][1][rows[0]:rows[1], cols[0]:cols[1]] = im
        assert all(int(c.max()) == 1 for c in hits.values()), "a point pushed twice"
        self.pending, self.access = [], {}

    def read_v(self, cta, v, rows):
        """Rows [r0, r1) of the input planes v = (vr, vi), read through L2
        from the fold bands that own them."""
        for p in range(self.plan.clusters):
            f0, f1 = self.plan.band(p)
            if max(f0, rows[0]) < min(f1, rows[1]):
                self._note(cta, p, "v", "r")
        return v[0][rows[0]:rows[1]], v[1][rows[0]:rows[1]]


def _rows_forward(m, rank, coil, v, coils, tables):
    """(a) of `coil` on CTA `rank`: C_c v on its band's rows, the rows
    forward (staged in its band), each point pushed into the block of the
    team CTA that owns its column."""
    plan, W = m.plan, m.W
    k = plan.team
    team0 = rank - rank % k
    r0, r1 = sense.split_part(plan.H, k, rank % k)
    vr, vi = m.read_v(rank, v, (r0, r1))
    ca, cb = coils[0][coil, r0:r1], coils[1][coil, r0:r1]
    m.touch(rank, "band")
    re, im = line_model(ca * vr - cb * vi, ca * vi + cb * vr, tables[1])
    m.bufs[rank]["band"] = [re.clone(), im.clone()]
    for q in range(k):
        c0, c1 = sense.split_part(W, k, q)
        m.push(rank, team0 + q, "block", (r0, r1), (0, c1 - c0), re[:, c0:c1], im[:, c0:c1])


def _columns(m, rank, tables):
    """(b) on CTA `rank`: its block's columns forward, times the transposed
    weights, back, each point pushed into the band of the team CTA that
    owns its row."""
    plan, W = m.plan, m.W
    k = plan.team
    team0 = rank - rank % k
    c0, c1 = sense.split_part(W, k, rank % k)
    tw_h, _, weights = tables
    m.touch(rank, "block")
    bre, bim = (t.T.contiguous() for t in m.bufs[rank]["block"])  # lines are columns
    re, im = line_model(bre, bim, tw_h)
    wt = weights.T[c0:c1]
    re, im = line_model(re * wt, im * wt, tw_h, inverse=True)
    m.bufs[rank]["block"] = [re.T.contiguous(), im.T.contiguous()]
    for q in range(k):
        r0, r1 = sense.split_part(plan.H, k, q)
        m.push(rank, team0 + q, "band", (0, r1 - r0), (c0, c1), re[:, r0:r1].T, im[:, r0:r1].T)


def _rows_back(m, rank, tables):
    """(c) on CTA `rank`: its band's rows back, where the result stays."""
    m.touch(rank, "band")
    re, im = m.bufs[rank]["band"]
    m.bufs[rank]["band"] = list(line_model(re, im, tables[1], inverse=True))


def split_normal(m, v, coils, tables, finish, barriers=BARRIERS):
    """The SENSE normal op of v = (vr, vi) on the split route: per round,
    (a) on every CTA with a coil, S1, (b), S2, (c), S3, then each CTA's
    fold of the round's coils into its fold band in coil order, and S4
    but after the last round. finish(p, rows, nr, ni) gets CTA p's fold
    band."""
    plan, W = m.plan, m.W
    k, C = plan.team, plan.C
    per = plan.clusters // k
    acc = {}
    for ro in range(plan.rounds):
        c0, c1 = ro * per, min(C, (ro + 1) * per)
        ranks = [(t * k + j, c0 + t) for t in range(c1 - c0) for j in range(k)]
        for rank, coil in ranks:
            _rows_forward(m, rank, coil, v, coils, tables)
        if "S1" in barriers:
            m.barrier()
        for rank, _ in ranks:
            _columns(m, rank, tables)
        if "S2" in barriers:
            m.barrier()
        for rank, _ in ranks:
            _rows_back(m, rank, tables)
        if "S3" in barriers:
            m.barrier()
        for p in range(plan.clusters):
            f0, f1 = plan.band(p)
            sr, si = acc.get(p, (torch.zeros(f1 - f0, W),) * 2)
            for c in range(c0, c1):
                yr, yi = torch.empty(f1 - f0, W), torch.empty(f1 - f0, W)
                for q in range(k):  # the team CTA that owns each row
                    r0, r1 = sense.split_part(plan.H, k, q)
                    a, b = max(f0, r0), min(f1, r1)
                    if a < b:
                        yr[a - f0:b - f0], yi[a - f0:b - f0] = m.read(
                            p, (c - c0) * k + q, "band", (a - r0, b - r0))
                ca, cb = coils[0][c, f0:f1], coils[1][c, f0:f1]
                sr, si = (sr + ca * yr) + cb * yi, (si + ca * yi) - cb * yr
            acc[p] = sr, si
        if ro + 1 < plan.rounds and "S4" in barriers:
            m.barrier()
    for p in range(plan.clusters):
        finish(p, plan.band(p), *acc[p])


def model_sense_normal(v, coils, tables, plan, W):
    """Σ_c C̄_c Fᴴ M F C_c v of one slice (H, W) by the split route."""
    m = SplitModel(plan, W)
    nr, ni = torch.full_like(v[0], float("nan")), torch.full_like(v[1], float("nan"))

    def finish(p, rows, sr, si):
        nr[rows[0]:rows[1]], ni[rows[0]:rows[1]] = sr, si

    split_normal(m, v, coils, tables, finish)
    m.barrier()
    return nr, ni


def model_fista(x0, scal, tab, coils, tables, plan, W, barriers=BARRIERS):
    """FISTA-L21 on one slice (x0 (2, H, W), scal (2,)) by the split route:
    per iteration every CTA's momentum step on its fold band, barrier A,
    the split normal op, the gradient step and the group threshold on the
    fold band; a final barrier."""
    m = SplitModel(plan, W)
    rho, lam = scal[0], scal[1]
    t = rho * lam
    x0r, x0i = x0[0], x0[1]
    xr, xi = x0r * 0.0, x0i * 0.0
    pr, pi = xr.clone(), xi.clone()
    mr, mi = torch.full_like(xr, float("nan")), torch.full_like(xr, float("nan"))
    for it in range(tab.shape[0]):
        a = tab[it, 0]
        for p in range(plan.clusters):
            band = slice(*plan.band(p))
            m.touch(p, "v")
            vr, vi = xr[band], xi[band]
            mr[band] = vr + a * (vr - pr[band])
            mi[band] = vi + a * (vi - pi[band])
        if "A" in barriers:
            m.barrier()

        def finish(p, rows, nr, ni):
            band = slice(*rows)
            m.touch(p, "v", write=False)
            gr = mr[band] - rho * (nr - x0r[band])
            gi = mi[band] - rho * (ni - x0i[band])
            pr[band], pi[band] = xr[band], xi[band]
            xr[band], xi[band] = sense.group_threshold(gr, gi, t)

        split_normal(m, (mr, mi), coils, tables, finish, barriers)
    m.barrier()
    return torch.stack([xr, xi])


def _case(H, W, C, B=1, seed=0):
    rng = np.random.default_rng(seed + H * W + C)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    maps = rng.normal(size=(C, H, W)) + 1j * rng.normal(size=(C, H, W))
    maps /= np.sqrt((np.abs(maps) ** 2).sum(0))
    tables = dft.dft_tables(t(rng.uniform(size=(H, W)) < 0.45))
    return (t(maps.real), t(maps.imag)), tables, t(rng.normal(size=(B, 2, H, W)))


# (H, W, C) and the forced plan (team, coils a round) or None (the
# planner's): the planner's at 192² and 256 × 128, then the small shapes
# with odd factors on even and uneven teams, one round and several
SPLIT_CASES = [
    ((192, 192, 6), None), ((256, 128, 6), None),
    ((24, 40, 3), (2, 3)), ((24, 40, 3), (3, 2)), ((24, 40, 3), (5, 1)),
    ((17, 24, 2), (2, 2)), ((17, 24, 2), (4, 1)),
    ((96, 12, 17), (2, 8)), ((96, 12, 17), (5, 3)),
]


@pytest.mark.parametrize("shape,split", SPLIT_CASES)
def test_the_split_normal_op_is_the_plain_one_bit_for_bit(shape, split, one_thread):
    H, W, C = shape
    coils, tables, x = _case(H, W, C)
    plan = _plan(1, H, W, C, split)
    assert plan.route == "split" and plan.team > 1
    got = model_sense_normal((x[0, 0], x[0, 1]), coils, tables, plan, W)
    want = dft.sense_normal(x[:, 0], x[:, 1], *coils, tables)
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[1][0])


@pytest.mark.parametrize("shape,split", SPLIT_CASES)
def test_the_split_fista_is_the_plain_version_bit_for_bit(shape, split, one_thread):
    """Two slices with their own ρ and λ; three iterations (two at 192² and
    256 × 128): the momentum at work from the second."""
    H, W, C = shape
    coils, tables, x0 = _case(H, W, C, B=2)
    scal = torch.tensor([[0.9, 1e-2], [0.7, 0.2]])
    tab = torch.as_tensor(_momentum_table("fista", 2 if H * W > 20_000 else 3))
    plan = _plan(2, H, W, C, split)
    want = sense.fista_l21_sense_fused_torch(x0, scal, tab, coils, tables)
    for b in range(2):
        assert torch.equal(model_fista(x0[b], scal[b], tab, coils, tables, plan, W), want[b])
    assert float(want.abs().max()) > 0  # the threshold left something


@pytest.mark.parametrize("dropped,buffer", [
    ("A", "v"),        # the momentum step's writes beside the coil loads
    ("S1", "block"),   # (b) reads its block while (a) pushes into it
    ("S2", "band"),    # (c) reads its band while (b) pushes into it
    ("S3", "band"),    # the fold reads a band while (c) writes it
    ("S4", "band"),    # the next round's (a) writes a band the fold reads
])
@pytest.mark.parametrize("shape,split", [((24, 40, 3), (2, 2)), ((17, 24, 3), (2, 2)),
                                         ((96, 12, 17), (5, 3))])
def test_each_cluster_barrier_is_needed(shape, split, dropped, buffer):
    H, W, C = shape
    coils, tables, x0 = _case(H, W, C)
    plan = _plan(1, H, W, C, split)
    assert plan.rounds > 1
    kept = tuple(b for b in BARRIERS if b != dropped)
    tab = torch.as_tensor(_momentum_table("fista", 2))
    with pytest.raises(Hazard, match=buffer):
        model_fista(x0[0], torch.tensor([0.9, 1e-2]), tab, coils, tables, plan, W, kept)
