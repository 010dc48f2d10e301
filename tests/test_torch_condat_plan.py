"""The exact 1-D Condat TV kernel's planner and a Python model of its chunked
walk (``rls_tpu_torch/csrc/tv_condat.cu``), on the CPU.

The model runs the kernel's four phases on numpy scalars of the line's
dtype, walker by walker: (1) each walker walks its own chunk from its start
state (walker 0 the line's own, walker j > 0 the state after a negative
jump to the chunk's start), tagging its restarts; (2) each walker walks on
into the next chunk until a restart meets that chunk's walker's tag of the
same index AND sign, clearing and tagging as it goes, or stops long; (3) one
pass a line follows the true walk through the stitched walkers and walks a
long one on from its saved state until it matches a later tag; (4) the
fill forward from the tagged starts. It is held bit for bit to the plain
version ``tv_condat_lines_torch`` (and through it to the JAX state
machine, checked on a few lines here too, float32 and x64) on lines of 1,
2, 3, 31, 32, 33, 256 and 1,000 entries, chunks of 1, 2, 32 and longer than
the line, λ = 0, tiny and huge, constant lines, ramps, alternating ±1 and
shortened versions of chip_smoke.py's long signals. A variant that
stitches on the index alone is caught by a line this file builds. The
planner: every plan fits the card's shared memory, its walker counts,
float64's smaller window, forced plans and refusals, with the kernel's
constants read from the .cu."""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rls_tpu.models import tv_condat as jcondat
from rls_tpu_torch.kernels import tv_condat as kc

CU = (Path(__file__).resolve().parents[1] / "rls_tpu_torch" / "csrc" / "tv_condat.cu").read_text()

# the model's events, tags and states (csrc/tv_condat.cu)
ADV, NEG, POS, BND, DONE = 0, 1, 2, 3, 4
TAG_START, EXT = 3, 4
ST_DONE, ST_LONG, ST_PENDING, ST_STITCHED = 0, 1, 2, 3


class Walk:
    """A walker's state and bookkeeping, as Walker<T>."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def copy(self):
        return Walk(**self.__dict__)


def step(w, c, l, two_l, last):
    """One event of the machine: (event, closed segment's start, its value)."""
    dt = type(l)
    if w.k == last:
        seg = w.k0
        if w.umin < 0:
            v = w.vmin
            kn = min(w.km + 1, last)
            w.vmin = c[kn]
            w.umin = l
            w.umax = (w.vmin + w.umin) - w.vmax
            w.k = w.k0 = w.km = kn
            return BND, seg, v
        if w.umax > 0:
            v = w.vmax
            kn = min(w.kp + 1, last)
            w.vmax = c[kn]
            w.umax = -l
            w.umin = (w.vmax + w.umax) - w.vmin
            w.k = w.k0 = w.kp = kn
            return BND, seg, v
        return DONE, seg, w.vmin + w.umin / dt(w.k - w.k0 + 1)
    cnext = c[w.k + 1]
    umin_n = (w.umin + cnext) - w.vmin
    umax_n = (w.umax + cnext) - w.vmax
    if umin_n < -l:
        seg, v = w.k0, w.vmin
        kn = w.km + 1
        w.vmin = c[kn]
        w.vmax = w.vmin + two_l
        w.umin, w.umax = l, -l
        w.k = w.k0 = w.km = w.kp = kn
        return NEG, seg, v
    if umax_n > l:
        seg, v = w.k0, w.vmax
        kn = w.kp + 1
        w.vmax = c[kn]
        w.vmin = w.vmax - two_l
        w.umin, w.umax = l, -l
        w.k = w.k0 = w.km = w.kp = kn
        return POS, seg, v
    kn = w.k + 1
    if umin_n >= l:
        w.km = kn
        w.vmin = w.vmin + (umin_n - l) / dt(w.km - w.k0 + 1)
        w.umin = l
    else:
        w.umin = umin_n
    if umax_n <= -l:
        w.kp = kn
        w.vmax = w.vmax + (umax_n + l) / dt(w.kp - w.k0 + 1)
        w.umax = -l
    else:
        w.umax = umax_n
    w.k = kn
    return ADV, None, None


def tag_of(ev):
    return TAG_START if ev == BND else ev


LOG = 16  # csrc/tv_condat.cu kLog


class Line:
    """One line's c, values and tags, and how a restart's tag matches."""

    def __init__(self, c, index_only):
        self.c = c
        self.val = np.zeros(len(c), c.dtype)
        self.tag = np.zeros(len(c), np.uint8)
        self.index_only = index_only

    def joins(self, kn, tg):
        """csrc/tv_condat.cu joins: a mid-line restart meets a tag of its
        sign (the broken variant: any mid-line restart's tag)."""
        at = int(self.tag[kn])
        if tg == TAG_START:
            return False
        return at in (1, 2) if self.index_only else at == tg


def start(ln, l, two_l, s, N):
    c = ln.c
    w = Walk(k=s, k0=s, km=s, kp=s, umin=l, umax=-l, status=ST_PENDING, n=0, chained=0,
             pk=-1, ptag=0, stop=-1, log=[])
    if s == 0:
        w.vmin, w.vmax = c[0] - l, c[0] + l
        ln.tag[0] = TAG_START
        if N == 1:
            ln.val[0] = c[0]
            w.status = ST_DONE
    else:
        w.vmin = c[s]
        w.vmax = w.vmin + two_l
        ln.tag[s] = NEG
    return w


def walk_own(w, ln, l, two_l, last, e):
    """Phase 1."""
    if w.status == ST_DONE:
        w.stop = last + 1
        return
    while True:
        ev, seg, v = step(w, ln.c, l, two_l, last)
        if ev == ADV:
            continue
        ln.val[seg] = v
        if ev == DONE:
            w.status, w.stop = ST_DONE, last + 1
            return
        if w.k0 >= e:
            w.status, w.pk, w.ptag = ST_PENDING, w.k0, tag_of(ev)
            return
        ln.tag[w.k0] = tag_of(ev)


def extend(w, ln, l, two_l, last, e):
    """Phase 2, reading the tags only: the stitch distance past e, or -1."""
    if w.status != ST_PENDING:
        return -1
    while True:
        if ln.joins(w.pk, w.ptag):
            w.status, w.stop = ST_STITCHED, w.pk
            return w.pk - e
        if len(w.log) == LOG:
            w.status, w.stop = ST_LONG, w.log[-1][0] + 1
            return -1
        w.log.append([w.pk, w.ptag, None])
        while True:
            ev, seg, v = step(w, ln.c, l, two_l, last)
            if ev != ADV:
                break
        assert seg == w.log[-1][0]
        w.log[-1][2] = v
        if ev == DONE:
            w.status, w.stop = ST_DONE, last + 1
            return -1
        w.pk, w.ptag = w.k0, tag_of(ev)


def chain(ws, ln, l, two_l, last, C):
    """Phase 3: marks the walkers on the true walk (a run of regular
    walkers, each stitched into the next chunk, to the first irregular one
    r, as the kernel's bitmasks do); the segments it closed itself."""
    events, j, G = 0, 0, len(ws)
    regular = [w.status == ST_STITCHED and w.stop // C == i + 1 for i, w in enumerate(ws)]
    while True:
        r = next(i for i in range(j, G) if not regular[i])  # the last walker is done
        for i in range(j, r + 1):
            ws[i].chained = 1
        st = ws[r].status
        if st == ST_DONE:
            return events
        if st == ST_STITCHED:
            j = ws[r].stop // C
            continue
        w = ws[r].copy()
        last_pos = w.log[-1][0]
        kn, tg = w.pk, w.ptag
        while True:
            ln.tag[last_pos + 1:max(kn, last_pos + 1)] = 0
            if ln.joins(kn, tg):
                j = kn // C
                break
            ln.tag[kn] = tg
            last_pos = kn
            while True:
                ev, seg, v = step(w, ln.c, l, two_l, last)
                if ev != ADV:
                    break
            events += 1
            ln.val[seg] = v
            if ev == DONE:
                ln.tag[last_pos + 1:last + 1] = 0
                return events
            kn, tg = w.k0, tag_of(ev)


def apply(w, ln, e):
    """Phase 3b: a marked walker's log over [e, its stop)."""
    if not w.chained:
        return
    ln.tag[e:max(e, w.stop)] = 0
    for pos, tg, v in w.log:
        ln.tag[pos] = tg
        ln.val[pos] = v


def model_line(c, lam, chunk, index_only=False, counts=None):
    """The kernel's phases on one line c (a numpy array) with its λ in
    chunks of `chunk`: its output, and the run's counts added to `counts`
    (csrc/tv_condat.cu kStats)."""
    N = len(c)
    dt = c.dtype.type
    l = dt(lam)
    two_l = dt(2) * l
    last = N - 1
    G = -(-N // chunk)
    ln = Line(c, index_only)
    region = [(j * chunk, min(j * chunk + chunk, N)) for j in range(G)]
    ws = [start(ln, l, two_l, s, N) for s, _ in region]
    for w, (s, e) in zip(ws, region):
        walk_own(w, ln, l, two_l, last, e)
    tags = ln.tag.copy()
    for w, (s, e) in zip(ws, region):
        dist = extend(w, ln, l, two_l, last, e)
        if counts is not None:
            if w.status == ST_STITCHED:
                counts["stitched"] += 1
                counts["stitch distance sum"] += dist
                counts["stitch distance max"] = max(counts["stitch distance max"], dist)
            counts["long"] += w.status == ST_LONG
            counts["done"] += w.status == ST_DONE
    assert np.array_equal(tags, ln.tag)  # phase 2 writes no tag
    events = chain(ws, ln, l, two_l, last, chunk)
    if counts is not None:
        counts["chain events"] += events
    for w, (s, e) in zip(ws, region):
        apply(w, ln, e)
    lastp = []
    for s, e in region:
        tagged = np.flatnonzero(ln.tag[s:e])
        lastp.append(s + int(tagged[-1]) if len(tagged) else -1)
    out = np.empty_like(c)
    for j, (s, e) in enumerate(region):
        cur = next((p for p in reversed(lastp[:j]) if p >= 0), 0)
        for p in range(s, e):
            if ln.tag[p]:
                cur = p
            out[p] = ln.val[cur]
    return out


def model(C, lam, chunk, index_only=False, counts=None):
    return np.stack([model_line(c, lv, chunk, index_only, counts) for c, lv in zip(C, lam)])


def plain(C, lam):
    return kc.tv_condat_lines_torch(torch.from_numpy(C), torch.from_numpy(lam)).numpy()


def long_signals(P, L, seed=23):
    """chip_smoke.py condat_long_input at P lines of L entries:
    piecewise-constant lines (a jump of N(0, 1) with probability 2e-3 an
    entry) plus noise of σ 0.1, one λ per line in [0.05, 0.5]."""
    rng = np.random.default_rng(seed)
    jumps = rng.uniform(size=(P, L)) < 2e-3
    x = np.cumsum(rng.normal(size=(P, L)) * jumps, axis=1) + 0.1 * rng.normal(size=(P, L))
    return x, rng.uniform(0.05, 0.5, size=P)


def lines_of(kind, N, dtype, seed=0):
    """Seeded lines (6, N) of a kind and their λs: noise (λ from 0 to huge),
    piecewise constant plus noise, constant, ramps, alternating ±1."""
    rng = np.random.default_rng(seed + N)
    if kind == "noise":
        C = rng.normal(size=(6, N))
        lam = np.array([0.0, 1e-6, 0.05, 0.3, 2.0, 1e4])
    elif kind == "phantom":
        C, lam = long_signals(6, N, seed=seed + 7)
        C = C + np.repeat(rng.normal(size=(6, -(-N // 17))), 17, axis=1)[:, :N]
    elif kind == "constant":
        C = np.repeat(rng.normal(size=(6, 1)), N, axis=1)
        lam = np.array([0.0, 1e-6, 0.05, 0.3, 2.0, 1e4])
    elif kind == "ramp":
        C = np.arange(N)[None, :] * rng.normal(size=(6, 1))
        lam = np.array([0.0, 1e-6, 0.05, 0.3, 2.0, 1e4])
    else:  # alternating ±1
        C = np.tile(np.where(np.arange(N) % 2 == 0, 1.0, -1.0), (6, 1)) * np.array(
            [1, 1, 1, 1, -1, 1])[:, None]
        lam = np.array([0.0, 1e-6, 0.5, 0.999, 1.0, 1e4])
    return C.astype(dtype), lam.astype(dtype)


KINDS = ("noise", "phantom", "constant", "ramp", "alternating")
SIZES = (1, 2, 3, 31, 32, 33, 256)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("N", SIZES)
def test_model_is_bit_for_bit_the_plain_version(dtype, kind, N):
    """The chunked walk, stitched on (index, sign), at chunks of 1, 2, 32 and
    longer than the line: bit for bit the plain version."""
    C, lam = lines_of(kind, N, dtype)
    want = plain(C, lam)
    for chunk in (1, 2, 32, N + 5):
        np.testing.assert_array_equal(model(C, lam, chunk), want, err_msg=f"chunk {chunk}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_model_on_long_signals_and_lines_of_1000(dtype):
    """chip_smoke.py's long signals shortened to 4,096 entries (chunks of 64,
    512 and 4,096) and noisy lines of 1,000 (chunks of 7, 32 and 100): bit
    for bit the plain version, and the walkers stitch: most in their next
    chunk, a few long, the chain walking a small share of the events."""
    C, lam = long_signals(4, 4096)
    C, lam = C.astype(dtype), lam.astype(dtype)
    want = plain(C, lam)
    for chunk in (64, 512, 4096):
        counts = dict.fromkeys(kc.COUNTS, 0)
        np.testing.assert_array_equal(model(C, lam, chunk, counts=counts), want,
                                      err_msg=f"chunk {chunk}")
        G = -(-4096 // chunk)
        assert counts["stitched"] + counts["long"] + counts["done"] == 4 * G
        if chunk == 64:
            assert counts["stitched"] >= 0.9 * 4 * (G - 1), counts
            assert counts["chain events"] < 0.02 * 4 * 4096, counts
    C, lam = lines_of("noise", 1000, dtype, seed=3)
    want = plain(C, lam)
    for chunk in (7, 32, 100):
        np.testing.assert_array_equal(model(C, lam, chunk), want, err_msg=f"chunk {chunk}")


def _jax_line(c, lam, x64):
    with jax.enable_x64(x64):
        return np.asarray(jax.jit(jcondat.tv_denoise_1d_condat)(jnp.asarray(c), lam))


@pytest.mark.parametrize("dtype,x64", [("float32", False), ("float64", True)])
def test_model_matches_jax_on_a_few_lines(dtype, x64):
    """A few lines of 64 through the JAX state machine and the model (chunks
    of 8): bit for bit."""
    C, lam = lines_of("phantom", 64, dtype, seed=5)
    C2, lam2 = lines_of("noise", 64, dtype, seed=5)
    C, lam = np.concatenate([C[:3], C2[:3]]), np.concatenate([lam[:3], lam2[:3]])
    want = np.stack([_jax_line(c, lv, x64) for c, lv in zip(C, lam)])
    np.testing.assert_array_equal(model(C, lam, 8), want)


def _index_only_catch():
    """A seeded noisy line of 64 and a chunk on which stitching on the index
    alone gives a wrong output: the first of default_rng(11)'s draws."""
    rng = np.random.default_rng(11)
    for _ in range(400):
        c = rng.normal(size=(1, 64)).astype(np.float32)
        lam = np.array([rng.uniform(0.05, 1.0)], np.float32)
        for chunk in (2, 4, 8):
            if not np.array_equal(model(c, lam, chunk, index_only=True), plain(c, lam)):
                return c, lam, chunk
    return None


def test_stitching_on_the_index_alone_is_caught():
    """The variant that matches a restart on its index alone (either sign)
    is not exact: a seeded line catches it, where the (index, sign) model
    holds bit for bit."""
    found = _index_only_catch()
    assert found is not None, "no line caught the index-only stitch"
    c, lam, chunk = found
    np.testing.assert_array_equal(model(c, lam, chunk), plain(c, lam))
    assert not np.array_equal(model(c, lam, chunk, index_only=True), plain(c, lam))


def test_model_counts_a_line_that_stitches_nowhere():
    """λ past the line's variation: no restart, every walker walks to the
    line's end in phase 1 (walker 0's walk is the sequential one), and the
    output is the line's single segment."""
    C, lam = lines_of("noise", 256, "float32")
    C, lam = C[-1:], lam[-1:]
    counts = dict.fromkeys(kc.COUNTS, 0)
    got = model(C, lam, 32, counts=counts)
    np.testing.assert_array_equal(got, plain(C, lam))
    assert len(np.unique(got)) == 1
    assert counts["stitched"] == 0 and counts["done"] == 8 and counts["chain events"] == 0, counts


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_model_carries_a_full_log_exactly(dtype):
    """Ramps in chunks of 1 and 2: walkers whose log fills before they meet
    another's restart stop long, and the chain goes on from their pending
    restarts, bit for bit the plain version."""
    C, lam = lines_of("ramp", 64, dtype)
    for chunk in (1, 2):
        counts = dict.fromkeys(kc.COUNTS, 0)
        np.testing.assert_array_equal(model(C, lam, chunk, counts=counts), plain(C, lam))
        assert counts["long"] > 0 and counts["chain events"] > 0, counts


# ---------------------------------------------------------------- the planner

def _cu_int(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CU)
    assert m, name
    return int(m.group(1))


def test_constants_match_the_kernel_source():
    """The planner's constants are the .cu's: a walker is four T and ten
    ints (the last, `lastp`, its chunk's last start), its log's entries, the
    most threads of a resident CTA, a global block's threads and most
    walkers a line, the timer's phases and the counts; and the model's log
    is the kernel's."""
    body = re.search(r"struct Walker \{(.*?)\};", CU, re.S).group(1)
    n_t = sum(len(line.split(",")) for line in re.findall(r"^\s*T ([^;/]*);", body, re.M))
    n_i = sum(len(line.split(",")) for line in re.findall(r"^\s*int ([^;/]*);", body, re.M))
    assert (n_t, n_i) == (4, 10)
    assert kc.WALKER_BYTES == {4: 4 * 4 + 4 * n_i, 8: 4 * 8 + 4 * n_i}
    assert kc.LOG == LOG == _cu_int("kLog")
    assert kc.MAX_THREADS == _cu_int("kMaxThreads")
    assert kc.GLOBAL_THREADS == _cu_int("kGlobalThreads")
    assert kc.GLOBAL_WALKERS == _cu_int("kChainWalkers")
    assert len(kc.PHASES) == _cu_int("kPhases")
    assert len(kc.COUNTS) == _cu_int("kStats")
    assert "return (N + (N >> 5)) | 1;" in CU  # a resident row: (N + N / 32) | 1 slots


SHAPES = [(4096, 256), (16384, 256), (16, 65536), (1, 1), (3, 2), (2000, 37), (5, 3000),
          (1, 12000), (1, 20000), (1, 30000), (10**6, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lines,N", SHAPES)
def test_every_plan_fits_and_counts_its_walkers(lines, N, dtype):
    """Every plan fits 227 KB of shared memory (resident) with at most 512
    threads a CTA, its walkers cover the line in chunks, and its CTAs cover
    the lines (resident) or the walkers (global)."""
    es = torch.empty((), dtype=dtype).element_size()
    p = kc.plan_tv_condat(lines, N, dtype)
    assert p.walkers == math.ceil(N / p.chunk)
    if p.route == "resident":
        assert p.smem == kc.resident_smem_bytes(p.lines_per_cta, N, p.walkers, es) <= 232448
        assert p.threads == p.lines_per_cta * p.walkers <= 512
        assert p.ctas == math.ceil(lines / p.lines_per_cta)
        assert p.lines_per_cta == 1 or p.smem <= 232448 // 2
    else:
        assert p.scratch == kc.global_scratch_bytes(lines, N, p.walkers, es)
        assert p.ctas == math.ceil(lines * p.walkers / 128)
        with pytest.raises(ValueError, match="no resident plan"):  # only where none fits
            kc.plan_tv_condat(lines, N, dtype, route="resident")


def test_the_main_shapes_plans():
    """The main path's 4,096 lines of 256: chunks of 64, 4 walkers a line,
    2 lines (8 threads) a CTA, 2,048 CTAs (~16 an SM); 64 × 256² (16,384
    lines): 8 lines a CTA; the long signals (16 × 65,536): the global route,
    chunks of 64."""
    p = kc.plan_tv_condat(4096, 256, torch.float32)
    assert (p.route, p.chunk, p.walkers, p.lines_per_cta, p.ctas) == ("resident", 64, 4, 2, 2048)
    p = kc.plan_tv_condat(16384, 256, torch.float32)
    assert (p.route, p.chunk, p.lines_per_cta, p.ctas) == ("resident", 64, 8, 2048)
    p = kc.plan_tv_condat(16, 65536, torch.float32)
    assert (p.route, p.chunk, p.walkers) == ("global", 64, 1024)


def test_float64_halves_the_resident_window():
    """The longest line a resident CTA holds: at chunks of 512 (walkers and
    logs a small share) float64's is about half float32's; at the planner's
    own chunks it is smaller too."""
    def window(dtype, chunk=None):
        def fits(n):
            return kc.plan_tv_condat(1, n, dtype, chunk=chunk).route == "resident"

        lo, hi = 1, 2
        while fits(hi):
            lo, hi = hi, 2 * hi
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if fits(mid) else (lo, mid)
        return lo

    w32, w64 = window(torch.float32, 512), window(torch.float64, 512)
    assert 16384 < w32 < 32768 and 0.45 < w64 / w32 < 0.6, (w32, w64)
    assert window(torch.float64) < window(torch.float32)


def test_forced_plans_and_refusals():
    """A forced route, chunk and lines a CTA are taken as given; a forced
    resident plan that does not fit, a global plan past GLOBAL_WALKERS
    walkers a line, an unknown route, an empty shape, a chunk below 1 and
    another dtype raise ValueError."""
    p = kc.plan_tv_condat(4096, 256, torch.float32, route="global", chunk=64)
    assert (p.route, p.chunk, p.walkers) == ("global", 64, 4)
    p = kc.plan_tv_condat(4096, 256, torch.float32, chunk=16, lines_per_cta=4)
    assert (p.route, p.walkers, p.lines_per_cta, p.threads) == ("resident", 16, 4, 64)
    p = kc.plan_tv_condat(5, 100, torch.float32, chunk=1000)
    assert (p.walkers, p.lines_per_cta) == (1, 1)
    with pytest.raises(ValueError, match="no resident plan"):
        kc.plan_tv_condat(16, 65536, torch.float32, route="resident")
    with pytest.raises(ValueError, match="no resident plan"):
        kc.plan_tv_condat(1, 3000, torch.float32, route="resident", chunk=1)
    with pytest.raises(ValueError, match="do not fit"):
        kc.plan_tv_condat(4096, 256, torch.float32, lines_per_cta=200)
    with pytest.raises(ValueError, match="past the global route's"):
        kc.plan_tv_condat(1, 10**6, torch.float32, chunk=32)
    p = kc.plan_tv_condat(1, 10**6, torch.float32)  # the chunk raised to keep to it
    assert (p.route, p.chunk, p.walkers) == ("global", 128, 7813)
    assert kc.plan_tv_condat(1, 10**5, torch.float32).chunk == 64
    with pytest.raises(ValueError, match="no route"):
        kc.plan_tv_condat(4, 8, torch.float32, route="cluster")
    with pytest.raises(ValueError, match="no plan"):
        kc.plan_tv_condat(0, 8, torch.float32)
    with pytest.raises(ValueError, match="a chunk of 0"):
        kc.plan_tv_condat(4, 8, torch.float32, chunk=0)
    with pytest.raises(ValueError, match="float32 or float64"):
        kc.plan_tv_condat(4, 8, torch.float16)
