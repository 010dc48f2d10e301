"""Exact 1-D TV prox of many lines at once (Condat's direct algorithm): the
hand-written CUDA kernel ``csrc/tv_condat.cu`` and its plain PyTorch
version.

No Pallas kernel is replaced: the JAX package runs the algorithm as a
vmapped ``lax.while_loop`` (``rls_tpu/models/tv_condat.py:25``), one
masked rewrite of the whole line per event. The plain version,
:func:`tv_condat_lines_torch`, steps every line's state machine at once,
one event per line per step, until every line is done. The kernel cuts
each line into chunks walked at once, one thread a chunk, and stitches
them exactly where a walker restarts at an (index, sign) that the next
chunk's walker restarted at too (the source's note sets out why that is
exact). Both take the same events in the same order with the same
operations, so on the card they agree bit for bit.

Two routes on the card, picked by :func:`plan_tv_condat`: **resident** —
a CTA stages a tile of lines in shared memory and runs the walk, the
stitch, the chain and the fill there — and **global** — for lines no CTA
holds, the same phases as a launch each on global scratch.
``prox_tv1d_condat.launches`` counts the calls that launched,
``.route_launches`` them by route; :func:`phase_clocks` reads the resident
route's clocks by phase and :func:`walk_counts` the stitches of a call.

The wrapper :func:`prox_tv1d_condat` takes the plain version only for a
tensor on the CPU; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["prox_tv1d_condat", "tv_condat_lines_torch", "prox_tv1d_condat_torch",
           "check_tv_condat", "CondatPlan", "plan_tv_condat", "card_plan",
           "resident_smem_bytes", "global_scratch_bytes", "phase_clocks", "walk_counts"]

ROUTES = ("resident", "global")
# csrc/tv_condat.cu: a walker's saved state (Walker<T>) in bytes by element
# size, the entries of its log, a resident CTA's most threads, a global-route
# block's threads and its most walkers a line
WALKER_BYTES = {4: 56, 8: 72}
LOG = 16
MAX_THREADS = 512
GLOBAL_THREADS = 128
GLOBAL_WALKERS = 8192
# the planner: chunks of CHUNK entries; a resident CTA of as few lines as
# leave about CTAS_PER_SM CTAs an SM (measured on an H100 over chunks of 32,
# 64 and 128 and 1 to 8 lines a CTA, at 4,096 and 16,384 lines of 256, on
# phase 12 (b)'s prox inputs and 16 lines of 65,536)
CHUNK = 64
CTAS_PER_SM = 16
# the resident route's timer (csrc/tv_condat.cu kPhases; walking: phases 1
# and 2, the walks and their extensions; stitching: the chain and the logs
# applied) and the run's counts (kStats)
PHASES = ("staging", "walking", "stitching", "assembly and store", "total")
COUNTS = ("stitched", "stitch distance sum", "stitch distance max", "long", "done",
          "chain events")


def _lam_groups(lam, x, axis):
    """λ as a flat tensor of x's dtype with one value per `group`
    consecutive lines of x viewed as (outer, N, inner): λ is a scalar, or
    carries a prefix of x's axes that ends before `axis` (one λ per
    problem, or per leading index)."""
    lam = torch.as_tensor(lam, dtype=x.dtype, device=x.device)
    lines = x.numel() // x.shape[axis]
    if lam.ndim == 0:
        return lam.reshape(1), lines
    if lam.ndim > axis or tuple(lam.shape) != tuple(x.shape[: lam.ndim]):
        raise ValueError(
            f"prox_tv1d_condat: λ of shape {tuple(lam.shape)} is neither a scalar nor a "
            f"prefix of x's shape {tuple(x.shape)} before axis {axis}")
    return lam.reshape(-1), lines // lam.numel()


def check_tv_condat(x, axis):
    """Raise ValueError naming why the kernel does not take `x` along
    `axis`: not a CUDA tensor, complex, neither float32 nor float64, or a
    line longer than 2³¹ − 1."""
    if x.device.type != "cuda":
        raise ValueError(f"prox_tv1d_condat: the CUDA kernel takes a CUDA tensor, not {x.device}")
    if x.is_complex():
        raise ValueError("prox_tv1d_condat: the exact 1-D TV prox takes real data")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"prox_tv1d_condat: the kernel takes float32 or float64, not {x.dtype}")
    if x.shape[axis] >= 2**31:
        raise ValueError(f"prox_tv1d_condat: a line of {x.shape[axis]} entries is too long")


def tv_condat_lines_torch(c, lam):
    """Plain version: the exact TV prox of each row of `c` (L, N) with its
    own λ (L,), by the state machine of ``rls_tpu/models/tv_condat.py:25-117``
    stepped for every line at once, one event per line per step, until
    every line is done. A segment is written where it starts (its end is
    the next one's start), and the rows are filled forward at the end: a
    segment never covers an entry the machine reads later."""
    L, N = c.shape
    if N == 1:
        return c.clone()
    dt, dev = c.dtype, c.device
    rows = torch.arange(L, device=dev)
    last = N - 1
    val = torch.zeros((L, N + 1), dtype=dt, device=dev)  # column N takes no write
    start = torch.zeros((L, N + 1), dtype=torch.bool, device=dev)
    k = torch.zeros(L, dtype=torch.int64, device=dev)
    k0, km, kp = k.clone(), k.clone(), k.clone()
    vmin, vmax = c[:, 0] - lam, c[:, 0] + lam
    umin, umax = lam.clone(), -lam
    two_l, neg_l = 2 * lam, -lam
    live = torch.ones(L, dtype=torch.bool, device=dev)

    def at(idx):
        return c[rows, torch.clamp(idx, max=last)]

    # the loop's exit reads the card once every `check` steps: a finished
    # line takes no more events, so extra steps change nothing
    check = 1
    while True:
        for _ in range(check):
            bnd = k == last
            cnext = at(k + 1)
            umin_n = (umin + cnext) - vmin
            umax_n = (umax + cnext) - vmax
            # the six events: boundary (neg, pos, done) and main (neg, pos, advance)
            b_neg = bnd & (umin < 0)
            b_pos = bnd & ~b_neg & (umax > 0)
            fin = bnd & ~b_neg & ~b_pos & live
            m_neg = ~bnd & (umin_n < neg_l)
            m_pos = ~bnd & ~m_neg & (umax_n > lam)
            adv = ~bnd & ~m_neg & ~m_pos & live
            neg = (b_neg | m_neg) & live
            pos = (b_pos | m_pos) & live
            b_neg, b_pos, m_neg, m_pos = b_neg & live, b_pos & live, m_neg & live, m_pos & live
            # the segment that closes: [k0, km] at vmin, [k0, kp] at vmax, or
            # [k0, N - 1] at vmin + umin / (k - k0 + 1)
            v_fin = vmin + umin / (k - k0 + 1).to(dt)
            wrote = neg | pos | fin
            col = torch.where(wrote, k0, N)
            val[rows, col] = torch.where(neg, vmin, torch.where(pos, vmax, v_fin))
            start[rows, col] = True
            # the new state
            kn_neg = torch.clamp(km + 1, max=last)
            kn_pos = torch.clamp(kp + 1, max=last)
            c_neg, c_pos = at(kn_neg), at(kn_pos)
            kn_adv = k + 1
            do_min = umin_n >= lam
            do_max = umax_n <= neg_l
            km_adv = torch.where(do_min, kn_adv, km)
            kp_adv = torch.where(do_max, kn_adv, kp)
            vmin_adv = torch.where(do_min, vmin + (umin_n - lam) / (km_adv - k0 + 1).to(dt), vmin)
            vmax_adv = torch.where(do_max, vmax + (umax_n + lam) / (kp_adv - k0 + 1).to(dt), vmax)
            umin_adv = torch.where(do_min, lam, umin_n)
            umax_adv = torch.where(do_max, neg_l, umax_n)

            kn = torch.where(neg, kn_neg, kn_pos)
            k_new = torch.where(neg | pos, kn, torch.where(adv, kn_adv, k))
            km_new = torch.where(neg | m_pos, kn, torch.where(adv, km_adv, km))
            kp_new = torch.where(pos | m_neg, kn, torch.where(adv, kp_adv, kp))
            vmin_new = torch.where(
                neg, c_neg, torch.where(m_pos, c_pos - two_l, torch.where(
                    adv, vmin_adv, torch.where(fin, v_fin, vmin))))
            vmax_new = torch.where(
                pos, c_pos, torch.where(m_neg, c_neg + two_l, torch.where(adv, vmax_adv, vmax)))
            umin_new = torch.where(
                m_neg | m_pos | b_neg, lam, torch.where(
                    b_pos, (c_pos + neg_l) - vmin, torch.where(adv, umin_adv, umin)))
            umax_new = torch.where(
                m_neg | m_pos | b_pos, neg_l, torch.where(
                    b_neg, (c_neg + lam) - vmax, torch.where(adv, umax_adv, umax)))
            k0 = torch.where(neg | pos, kn, k0)
            k, km, kp = k_new, km_new, kp_new
            vmin, vmax, umin, umax = vmin_new, vmax_new, umin_new, umax_new
            live = live & ~fin
        if not bool(live.any()):
            break
        check = min(2 * check, 256)
    idx = torch.where(start[:, :N], torch.arange(N, device=dev), 0).cummax(dim=1).values
    return val.gather(1, idx)


def _as_lines(x, axis):
    """(outer, N, inner) of x along `axis`."""
    N = x.shape[axis]
    inner = math.prod(x.shape[axis + 1:])
    return x.numel() // (N * inner) if N * inner else 0, N, inner


def prox_tv1d_condat_torch(x, lam, axis: int):
    """Plain version of :func:`prox_tv1d_condat`."""
    axis = axis % x.ndim
    lam_g, group = _lam_groups(lam, x, axis)
    moved = x.movedim(axis, -1)
    lines = moved.reshape(-1, x.shape[axis])
    # the lines of moved are ordered (outer, inner), as the kernel's
    lam_l = lam_g.repeat_interleave(group) if lam_g.numel() > 1 else lam_g.expand(lines.shape[0])
    out = tv_condat_lines_torch(lines, lam_l.contiguous())
    return out.reshape(moved.shape).movedim(-1, axis)


def _align16(n):
    return -(-n // 16) * 16


def _walkers_bytes(W, itemsize):
    """W walkers and their logs (index, value, tag of LOG restarts each)."""
    return (_align16(W * WALKER_BYTES[itemsize]) + _align16(W * LOG * 4)
            + _align16(W * LOG * itemsize) + _align16(W * LOG))


def _mask_bytes(lines, G):
    """Two bitmasks of G bits (the irregular and the chained walkers) a
    line, in 32-bit words."""
    return _align16(2 * lines * (-(-G // 32)) * 4)


def resident_smem_bytes(L, N, G, itemsize):
    """Shared memory of a resident CTA, as ``resident_bytes`` in
    csrc/tv_condat.cu counts it: L lines of c and of the values (rows of
    (N + N // 32) | 1 slots: a pad after every 32 entries), their tags (a
    byte a slot), two bitmasks, L·G walkers and their logs, each piece
    16-byte aligned."""
    row = (N + N // 32) | 1
    return (2 * _align16(L * row * itemsize) + _align16(L * row) + _mask_bytes(L, G)
            + _walkers_bytes(L * G, itemsize))


def global_scratch_bytes(lines, N, G, itemsize):
    """Global scratch of the global route, as ``global_bytes`` in
    csrc/tv_condat.cu counts it: the tags, the bitmasks, the values, the
    walkers and their logs."""
    return (_align16(lines * N) + _mask_bytes(lines, G) + _align16(lines * N * itemsize)
            + _walkers_bytes(lines * G, itemsize))


@dataclasses.dataclass(frozen=True)
class CondatPlan:
    """A launch of the Condat kernel: its route, the chunk of entries a
    walker starts in and the walkers a line; on the resident route the
    lines a CTA, its threads and shared memory; the CTAs (the global route:
    of its walker phases) and the global route's scratch bytes."""

    route: str
    chunk: int
    walkers: int
    lines_per_cta: int
    threads: int
    smem: int
    ctas: int
    scratch: int


def _pow2(n):
    return 1 << max(0, math.ceil(math.log2(max(n, 1))))


def plan_tv_condat(lines, N, dtype, sms=132, smem_max=232448, route=None, chunk=None,
                   lines_per_cta=None):
    """The plan of one call on `lines` lines of N entries of `dtype` on a
    card of `sms` SMs with `smem_max` bytes of shared memory a block.

    Chunks of CHUNK entries. The resident route takes a line whose G =
    ⌈N / chunk⌉ walkers fit one CTA (raising the chunk to a power of two
    that makes G ≤ MAX_THREADS) and whose tile of one line fits `smem_max`;
    a CTA holds ⌈lines / (sms · CTAS_PER_SM)⌉ lines, fewer where their
    threads or their tile (half of `smem_max`) do not fit, at least one. The
    global route takes the rest, at most GLOBAL_WALKERS walkers a line (the
    chunk raised to a power of two that keeps to it). `route`, `chunk`
    and `lines_per_cta` force a plan (timing and tests); a forced plan that
    does not fit raises ValueError."""
    if route not in (None, *ROUTES):
        raise ValueError(f"plan_tv_condat: no route {route!r}; one of {ROUTES}")
    if lines < 1 or N < 1:
        raise ValueError(f"plan_tv_condat: no plan for {lines} lines of {N} entries")
    if chunk is not None and chunk < 1:
        raise ValueError(f"plan_tv_condat: a chunk of {chunk} entries")
    es = torch.empty((), dtype=dtype).element_size()
    if es not in WALKER_BYTES:
        raise ValueError(f"plan_tv_condat: the kernel takes float32 or float64, not {dtype}")
    base = chunk or CHUNK
    if route != "global":
        rc = base
        if chunk is None and -(-N // rc) > MAX_THREADS:
            rc = _pow2(-(-N // MAX_THREADS))
        G = -(-N // rc)
        if G <= MAX_THREADS and resident_smem_bytes(1, N, G, es) <= smem_max:
            L = lines_per_cta or max(1, min(-(-lines // (sms * CTAS_PER_SM)), lines))
            L = min(L, MAX_THREADS // G)
            while L > 1 and resident_smem_bytes(L, N, G, es) > (
                    smem_max if lines_per_cta else smem_max // 2):
                L -= 1
            if lines_per_cta and L != lines_per_cta:
                raise ValueError(f"plan_tv_condat: {lines_per_cta} lines of {N} a CTA do not fit")
            return CondatPlan("resident", rc, G, L, L * G, resident_smem_bytes(L, N, G, es),
                              -(-lines // L), 0)
        if route == "resident":
            raise ValueError(f"plan_tv_condat: no resident plan holds a line of {N} {dtype} "
                             f"entries in chunks of {rc} ({G} walkers, {smem_max} bytes)")
    gc = base
    if chunk is None and -(-N // gc) > GLOBAL_WALKERS:
        gc = _pow2(-(-N // GLOBAL_WALKERS))
    G = -(-N // gc)
    if G > GLOBAL_WALKERS:
        raise ValueError(f"plan_tv_condat: {G} walkers a line past the global route's "
                         f"{GLOBAL_WALKERS} (chunks of {gc})")
    return CondatPlan("global", gc, G, 0, GLOBAL_THREADS, 0, -(-lines * G // GLOBAL_THREADS),
                      global_scratch_bytes(lines, N, G, es))


def card_plan(lines, N, dtype, device, route=None, chunk=None, lines_per_cta=None):
    """:func:`plan_tv_condat` on the card `device`."""
    from .. import _build

    sms, smem_max = _build.device_limits(device.index or 0)
    return plan_tv_condat(lines, N, dtype, sms, smem_max, route, chunk, lines_per_cta)


def _prox(x, lam, axis, route=None, chunk=None, lines_per_cta=None, prof=None, counts=None):
    """`prox_tv1d_condat`, its plan forced where `route`, `chunk` or
    `lines_per_cta` is given (the timing mode and the card tests only)."""
    axis = axis % x.ndim
    if x.device.type == "cpu":
        return prox_tv1d_condat_torch(x, lam, axis)
    check_tv_condat(x, axis)
    from .. import _build

    xc = x.contiguous()
    lam_g, group = _lam_groups(lam, xc, axis)
    lam_g = lam_g.contiguous()
    outer, N, inner = _as_lines(xc, axis)
    out = torch.empty_like(xc)
    if xc.numel() == 0:
        return out
    plan = card_plan(outer * inner, N, xc.dtype, xc.device, route, chunk, lines_per_cta)
    glob = plan.route == "global"
    scratch = torch.empty(plan.scratch, dtype=torch.uint8, device=xc.device) if glob else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.load_library()
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.tv_condat_launch(
            xc.data_ptr(), lam_g.data_ptr(), out.data_ptr(), outer, N, inner, group,
            int(xc.dtype == torch.float64), int(glob), plan.chunk, plan.lines_per_cta,
            plan.scratch if glob else plan.smem, ptr(scratch), ptr(prof), ptr(counts), stream)
    _build.check(code, f"prox_tv1d_condat ({tuple(x.shape)} along axis {axis}, {plan})")
    prox_tv1d_condat.launches += 1
    prox_tv1d_condat.route_launches[plan.route] += 1
    return out


def prox_tv1d_condat(x, lam, axis: int):
    """Exact TV prox of every line of the real tensor `x` along `axis`,
    argmin_u ½‖u − c‖² + λ TV(u) for each line c. λ is a scalar or carries a
    prefix of x's axes before `axis` (one λ per problem). On a CUDA tensor
    one call of ``csrc/tv_condat.cu`` (float32 or float64) on the route of
    :func:`plan_tv_condat`; on a CPU tensor the plain version.
    ``prox_tv1d_condat.launches`` counts the calls that launched the
    kernel, ``.route_launches`` them by route (a call on the global route
    enqueues six kernels)."""
    return _prox(x, lam, axis)


prox_tv1d_condat.launches = 0
prox_tv1d_condat.route_launches = {"resident": 0, "global": 0}


def phase_clocks(x, lam, axis, chunk=None, lines_per_cta=None):
    """One call of `prox_tv1d_condat` on the resident route with its phase
    timer on: {phase: SM clocks that CTA 0 spent in it} (``PHASES``; the
    call is counted). Raises where no resident plan fits."""
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=x.device)
    _prox(x, lam, axis, route="resident", chunk=chunk, lines_per_cta=lines_per_cta, prof=prof)
    return dict(zip(PHASES, prof.tolist()))


def walk_counts(x, lam, axis, route=None, chunk=None, lines_per_cta=None):
    """One call of `prox_tv1d_condat` (its plan forced as for `_prox`; the
    call is counted) with the run's counts: {count: value} (``COUNTS``: the
    walkers that stitched, the sum and the largest of their stitch
    distances past their chunk's end, the walkers that stopped long and
    that reached the line's end, the segments the chain closed itself)."""
    counts = torch.zeros(len(COUNTS), dtype=torch.int64, device=x.device)
    _prox(x, lam, axis, route=route, chunk=chunk, lines_per_cta=lines_per_cta, counts=counts)
    return dict(zip(COUNTS, counts.tolist()))
