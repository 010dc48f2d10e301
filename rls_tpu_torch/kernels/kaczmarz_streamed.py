"""The Kaczmarz row recurrence as ONE launch per call: a sweep
(``kaczmarz_sweep``) or the whole multi-sweep solve (``kaczmarz_solve``),
both on the hand-written CUDA kernel ``csrc/kaczmarz.cu``, with their
plain PyTorch version.

Counterpart of ``rls_tpu/kernels/kaczmarz_pallas.py``:
``kaczmarz_sweep_pallas`` (:72-110), ``kaczmarz_solve_pallas``
(:206-323), ``check_kaczmarz_streamed`` (:333-413) and
``solve_kaczmarz_streamed`` (:423-595). A sweep is the solve with one
sweep of a reused index list, so one kernel serves both. For every
visited row i of every problem (an index −1 is skipped):

    τ     = aᵢ·x                       (unconjugated)
    α     = dᵢ((uᵢ − τ) − ε·vlᵢ)
    x    += α·conj(aᵢ)
    vlᵢ  += α·ε

and after each sweep the Positive projection (max(x, 0), and for complex
x the imaginary part zeroed) or the Real one (the imaginary part zeroed).
Rows come from a dense A (L = n entries) or a ``PaddedCSROperator``
(L = k_max entries, read in place: ``rls_tpu`` densifies the visited rows
instead, so the dot's summation order differs); complex data rides as
split re / im planes. A real A with a complex b decouples into 2K real
problems, as ``rls_tpu`` solves it.

Numerics, the same in both versions: each real dot of a row is summed in
float64 from the f32 products and rounded to f32 once; the scalars and the
updates are separate f32 operations. The composed ``Kaczmarz.step`` sums
the dot in f32 and differs from both by f32 rounding.

Two routes on the card, picked by :func:`plan_kaczmarz`: **warp** — one
warp per problem, g problems per CTA sharing each row that a producer warp
stages ahead into a ring of R shared-memory slots, no block barrier in a
row step: dense rows whose x fits a warp's registers and CSR rows of at
most `WARP_MAX_L` entries — and **block** — one CTA of 256 threads per
problem, for wider rows, which one warp should not carry alone. ``kaczmarz_sweep.route_launches`` and
``kaczmarz_solve.route_launches`` count the launches by route;
:func:`phase_clocks` reads the warp route's clocks by phase.

Not carried over: the TPU's row gather in visit order, its sweep chunking
and its SMEM / HBM / VMEM gates (:38-47, :326-413, :503-587). The one
limit of the CUDA kernel is the card's: x lives in a block's shared
memory, so n ≤ `MAX_N_REAL` (half that complex).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.prox import PositiveRegularization, RealRegularization
from ..models.solvers.kaczmarz import Kaczmarz
from ..ops.base import DenseOperator
from ..ops.sparse import PaddedCSROperator

__all__ = [
    "kaczmarz_sweep",
    "kaczmarz_solve",
    "kaczmarz_solve_torch",
    "KaczmarzPlan",
    "plan_kaczmarz",
    "warp_smem_bytes",
    "card_plan",
    "phase_clocks",
    "check_kaczmarz_streamed",
    "solve_kaczmarz_streamed",
    "solver_operands",
    "sweep_projection",
    "MAX_N_REAL",
]

PROXES = ("none", "positive", "real")
# the block route's x in dynamic shared memory: 227 KiB a block, less the
# kernel's own 360 B
MAX_N_REAL = (232448 - 512) // 4
ROUTES = ("warp", "block")
# the warp route: at most MAX_GROUPS problems (consumer warps) a CTA, a ring
# of at most RING row slots, x in registers up to 32·REG_LANES[nc] entries
# (x[l + 32k] in lane l); it takes dense rows that fit there and CSR rows
# of at most WARP_MAX_L entries (the crossover measured on an H100,
# PERF.md §6)
MAX_GROUPS = 16
RING = 8
REG_LANES = {1: 16, 2: 8}
WARP_MAX_L = 512
# the phases of the warp route's timer (csrc/kaczmarz.cu kWarpPhases)
WARP_PHASES = ("ring wait", "dot", "butterfly", "alpha", "axpy", "projection", "total")


def _dsum(a, b):
    """Σ a·b over the last axis in float64, rounded to b's dtype."""
    return (a.double() * b.double()).sum(dim=-1).to(b.dtype)


def kaczmarz_solve_torch(rows, idx, x0, vl0, u, denom, eps, sweeps: int, reuse: bool,
                         prox="none", cols=None):
    """Plain version. `rows` (nc, m, L): the rows' real (and imaginary)
    parts, dense (L = n) or padded CSR values with `cols` (m, L); `idx`
    (reuse ? 1 : sweeps, S), −1 = skip; x0 (P, nc, n); vl0, u (P, nc, m);
    denom (P, m); eps (P,). The problems are batched inside each row step.
    Returns (x, vl) in x0's dtype."""
    nc = rows.shape[0]
    x, vl = x0.clone(), vl0.clone()
    order = idx.tolist()
    ar = rows[0]
    ai = rows[1] if nc == 2 else None
    cl = None if cols is None else cols.long()
    for t in range(sweeps):
        for i in order[0 if reuse else t]:
            if i < 0:
                continue
            a = ar[i]
            b = None if ai is None else ai[i]
            c = slice(None)
            if cl is not None:  # the row's nonzero entries (padding does not write)
                keep = (a != 0) if b is None else ((a != 0) | (b != 0))
                keep = keep.nonzero().squeeze(-1)
                c, a = cl[i][keep], a[keep]
                b = None if b is None else b[keep]
            xr = x[:, 0, c]
            d = denom[:, i]
            if nc == 1:
                al = d * ((u[:, 0, i] - _dsum(a, xr)) - eps * vl[:, 0, i])
                vl[:, 0, i] = vl[:, 0, i] + al * eps
                x[:, 0, c] = xr + al[:, None] * a
                continue
            xi = x[:, 1, c]
            taur = _dsum(a, xr) - _dsum(b, xi)
            taui = _dsum(a, xi) + _dsum(b, xr)
            alr = d * ((u[:, 0, i] - taur) - eps * vl[:, 0, i])
            ali = d * ((u[:, 1, i] - taui) - eps * vl[:, 1, i])
            vl[:, 0, i] = vl[:, 0, i] + alr * eps
            vl[:, 1, i] = vl[:, 1, i] + ali * eps
            x[:, 0, c] = (xr + alr[:, None] * a) + ali[:, None] * b
            x[:, 1, c] = (xi + ali[:, None] * a) - alr[:, None] * b
        if prox == "positive":
            x[:, 0] = torch.clamp(x[:, 0], min=0.0)
        if nc == 2 and prox != "none":
            x[:, 1] = x[:, 1] * 0.0
    return x, vl


def _align16(nbytes):
    return -(-nbytes // 16) * 16


def warp_smem_bytes(m, n, L, nc, csr, groups, ring, x_lanes, vl_shared):
    """Shared memory of a warp-route CTA, as ``warp_layout`` in
    csrc/kaczmarz.cu counts it: `ring` full and `ring` empty mbarriers; the
    slots, each the `groups` problems' d_i and u_i and the row (nc planes of
    L floats rounded up to 4, or of 32·`x_lanes` where x is in registers,
    then as many columns for CSR); x of the CTA's problems where it is not
    in registers (`x_lanes` 0); their vl where it is in shared memory. Each
    piece 16-byte aligned."""
    lr = 32 * x_lanes if x_lanes else -(-L // 4) * 4
    slot = _align16(4 * groups * (1 + nc)) + 4 * (nc + int(csr)) * lr
    total = _align16(16 * ring) + ring * slot
    if not x_lanes:
        total += _align16(4 * groups * nc * n)
    if vl_shared:
        total += _align16(4 * groups * nc * m)
    return total


@dataclasses.dataclass(frozen=True)
class KaczmarzPlan:
    """A launch of the row kernel: its route; on the warp route the
    problems a CTA (`groups`), the ring's slots, where x lies ("registers",
    `x_lanes` entries a lane, or "shared") and vl ("shared" or "global");
    the CTAs and the shared memory of each."""

    route: str
    groups: int
    ring: int
    x_in: str
    x_lanes: int
    vl_in: str
    ctas: int
    smem: int


def _reg_lanes(n, nc, csr):
    """The fewest x entries a lane (a power of two) that hold a dense row
    in registers, or 0 (x in shared memory)."""
    if csr:
        return 0
    k = 1
    while 32 * k < n:
        k *= 2
    return k if k <= REG_LANES[nc] else 0


def plan_kaczmarz(P, m, n, L, nc, csr, sms=132, smem_max=232448, groups=None, route=None):
    """The plan of a launch for P problems on rows of L entries (dense: L =
    n; padded CSR: k_max) of an m × n system with nc planes, on a card of
    `sms` SMs and `smem_max` bytes of shared memory a block.

    The warp route takes a dense row whose x fits in registers
    (`REG_LANES`) and a CSR row of at most `WARP_MAX_L` entries: ⌈P / sms⌉
    problems a CTA (capped at `MAX_GROUPS`; fewer where the CTA does not
    fit), and the first that fits of RING slots with vl in shared memory,
    RING/2 with vl shared, then RING, RING/2, 2, 1 with vl in global
    memory. The block route takes the rest. `groups` or `route` force a
    CTA's problems or the route (timing and tests; a forced warp route
    keeps x in shared memory where it does not fit registers). A forced
    warp route that fits nowhere, or a shape whose x fits neither route,
    raises ValueError. The index list takes no shared memory: every warp
    reads it in coalesced chunks of 32."""
    if route not in (None, *ROUTES):
        raise ValueError(f"plan_kaczmarz: no route {route!r}; one of {ROUTES}")
    if groups is not None and not 1 <= groups <= MAX_GROUPS:
        raise ValueError(f"plan_kaczmarz: groups must lie in [1, {MAX_GROUPS}], got {groups}")
    P = max(int(P), 1)
    kx = _reg_lanes(n, nc, csr)
    block = KaczmarzPlan("block", 1, 0, "shared", 0, "global", P, 4 * nc * n)
    if block.smem > smem_max:  # x of one problem must fit a block's shared memory
        route = route or "warp"
    elif route == "block" or (route is None and (L > WARP_MAX_L or not (csr or kx))):
        return block
    g0 = groups or min(MAX_GROUPS, max(1, -(-P // sms)))
    for g in ([g0] if groups else range(min(g0, P), 0, -1)):
        for R, vl_shared in ((RING, True), (RING // 2, True), (RING, False), (RING // 2, False),
                             (2, False), (1, False)):
            smem = warp_smem_bytes(m, n, L, nc, csr, g, R, kx, vl_shared)
            if smem <= smem_max:
                return KaczmarzPlan("warp", g, R, "shared" if kx == 0 else "registers", kx,
                                    "shared" if vl_shared else "global", -(-P // g), smem)
    if route == "warp" or block.smem > smem_max:
        raise ValueError(f"plan_kaczmarz: no warp plan fits {smem_max} bytes for rows of {L} "
                         f"entries, n = {n}, m = {m}, {nc} plane(s), groups {groups}")
    return block


def card_plan(rows, x0, cols=None, groups=None, route=None):
    """:func:`plan_kaczmarz` for the operands of a launch on the card that
    holds them."""
    from .. import _build

    P, nc, n = x0.shape
    m, L = rows.shape[1:]
    return plan_kaczmarz(P, m, n, L, nc, cols is not None,
                         *_build.device_limits(x0.device.index or 0), groups=groups, route=route)


def _check_cuda(name, rows, idx, x0, vl0, u, denom, eps, cols):
    dev = x0.device
    for t in (rows, x0, vl0, u, denom, eps):
        if t.device != dev:
            raise ValueError(f"{name}: a tensor lies on {t.device}, x0 on {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    for t in (idx,) + (() if cols is None else (cols,)):
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"{name}: index tables must be int32 on {dev}")
    if x0.shape[1] * x0.shape[2] > MAX_N_REAL:
        raise ValueError(f"{name}: x of {x0.shape[1]}×{x0.shape[2]} floats exceeds a "
                         "block's shared memory")


def _launch(fn, rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols, plan, prof=None):
    from .. import _build

    P, nc, n = x0.shape
    m, L = rows.shape[1:]
    lib = _build.load_library()
    rows = rows.contiguous()
    x, vl = x0.contiguous().clone(), vl0.contiguous().clone()
    ai = rows[1].data_ptr() if nc == 2 else None
    ops = (rows[0].data_ptr(), ai, None if cols is None else cols.contiguous().data_ptr(),
           idx.contiguous().data_ptr(), x.data_ptr(), vl.data_ptr(), u.contiguous().data_ptr(),
           denom.contiguous().data_ptr(), eps.contiguous().data_ptr())
    shape = (P, m, n, L, sweeps, idx.shape[1], int(reuse), PROXES.index(prox))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "warp":
            code = lib.kaczmarz_warp_launch(
                *ops, None if prof is None else prof.data_ptr(), *shape, plan.groups, plan.ring,
                plan.x_lanes, int(plan.vl_in == "shared"), plan.smem, stream)
        else:
            code = lib.kaczmarz_launch(*ops, *shape, stream)
    _build.check(code, f"kaczmarz_{plan.route}_launch ({plan})")
    if P > 0 and sweeps > 0 and idx.shape[1] > 0:  # the C entry point launched
        fn.launches += 1
        fn.route_launches[plan.route] += 1
    return x, vl


def check_indices(name, t, lo, hi):
    """Raise unless every entry of the int tensor `t` lies in [lo, hi): the
    kernel reads and writes by these indices unchecked."""
    if t.numel() == 0:
        return
    tmin, tmax = torch.stack(torch.aminmax(t)).tolist()  # one device-to-host read
    if tmin < lo or tmax >= hi:
        raise ValueError(f"{name}: indices must lie in [{lo}, {hi}), got [{tmin}, {tmax}]")


def _run(fn, rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols, check=True,
         groups=None, route=None, prof=None):
    """Check the operands (the indices too, with `check`: one blocking
    device-to-host read), then run the plain version for CPU tensors or
    launch the kernel on :func:`card_plan` (`groups`, `route` forced where
    given)."""
    name = fn.__name__
    if prox not in PROXES:
        raise ValueError(f"unknown prox {prox!r}; the Kaczmarz kernel takes {PROXES}")
    nc, m, L = rows.shape
    if x0.shape[1] != nc or u.shape[-1] != m or denom.shape[-1] != m:
        raise ValueError(f"{name}: rows {tuple(rows.shape)}, x0 {tuple(x0.shape)}, "
                         f"u {tuple(u.shape)}, denom {tuple(denom.shape)} do not agree")
    if cols is None and L != x0.shape[-1]:
        raise ValueError(f"{name}: dense rows of {L} entries for x of {x0.shape[-1]}")
    if idx.shape[0] != (1 if reuse else sweeps):
        raise ValueError(f"{name}: idx has {idx.shape[0]} rows for {sweeps} sweeps "
                         f"(reuse={reuse})")
    if check:
        check_indices(name + " (row index, -1 = skip)", idx, -1, m)
        if cols is not None:
            check_indices(name + " (column index)", cols, 0, x0.shape[-1])
    if x0.device.type == "cpu":
        return kaczmarz_solve_torch(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols)
    _check_cuda(name, rows, idx, x0, vl0, u, denom, eps, cols)
    plan = card_plan(rows, x0, cols, groups, route)
    return _launch(fn, rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols, plan, prof)


def kaczmarz_solve(rows, idx, x0, vl0, u, denom, eps, sweeps: int, reuse: bool, prox="none",
                   cols=None):
    """The whole multi-sweep solve for P problems, one CTA per problem.

    rows: (nc, m, L) float32, the rows' real (and imaginary) planes, dense
    (L = n) or padded CSR values with `cols` (m, L) int32; idx: int32,
    (1, S) with `reuse` (the same list every sweep: cyclic or shuffled),
    else (sweeps, S), −1 = skip; x0: (P, nc, n); vl0, u: (P, nc, m); denom:
    (P, m); eps: (P,); prox "none" | "positive" | "real". The plain version
    runs for CPU tensors, the CUDA kernel for CUDA tensors, on the route of
    :func:`plan_kaczmarz`. ``kaczmarz_solve.launches`` counts the kernel's
    launches, ``kaczmarz_solve.route_launches`` them by route. An index
    outside [−1, m) raises ValueError. Returns (x, vl)."""
    return _run(kaczmarz_solve, rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols)


kaczmarz_solve.launches = 0
kaczmarz_solve.route_launches = {"warp": 0, "block": 0}


def _forced(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox="none", cols=None,
            groups=None, route=None):
    """`kaczmarz_solve` with its route, or the warp route's problems a CTA,
    forced (the timing mode and the card tests only)."""
    return _run(kaczmarz_solve, rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols,
                groups=groups, route=route)


def phase_clocks(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox="none", cols=None,
                 groups=None):
    """One launch of `kaczmarz_solve` on the warp route with its phase timer
    on: {phase: SM clocks that CTA 0's warp 0 spent in it over the solve}
    (``WARP_PHASES``; "total" is the consumer's whole run; the launch is
    counted). Raises where no warp plan fits."""
    prof = torch.zeros(len(WARP_PHASES), dtype=torch.int64, device=x0.device)
    _run(kaczmarz_solve, rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols,
         groups=groups, route="warp", prof=prof)
    return dict(zip(WARP_PHASES, prof.tolist()))


def _sweep(A, x, vl, u, denom, eps, idx, check):
    n, m = x.shape[-1], A.shape[0]
    x3 = x.reshape(-1, 1, n)
    P = x3.shape[0]
    if x.device.type != "cpu":
        A, u, denom, eps = (t.to(torch.float32) for t in (A, u, denom, eps))
    xo, vlo = _run(kaczmarz_sweep, A[None], idx.reshape(1, -1).to(torch.int32), x3,
                   vl.reshape(P, 1, m), u.reshape(P, 1, m).to(x.dtype),
                   denom.reshape(-1, m).expand(P, m).to(x.dtype),
                   eps.reshape(-1).expand(P).to(x.dtype), 1, True, "none", None, check=check)
    return xo.reshape(x.shape), vlo.reshape(vl.shape)


def kaczmarz_sweep(A, x, vl, u, denom, eps, idx):
    """One sweep over the rows `idx` (K,) of the dense real A (m, n) for the
    problems of x (..., n): vl, u and denom (..., m), eps one per problem.
    The plain version runs for CPU tensors, the CUDA kernel for CUDA
    tensors. ``kaczmarz_sweep.launches`` counts the kernel's launches,
    ``kaczmarz_sweep.route_launches`` them by route. An index outside
    [−1, m) raises ValueError. Returns (x, vl) in their shapes."""
    return _sweep(A, x, vl, u, denom, eps, idx, True)


kaczmarz_sweep.launches = 0
kaczmarz_sweep.route_launches = {"warp": 0, "block": 0}


def solver_sweep(A, x, vl, u, denom, eps, idx):
    """`kaczmarz_sweep` on rows already checked: the Kaczmarz solver's own
    `perm`, which it validates at construction, so that a sweep makes no
    blocking read of the host."""
    return _sweep(A, x, vl, u, denom, eps, idx, False)


def check_kaczmarz_streamed(solver):
    """Validate `solver` for the streamed kernel (raises ValueError naming
    the unsupported piece); returns the projection after each sweep."""
    if not isinstance(solver, Kaczmarz):
        raise ValueError("streamed path requires a Kaczmarz solver")
    if solver.greedy:
        raise ValueError(
            "greedy row selection is residual-driven and cannot be "
            "precomputed; use the greedy kernel or the composed path"
        )
    A = solver.A
    if not isinstance(A, (DenseOperator, PaddedCSROperator)):
        raise ValueError("streamed path requires a dense or padded-CSR operator")
    if solver.randomized and solver.precomputed_order is None:
        raise ValueError(
            "randomized mode needs a host-precomputed order — construct "
            "with Kaczmarz.create(..., precompute_order=True)"
        )
    for r in solver.reg:
        if not isinstance(r, (PositiveRegularization, RealRegularization)):
            raise ValueError(
                "streamed path supports only Positive/Real projections as "
                f"extra terms, got {type(r).__name__}"
            )
    if A.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"streamed path takes float32 or complex64 systems, got {A.dtype}")
    nc = 2 if A.dtype.is_complex else 1
    if nc * A.in_size > MAX_N_REAL:
        raise ValueError(
            f"streamed path keeps x in a block's shared memory: n = {A.in_size} "
            f"exceeds {MAX_N_REAL // nc}"
        )
    return sweep_projection(solver)


def sweep_projection(solver):
    """The projection after each sweep: "positive", "real" or "none"."""
    if any(isinstance(r, PositiveRegularization) for r in solver.reg):
        return "positive"
    if any(isinstance(r, RealRegularization) for r in solver.reg):
        return "real"
    return "none"


def _planes(v, nc, dtype):
    """(P, k) real or complex → (P, nc, k) planes of `dtype`."""
    if nc == 1:
        return (v.real if v.is_complex() else v)[:, None, :].to(dtype).contiguous()
    return torch.stack([v.real, v.imag], dim=1).to(dtype).contiguous()


def solver_operands(solver, B_mat, dtype=torch.float32):
    """The kernel's operands for the problems in B_mat's columns: (rows, cols,
    idx, x0, vl0, u, denom, eps, sweeps, reuse); the initial state from
    ``solver.init``, in planes of `dtype` (the kernel's float32, or float64
    for a plain reference solve)."""
    A = solver.A
    vals = A.vals if isinstance(A, PaddedCSROperator) else A.mat
    nc = 2 if vals.is_complex() else 1
    rows = (torch.stack([vals.real, vals.imag]) if nc == 2 else vals[None])
    rows = rows.to(dtype).contiguous()
    cols = A.cols if isinstance(A, PaddedCSROperator) else None
    st = solver.init(B_mat.T)
    if solver.randomized:
        idx, reuse = solver.precomputed_order, False
    else:
        idx, reuse = solver.perm[None, :], True
    denom = (st.denom.real if st.denom.is_complex() else st.denom).to(dtype)
    eps = (st.eps_w.real if st.eps_w.is_complex() else st.eps_w).to(dtype)
    return (rows, cols, idx.to(torch.int32).contiguous(), _planes(st.x, nc, dtype),
            _planes(st.vl, nc, dtype), _planes(st.u, nc, dtype), denom.contiguous(),
            eps.contiguous(), solver.iterations, reuse)


def solve_kaczmarz_streamed(solver, B_mat):
    """Drop-in fast path for ``solve_batched_unrolled(solver, B)`` on a
    Kaczmarz solver: the whole multi-sweep solve of all problems in one
    launch (columns of ``B_mat`` are problems; returns n × K, complex where
    the system is). A real A with a complex b is solved as 2K real
    problems and recombined; a projection does not decouple so, and is
    refused."""
    prox = check_kaczmarz_streamed(solver)
    A = solver.A
    A.check_device(B_mat)
    if not A.dtype.is_complex and B_mat.is_complex():
        if prox != "none":
            raise ValueError(
                "streamed path: Positive/Real projections act on the COMPLEX "
                "iterate and do not decouple for a real A with complex b; use "
                "the composed path"
            )
        re = solve_kaczmarz_streamed(solver, torch.cat([B_mat.real, B_mat.imag], dim=1))
        K = B_mat.shape[1]
        return torch.complex(re[:, :K], re[:, K:]).to(B_mat.dtype)
    rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse = solver_operands(solver, B_mat)
    x, _ = kaczmarz_solve(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols)
    sol = torch.complex(x[:, 0], x[:, 1]).to(A.dtype) if x.shape[1] == 2 else x[:, 0]
    if solver.tikhonov_inv_sqrt is not None:
        sol = sol * solver.tikhonov_inv_sqrt.to(sol.dtype)[None, :]
    return sol.T
