"""The greedy-randomized Kaczmarz solve as ONE launch: the hand-written CUDA
kernel ``csrc/kaczmarz_greedy.cu`` and its plain PyTorch version.

Counterpart of ``rls_tpu/kernels/kaczmarz_greedy.py``: ``_kernel``
(:53-161), ``kaczmarz_greedy_sweep_pallas`` (:164-265),
``check_kaczmarz_greedy`` (:268-300) and ``solve_kaczmarz_greedy``
(:303-367). One sweep is S steps of the reference's greedy mode
(Kaczmarz.jl:393-426) for every problem: score |r|², threshold it by
e_k, draw a row from the surviving weights by Gumbel-max (or take the
step's forced row), then x += α·a_row, vl_row += α·ε and
r −= r_row·Gt[row] with Gt = diag(denom)·(AAᵀ + λI). The solve runs T
sweeps, each followed by the Positive projection and the residual refresh
r = (u − ε·vl) − A x, with each entry of A x summed in float64 from the
exact f32 products and rounded to f32 once (in both versions).

The draws: ``rls_tpu`` draws with ``pltpu.prng_*`` (``jax.random`` in
interpret mode), which torch cannot repeat. Kernel and plain version share
a counter-based generator in integer arithmetic (`uniforms`): the uniform
of row k at step j of sweep t for problem p is a hash of (seed, t, p, j, k),
and the Gumbel noise −log(−log U) is taken in f32. On the card both
versions draw the same rows; ``forced_rows`` pins the sequence.

Two routes on the card, picked by :func:`plan_kaczmarz_greedy`:
**resident** — the whole T-sweep solve in one launch, one CTA per problem
whose 256 consumer threads hold r in registers for the whole solve, with
producer warps drawing the noise ahead into a shared-memory ring — and
**block** — the one-sweep kernel, a launch per sweep with r in global memory
and the projection and refresh in PyTorch between them, for the sizes the
resident route cannot hold or, past RESIDENT_MAX_ENTRIES entries of A, runs
slower. ``kaczmarz_greedy_solve.route_launches`` and
``kaczmarz_greedy_sweep.route_launches`` count the launches by route;
:func:`phase_clocks` reads the resident route's clocks by phase.

λ: ``rls_tpu`` recovers λ as ``norms[0] − rownorm²[0]`` in f32 (:333-334),
which for λ = 1e-6 beside row norms of order n is mostly rounding. The
port takes λ_eff from the solver's L2 term.

Real float32 dense systems only (the composed ``Kaczmarz`` covers the
rest), as in ``rls_tpu``; its VMEM gate has no counterpart.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.prox import PositiveRegularization, RealRegularization
from ..models.solvers.kaczmarz import Kaczmarz, greedy_table_lam
from ..ops.base import DenseOperator
from .kaczmarz_streamed import check_indices, sweep_projection

__all__ = [
    "kaczmarz_greedy_sweep",
    "kaczmarz_greedy_sweep_torch",
    "kaczmarz_greedy_solve",
    "kaczmarz_greedy_solve_torch",
    "GreedyPlan",
    "plan_kaczmarz_greedy",
    "resident_smem_bytes",
    "card_plan",
    "phase_clocks",
    "check_kaczmarz_greedy",
    "greedy_operands",
    "greedy_solve",
    "solve_kaczmarz_greedy",
    "uniforms",
]

_M32 = 0xFFFFFFFF
ROUTES = ("resident", "block")
# the resident route (csrc/kaczmarz_greedy.cu): 8 consumer warps, thread t
# holding rows t + 256 i of r in registers (at most MAX_ROWS: m ≤ 4096),
# x[t] in a register up to n = THREADS, and PRODUCER_WARPS warps drawing
# the noise into a ring of at most RING slots of m floats
THREADS = 256
PRODUCER_WARPS = 4
RESIDENT_THREADS = THREADS + 32 * PRODUCER_WARPS
MAX_ROWS = 16
RING = 8
# the most entries of A the planner gives the resident route, whose CTA reads
# all of A on one SM for each sweep's refresh: measured on an H100 (20 sweeps
# of m/16 steps, batch 4), it beat the block route at 2048 × 2048 (1.08×) and
# 4096 × 256 (1.1×) and lost at 4096 × 2048 (1.34× slower)
RESIDENT_MAX_ENTRIES = 2048 * 2048
# the phases of the resident route's timer (csrc/kaczmarz_greedy.cu kGreedyPhases)
PHASES = ("stats", "reduction 1", "draw", "reduction 2", "row wait", "axpy", "refresh",
          "row issue", "ring wait", "ring read", "total")


def _mul32(a, c: int):
    """a·c mod 2³² for a < 2³² (an int or an int64 tensor), without
    leaving int64."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M32


def _lowbias32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniforms(seed: int, sweep: int, P: int, step: int, m: int, device):
    """(P, m) float32: the uniform of row k at this step for problem p,
    ((h >> 9) + 0.5)·2⁻²³ of the hash h of (seed, sweep, p, step, k) —
    bit for bit what the kernel draws."""
    pre = _lowbias32((_lowbias32(seed & _M32) + sweep) & _M32)
    pre = [_lowbias32((_lowbias32((pre + p) & _M32) + step) & _M32) for p in range(P)]
    pre = torch.tensor(pre, dtype=torch.int64, device=device)[:, None]
    h = _lowbias32((pre + torch.arange(m, dtype=torch.int64, device=device)) & _M32)
    return ((h >> 9).to(torch.float32) + 0.5) * 2.0**-23


def kaczmarz_greedy_sweep_torch(A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S: int,
                                seed: int, sweep: int, forced_rows=None):
    """Plain version of one S-step sweep, the problems batched inside each
    step; the arguments as for `kaczmarz_greedy_sweep`. Returns
    (x, vl, r, rows)."""
    P, m = r.shape
    dev, dt = r.device, r.dtype
    fnorm = torch.as_tensor(fnorm, dtype=dt, device=dev)
    theta_t = None if theta is None else torch.as_tensor(theta, dtype=dt, device=dev)
    x, vl, r = x.clone(), vl.clone(), r.clone()
    forced = None if forced_rows is None else forced_rows.tolist()
    ks = torch.arange(m, device=dev)
    pr = torch.arange(P, device=dev)
    rows = torch.empty((P, S), dtype=torch.int32, device=dev)
    for j in range(S):
        r2 = r * r
        dn = r2.double().sum(dim=-1).to(dt)
        mx = (r2 * denom).amax(dim=-1)
        safe = torch.where(dn > 0, dn, torch.ones_like(dn))
        q = mx / safe
        if theta_t is None:
            ek = 0.5 * (q + fnorm)
        else:
            ek = theta_t * q + (1.0 - theta_t) * fnorm
        lower = ek * safe
        if forced is not None and forced[j] >= 0:
            row = torch.full((P,), forced[j], dtype=torch.int64, device=dev)
        else:
            w = torch.where(r2 >= lower[:, None] * norms, r2, torch.zeros_like(r2))
            g = -torch.log(-torch.log(uniforms(seed, sweep, P, j, m, dev)))
            score = torch.where(w > 0, torch.log(torch.where(w > 0, w, torch.ones_like(w))) + g,
                                torch.full_like(w, -float("inf")))
            smax = score.amax(dim=-1, keepdim=True)
            row = torch.where(score >= smax, ks, m).amin(dim=-1)
        r_row = r[pr, row]
        alpha = denom[row] * r_row
        vl[pr, row] = vl[pr, row] + alpha * eps
        x = x + alpha[:, None] * A[row]
        r = r - r_row[:, None] * Gt[row]
        rows[:, j] = row
    return x, vl, r, rows


def refresh_torch(A64, x, vl, u, eps):
    """r = (u − ε·vl) − A x, each entry of A x summed in float64 from the
    exact products and rounded to x's dtype once; A64 is A in float64
    (converted once a solve)."""
    ax = (x.double() @ A64.T).to(x.dtype)
    return (u - eps[:, None] * vl) - ax


def kaczmarz_greedy_solve_torch(A, Gt, denom, norms, bt, eps, fnorm, theta, S: int, T: int,
                                seed: int, prox="none", forced_rows=None):
    """Plain version of the T-sweep solve: from x = 0, vl = 0, r = bt, each
    sweep t (drawing with the counter t) followed by the projection and
    the refresh; the arguments as for `kaczmarz_greedy_solve`. Returns
    (x, vl, r, rows (T, P, S))."""
    P, m = bt.shape
    x = bt.new_zeros((P, A.shape[1]))
    vl = bt.new_zeros((P, m))
    r = bt.clone()
    rows = torch.empty((T, P, S), dtype=torch.int32, device=bt.device)
    A64 = A.double()
    for t in range(T):
        x, vl, r, rows[t] = kaczmarz_greedy_sweep_torch(
            A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S, seed, t,
            None if forced_rows is None else forced_rows[t])
        if prox == "positive":
            x = torch.clamp(x, min=0.0)
        r = refresh_torch(A64, x, vl, bt, eps)
    return x, vl, r, rows


def _align16(nbytes):
    return -(-nbytes // 16) * 16


def resident_smem_bytes(m, n, ring, x_shared):
    """Shared memory of a resident CTA, as ``greedy_layout`` in
    csrc/kaczmarz_greedy.cu counts it: `ring` full and `ring` empty
    mbarriers; the 8 warps' dn partials (double) and mx partials (float);
    the 8 draw candidates (16 B each); the ring of noise slots (m floats
    each); vl and the refresh's dots (m floats each); x in double (n); x
    (n floats) where it is not in registers (`x_shared`). Each piece
    16-byte aligned."""
    total = _align16(16 * ring) + _align16(12 * 8) + _align16(16 * 8)
    total += ring * _align16(4 * m) + 2 * _align16(4 * m) + _align16(8 * n)
    return total + (_align16(4 * n) if x_shared else 0)


@dataclasses.dataclass(frozen=True)
class GreedyPlan:
    """A launch of the greedy kernel: its route; on the resident route the
    ring's slots, the rows of r a consumer thread holds, where x lies
    ("registers" or "shared"); the threads and shared memory of a CTA and
    the CTAs (one per problem)."""

    route: str
    ring: int
    rows: int
    x_in: str
    threads: int
    smem: int
    ctas: int


def plan_kaczmarz_greedy(P, m, n, smem_max=232448, route=None):
    """The plan of a launch for P problems of an m × n system on a card
    with `smem_max` bytes of shared memory a block.

    The resident route takes m ≤ THREADS·MAX_ROWS and, unless forced, m·n
    ≤ RESIDENT_MAX_ENTRIES: each consumer thread holds the fewest rows (a
    power of two) that cover m, x in registers where n ≤ THREADS (else in
    shared memory), and the first ring of RING, RING/2, 2, 1 slots that
    fits. The block route takes the rest. `route` forces one (timing and
    tests); a forced resident route that does not fit raises ValueError."""
    if route not in (None, *ROUTES):
        raise ValueError(f"plan_kaczmarz_greedy: no route {route!r}; one of {ROUTES}")
    block = GreedyPlan("block", 0, 0, "global", THREADS, 0, P)
    if route == "block":
        return block
    rows = 1
    while THREADS * rows < m:
        rows *= 2
    x_shared = n > THREADS
    if rows <= MAX_ROWS and (route == "resident" or m * n <= RESIDENT_MAX_ENTRIES):
        for ring in (RING, RING // 2, 2, 1):
            smem = resident_smem_bytes(m, n, ring, x_shared)
            if smem <= smem_max:
                return GreedyPlan("resident", ring, rows, "shared" if x_shared else "registers",
                                  RESIDENT_THREADS, smem, P)
    if route == "resident":
        raise ValueError(f"plan_kaczmarz_greedy: no resident plan holds m = {m}, n = {n} in "
                         f"{THREADS * MAX_ROWS} rows and {smem_max} bytes")
    return block


def card_plan(P, m, n, device, route=None):
    """:func:`plan_kaczmarz_greedy` on the card `device`."""
    from .. import _build

    return plan_kaczmarz_greedy(P, m, n, _build.device_limits(device.index or 0)[1], route)


def _check_forced(name, forced_rows, shape, m):
    if forced_rows is None:
        return
    if tuple(forced_rows.shape) != shape:
        raise ValueError(f"{name}: forced_rows of shape {tuple(forced_rows.shape)} for "
                         f"{shape[-1]} steps" + ("" if len(shape) == 1 else f" × {shape[0]} sweeps"))
    check_indices(f"{name} (forced row, -1 = draw)", forced_rows, -1, m)


def _check_cuda(name, tensors, forced_rows):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: the CUDA kernel takes float32 on {dev}, got {t.dtype} on "
                             f"{t.device}")
    if forced_rows is not None and forced_rows.device != dev:
        raise ValueError(f"{name}: forced_rows on {forced_rows.device}, the operands on {dev}")


def _launch(fn, plan, A, Gt, denom, norms, u, x_in, vl_in, eps, fnorm, theta, S, T, seed,
            sweep0, positive, refresh, forced, prof=None):
    """One solve on `plan`: T sweeps from (x_in, vl_in, u), counter sweep0 + t,
    Positive and the refresh after each sweep where asked. x_in, vl_in None:
    zeros. Returns (x, vl, r, rows (T, P, S)); counts the launches in `fn`."""
    from .. import _build

    P, m = u.shape
    n = A.shape[1]
    lib = _build.load_library()
    A, Gt, denom, norms, u, eps = (t.contiguous() for t in (A, Gt, denom, norms, u, eps))
    rows = torch.empty((T, P, S), dtype=torch.int32, device=u.device)
    use_theta = int(theta is not None)
    theta = 0.0 if theta is None else float(theta)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "resident":
            x = torch.empty((P, n), dtype=torch.float32, device=u.device)
            vl, r = torch.empty_like(u), torch.empty_like(u)
            code = lib.kaczmarz_greedy_solve_launch(
                A.data_ptr(), Gt.data_ptr(), denom.data_ptr(), norms.data_ptr(), u.data_ptr(),
                ptr(x_in), ptr(vl_in), eps.data_ptr(), ptr(forced), x.data_ptr(), vl.data_ptr(),
                r.data_ptr(), rows.data_ptr(), ptr(prof), P, m, n, S, T, float(fnorm), theta,
                use_theta, seed & _M32, sweep0 & _M32, int(positive), int(refresh), plan.ring,
                plan.rows, int(plan.x_in == "shared"), plan.smem, stream)
            _build.check(code, f"kaczmarz_greedy_solve_launch ({plan})")
            launched = int(P > 0 and S > 0 and T > 0)
            if not launched:  # no step: the start, as the plain version leaves it
                x = x.zero_() if x_in is None else x_in.clone()
                vl = vl.zero_() if vl_in is None else vl_in.clone()
                r = u.clone()
        else:
            x = torch.zeros((P, n), dtype=torch.float32, device=u.device) if x_in is None \
                else x_in.clone()
            vl = torch.zeros_like(u) if vl_in is None else vl_in.clone()
            r = u.clone()
            A64 = A.double() if refresh and T > 0 else None
            for t in range(T):
                code = lib.kaczmarz_greedy_launch(
                    A.data_ptr(), Gt.data_ptr(), denom.data_ptr(), norms.data_ptr(),
                    x.data_ptr(), vl.data_ptr(), r.data_ptr(), eps.data_ptr(),
                    None if forced is None else forced[t].data_ptr(), rows[t].data_ptr(), P, m,
                    n, S, float(fnorm), theta, use_theta, seed & _M32, (sweep0 + t) & _M32,
                    stream)
                _build.check(code, "kaczmarz_greedy_launch")
                if positive:
                    x.clamp_(min=0.0)
                if refresh:
                    r = refresh_torch(A64, x, vl, u, eps)
            launched = T if P > 0 and S > 0 else 0
    fn.launches += launched
    fn.route_launches[plan.route] += launched
    return x, vl, r, rows


def _forced_int32(forced_rows):
    return None if forced_rows is None else forced_rows.to(torch.int32).contiguous()


def kaczmarz_greedy_sweep(A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S: int, seed: int,
                          sweep: int, forced_rows=None):
    """One S-step greedy sweep for P problems, one CTA per problem: the
    solve of `kaczmarz_greedy_solve` with T = 1, from (x, vl, r), with no
    projection and no refresh.

    A: (m, n) float32; Gt: (m, m), Gt[i] = denomᵢ·(AAᵀ + λI)[i]; denom,
    norms: (m,) (1/(rownorm² + λ), rownorm² + λ); x: (P, n); vl, r: (P, m);
    eps: (P,); fnorm: 1/(‖A‖_F² + λ); theta: the e_k mix, or None for ½;
    seed, sweep: the draw's counters; forced_rows: (S,) rows, −1 = draw
    (a row outside [−1, m) raises ValueError). The plain version runs for
    CPU tensors, the CUDA kernel for CUDA tensors, on the route of
    :func:`plan_kaczmarz_greedy`. ``kaczmarz_greedy_sweep.launches`` counts
    the kernel's launches, ``.route_launches`` them by route. Returns
    (x, vl, r, rows (P, S) int32)."""
    return _sweep(A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S, seed, sweep, forced_rows)


def _sweep(A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S, seed, sweep, forced_rows=None,
           route=None):
    """`kaczmarz_greedy_sweep`, its route forced where `route` is given (the
    timing mode and the card tests only)."""
    _check_forced("kaczmarz_greedy_sweep", forced_rows, (S,), r.shape[1])
    if r.device.type == "cpu":
        return kaczmarz_greedy_sweep_torch(A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S,
                                           seed, sweep, forced_rows)
    _check_cuda("kaczmarz_greedy_sweep", (A, Gt, denom, norms, x, vl, r, eps), forced_rows)
    plan = card_plan(r.shape[0], r.shape[1], x.shape[1], r.device, route)
    forced = _forced_int32(forced_rows)
    x, vl, r, rows = _launch(kaczmarz_greedy_sweep, plan, A, Gt, denom, norms, r,
                             x.contiguous(), vl.contiguous(), eps, fnorm, theta, S, 1, seed, sweep,
                             False, False, None if forced is None else forced[None])
    return x, vl, r, rows[0]


kaczmarz_greedy_sweep.launches = 0
kaczmarz_greedy_sweep.route_launches = {"resident": 0, "block": 0}


def _solve(A, Gt, denom, norms, bt, eps, fnorm, theta, S, T, seed, prox, forced_rows,
           route=None, plan=None, prof=None):
    name = "kaczmarz_greedy_solve"
    if prox not in ("none", "positive", "real"):
        raise ValueError(f"{name}: unknown prox {prox!r}")
    _check_forced(name, forced_rows, (T, S), bt.shape[1])
    if bt.device.type == "cpu":
        return kaczmarz_greedy_solve_torch(A, Gt, denom, norms, bt, eps, fnorm, theta, S, T,
                                           seed, prox, forced_rows)
    _check_cuda(name, (A, Gt, denom, norms, bt, eps), forced_rows)
    P, m = bt.shape
    plan = plan or card_plan(P, m, A.shape[1], bt.device, route)
    # the forced rows go to the card once per solve, as int32
    return _launch(kaczmarz_greedy_solve, plan, A, Gt, denom, norms, bt, None, None, eps, fnorm,
                   theta, S, T, seed, 0, prox == "positive", True, _forced_int32(forced_rows),
                   prof)


def kaczmarz_greedy_solve(A, Gt, denom, norms, bt, eps, fnorm, theta, S: int, T: int, seed: int,
                          prox="none", forced_rows=None):
    """The T-sweep greedy solve for P problems in one launch, one CTA per
    problem: from x = 0, vl = 0, r = bt, sweep t draws with the counter t
    and is followed by the projection (`prox` "positive"; "none" and "real"
    leave a real x as it is) and the refresh r = (bt − ε·vl) − A x.

    A, Gt, denom, norms, eps, fnorm, theta as for `kaczmarz_greedy_sweep`;
    bt: (P, m) the problems' right-hand sides; forced_rows: (T, S) rows,
    −1 = draw (a row outside [−1, m) raises ValueError). The plain version
    runs for CPU tensors, the CUDA kernel for CUDA tensors, on the route of
    :func:`plan_kaczmarz_greedy` (the block route launches once a sweep).
    ``kaczmarz_greedy_solve.launches`` counts the kernel's launches,
    ``.route_launches`` them by route. Returns (x (P, n), vl, r (P, m),
    rows (T, P, S) int32)."""
    return _solve(A, Gt, denom, norms, bt, eps, fnorm, theta, S, T, seed, prox, forced_rows)


kaczmarz_greedy_solve.launches = 0
kaczmarz_greedy_solve.route_launches = {"resident": 0, "block": 0}


def _forced(A, Gt, denom, norms, bt, eps, fnorm, theta, S, T, seed, prox="none",
            forced_rows=None, route=None, plan=None):
    """`kaczmarz_greedy_solve` with its route, or its whole plan, forced
    (the timing mode and the card tests only)."""
    return _solve(A, Gt, denom, norms, bt, eps, fnorm, theta, S, T, seed, prox, forced_rows,
                  route, plan)


def phase_clocks(A, Gt, denom, norms, bt, eps, fnorm, theta, S, T, seed, prox="none",
                 forced_rows=None):
    """One launch of `kaczmarz_greedy_solve` on the resident route with its
    phase timer on: {phase: SM clocks that CTA 0's thread 0 spent in it
    over the solve} (``PHASES``; "total" is the consumer's whole run; the
    launch is counted). Raises where no resident plan fits."""
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=bt.device)
    _solve(A, Gt, denom, norms, bt, eps, fnorm, theta, S, T, seed, prox, forced_rows,
           route="resident", prof=prof)
    return dict(zip(PHASES, prof.tolist()))


def check_kaczmarz_greedy(solver):
    """Validate `solver` for the greedy kernel (raises ValueError naming the
    unsupported piece); returns the projection between sweeps."""
    if not isinstance(solver, Kaczmarz):
        raise ValueError("greedy kernel requires a Kaczmarz solver")
    if not solver.greedy:
        raise ValueError("greedy kernel requires greedy_randomized=True")
    if not isinstance(solver.A, DenseOperator):
        raise ValueError("greedy kernel requires a dense operator")
    if solver.A.dtype != torch.float32:
        raise ValueError(f"greedy kernel is real float32 only, got {solver.A.dtype}; "
                         "use the composed path")
    if solver.tikhonov_inv_sqrt is not None:
        raise ValueError("greedy kernel does not support vector-λ Tikhonov")
    for r in solver.reg:
        if not isinstance(r, (PositiveRegularization, RealRegularization)):
            raise ValueError(
                "greedy kernel supports only Positive/Real projections, "
                f"got {type(r).__name__}"
            )
    return sweep_projection(solver)


def greedy_operands(solver, B_mat, dtype=torch.float32):
    """(A, Gt, denom, norms, eps, fnorm, bt) of the problems in B_mat's
    columns, in `dtype` (the kernel's float32, or float64 for a plain
    reference solve), all from the solver's greedy tables and the λ they
    were built with (greedy mode has no per-problem normalization):
    norms = rownorm² + λ, denom = 1/norms (0 on empty rows), εw = √λ,
    Gt = greedy_Bᵀ."""
    solver.A.check_device(B_mat)
    if B_mat.is_complex():
        raise ValueError("greedy kernel is real-only; use the composed path")
    bt = B_mat.T.to(dtype).contiguous()
    lam = greedy_table_lam(solver.l2, bt.device).to(dtype)
    eps = torch.sqrt(lam).expand(bt.shape[0]).contiguous()
    norms = solver.greedy_norms.to(dtype)
    rn2 = solver.A.row_norms_sq()
    denom = torch.where(rn2 > 0, 1.0 / norms, torch.zeros_like(norms))
    return (solver.A.mat.to(dtype).contiguous(), solver.greedy_B.T.to(dtype).contiguous(),
            denom, norms, eps, float(solver.greedy_fnorm), bt)


def greedy_solve(solver, B_mat, forced_rows=None, dtype=torch.float32,
                 solve=kaczmarz_greedy_solve):
    """The T-sweep greedy solve of the problems in B_mat's columns by
    `solve` (the kernel's wrapper, or its plain version in any `dtype`) on
    the operands of `greedy_operands`, built once. `forced_rows` (T, S) pins
    the rows. Returns (x (n, K), rows (T, K, S))."""
    A, Gt, denom, norms, eps, fnorm, bt = greedy_operands(solver, B_mat, dtype)
    x, _, _, rows = solve(A, Gt, denom, norms, bt, eps, fnorm, solver.theta,
                          solver.sub_matrix_size, solver.iterations, solver.seed,
                          sweep_projection(solver), forced_rows)
    return x.T, rows


def solve_kaczmarz_greedy(solver, B_mat, forced_rows=None):
    """Drop-in fast path for batched greedy-randomized Kaczmarz: the whole
    T-sweep solve, projections and refreshes included, is ONE launch of the
    greedy kernel. Returns the n × K solution matrix. The draws differ from
    the composed path's generator (the same per-step distribution);
    ``forced_rows`` (T, S) pins the row sequence."""
    check_kaczmarz_greedy(solver)
    return greedy_solve(solver, B_mat, forced_rows=forced_rows)[0]
