"""The whole batched proximal-gradient solve (FISTA, OptISTA, POGM) on a
dense matrix as ONE launch: the hand-written CUDA kernels
``csrc/pgm_dense_fused.cu`` (real, and complex as re/im planes) and their
plain PyTorch versions.

Counterpart of ``rls_tpu/kernels/pgm_dense_fused.py``: ``_kernel``
(:47-129), ``_kernel_cplx`` (:132-262), ``check_pgm_dense_fused``
(:265-352), ``solve_pgm_dense_fused`` (:355-455) and ``_solve_cplx``
(:458-545). Per problem, from x = 0 and x0hat = Aᴴb:

* FISTA: the momentum point xm = x + (θ_old − 1)/θ·(x − x_prev), the
  gradient step xg = xm − ρ(AᴴA xm − x0hat), the prox, and the f32 θ
  recurrence of ``FISTA.step`` with its restart (``"gradient"``: θ ← 1
  where res·(x⁺ − x) > 0; ``"gradient_mapping"``: where
  (xm − x⁺)·(x⁺ − x) > 0);
* OptISTA and POGM (no restart): the f64 momentum table of
  ``fista_tv_fused._momentum_table``, one row per iteration, as
  ``_pgm_loop`` runs it.

The prox is the soft threshold (L1) or the shrinkage x/(1+2λ) (L2) at
λ·ρ (FISTA) or λ·ρ·γ (OptISTA, POGM), then the projection: Positive
clips (and zeroes the imaginary plane), Real zeroes the imaginary plane.
On complex data the L1 prox is the group soft threshold over the (re, im)
pair, max(|g| − λ, 0)/(|g| + ε)·(Re g + ε, Im g), and the restart dot sums
both planes. Both versions return the per-problem count of restarts.

Numerics, as in ``cgnr_fused``: every matvec entry and every dot is summed
in double and rounded to f32, and the updates are separate f32 operations,
in both versions; the restart decisions compare the rounded dot with 0.

Routes of the real kernel (:func:`plan_pgm_dense` picks one from the
shape): ``"grid"``, row 6's design, the batch's solve as one cooperative
grid of A-slabs × problem groups, each CTA keeping its slab of A and its
group's Gram input in shared memory, so that one load of A serves every
problem of a group, with two group barriers per iteration; and
``"per_problem"``, one CTA per problem, only where no grid plan fits the
card. The complex kernel runs one CTA per problem.

Not carried over: the TPU's pre-split bf16 hi/lo factors, their VMEM gate
(:339), ``chunked_batch_run`` and the concrete-θ test (a JAX tracer has no
counterpart here).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..models.prox import (
    L1Regularization,
    L2Regularization,
    PositiveRegularization,
    RealRegularization,
)
from ..models.solvers.base import theta_next
from .cgnr_fused import (
    SYNC_CLOCKS,
    TILE,
    TRIP_CLOCKS,
    WARPS,
    _align16,
    _cdiv,
    check_cuda_operands,
    check_dense_normal,
    dsum_dot,
    dsum_mm,
    is_scalar,
    lam_per_problem,
    slab_ld,
)
from .fista_tv_fused import _METHOD_OF, METHODS, RESTARTS, _momentum_table

__all__ = [
    "pgm_dense_fused",
    "plan_pgm_dense",
    "PgmDensePlan",
    "phase_clocks",
    "pgm_dense_fused_cplx",
    "pgm_dense_fused_torch",
    "pgm_dense_fused_cplx_torch",
    "kernel_args",
    "check_pgm_dense_fused",
    "solve_pgm_dense_fused",
]

KINDS = ("l1", "l2")
PROXES = ("none", "positive", "real")


def _col(v):
    return v.unsqueeze(-1)


def _prox_pair(gr, gi, lam_s, kind, prox):
    """The prox on the (re, im) planes (`gi` None: real data): L1 soft
    threshold, group-wise on complex data, or L2 shrinkage at `lam_s`
    (P,), then the projection."""
    eps = torch.finfo(gr.dtype).eps
    lam_c = _col(lam_s)
    if kind == "l1":
        if gi is None:
            mag = gr.abs()
            pr, pi = torch.clamp(mag - lam_c, min=0.0) * (gr + eps) / (mag + eps), None
        else:
            mag = torch.sqrt(gr * gr + gi * gi)
            sc = torch.clamp(mag - lam_c, min=0.0) / (mag + eps)
            pr, pi = sc * (gr + eps), sc * gi
    else:
        d = 1.0 + 2.0 * lam_c
        pr, pi = gr / d, None if gi is None else gi / d
    if prox == "positive":
        pr = torch.clamp(pr, min=0.0)
    if prox != "none" and pi is not None:
        pi = pi * 0.0
    return pr, pi


def _pgm_planes(normal, x0, scal, tab, steps, method, kind, restart, prox):
    """The dense PGM loop on a tuple of planes (one real plane, or the re
    and im planes): `normal` maps planes to AᴴA planes, `x0` is Aᴴb.
    Returns (planes, restart counts)."""
    lam, rho, th0 = scal[:, 0], scal[:, 1], scal[:, 2]
    cplx = len(x0) == 2

    def prox_fn(g, lam_s):
        out = _prox_pair(g[0], g[1] if cplx else None, lam_s, kind, prox)
        return out if cplx else out[:1]

    def dot(a, b):
        return dsum_dot(torch.cat(a, -1), torch.cat(b, -1))

    def sub(a, b):
        return tuple(u - v for u, v in zip(a, b))

    zero = tuple(v * 0.0 for v in x0)
    x = m1 = m2 = zero
    fires = torch.zeros(x0[0].shape[0], dtype=torch.int32, device=x0[0].device)
    if method == "fista":
        th = th_old = th0
        for _ in range(steps):
            a = (th_old - 1.0) / th
            xm = tuple(xk + _col(a) * (xk - pk) for xk, pk in zip(x, m1))
            res = sub(normal(xm), x0)
            xn = prox_fn(tuple(u - _col(rho) * r for u, r in zip(xm, res)), rho * lam)
            if restart != "none":
                d = sub(xn, x)
                fire = (dot(res, d) if restart == "gradient" else dot(sub(xm, xn), d)) > 0
                fires += fire.to(torch.int32)
                th = torch.where(fire, torch.ones_like(th), th)
            th_old, th = th, theta_next(th)
            x, m1 = xn, x
        return x, fires
    for i in range(steps):
        a, bc, g, e = tab[i]
        res = sub(normal(x), x0)
        if method == "optista":
            c = rho * g
            y_new = prox_fn(tuple(y - _col(c) * r for y, r in zip(m1, res)), c * lam)
            z_new = tuple(xk + (yn - y) * e for xk, yn, y in zip(x, y_new, m1))
            x_new = tuple(
                (1.0 + a + bc) * zn - a * z - bc * xk for zn, z, xk in zip(z_new, m2, x)
            )
            x, m1, m2 = x_new, y_new, z_new
        else:  # POGM: m1, m2 = y, x_mid
            y_new = tuple(xk - _col(rho) * r for xk, r in zip(x, res))
            x_mid = tuple(
                (1.0 + a + bc) * yn - a * y - (bc + e) * xk + e * z
                for yn, y, xk, z in zip(y_new, m1, x, m2)
            )
            x, m1, m2 = prox_fn(x_mid, rho * g * lam), y_new, x_mid
    return x, fires


def pgm_dense_fused_torch(b, A, scal, tab, steps: int, method="fista", kind="l1",
                          restart="none", prox="none"):
    """Plain version on real data: `b` (P, m), `A` (m, n), `scal` (P, 3) =
    [λ_eff, ρ, θ0], `tab` the momentum table (OptISTA, POGM). Returns
    ``(x (P, n), restarts (P,))`` in b's dtype."""
    A64 = A.double()

    def normal(v):
        return (dsum_mm(dsum_mm(v[0], A64.T), A64),)

    (x,), fires = _pgm_planes(normal, (dsum_mm(b, A64),), scal, tab, steps, method, kind,
                              restart, prox)
    return x, fires


def _cplx_ops(ar, ai):
    """(A x, Aᴴ q) on (re, im) planes, with four real matvecs in the
    complex pattern, each summed in double."""
    Ar, Ai = ar.double(), ai.double()

    def fwd(xr, xi):
        return (dsum_mm(xr, Ar.T) - dsum_mm(xi, Ai.T), dsum_mm(xr, Ai.T) + dsum_mm(xi, Ar.T))

    def adj(qr, qi):
        return (dsum_mm(qr, Ar) + dsum_mm(qi, Ai), dsum_mm(qi, Ar) - dsum_mm(qr, Ai))

    return fwd, adj


def pgm_dense_fused_cplx_torch(br, bi, ar, ai, scal, tab, steps: int, method="fista",
                               kind="l1", restart="none", prox="none"):
    """Plain version on complex data as planes: `br`, `bi` (P, m) and
    `ar`, `ai` (m, n) real; as `pgm_dense_fused_torch` otherwise. Returns
    ``(xr, xi, restarts)``."""
    fwd, adj = _cplx_ops(ar, ai)

    def normal(v):
        return adj(*fwd(*v))

    (xr, xi), fires = _pgm_planes(normal, adj(br, bi), scal, tab, steps, method, kind,
                                  restart, prox)
    return xr, xi, fires


def kernel_args(b, lam, rho, theta, method, steps: int, dtype=np.float32):
    """(scal, tab) for the kernels and their plain versions, in `dtype` on
    b's device: [λ_eff, ρ, θ0] per problem (each a scalar or (P,)), and
    the momentum table of OptISTA and POGM (one zero row for FISTA, which
    runs its θ recurrence instead)."""
    P, dev = b.shape[0], b.device
    tdt = torch.from_numpy(np.zeros((), dtype)).dtype

    def per_problem(v):
        v = v.real if torch.is_tensor(v) else v
        return torch.broadcast_to(torch.as_tensor(v, dtype=tdt, device=dev).reshape(-1), (P,))

    scal = torch.stack([per_problem(lam), per_problem(rho), per_problem(theta)], dim=1)
    if method == "fista":
        tab = np.zeros((1, 4), dtype)
    else:
        tab = _momentum_table(method, steps, float(theta), dtype=dtype)
    return scal, torch.as_tensor(tab, device=dev)


# the grid route's phases that the kernel can time
# (csrc/pgm_dense_fused.cu kSetup ... kReload)
GRID_PHASES = ("set-up", "q", "partial v", "barrier 1", "slab sums and update", "barrier 2",
               "x reload")
# the L2's rate to every SM together, in bytes per SM clock (an H100's
# ~5.5 TB/s at 1.755 GHz), for the planner's price of the grid's traffic
L2_BYTES_PER_CLOCK = 3000


@dataclasses.dataclass(frozen=True)
class PgmDensePlan:
    """How the real dense PGM solve runs. Route ``"grid"``: one cooperative
    grid of `slabs` slabs of `rows` rows of A × `groups` groups of
    `group_size` problems, one CTA per (slab, group), A's slab in shared
    memory with `resident`, `smem` bytes of it per CTA. Route
    ``"per_problem"`` (the kernel of one CTA per problem; slabs = 1,
    groups = P): where no grid plan fits the card."""

    route: str
    slabs: int
    rows: int
    groups: int
    group_size: int
    resident: bool
    smem: int

    @property
    def ctas(self) -> int:
        return self.slabs * self.groups


def grid_smem_bytes(n, slabs, rows, group_size, resident):
    """Shared memory of one CTA of the grid route, as ``grid_smem_bytes``
    in csrc/pgm_dense_fused.cu counts it: q for a tile of 8 problems
    (float64, rows rounded up to 16), five 4-byte scalars per problem, the
    block reduction (8 × 8 float64), the phase timer, the warps' split sums
    (8 × 128 float64), with `resident` the slab of A (f32, rows rounded up
    to 16 × ``slab_ld``), the group's Gram input (f32, tiles × n rounded up
    to 8 × 8), its x (f32, tiles × n × 8) and the owner's x0hat, m1, m2
    (f32, tiles × its columns × 8). Each piece starts 16-byte aligned."""
    chunk, tiles, rows16 = _cdiv(n, slabs), _cdiv(group_size, TILE), _cdiv(rows, 16) * 16
    nbytes = sum(_align16(b) for b in (
        8 * TILE * rows16, 20 * group_size, 8 * WARPS * TILE, 8 * len(GRID_PHASES),
        8 * WARPS * 128, 4 * TILE * tiles * _cdiv(n, 8) * 8, 4 * TILE * tiles * n,
        12 * TILE * tiles * chunk))
    if resident:
        nbytes += _align16(4 * rows16 * slab_ld(n))
    return nbytes


def step_clocks(n, slabs, rows, group_size, resident, ctas):
    """A model of one iteration's SM clocks on a CTA of a grid plan of
    `ctas` CTAs: q and the partial v on the FP64 tensor cores (as
    ``cgnr_fused.step_clocks`` prices them), the partial v written to L2
    and the owner's slab sums read back (64 bytes per SM clock each), the
    grid's whole traffic over the L2's rate, the owner's update and the
    reload of the group's x, and with several slabs two group barriers and
    two round trips through L2; A read from L2 twice per tile where it is
    not resident."""
    tiles = _cdiv(group_size, TILE)
    rows16, n16 = _cdiv(rows, 16) * 16, _cdiv(n, 16) * 16
    work = 8 * rows16 * n16 // 100
    q = tiles * max(work, 16 * 8 * n16 // 25)
    v = tiles * max(work, 16 * 8 * rows16 // 25)
    traffic = 2 * tiles * n + ctas * tiles * n * 128 // L2_BYTES_PER_CLOCK
    vec = tiles * _cdiv(n, slabs) + tiles * n // 4
    group = 0 if slabs == 1 else 2 * SYNC_CLOCKS + 2 * TRIP_CLOCKS
    stream = 0 if resident else tiles * rows * n // 4
    return q + v + traffic + vec + group + stream


@functools.lru_cache(maxsize=256)
def plan_pgm_dense(m, n, P, sms, smem_max) -> PgmDensePlan:
    """The route and cut of a solve of P problems on a real m × n A for a
    card of `sms` SMs and `smem_max` bytes of shared memory per block: the
    grid plan of least :func:`step_clocks` whose CTAs, at most one per SM,
    are all resident at once; the per-problem kernel only where no grid
    plan fits (a group's Gram input and x too large for shared memory even
    with A streamed from L2). Raises ValueError for an empty shape."""
    if min(m, n, P) < 1:
        raise ValueError(f"pgm_dense_fused: empty shape A {m}x{n}, {P} problems")
    best = None
    for s_try in range(1, min(m, sms) + 1):
        rows = _cdiv(m, s_try)
        slabs = _cdiv(m, rows)
        if slabs != s_try:
            continue  # the same cut as a smaller slab count
        for g_try in range(1, min(P, sms // slabs) + 1):
            group_size = _cdiv(P, g_try)
            groups = _cdiv(P, group_size)
            if groups != g_try:
                continue
            for resident in (True, False):
                smem = grid_smem_bytes(n, slabs, rows, group_size, resident)
                if smem > smem_max:
                    continue
                clocks = step_clocks(n, slabs, rows, group_size, resident, slabs * groups)
                key = (clocks, -groups, slabs)
                if best is None or key < best[0]:
                    best = (key, PgmDensePlan("grid", slabs, rows, groups, group_size, resident,
                                              smem))
                break
    if best is None:
        return PgmDensePlan("per_problem", 1, m, P, 1, False, 0)
    return best[1]


def check_schedule(method, kind, restart, prox):
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if kind not in KINDS:
        raise ValueError(f"unknown prox kind {kind!r}; the dense PGM kernels take {KINDS}")
    if restart not in RESTARTS:
        raise ValueError(f"unknown restart mode {restart!r}")
    if restart != "none" and method != "fista":
        raise ValueError(
            "dense OptISTA/POGM ride the fixed f64 momentum table; restart needs the "
            "composed path"
        )
    if prox not in PROXES:
        raise ValueError(f"unknown projection {prox!r}; the dense PGM kernels take {PROXES}")


def _launch_planes(name, planes_b, planes_a, scal, tab, steps, method, kind, restart, prox):
    """Launch the per-problem kernel, real (one plane each) or complex
    (two)."""
    from .. import _build

    P, m = planes_b[0].shape
    n = planes_a[0].shape[1]
    c = len(planes_b)
    lib = _build.load_library()
    dev = planes_b[0].device
    out = torch.empty((c, P, n), dtype=torch.float32, device=dev)
    counts = torch.empty((P,), dtype=torch.int32, device=dev)
    # per problem, for each plane: x0hat, x_prev | y, z, the Gram's input
    # and its result (n each), and A's output (m)
    scratch = torch.empty((P, c * (5 * n + m)), dtype=torch.float32, device=dev)
    codes = (METHODS.index(method), KINDS.index(kind), RESTARTS.index(restart),
             PROXES.index(prox))
    with torch.cuda.device(dev):
        code = getattr(lib, f"{name}_launch")(
            *(t.data_ptr() for t in planes_b), *(t.data_ptr() for t in planes_a),
            scal.data_ptr(), tab.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            counts.data_ptr(), P, m, n, steps, *codes,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, f"{name}_launch")
    return (*out, counts)


def _launch_grid(b, A, scal, tab, plan, steps, method, kind, restart, prox, prof=None):
    """Launch the grid route on `plan`: one cooperative grid of slabs ×
    groups."""
    from .. import _build

    P, m = b.shape
    n = A.shape[1]
    lib = _build.load_library()
    out = torch.empty((P, n), dtype=torch.float32, device=b.device)
    counts = torch.empty((P,), dtype=torch.int32, device=b.device)
    # one float64 workspace, each piece 256-byte aligned: the barrier
    # counters (zeroed), the slabs' partial v, the restart partials and
    # the owners' new x (f32) that meet in L2
    tiles = _cdiv(plan.group_size, TILE)
    sizes = (plan.groups * 16, plan.groups * plan.slabs * tiles * n * TILE,
             plan.groups * plan.slabs * plan.group_size, _cdiv(plan.groups * tiles * n * TILE, 2))
    starts = [0]
    for size in sizes:
        starts.append(starts[-1] + _cdiv(size, 32) * 32)
    ws = torch.empty(starts[-1], dtype=torch.float64, device=b.device)
    ws[:starts[1]].zero_()
    bar, part, rdots, xpub = (ws[starts[i]:starts[i + 1]] for i in range(4))
    codes = (METHODS.index(method), KINDS.index(kind), RESTARTS.index(restart),
             PROXES.index(prox))
    with torch.cuda.device(b.device):
        code = lib.pgm_dense_grid_launch(
            b.data_ptr(), A.data_ptr(), scal.data_ptr(), tab.data_ptr(), out.data_ptr(),
            counts.data_ptr(), part.data_ptr(), rdots.data_ptr(), xpub.data_ptr(),
            bar.data_ptr(), None if prof is None else prof.data_ptr(), P, m, n, steps, *codes,
            plan.slabs, plan.rows, plan.groups, plan.group_size, int(plan.resident), plan.smem,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, f"pgm_dense_grid_launch (A {m}x{n}, {P} problems, {plan})")
    return out, counts


def card_plan(b, A):
    """The plan of :func:`plan_pgm_dense` for `b` (P, m) and `A` (m, n) on
    the card that holds them."""
    from .. import _build

    return plan_pgm_dense(A.shape[0], A.shape[1], b.shape[0],
                          *_build.device_limits(b.device.index or 0))


def _launch(b, A, scal, tab, sched, route=None, prof=None):
    """One launch on real data, on the route of :func:`plan_pgm_dense` or
    on `route` where the caller forces one (the timing mode and the card
    tests); a forced ``"grid"`` that the shape has no plan for raises.
    Counts the launch and its route. Returns (x, restarts)."""
    if b.shape[0] == 0:
        return (torch.empty((0, A.shape[1]), dtype=torch.float32, device=b.device),
                torch.empty((0,), dtype=torch.int32, device=b.device))
    plan = card_plan(b, A)
    route = plan.route if route is None else route
    if route == "grid":
        if plan.route != "grid":
            raise ValueError(f"pgm_dense_fused: A {tuple(A.shape)} with {b.shape[0]} problems has "
                             "no grid plan")
        out = _launch_grid(b, A, scal, tab, plan, *sched, prof=prof)
    elif route == "per_problem" and prof is None:
        out = _launch_planes("pgm_dense_fused", (b,), (A,), scal, tab, *sched)
    else:
        raise ValueError(f"pgm_dense_fused: no route {route!r} (with the phase timer: grid only)")
    pgm_dense_fused.launches += 1
    pgm_dense_fused.route_launches[route] += 1
    return out


def pgm_dense_fused(b, A, lam, rho, theta, steps: int, method="fista", kind="l1",
                    restart="none", prox="none", with_counts=False):
    """Batched FISTA / OptISTA / POGM on a dense real A, the batch's solve
    as one cooperative grid of A-slabs × problem groups (the route and cut
    of :func:`plan_pgm_dense`).

    b: (P, m) float32, one problem per row; A: (m, n) float32; lam, rho,
    theta: scalars or (P,) (λ already normalization-scaled); kind "l1" |
    "l2"; restart (FISTA) "none" | "gradient" | "gradient_mapping"; prox
    "none" | "positive". The plain version runs for CPU tensors, the CUDA
    kernel for CUDA tensors. ``pgm_dense_fused.launches`` counts the
    kernel's launches, ``pgm_dense_fused.route_launches`` them by route
    ("grid", "per_problem"). Returns x (P, n), or ``(x, restarts)`` with
    `with_counts`.
    """
    check_schedule(method, kind, restart, prox)
    if prox == "real":
        raise ValueError("the Real projection is the identity on real data")
    scal, tab = kernel_args(b, lam, rho, theta, method, steps)
    sched = (steps, method, kind, restart, prox)
    if b.device.type == "cpu":
        out = pgm_dense_fused_torch(b, A, scal, tab, *sched)
    else:
        check_cuda_operands("pgm_dense_fused", A, b)
        out = _launch(b.contiguous(), A.contiguous(), scal, tab, sched)
    return out if with_counts else out[0]


pgm_dense_fused.launches = 0
pgm_dense_fused.route_launches = {"grid": 0, "per_problem": 0}


def phase_clocks(b, A, lam, rho, theta, steps: int, method="fista", kind="l1", restart="none",
                 prox="none"):
    """One launch on the grid route with its phase timer on: {phase: SM
    clocks that CTA 0 spent in it over the whole solve} (``GRID_PHASES``;
    the launch is counted). Raises where the shape has no grid plan."""
    check_schedule(method, kind, restart, prox)
    check_cuda_operands("pgm_dense_fused", A, b)
    scal, tab = kernel_args(b, lam, rho, theta, method, steps)
    prof = torch.zeros(len(GRID_PHASES), dtype=torch.int64, device=b.device)
    _launch(b.contiguous(), A.contiguous(), scal, tab, (steps, method, kind, restart, prox),
            route="grid", prof=prof)
    return dict(zip(GRID_PHASES, prof.tolist()))


def pgm_dense_fused_cplx(br, bi, ar, ai, lam, rho, theta, steps: int, method="fista",
                         kind="l1", restart="none", prox="none", with_counts=False):
    """`pgm_dense_fused` on complex data as float32 planes: `br`, `bi` (P,
    m) and `ar`, `ai` (m, n); prox also "real". Returns (xr, xi), or
    ``(xr, xi, restarts)`` with `with_counts`;
    ``pgm_dense_fused_cplx.launches`` counts the kernel's launches."""
    check_schedule(method, kind, restart, prox)
    scal, tab = kernel_args(br, lam, rho, theta, method, steps)
    sched = (steps, method, kind, restart, prox)
    if br.device.type == "cpu":
        out = pgm_dense_fused_cplx_torch(br, bi, ar, ai, scal, tab, *sched)
    else:
        check_cuda_operands("pgm_dense_fused_cplx", ar, ai, br, bi)
        out = _launch_planes("pgm_dense_fused_cplx", (br.contiguous(), bi.contiguous()),
                             (ar.contiguous(), ai.contiguous()), scal, tab, *sched)
        pgm_dense_fused_cplx.launches += 1
    return out if with_counts else out[:2]


pgm_dense_fused_cplx.launches = 0


def check_pgm_dense_fused(solver):
    """Validate `solver` for the dense PGM kernels (raises ValueError
    naming the unsupported piece); returns (method, kind, projection)."""
    method = next((m for cls, m in _METHOD_OF if isinstance(solver, cls)), None)
    if method is None:
        raise ValueError("fused dense PGM path covers FISTA/OptISTA/POGM solvers")
    check_dense_normal(solver, "fused dense PGM path")
    if type(solver.reg) is L1Regularization:
        kind = "l1"
    elif type(solver.reg) is L2Regularization:
        kind = "l2"
    else:
        raise ValueError(
            "fused dense PGM path supports plain L1/L2 regularization, got "
            f"{type(solver.reg).__name__}"
        )
    if not is_scalar(solver.reg.get_lam()):
        raise ValueError("fused dense PGM path requires a scalar λ")
    check_schedule(method, kind, getattr(solver, "restart", "none"), "none")
    for p in solver.proj:
        if not isinstance(p, (PositiveRegularization, RealRegularization)):
            raise ValueError(
                "fused dense PGM path supports only Positive/Real projections, got "
                f"{type(p).__name__}"
            )
    if method == "optista" and solver.proj:
        raise ValueError(
            "OptISTA applies no projection terms in-step (optista.py); use the composed path"
        )
    if any(isinstance(p, PositiveRegularization) for p in solver.proj):
        prox = "positive"
    elif solver.A.mat.is_complex() and any(isinstance(p, RealRegularization)
                                           for p in solver.proj):
        prox = "real"  # zeroes the imaginary plane: not the identity here
    else:
        prox = "none"
    return method, kind, prox


def solve_pgm_dense_fused(solver, B_mat):
    """Drop-in fast path for ``solve_batched_unrolled(solver, B)`` on a
    dense FISTA / OptISTA / POGM solver: the whole batch runs as one launch
    (columns of ``B_mat`` are problems; returns n × K). Complex A or
    complex b runs the plane kernel (a real A with Im A = 0): its planes
    couple through the joint momentum and restart scalars, so neither
    stacking them as problems nor dropping Im b would be right."""
    method, kind, prox = check_pgm_dense_fused(solver)
    mat0 = solver.A.mat
    if B_mat.shape[0] != mat0.shape[0]:
        raise ValueError(f"B has {B_mat.shape[0]} rows, operator expects {mat0.shape[0]}")
    bt = B_mat.T
    args = (lam_per_problem(solver, solver.reg, bt), solver.rho, float(solver.theta),
            solver.total_steps, method, kind, getattr(solver, "restart", "none"))
    if not (mat0.is_complex() or B_mat.is_complex()):
        return pgm_dense_fused(bt.to(torch.float32), mat0.to(torch.float32), *args,
                               prox=prox).T
    if prox == "none" and any(isinstance(p, RealRegularization) for p in solver.proj):
        # the check saw only A; with a real A and complex b the Real
        # projection is not the identity either
        prox = "real"
    bc = bt.to(torch.complex64)
    xr, xi = pgm_dense_fused_cplx(
        bc.real.contiguous(), bc.imag.contiguous(), mat0.real.to(torch.float32),
        mat0.imag.to(torch.float32) if mat0.is_complex() else
        torch.zeros(mat0.shape, dtype=torch.float32, device=mat0.device),
        *args, prox=prox,
    )
    return torch.complex(xr, xi).T
