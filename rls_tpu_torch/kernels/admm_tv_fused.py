"""The whole batched ADMM-TV solve as ONE launch: the hand-written CUDA
kernel ``csrc/admm_tv_fused.cu`` and its plain PyTorch version.

Counterpart of ``rls_tpu/kernels/admm_tv_fused.py``: ``_kernel``
(:44-153), ``admm_tv_fused`` (:156-209), ``check_admm_tv_fused``
(:212-260) and ``solve_admm_tv_fused`` (:274-344). BASELINE configuration
#3: ADMM with one TV term on an identity ``reg_trafo``, the x-update by a
masked fixed-count CG on the exact stencil Gram, per outer iteration

    β = Aᴴb + ρ(z − u)
    x = CG(AᴴA + ρI, β, x₀ = x, cg_iterations, ‖r‖ ≤ tol_inner·‖β‖)
    x = max(x, 0)                       (Positive projection, if any)
    z = FGP-TV(x + u, λ_eff / 2ρ)       (z = x + u where ρ = 0)
    u = u + x − z

The CG is ``pcg``'s masked form: a step of a problem whose ‖r‖ is at or
below its target takes α = 0 and keeps p. The TV prox is the fold FGP
(``_fgp_common.fgp_fold``), valid because the prox scale λ/(2ρ) is the
same at every outer iteration (``vary_rho="none"``). Both versions return
per-problem counts, (B,) int32: the CG steps that were live, summed over
the outer iterations.

The kernel runs on one of two routes that :func:`plan_admm_tv` picks by
shape (``csrc/admm_tv_fused.cu``):

* resident: each problem on a thread-block cluster of c ≤ 16 CTAs, one
  band of image rows per CTA, the five planes read at other bands' rows
  in shared memory for the whole solve (the PGM-TV kernel's band design,
  sharing its banded Gram passes and fold FGP), the CG's sums in double
  over the cluster in rank order (BASELINE #3 at 256² × 16: 6 bands of
  43 rows, the 16 problems in one wave);
* global: one CTA per problem with its planes in global scratch, for a
  row so wide that no band fits (about W > 11,500).

Not carried over: the TPU's compensated bf16 hi/lo Gram (``op.cat``) and
its VMEM model (``_check_vmem_admm_tv``); the port always runs the exact
stencil Gram.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..models.prox import PositiveRegularization, RealRegularization, TVRegularization
from ..models.solvers.admm import ADMM
from ..ops.base import IdentityOperator, NormalOperator
from ..ops.conv_direct import SeparableConvOperator
from .._build import SMEM_MAX, SMS
from . import _fgp_common
from ._bands import HALO, band_sizes, cdiv, fewest_waves
from ._tables import shared_table
from .fista_tv_fused import (GLOBAL_SMEM, MAX_TAPS, PgmTvPlan, check_cuda_input, prepare,
                             problem_scalars)

__all__ = [
    "admm_tv_fused",
    "admm_tv_fused_torch",
    "plan_admm_tv",
    "AdmmTvPlan",
    "phase_clocks",
    "check_admm_tv",
    "check_admm_tv_fused",
    "solve_admm_tv_fused",
]

PROXES = ("none", "positive")
# the dispatch's size rule between this kernel and the row-tiled ADMM-TV
# kernel (row 5): images of more pixels go tiled. It predates the resident
# route, which plans images past it (300², 512²); the boundary between the
# two kernels is not measured yet
FUSED_MAX_PIXELS = 256 * 256
# the kernel's threads per CTA, the resident route's shared-memory planes
# and its largest cluster (the non-portable size; csrc/admm_tv_fused.cu)
THREADS, PLANES, MAX_CLUSTER = 1024, 5, 16
# the phases of the resident route's timer (csrc/admm_tv_fused.cu kPhases)
PHASES = ("set-up", "gram", "cg vector sweeps", "cluster sums", "fgp sweeps",
          "cluster barriers", "z-update")
# global scratch planes of (B, H, W): the resident route's own-pixel planes
# (z, u, r, q and the dual ph), and the global route's z, u, r, p, q, two
# stencil temporaries, xg and the four FGP duals
RESIDENT_SCRATCH, GLOBAL_SCRATCH = 5, 12


def cluster_smem_bytes(rows, W):
    """Shared memory of a resident CTA whose band has `rows` rows of width
    W, as ``cluster_smem_bytes`` in csrc/admm_tv_fused.cu counts it: five
    planes (each rounded up to 4 floats), the block sums (3 × 32 float64),
    the CTA's two slots and the cluster's sums (4 float64 each), the phase
    timer, the DSMEM row table (rows + 2·HALO pointers) and the taps (2 ×
    MAX_TAPS f32)."""
    return (4 * PLANES * cdiv(rows * W, 4) * 4 + 8 * (3 * (THREADS // 32) + 12)
            + 8 * len(PHASES) + 8 * (rows + 2 * HALO) + 4 * 2 * MAX_TAPS)


class AdmmTvPlan(PgmTvPlan):
    """How a fused ADMM-TV launch runs: `route` "resident" (a cluster of
    `clusters` CTAs per problem, bands of `rows` image rows, the last one
    possibly shorter) or "global" (one CTA per problem, `rows` = H); `ctas`
    CTAs in all, `smem` bytes of shared memory per CTA and `scratch` planes
    of (B, H, W) in global memory. ``band_rows`` and ``locate`` are the
    PGM-TV plan's."""


def fitting_sizes(H, W, sms=SMS, smem_max=SMEM_MAX):
    """The cluster sizes c ≤ 16 (and ≤ sms) whose bands of ⌈H/c⌉ rows fit
    one CTA's shared memory with no band empty."""
    return band_sizes(H, W, range(1, MAX_CLUSTER + 1), cluster_smem_bytes, sms, smem_max)


@functools.lru_cache(maxsize=256)
def plan_admm_tv(B, H, W, kh, kw, resident, sms=SMS, smem_max=SMEM_MAX,
                 clusters=None) -> AdmmTvPlan:
    """The route of a fused ADMM-TV launch of B problems of H × W with kh ×
    kw taps, on a card of `sms` SMs and `smem_max` bytes of shared memory
    per block that holds n clusters of c CTAs of the resident kernel at
    once for each pair (c, n) of `resident`
    (``cudaOccupancyMaxActiveClusters``; a size not named is held 0 times).

    The rule (``fewest_waves``, as for the PDHG and FISTA-L1-DFT kernels):
    among the sizes of :func:`fitting_sizes` that the card holds, the
    smallest and each larger one that leaves every CTA at least
    ``MIN_CTA_PIXELS`` pixels, the one with the fewest waves × rows per
    band, ⌈B / held(c)⌉ · ⌈H/c⌉; ties go to the smaller c. `clusters`
    forces a fitting size instead (the timing mode and the tests compare
    sizes with it). An image whose bands fit at no c (a row wider than
    ~11,500 pixels) takes the global route. Raises ValueError naming the
    shape where it is empty, its taps too many, a forced size unfit, or no
    route exists (2³¹ pixels or more per problem), and naming the plan
    where the card holds no cluster of it (no fallback)."""
    if min(B, H, W) < 1:
        raise ValueError(f"admm_tv_fused: empty shape {B} x {H}x{W}")
    if not (1 <= kh <= MAX_TAPS and 1 <= kw <= MAX_TAPS):
        raise ValueError(f"admm_tv_fused: {kh} x {kw} taps; at most {MAX_TAPS} per axis")
    fit = fitting_sizes(H, W, sms, smem_max)
    if clusters is not None and clusters not in fit:
        raise ValueError(f"admm_tv_fused: a cluster of {clusters} CTAs does not fit "
                         f"{B} x {H}x{W} (the fitting sizes: {fit})")
    if fit:
        c = clusters or fewest_waves(B, H, W, fit, resident)
        rows = cdiv(H, c)
        plan = AdmmTvPlan("resident", c, rows, H, B * c, cluster_smem_bytes(rows, W),
                          RESIDENT_SCRATCH)
        if dict(resident).get(c, 0) < 1:
            raise ValueError(f"admm_tv_fused: the card holds no cluster of {plan} "
                             f"({B} x {H}x{W})")
        return plan
    if H * W >= 2**31:
        raise ValueError(
            f"admm_tv_fused: no route for {B} x {H}x{W}: bands fit no cluster of at most "
            f"{MAX_CLUSTER} CTAs with {smem_max} bytes of shared memory each, and one CTA "
            "per problem indexes fewer than 2**31 pixels"
        )
    return AdmmTvPlan("global", 1, H, H, B, GLOBAL_SMEM, GLOBAL_SCRATCH)


@functools.lru_cache(maxsize=None)
def resident_limits(index, clusters, rows, W):
    """(shared memory per CTA as the kernel counts it, clusters of the
    resident kernel that device `index` holds at once:
    ``cudaOccupancyMaxActiveClusters``)."""
    from .. import _build

    out = (ctypes.c_longlong * 2)()
    with torch.cuda.device(index):
        _build.check(_build.load_library().admm_tv_cluster_occupancy(clusters, rows, W, out),
                     "admm_tv_cluster_occupancy")
    return out[0], out[1]


def plan_on_card(x0hat, taps, clusters=None):
    """(plan, clusters resident at once) of a launch on x0hat's card, with
    `clusters` forced where given; the count is None on the global route.
    Raises RuntimeError where the kernel counts other shared memory than
    the planner, ValueError where the resident plan has no cluster the card
    can hold."""
    from .. import _build

    B, H, W = x0hat.shape
    index = x0hat.device.index or 0
    limits = _build.device_limits(index)
    held = {c: resident_limits(index, c, cdiv(H, c), W) for c in fitting_sizes(H, W, *limits)}
    plan = plan_admm_tv(B, H, W, *(len(t) for t in taps),
                        tuple((c, n) for c, (_, n) in held.items()), *limits, clusters=clusters)
    if plan.route == "global":
        return plan, None
    smem, active = held[plan.clusters]
    if smem != plan.smem:
        raise RuntimeError(f"admm_tv_fused: the kernel counts {smem} bytes of shared memory "
                           f"for {plan}")
    return plan, active


def admm_tv_fused_torch(x0hat, scal, t2tab, taps, iterations, cg_iterations, tol_inner,
                        prox="none"):
    """Plain version: `x0hat` (B, H, W), `scal` (B, 2) = [ρ, λ_eff],
    `t2tab` the fold-FGP constants (one row per dual iteration), `taps`
    (taps_h, taps_w), `tol_inner` a Python float. Returns ``(x, counts)``;
    the dtype is x0hat's."""
    taps_h, taps_w = taps
    rho, lam = scal[:, 0], scal[:, 1]

    def col(v):
        return v.view(-1, 1, 1)

    def matvec(v):  # AᴴA + ρI
        return _fgp_common.sepconv_stencil_normal(v, taps_h, taps_w) + col(rho) * v

    def vsum(v):
        return v.sum(dim=(1, 2))

    rho_safe = torch.where(rho != 0, rho, torch.ones_like(rho))
    lam_z = lam / (2.0 * rho_safe)
    x = z = u = x0hat * 0.0
    live = torch.zeros(x0hat.shape[0], dtype=torch.int32, device=x0hat.device)
    for _ in range(iterations):
        beta = x0hat + col(rho) * (z - u)
        target = tol_inner * torch.sqrt(vsum(beta * beta))
        r = beta - matvec(x)
        p = r
        rz = vsum(r * r)
        for _ in range(cg_iterations):
            q = matvec(p)
            pq = vsum(p * q)
            active = torch.sqrt(rz) > target  # ‖r‖ = √rz
            live += active.to(torch.int32)
            denom = torch.where(pq == 0, torch.ones_like(pq), pq)
            alpha = torch.where(active, rz / denom, torch.zeros_like(rz))
            x = x + col(alpha) * p
            r = r - col(alpha) * q
            rz_new = vsum(r * r)
            safe = torch.where(rz == 0, torch.ones_like(rz), rz)
            beta_c = torch.where(rz == 0, torch.zeros_like(rz), rz_new / safe)
            p = torch.where(col(active), r + col(beta_c) * p, p)
            rz = rz_new
        if prox == "positive":
            x = torch.clamp(x, min=0.0)
        xg = x + u
        z = torch.where(col(rho != 0), _fgp_common.fgp_fold(xg, col(lam_z), t2tab), xg)
        u = u + x - z
    return x, live


def kernel_args(x0hat_b, rho, lam, tv_iterations, dtype=np.float32):
    """(scal, t2tab) for the ADMM-TV kernels and their plain versions, in
    `dtype` on x0hat's device."""
    scal = problem_scalars(x0hat_b, rho, lam, dtype)
    t2tab = shared_table(_fgp_common.fgp_t2_table, tv_iterations, dtype, device=x0hat_b.device)
    return scal, t2tab


def _taps_table(taps_h, taps_w):
    return np.asarray(taps_h + taps_w, np.float32)


def check_prox(prox):
    if prox not in PROXES:
        raise ValueError(f"unknown prox {prox!r}; the ADMM-TV kernels take {PROXES}")


def _launch(x0hat, scal, t2tab, taps, iterations, cg_iterations, tol_inner, prox,
            clusters=None, prof=None):
    from .. import _build

    B, H, W = x0hat.shape
    taps_h, taps_w = (tuple(float(t) for t in v) for v in taps)
    plan, _ = plan_on_card(x0hat, taps, clusters)
    if prof is not None and plan.route != "resident":
        raise ValueError(f"admm_tv_fused: the phase timer is on the resident route, not {plan}")
    lib = _build.load_library()
    dev = x0hat.device
    taps_t = shared_table(_taps_table, taps_h, taps_w, device=dev)
    out = torch.empty_like(x0hat)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    scratch = torch.empty((plan.scratch, B, H, W), dtype=torch.float32, device=dev)
    args = (x0hat.data_ptr(), scal.data_ptr(), t2tab.data_ptr(), taps_t.data_ptr(),
            len(taps_h), len(taps_w), out.data_ptr(), scratch.data_ptr(), counts.data_ptr())
    sched = (B, H, W, iterations, cg_iterations, t2tab.shape[0], float(tol_inner),
             int(prox == "positive"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "resident":
            code = lib.admm_tv_cluster_launch(
                *args, None if prof is None else prof.data_ptr(), *sched, plan.clusters,
                plan.rows, plan.smem, stream)
        else:
            code = lib.admm_tv_fused_launch(*args, *sched, stream)
    _build.check(code, f"admm_tv_fused ({B} x {H}x{W}, {plan})")
    admm_tv_fused.launches += 1
    admm_tv_fused.route_launches[plan.route] += 1
    return out, counts


def admm_tv_fused(
    x0hat_b, taps, rho, lam, iterations: int, cg_iterations: int, tv_iterations: int,
    tol_inner: float, prox="none", with_counts=False, clusters=None,
):
    """Batched ADMM-TV on a separable conv in one launch, on the route of
    :func:`plan_admm_tv` (a cluster of CTAs per problem with its planes in
    shared memory, or one CTA per problem on global scratch).

    x0hat_b: (B, H, W) float32, Aᴴb per problem; taps: (taps_h, taps_w);
    rho, lam: scalars or (B,) (λ already normalization-scaled); prox
    "none" | "positive" (the projection after the x-update); `clusters`
    forces the resident route's cluster size (timing and tests only). The
    plain version runs for a CPU tensor, the CUDA kernel for a CUDA tensor.
    ``admm_tv_fused.launches`` counts the kernel's launches, and
    ``admm_tv_fused.route_launches`` the launches by route. Returns x, or
    ``(x, counts)`` with `with_counts`: the live CG steps per problem.
    """
    check_prox(prox)
    scal, t2tab = kernel_args(x0hat_b, rho, lam, tv_iterations)
    args = (iterations, cg_iterations, float(tol_inner), prox)
    if x0hat_b.device.type == "cpu":
        out = admm_tv_fused_torch(x0hat_b, scal, t2tab, taps, *args)
    else:
        check_cuda_input("admm_tv_fused", x0hat_b, taps)
        out = _launch(x0hat_b.contiguous(), scal, t2tab, taps, *args, clusters)
    return out if with_counts else out[0]


admm_tv_fused.launches = 0
admm_tv_fused.route_launches = {"resident": 0, "global": 0}


def phase_clocks(x0hat_b, taps, rho, lam, iterations: int, cg_iterations: int,
                 tv_iterations: int, tol_inner: float, prox="none", clusters=None):
    """One launch of the resident kernel with its phase timer on: {phase:
    SM clocks that CTA 0 spent in it over the whole solve} (``PHASES``; the
    launch counts in ``admm_tv_fused.launches``). Raises on the global route
    and for a CPU tensor."""
    check_prox(prox)
    if x0hat_b.device.type == "cpu":
        raise ValueError("admm_tv_fused: the phase timer runs on the card")
    check_cuda_input("admm_tv_fused", x0hat_b, taps)
    scal, t2tab = kernel_args(x0hat_b, rho, lam, tv_iterations)
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=x0hat_b.device)
    _launch(x0hat_b.contiguous(), scal, t2tab, taps, iterations, cg_iterations,
            float(tol_inner), prox, clusters, prof)
    return dict(zip(PHASES, prof.tolist()))


def check_admm_tv(solver, path="fused"):
    """Validate `solver` for an ADMM-TV kernel (raises ValueError naming the
    first unsupported piece). Shared by the fused and the tiled path
    (``check_admm_tv_fused``, :212-260, and ``check_admm_tv_tiled``,
    ``admm_tv_tiled.py:254-313``) without the TPU's own requirements
    (compensated factors, concrete tracers, VMEM); a float32 operator with
    tap metadata takes the place of the compensated-factor requirement."""
    if not isinstance(solver, ADMM):
        raise ValueError(f"{path} path requires an ADMM solver")
    if not isinstance(solver.AHA, NormalOperator) or solver.AHA.weights is not None:
        raise ValueError(
            f"{path} path requires AHA to be the NormalOperator of a "
            "SeparableConvOperator (construct the solver from A, not AHA)"
        )
    op = solver.AHA.A
    if not isinstance(op, SeparableConvOperator):
        raise ValueError(f"{path} path requires SeparableConvOperator")
    if op.dtype != torch.float32:
        raise ValueError(f"{path} path requires a float32 operator, got {op.dtype}")
    if op.taps is None:
        raise ValueError(f"{path} path requires an operator built with tap metadata")
    if solver.A is None:
        raise ValueError(f"{path} path requires solver.A (for Aᴴb)")
    if len(solver.reg) != 1 or not isinstance(solver.reg[0], TVRegularization):
        raise ValueError(f"{path} path requires exactly one TVRegularization term")
    if not isinstance(solver.reg_trafo[0], IdentityOperator):
        raise ValueError(f"{path} path requires an identity reg_trafo")
    reg = solver.reg[0]
    H, W = op.im_shape
    if reg.shape != (H, W) or tuple(sorted(reg.dims)) != (0, 1):
        raise ValueError(f"{path} path requires 2-D TV over both axes")
    for p in solver.proj:
        if not isinstance(p, (PositiveRegularization, RealRegularization)):
            raise ValueError(
                f"{path} path supports only Positive/Real projection terms, "
                f"got {type(p).__name__}"
            )
    if solver.vary_rho != "none":
        raise ValueError(f"{path} path does not support vary_rho")
    if solver.precon is not None:
        raise ValueError(f"{path} path does not support a preconditioner")


def check_admm_tv_fused(solver):
    """`check_admm_tv` for the fused kernel, with the dispatch's pixel
    rule: an image of more than ``FUSED_MAX_PIXELS`` goes to the tiled
    kernel."""
    check_admm_tv(solver, "fused")
    H, W = solver.AHA.A.im_shape
    if H * W > FUSED_MAX_PIXELS:
        raise ValueError(
            f"a {H}x{W} image goes to the row-tiled kernel (the dispatch sends the fused "
            f"kernel images of at most {FUSED_MAX_PIXELS} pixels)"
        )


def solver_args(solver, B_mat):
    """(x0hat_b, taps, ρ, λ_eff, iterations, cg_iterations, tv_iterations,
    tol_inner, prox) of a checked solver. The seed x0hat = Aᴴb is the
    exact-f32 stencil adjoint ``rmv_stencil`` (``admm_tv_fused.py:293-297``);
    λ_eff = λ·normalization_factor per problem."""
    reg = solver.reg[0]
    x0hat_b, lam_eff = prepare(solver, B_mat, reg)
    prox = "positive" if any(isinstance(p, PositiveRegularization) for p in solver.proj) \
        else "none"
    return (x0hat_b, solver.AHA.A.taps_hw(), solver.rho0[0], lam_eff, solver.iterations,
            solver.iterations_cg, reg.iterations_tv, float(solver.tol_inner), prox)


def solve_admm_tv_fused(solver, B_mat):
    """Drop-in fast path for `solve_batched_unrolled(solver, B)` when the
    solver is ADMM + SeparableConvOperator + one identity-trafo 2-D TV term
    (BASELINE configuration #3). Returns the n×K solution matrix."""
    check_admm_tv_fused(solver)
    H, W = solver.AHA.A.im_shape
    *args, prox = solver_args(solver, B_mat)
    out = admm_tv_fused(*args, prox=prox)
    return out.reshape(out.shape[0], H * W).T
