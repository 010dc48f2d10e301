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

Not carried over: the TPU's compensated bf16 hi/lo Gram (``op.cat``) and
its VMEM model (``_check_vmem_admm_tv``); the port always runs the exact
stencil Gram.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.prox import PositiveRegularization, RealRegularization, TVRegularization
from ..models.solvers.admm import ADMM
from ..ops.base import IdentityOperator, NormalOperator
from ..ops.conv_direct import SeparableConvOperator
from . import _fgp_common
from .fista_tv_fused import check_cuda_input, check_fused_pixels, prepare, problem_scalars

__all__ = [
    "admm_tv_fused",
    "admm_tv_fused_torch",
    "check_admm_tv",
    "check_admm_tv_fused",
    "solve_admm_tv_fused",
]

PROXES = ("none", "positive")


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
    t2tab = torch.as_tensor(_fgp_common.fgp_t2_table(tv_iterations, dtype),
                            device=x0hat_b.device)
    return scal, t2tab


def check_prox(prox):
    if prox not in PROXES:
        raise ValueError(f"unknown prox {prox!r}; the ADMM-TV kernels take {PROXES}")


def _launch(x0hat, scal, t2tab, taps, iterations, cg_iterations, tol_inner, prox):
    from .. import _build

    B, H, W = x0hat.shape
    taps_h, taps_w = taps
    lib = _build.load_library()
    dev = x0hat.device
    taps_t = torch.tensor(list(taps_h) + list(taps_w), dtype=torch.float32, device=dev)
    out = torch.empty_like(x0hat)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    # z, u, r, p, q, two stencil temporaries, xg and the four FGP duals
    scratch = torch.empty((12, B, H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.admm_tv_fused_launch(
            x0hat.data_ptr(), scal.data_ptr(), t2tab.data_ptr(), taps_t.data_ptr(),
            len(taps_h), len(taps_w), out.data_ptr(), scratch.data_ptr(), counts.data_ptr(),
            B, H, W, iterations, cg_iterations, t2tab.shape[0], float(tol_inner),
            int(prox == "positive"), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "admm_tv_fused_launch")
    admm_tv_fused.launches += 1
    return out, counts


def admm_tv_fused(
    x0hat_b, taps, rho, lam, iterations: int, cg_iterations: int, tv_iterations: int,
    tol_inner: float, prox="none", with_counts=False,
):
    """Batched ADMM-TV on a separable conv, one CTA per problem.

    x0hat_b: (B, H, W) float32, Aᴴb per problem; taps: (taps_h, taps_w);
    rho, lam: scalars or (B,) (λ already normalization-scaled); prox
    "none" | "positive" (the projection after the x-update). The plain
    version runs for a CPU tensor, the CUDA kernel for a CUDA tensor.
    ``admm_tv_fused.launches`` counts the kernel's launches. Returns x, or
    ``(x, counts)`` with `with_counts`: the live CG steps per problem.
    """
    check_prox(prox)
    scal, t2tab = kernel_args(x0hat_b, rho, lam, tv_iterations)
    args = (iterations, cg_iterations, float(tol_inner), prox)
    if x0hat_b.device.type == "cpu":
        out = admm_tv_fused_torch(x0hat_b, scal, t2tab, taps, *args)
    else:
        check_cuda_input("admm_tv_fused", x0hat_b, taps)
        out = _launch(x0hat_b.contiguous(), scal, t2tab, taps, *args)
    return out if with_counts else out[0]


admm_tv_fused.launches = 0


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
    check_fused_pixels(*solver.AHA.A.im_shape)


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
