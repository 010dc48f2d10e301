"""The whole fixed-iteration PDHG solve on a separable convolution as ONE
launch: the hand-written CUDA kernel ``csrc/pdhg_fused.cu`` and its plain
PyTorch version.

Counterpart of ``rls_tpu/kernels/pdhg_fused.py``: ``_grad8_ops`` (:56-94),
``_kernel`` (:97-182), ``pdhg_fused`` (:185-219), ``check_pdhg_fused``
(:232-265) and ``solve_pdhg_fused`` (:268-308). Per problem, from
x = y₁ = y₂ = 0, `iterations` times

    y₁ ← (y₁ + σ(Ax − u)) · (1 / (1 + σ))
    y₂ ← conj-prox(y₂ + σΦx)
    x  ← x − τ(Aᴴy₁ + Φᴴy₂), then max(x, 0) with Positive

with A and Aᴴ the zero-padded stencil passes (rows, then columns) and the
dual kind ``"tv8"`` (the 8 planes of ``Grad8Operator`` and the sequential
weighted projection), ``"tviso"`` (the 2 masked forward differences of
``GradientOperator`` on full planes and the elementwise λ-clip) or
``"l1"`` (Φ = I and the clip). No gap is computed: the kernel matches the
fixed-iteration ``solve_batched_unrolled``, which ignores it.

Numerics, the same in both versions: every product and sum is rounded on
its own in the order written here (the kernel forbids FMA contraction), so
the kernel can agree with the plain version bit for bit. The composed
solver multiplies by banded matrices and divides by 1 + σ, so it differs
from both by f32 rounding.

Not carried over: the TPU's VMEM gate (``_check_vmem_pdhg``, :222-229);
the CUDA kernel keeps its planes in global memory.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.prox import PositiveRegularization, RealRegularization
from ..models.regularization import normalization_factor
from ..models.solvers.pdhg import PDHG, W8, clip_conj
from ..ops.conv_direct import SeparableConvOperator, stencil_pass
from ..ops.grad import Grad8Operator
from .fista_tv_fused import check_cuda_input

__all__ = [
    "pdhg_fused",
    "pdhg_fused_torch",
    "check_pdhg_fused",
    "solve_pdhg_fused",
    "kernel_scalars",
    "KINDS",
]

KINDS = ("tv8", "tviso", "l1")
PROXES = ("none", "positive")
_PLANES = {"tv8": 8, "tviso": 2, "l1": 1}


def _grad_div(kind, H, W, like):
    """(grad, div) of the dual kind on (B, H, W) planes, in the kernel's
    op order."""
    if kind == "tv8":
        g8 = Grad8Operator((H, W), like.dtype, device=like.device)

        def grad(x):
            return list(g8.mv(x.reshape(-1, H * W)).reshape(-1, 8, H, W).unbind(dim=1))

        def div(planes):
            return g8.rmv(torch.stack(planes, dim=1).reshape(-1, 8 * H * W)).reshape(-1, H, W)

        return grad, div
    if kind == "tviso":
        not_last_row = (torch.arange(H, device=like.device) < H - 1).to(like.dtype)[:, None]
        not_last_col = (torch.arange(W, device=like.device) < W - 1).to(like.dtype)[None, :]

        def grad(x):
            return [(torch.roll(x, -1, -2) - x) * not_last_row,
                    (torch.roll(x, -1, -1) - x) * not_last_col]

        def div(planes):
            pv, ph = planes
            return (torch.roll(pv, 1, -2) - pv + torch.roll(ph, 1, -1)) - ph

        return grad, div
    return (lambda x: [x]), (lambda planes: planes[0])


def pdhg_fused_torch(u, scal, taps, iterations: int, kind="tv8", prox="none"):
    """Plain version: `u` (B, H, W), `scal` (B, 3) = [σ, τ, λ_eff], `taps`
    (taps_h, taps_w). Returns x (B, H, W) in u's dtype."""
    taps_h, taps_w = taps
    H, W = u.shape[-2:]
    sigma, tau, lam = (scal[:, k].view(-1, 1, 1) for k in range(3))
    inv1s = 1.0 / (1.0 + sigma)
    grad, div = _grad_div(kind, H, W, u)

    def fwd(v):
        return stencil_pass(stencil_pass(v, taps_h, -2, False), taps_w, -1, False)

    def adj(v):
        return stencil_pass(stencil_pass(v, taps_h, -2, True), taps_w, -1, True)

    def conj_prox(planes):
        if kind != "tv8":
            return [clip_conj(p, lam) for p in planes]
        planes = list(planes)
        for k in range(8):
            gnorm = torch.sqrt(sum(p * p for p in planes))
            planes[k] = W8[k] * torch.sign(planes[k]) * torch.minimum(gnorm, lam)
        return planes

    zero = u * 0.0
    x, y1, y2 = zero, zero, [zero] * _PLANES[kind]
    for _ in range(iterations):
        y1 = (y1 + sigma * (fwd(x) - u)) * inv1s
        g = grad(x)
        y2 = conj_prox([y2[k] + sigma * g[k] for k in range(len(y2))])
        x = x - tau * (adj(y1) + div(y2))
        if prox == "positive":
            x = torch.clamp(x, min=0.0)
    return x


def _launch(u, scal, taps, iterations, kind, prox):
    from .. import _build

    B, H, W = u.shape
    taps_h, taps_w = taps
    lib = _build.load_library()
    dev = u.device
    taps_t = torch.tensor(list(taps_h) + list(taps_w), dtype=torch.float32, device=dev)
    weights = torch.tensor(W8, dtype=torch.float32, device=dev)
    out = torch.empty_like(u)
    # y1, the stencil temporary and the dual planes
    scratch = torch.empty((2 + _PLANES[kind], B, H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.pdhg_fused_launch(
            u.data_ptr(), scal.data_ptr(), taps_t.data_ptr(), weights.data_ptr(),
            len(taps_h), len(taps_w), out.data_ptr(), scratch.data_ptr(), B, H, W, iterations,
            KINDS.index(kind), int(prox == "positive"), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "pdhg_fused_launch")
    pdhg_fused.launches += 1
    return out


def kernel_scalars(u_b, sigma, tau, lam, dtype=np.float32):
    """(B, 3) [σ, τ, λ_eff] per problem in `dtype` on u's device; each a
    scalar or (B,)."""
    B = u_b.shape[0]
    tdt = torch.from_numpy(np.zeros((), dtype)).dtype

    def per_problem(v):
        return torch.broadcast_to(
            torch.as_tensor(v, dtype=tdt, device=u_b.device).reshape(-1), (B,))

    return torch.stack([per_problem(v) for v in (sigma, tau, lam)], dim=1)


def pdhg_fused(u_b, taps, sigma, tau, lam, iterations: int, kind="tv8", prox="none"):
    """Batched fixed-iteration PDHG on a separable conv, one CTA per
    problem.

    u_b: (B, H, W) float32, the data images; taps: (taps_h, taps_w);
    sigma, tau, lam: scalars or (B,) (λ already normalization-scaled);
    kind "tv8" | "tviso" | "l1"; prox "none" | "positive". The plain
    version runs for a CPU tensor, the CUDA kernel for a CUDA tensor.
    ``pdhg_fused.launches`` counts the kernel's launches. Returns x
    (B, H, W).
    """
    if kind not in KINDS:
        raise ValueError(f"unknown PDHG kind {kind!r}; the kernel takes {KINDS}")
    if prox not in PROXES:
        raise ValueError(f"unknown prox {prox!r}; the PDHG kernel takes {PROXES}")
    scal = kernel_scalars(u_b, sigma, tau, lam)
    if u_b.device.type == "cpu":
        return pdhg_fused_torch(u_b, scal, taps, iterations, kind, prox)
    check_cuda_input("pdhg_fused", u_b, taps)
    return _launch(u_b.contiguous(), scal, taps, iterations, kind, prox)


pdhg_fused.launches = 0


def check_pdhg_fused(solver):
    """Validate `solver` for the fused PDHG kernel (raises ValueError naming
    the unsupported piece); returns (kind, prox)."""
    if not isinstance(solver, PDHG):
        raise ValueError("fused PDHG path requires a PDHG solver")
    op = solver.A
    if not isinstance(op, SeparableConvOperator):
        raise ValueError("fused PDHG path requires a SeparableConvOperator")
    if op.taps is None:
        raise ValueError("fused PDHG path requires tap metadata (from_taps)")
    if op.dtype != torch.float32:
        raise ValueError(f"fused PDHG path covers real float32 systems only, got {op.dtype}")
    if solver.reg_kind == "tv":
        if tuple(solver.shape) != tuple(op.im_shape):
            raise ValueError("TV shape must equal the operator image shape")
        kind = "tv8" if solver.tv_scheme == "8dir" else "tviso"
    elif solver.reg_kind == "l1":
        kind = "l1"
    else:
        raise ValueError(f"unsupported reg kind {solver.reg_kind}")
    for p in solver.proj:
        if not isinstance(p, (PositiveRegularization, RealRegularization)):
            raise ValueError(
                "fused PDHG path supports only Positive/Real projections, "
                f"got {type(p).__name__}"
            )
    if any(isinstance(p, PositiveRegularization) for p in solver.proj):
        return kind, "positive"
    return kind, "none"  # Real is the identity on real systems


def solve_pdhg_fused(solver, B_mat):
    """Drop-in fast path for ``solve_batched_unrolled(solver, B)`` on a
    PDHG solver over a separable-conv operator with 8-direction or
    isotropic TV or L1 (columns of ``B_mat`` are problems; returns n × K).
    λ_eff = f32(λ)·normalization per problem, as ``rls_tpu`` forms it."""
    kind, prox = check_pdhg_fused(solver)
    op = solver.A
    H, W = op.im_shape
    if B_mat.is_complex():
        raise ValueError(
            "fused PDHG path covers real data only (complex b: the composed "
            "real-only solver rejects it too)"
        )
    if B_mat.shape[0] != H * W:
        raise ValueError(f"B has {B_mat.shape[0]} rows, operator expects {H * W}")
    op.check_device(B_mat)
    bt = B_mat.to(torch.float32).T
    scale = normalization_factor(solver.normalize_reg, solver.A, bt)
    lam = solver.reg.get_lam()
    lam = torch.as_tensor(lam.real if torch.is_tensor(lam) else lam, dtype=torch.float32,
                          device=bt.device)
    lam_eff = lam * scale.to(torch.float32)
    out = pdhg_fused(bt.reshape(-1, H, W).contiguous(), op.taps_hw(), solver.sigma, solver.tau,
                     lam_eff, solver.iterations, kind, prox)
    return out.reshape(out.shape[0], H * W).T
