"""The whole batched FISTA-L1 compressed-sensing solve on a subsampled 2-D
DFT as ONE launch: the hand-written CUDA kernel
``csrc/fista_l1_dft_fused.cu`` and its plain PyTorch version.

Counterpart of ``rls_tpu/kernels/fista_l1_dft_fused.py``: ``_kernel``
(:32-107), ``fista_l1_dft_fused`` (:110-147), ``check_fista_l1_dft_fused``
(:150-190) and ``solve_fista_l1_dft_fused`` (:205-247). BASELINE
configuration #2: FISTA with the real soft threshold on
``SubsampledDFT2RealOperator``, fixed iterations, per problem

    a     = momentum table, column 0 (f64 on the host, rounded once)
    x_mom = x + a (x − x_prev)
    xg    = x_mom − ρ (Re(Fᴴ M F x_mom) − x0hat)
    x     = max(|xg| − ρλ, 0) · (xg + ε) / (|xg| + ε)

from x = x_prev = 0. The normal op runs on the in-kernel FFT of
``_dft_common`` (the plain version repeats it stage by stage); x0hat is
the operator's own adjoint of b (cuFFT on the card).

Not carried over: the TPU's bf16 hi/lo DFT factors (``op.cat``), its VMEM
gate ``_check_vmem_fista_l1_dft`` and ``interpret=``. The size gate is the
FFT's own: H and W powers of two (``_dft_common.check_fft_shape``).
"""

from __future__ import annotations

import torch

from ..models.prox import L1Regularization
from ..models.solvers.fista import FISTA
from ..ops.dft_real import SubsampledDFT2RealOperator
from . import _dft_common
from .fista_tv_fused import _momentum_table, problem_scalars

__all__ = [
    "fista_l1_dft_fused",
    "fista_l1_dft_fused_torch",
    "check_fista_l1_dft_fused",
    "solve_fista_l1_dft_fused",
]


def fista_l1_dft_fused_torch(x0hat, scal, tab, tables):
    """Plain version: `x0hat` (B, H, W), `scal` (B, 2) = [ρ, λ_eff], `tab`
    the momentum table (one row per iteration), `tables` the
    ``_dft_common.dft_tables`` of the mask. Returns x in x0hat's dtype."""

    def col(v):
        return v.view(-1, 1, 1)

    rho, lam = col(scal[:, 0]), col(scal[:, 1])
    t = rho * lam
    eps = torch.finfo(x0hat.dtype).eps
    x = x_prev = x0hat * 0.0
    for i in range(tab.shape[0]):
        x_mom = x + tab[i, 0] * (x - x_prev)
        res = _dft_common.real_normal(x_mom, tables) - x0hat
        xg = x_mom - rho * res
        mag = xg.abs()
        x, x_prev = torch.clamp(mag - t, min=0.0) * (xg + eps) / (mag + eps), x
    return x


def _launch(x0hat, scal, tab, tables):
    from .. import _build

    B, H, W = x0hat.shape
    lib = _build.load_library()
    dev = x0hat.device
    tw = _dft_common.twiddle_tensor(tables)
    weights = tables[2].contiguous()
    out = torch.empty_like(x0hat)
    # x_prev, x_mom and the spectrum's (re, im)
    scratch = torch.empty((4, B, H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.fista_l1_dft_fused_launch(
            x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), tw.data_ptr(),
            weights.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, H, W, tab.shape[0],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "fista_l1_dft_fused_launch")
    fista_l1_dft_fused.launches += 1
    return out


def fista_l1_dft_fused(x0hat_b, mask, rho, lam, iterations: int):
    """Batched FISTA-L1 on the subsampled DFT of `mask` (H, W), one CTA per
    problem.

    x0hat_b: (B, H, W), Aᴴb per problem; rho, lam: scalars or (B,) (λ
    already normalization-scaled). The plain version runs for a CPU
    tensor, the CUDA kernel (float32) for a CUDA tensor.
    ``fista_l1_dft_fused.launches`` counts the kernel's launches."""
    np_dt = torch.empty((), dtype=x0hat_b.dtype).numpy().dtype
    scal = problem_scalars(x0hat_b, rho, lam, np_dt)
    tab = torch.as_tensor(_momentum_table("fista", iterations, dtype=np_dt),
                          device=x0hat_b.device)
    tables = _dft_common.dft_tables(mask, x0hat_b.dtype)
    if x0hat_b.device.type == "cpu":
        return fista_l1_dft_fused_torch(x0hat_b, scal, tab, tables)
    _dft_common.check_dft_cuda_input("fista_l1_dft_fused", x0hat_b, mask)
    return _launch(x0hat_b.contiguous(), scal, tab, tables)


fista_l1_dft_fused.launches = 0


def check_fista_l1_dft_fused(solver):
    """Validate `solver` for the fused FISTA-L1-DFT path (raises ValueError
    naming the first unsupported piece)."""
    if not isinstance(solver, FISTA):
        raise ValueError("fused path requires a FISTA solver")
    _dft_common.check_fft_normal(solver, SubsampledDFT2RealOperator)
    if not isinstance(solver.reg, L1Regularization):
        raise ValueError("fused path requires L1Regularization")
    _dft_common.check_fista_schedule(solver)


def solve_fista_l1_dft_fused(solver, B_mat):
    """Drop-in fast path for `solve_batched_unrolled(solver, B)` when the
    solver is FISTA + SubsampledDFT2RealOperator + L1 (BASELINE
    configuration #2's shape). Returns the n×K solution matrix."""
    check_fista_l1_dft_fused(solver)
    op = solver.A
    H, W = op.im_shape
    x0, lam_eff = _dft_common.seed_and_lam(solver, B_mat, solver.reg)
    out = fista_l1_dft_fused(x0.reshape(-1, H, W), op.mask, solver.rho, lam_eff,
                             solver.iterations)
    return out.reshape(out.shape[0], H * W).T

