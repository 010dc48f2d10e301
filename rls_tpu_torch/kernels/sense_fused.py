"""The whole batched FISTA-L21 multi-coil SENSE solve as ONE launch: the
hand-written CUDA kernel ``csrc/sense_fused.cu`` and its plain PyTorch
version.

Counterpart of ``rls_tpu/kernels/sense_fused.py``: ``_kernel`` (:33-82),
``fista_l21_sense_fused`` (:85-133), ``check_fista_l21_sense_fused``
(:136-179) and ``solve_fista_l21_sense_fused`` (:198-235). The complex
image x = (xr, xi) of each slice, complex L1 as ``L21Regularization(λ,
slices=2)`` (the group soft threshold over (re, im) pairs), fixed
iterations, per problem

    a      = momentum table, column 0
    m      = x + a (x − x_prev)                       (both planes)
    g      = m − ρ (Σ_c C̄_c Fᴴ M F C_c m − x0hat)
    |g|    = √(gr² + gi²)
    x      = g · max((|g| − ρλ) / (|g| or 1 where 0), 0)

from x = x_prev = 0. The SENSE normal op multiplies by each coil's map,
runs the masked normal op of the in-kernel FFT, and accumulates the
conjugate maps in coil order (``_dft_common.sense_normal``).

Not carried over: the TPU's bf16 hi/lo DFT factors, its VMEM gate
``_check_vmem_sense`` and ``interpret=``.
"""

from __future__ import annotations

import torch

from ..models.prox import L21Regularization
from ..models.solvers.fista import FISTA
from ..ops.dft_real import SenseDFT2RealOperator
from . import _dft_common
from ._dft_common import (
    check_dft_cuda_input,
    check_fft_normal,
    check_fista_schedule,
    seed_and_lam,
    twiddle_tensor,
)
from .fista_tv_fused import momentum_tensor, problem_scalars

__all__ = [
    "fista_l21_sense_fused",
    "fista_l21_sense_fused_torch",
    "check_fista_l21_sense_fused",
    "solve_fista_l21_sense_fused",
]


def group_threshold(gr, gi, t):
    """The L21 prox over (re, im) pairs at strength t, as the kernels form
    it (``prox.py`` ``_group_scale``, the ``gn == 0`` guard included)."""
    gn = torch.sqrt(gr * gr + gi * gi)
    scale = torch.clamp((gn - t) / torch.where(gn == 0, torch.ones_like(gn), gn), min=0.0)
    return gr * scale, gi * scale


def fista_l21_sense_fused_torch(x0hat, scal, tab, coils, tables):
    """Plain version: `x0hat` (B, 2, H, W) the split [re; im] Aᴴb, `scal`
    (B, 2) = [ρ, λ_eff], `tab` the momentum table, `coils` the maps
    (coils_r, coils_i), (C, H, W) each, `tables` the ``dft_tables`` of the
    mask. Returns x (B, 2, H, W) in x0hat's dtype."""

    def col(v):
        return v.view(-1, 1, 1)

    rho, lam = col(scal[:, 0]), col(scal[:, 1])
    t = rho * lam
    x0r, x0i = x0hat[:, 0], x0hat[:, 1]
    xr = xi = pr = pi = x0r * 0.0
    for i in range(tab.shape[0]):
        a = tab[i, 0]
        mr = xr + a * (xr - pr)
        mi = xi + a * (xi - pi)
        nr, ni = _dft_common.sense_normal(mr, mi, *coils, tables)
        gr = mr - rho * (nr - x0r)
        gi = mi - rho * (ni - x0i)
        (xr, xi), pr, pi = group_threshold(gr, gi, t), xr, xi
    return torch.stack([xr, xi], dim=1)


def sense_args(x0hat_b, coils, mask):
    """(coils, tables) of a SENSE kernel call in x0hat's dtype."""
    coils = tuple(c.to(x0hat_b.dtype).contiguous() for c in coils)
    return coils, _dft_common.dft_tables(mask, x0hat_b.dtype)


def _launch(x0hat, scal, tab, coils, tables):
    from .. import _build

    B, _, H, W = x0hat.shape
    C = coils[0].shape[0]
    lib = _build.load_library()
    dev = x0hat.device
    tw = twiddle_tensor(tables)
    weights = tables[2].contiguous()
    out = torch.empty_like(x0hat)
    # m and x_prev (re, im), the spectrum and the coil sum (re, im)
    scratch = torch.empty((8, B, H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.sense_fused_launch(
            x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), tw.data_ptr(),
            weights.data_ptr(), coils[0].data_ptr(), coils[1].data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, H, W, C, tab.shape[0],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "sense_fused_launch")
    fista_l21_sense_fused.launches += 1
    return out


def fista_l21_sense_fused(x0hat_b, mask, coils_r, coils_i, rho, lam, iterations: int):
    """Batched FISTA-L21 on C-coil SENSE, one CTA per slice.

    x0hat_b: (B, 2, H, W) split [re; im] Aᴴb; mask (H, W); coils_r,
    coils_i (C, H, W); rho, lam: scalars or (B,) (λ already
    normalization-scaled). The plain version runs for a CPU tensor, the
    CUDA kernel (float32) for a CUDA tensor.
    ``fista_l21_sense_fused.launches`` counts the kernel's launches."""
    np_dt = torch.empty((), dtype=x0hat_b.dtype).numpy().dtype
    scal = problem_scalars(x0hat_b, rho, lam, np_dt)
    tab = momentum_tensor("fista", iterations, np_dt, x0hat_b.device)
    coils, tables = sense_args(x0hat_b, (coils_r, coils_i), mask)
    if x0hat_b.device.type == "cpu":
        return fista_l21_sense_fused_torch(x0hat_b, scal, tab, coils, tables)
    check_dft_cuda_input("fista_l21_sense_fused", x0hat_b, mask, *coils)
    return _launch(x0hat_b.contiguous(), scal, tab, coils, tables)


fista_l21_sense_fused.launches = 0


def check_fista_l21_sense_fused(solver):
    """Validate `solver` for the fused SENSE FISTA-L21 path (raises
    ValueError naming the first unsupported piece)."""
    if not isinstance(solver, FISTA):
        raise ValueError("fused path requires a FISTA solver")
    check_fft_normal(solver, SenseDFT2RealOperator)
    reg = solver.reg
    if not isinstance(reg, L21Regularization) or reg.slices != 2:
        raise ValueError(
            "fused path requires L21Regularization(slices=2) — the split-real form of complex L1"
        )
    check_fista_schedule(solver)


def solve_fista_l21_sense_fused(solver, B_mat):
    """Drop-in fast path for `solve_batched_unrolled(solver, B)` when the
    solver is FISTA + SenseDFT2RealOperator + L21(slices=2) (complex-L1
    SENSE MRI). Returns the n×K solution matrix ([re; im] rows)."""
    check_fista_l21_sense_fused(solver)
    op = solver.A
    H, W = op.im_shape
    x0, lam_eff = seed_and_lam(solver, B_mat, solver.reg)
    out = fista_l21_sense_fused(x0.reshape(-1, 2, H, W), op.mask, op.coils_r, op.coils_i,
                                solver.rho, lam_eff, solver.iterations)
    return out.reshape(out.shape[0], 2 * H * W).T
