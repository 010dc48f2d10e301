"""Exact 1-D total-variation denoising (Condat's direct algorithm).

PyTorch counterpart of ``rls_tpu/models/tv_condat.py``:
``tv_denoise_1d_condat`` (:25-117), ``prox_tv_1d_axis`` (:120-126) and
``prox_tv_condat_nd`` (:129-137). Every line goes through
``kernels/tv_condat.py`` ``prox_tv1d_condat``: on the card one launch of
the hand-written kernel ``csrc/tv_condat.cu`` (one thread per line), on
the CPU its plain version, the same state machine stepped for all lines at
once. A λ is a scalar or carries the leading (problem) axes, one λ per
problem, broadcast to that problem's lines.
"""

from __future__ import annotations

import torch

from ..kernels.tv_condat import prox_tv1d_condat

__all__ = ["tv_denoise_1d_condat", "prox_tv_1d_axis", "prox_tv_condat_nd"]


def tv_denoise_1d_condat(c, lam):
    """Exact TV prox of real signals along the last axis:
    argmin_u ½‖u − c‖² + λ TV(u). `c` is (..., N); λ a scalar or one per
    leading index."""
    return prox_tv1d_condat(c, lam, c.ndim - 1)


def prox_tv_1d_axis(x_img, lam, axis: int):
    """Exact TV prox applied independently along `axis` of a real tensor
    (reference ProxTV.jl:64-79, the dims::Integer dispatch). λ is a scalar
    or carries a prefix of x_img's axes before `axis`."""
    return prox_tv1d_condat(x_img, lam, axis)


def prox_tv_condat_nd(x_img, lam, batch_dims: int = 0):
    """Averaged axis-sweep TV (reference ``proxTVCondat!``,
    ProxTVCondat.jl:4-19): the mean over the image axes of the per-axis
    exact 1-D TV prox. The first `batch_dims` axes are problems, not image
    axes (λ may carry them)."""
    nd = x_img.ndim - batch_dims
    out = torch.zeros_like(x_img)
    for d in range(batch_dims, x_img.ndim):
        out = out + prox_tv_1d_axis(x_img, lam, d) / nd
    return out
