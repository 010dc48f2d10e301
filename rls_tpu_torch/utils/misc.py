"""Shared numeric utilities.

PyTorch counterpart of ``rls_tpu/utils/misc.py``: ``enf_real`` and
``enf_pos`` (:15-28), ``nrmsd`` (:31-45), ``im2col_distinct`` and
``col2im_distinct`` (:48-70). Leading axes are batch axes: ``nrmsd`` gives
one value per problem (over the last axis), and the block functions take
a batch of 2-D arrays.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["enf_real", "enf_pos", "nrmsd", "im2col_distinct", "col2im_distinct"]


def enf_real(x):
    """Project onto real numbers (keeps dtype: complex with zero imag)."""
    return torch.complex(x.real, torch.zeros_like(x.real)) if x.is_complex() else x


def enf_pos(x):
    """Zero out negative real parts (imaginary part untouched, as in the
    reference's enfPos!)."""
    if x.is_complex():
        return torch.complex(torch.clamp(x.real, min=0), x.imag)
    return torch.clamp(x, min=0)


def _vdot(a, b):
    return (a.conj() * b).sum(dim=-1)


def nrmsd(ref, reco):
    """Scale-calibrated normalized RMS deviation (reference Utils.jl:230),
    one per problem: `ref` and `reco` are (..., n)."""
    ref = torch.as_tensor(ref, device=reco.device)
    n = ref.shape[-1]
    denom = 2.0 * _vdot(reco, reco).real
    alpha = torch.where(
        torch.linalg.vector_norm(reco, dim=-1) > 0,
        (_vdot(ref, reco) + _vdot(reco, ref)).real / denom,
        torch.ones_like(denom),
    )
    i2 = reco * alpha.unsqueeze(-1).to(reco.dtype)
    rms = torch.linalg.vector_norm(ref - i2, dim=-1) / math.sqrt(n)
    spread = ref.abs().amax(dim=-1) - ref.abs().amin(dim=-1)
    return rms / spread


def im2col_distinct(a, blocksize):
    """Rearrange the distinct (non-overlapping) blocks of the last two axes
    of `a` into columns, zero-padding to a multiple of the block size:
    column k is block (i, j) with i fastest, each flattened column-major
    (the reference's layout)."""
    br, bc = blocksize
    r, c = a.shape[-2:]
    ap = F.pad(a, (0, (-c) % bc, 0, (-r) % br))
    R, C = ap.shape[-2:]
    t = ap.reshape(*a.shape[:-2], R // br, br, C // bc, bc)  # [..., i, r, j, c]
    return t.movedim((-1, -3, -2, -4), (-4, -3, -2, -1)).reshape(*a.shape[:-2], br * bc, -1)


def col2im_distinct(cols, blocksize, matsize):
    """Inverse of :func:`im2col_distinct` for exact multiples."""
    br, bc = blocksize
    r, c = matsize
    if r % br or c % bc:
        raise ValueError("matsize must be divisible by blocksize")
    lead = cols.shape[:-2]
    t = cols.reshape(*lead, bc, br, c // bc, r // br)  # [..., c, r, j, i]
    return t.movedim((-1, -3, -2, -4), (-4, -3, -2, -1)).reshape(*lead, r, c)
