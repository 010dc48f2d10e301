"""Finite-difference gradient operators (TV's regTrafo).

PyTorch counterparts of ``GradientOperator`` (``rls_tpu/ops/grad.py:35-90``)
and ``Grad8Operator`` (:93-147). ``GradientOperator`` concatenates the
forward differences along each requested axis,
``y = vcat_d (x[..., 1:, ...] - x[..., :-1, ...])``; the adjoint is the
negative divergence. ``Grad8Operator`` stacks PDHG's 8 directional
differences. Leading batch axes pass through. The operators hold no
tensors; ``device`` (default ``"cuda"``) is what they report as their
device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import LinearOperator
from .conv_direct import shift_zero

__all__ = ["GradientOperator", "Grad8Operator"]

# (row, column) offset of the subtracted sample per plane of Grad8Operator:
# axial, diagonal, knight-move (rls_tpu/kernels/pdhg_fused.py:46)
DIRS8 = ((1, 0), (0, 1), (1, 1), (1, -1), (2, 1), (2, -1), (1, 2), (1, -2))


def _axis_block_size(shape: tuple[int, ...], d: int) -> int:
    n = 1
    for i, s in enumerate(shape):
        n *= (s - 1) if i == d else s
    return n


class GradientOperator(LinearOperator):
    """Directional forward-difference operator on a flattened image."""

    def __init__(self, im_shape, dims=None, dtype=torch.complex64, device="cuda"):
        super().__init__()
        self._device = torch.device(device)
        self.im_shape = tuple(int(s) for s in im_shape)
        if dims is None:
            dims = tuple(range(len(self.im_shape)))
        elif isinstance(dims, int):
            dims = (dims,)
        self.dims = tuple(dims)
        self._dtype = dtype

    @property
    def in_size(self) -> int:
        n = 1
        for s in self.im_shape:
            n *= s
        return n

    @property
    def out_size(self) -> int:
        return sum(_axis_block_size(self.im_shape, d) for d in self.dims)

    @property
    def dtype(self):
        return self._dtype

    def mv(self, x):
        lead = x.shape[:-1]
        im = x.reshape(*lead, *self.im_shape)
        nb = len(lead)
        blocks = [torch.diff(im, dim=nb + d).reshape(*lead, -1) for d in self.dims]
        return torch.cat(blocks, dim=-1)

    def rmv(self, y):
        lead = y.shape[:-1]
        nd = len(self.im_shape)
        out = y.new_zeros(*lead, *self.im_shape)
        offset = 0
        for d in self.dims:
            bsize = _axis_block_size(self.im_shape, d)
            dshape = tuple(
                (s - 1) if i == d else s for i, s in enumerate(self.im_shape)
            )
            diff = y[..., offset : offset + bsize].reshape(*lead, *dshape)
            # adjoint of forward diff: out[..., :-1] -= diff; out[..., 1:] += diff
            # (F.pad lists (before, after) pairs from the LAST axis backwards)
            pad_lo = [0] * (2 * nd)
            pad_hi = [0] * (2 * nd)
            pad_lo[2 * (nd - 1 - d) + 1] = 1
            pad_hi[2 * (nd - 1 - d)] = 1
            out = out - F.pad(diff, pad_lo) + F.pad(diff, pad_hi)
            offset += bsize
        return out.reshape(*lead, -1)


def _shift2(u, dr: int, dc: int):
    """``out[r, c] = u[r + dr, c + dc]`` over the last two axes, zero where
    that falls outside."""
    return shift_zero(shift_zero(u, dr, -2), dc, -1)


def _grad8_masks(H: int, W: int, dtype, device):
    """(8, H, W): 1 where plane k of Grad8Operator is defined, row < H − dr
    and, for dc ≥ 0, column < W − dc, else column ≥ −dc."""
    row = torch.arange(H, device=device)[:, None]
    col = torch.arange(W, device=device)[None, :]
    masks = []
    for dr, dc in DIRS8:
        m = row < H - dr
        m = m & ((col < W - dc) if dc >= 0 else (col >= -dc))
        masks.append(m.to(dtype))
    return torch.stack(masks)


class Grad8Operator(LinearOperator):
    """The 8-direction finite differences of the reference's
    PrimalDualSolver: plane k holds ``u[r, c] − u[r + dr, c + dc]`` for the
    k-th offset of `DIRS8` on its defined region and 0 elsewhere, the 8
    planes stacked in that order.

    ``rmv`` is the true transpose written out as the fused PDHG kernel
    writes it (``rls_tpu/kernels/pdhg_fused.py:86-92``): per direction the
    plane masked, minus the masked plane shifted back by (dr, dc), the
    eight terms summed in plane order. (``rls_tpu`` takes it from
    ``jax.linear_transpose``; the two agree to rounding.)"""

    def __init__(self, im_shape, dtype=torch.float32, device="cuda"):
        super().__init__()
        self._device = torch.device(device)
        self.im_shape = tuple(int(s) for s in im_shape)
        self._dtype = dtype

    @property
    def in_size(self) -> int:
        m, n = self.im_shape
        return m * n

    @property
    def out_size(self) -> int:
        return 8 * self.in_size

    @property
    def dtype(self):
        return self._dtype

    def _masks(self, like):
        return _grad8_masks(*self.im_shape, like.dtype, like.device)

    def mv(self, x):
        lead = x.shape[:-1]
        u = x.reshape(*lead, *self.im_shape)
        masks = self._masks(u)
        planes = [(u - _shift2(u, dr, dc)) * masks[k] for k, (dr, dc) in enumerate(DIRS8)]
        return torch.stack(planes, dim=-3).reshape(*lead, -1)

    def rmv(self, y):
        lead = y.shape[:-1]
        planes = y.reshape(*lead, 8, *self.im_shape)
        masks = self._masks(planes)
        out = None
        for k, (dr, dc) in enumerate(DIRS8):
            q = planes[..., k, :, :] * masks[k]
            term = q - _shift2(q, -dr, -dc)
            out = term if out is None else out + term
        return out.reshape(*lead, -1)
