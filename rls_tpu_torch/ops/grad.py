"""Finite-difference gradient operator (TV's regTrafo).

PyTorch counterpart of ``GradientOperator`` (``rls_tpu/ops/grad.py:35-90``).
Forward differences along each requested axis are concatenated:
``y = vcat_d (x[..., 1:, ...] - x[..., :-1, ...])``; the adjoint is the
negative divergence. Leading batch axes pass through. The operator holds
no tensors; ``device`` (default ``"cuda"``) is what it reports as its
device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import LinearOperator

__all__ = ["GradientOperator"]


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
