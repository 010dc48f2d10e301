"""Parallel-beam Radon transform operator (sparse-view CT).

PyTorch counterpart of ``rls_tpu/ops/radon.py`` (:27-77), the reference's
``RadonOp``. Each ray is sampled at the image's pixel pitch and each
sample read by bilinear interpolation, as
``map_coordinates(order=1, mode="constant")`` reads it there: the floor
of each coordinate, the four neighbours weighted by the products of
their 1-D weights (summed in that function's order), and zero for a
neighbour outside the image. The sample points and weights are computed
once, in float32 on the host (as ``rls_tpu`` computes them), and kept as
tables; an operator of another dtype holds the same weights in it.

``rmv`` (backprojection) is the written transpose: each weighted
detector value added to its four pixels with ``index_add_``, along the
first axis of a (pixels, problems) image so that each scatter moves a
whole row of problems (along the last axis the scatter took 1.26 ms a
call at 8 × 128², 90 × 128 on an H100; ``chip_smoke.py
--time-composite``). On the card that is an atomic scatter, so two runs
may differ in the last bits.
"""

from __future__ import annotations

import torch

from .base import LinearOperator

__all__ = ["RadonOperator"]


def _tables(angles, im_shape, num_det):
    """(idx, w): the four neighbours of every sample, (4, A·D·T) flat pixel
    indices (H·W for a neighbour outside the image: a zero slot) and their
    float32 weights, in ``map_coordinates``'s order."""
    H, W = im_shape
    n = H
    c = (n - 1) / 2.0
    theta = torch.as_tensor(angles, dtype=torch.float32, device="cpu")
    det = torch.arange(num_det, dtype=torch.float32) - (num_det - 1) / 2.0
    t = torch.arange(n, dtype=torch.float32) - c
    ct, st = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    rows = c + det[:, None] * ct + t[None, :] * (-st)
    cols = c + det[:, None] * st + t[None, :] * ct

    def nodes(coord, size):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        return [(index, 1 - upper_w, (index >= 0) & (index < size)),
                (index + 1, upper_w, (index + 1 >= 0) & (index + 1 < size))]

    idx, w = [], []
    for ir, wr, vr in nodes(rows, H):
        for ic, wc, vc in nodes(cols, W):
            idx.append(torch.where(vr & vc, ir.clamp(0, H - 1) * W + ic.clamp(0, W - 1), H * W))
            w.append(wr * wc)
    return torch.stack(idx).reshape(4, -1), torch.stack(w).reshape(4, -1)


class RadonOperator(LinearOperator):
    """Line integrals of an (N, N) image at `angles` (radians), `num_det`
    detectors (N by default). Output layout: (num_angles · num_det,),
    detector index fastest; leading axes are a batch."""

    def __init__(self, angles, im_shape, num_det: int = 0, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.im_shape = tuple(int(s) for s in im_shape)
        self.num_det = int(num_det) or self.im_shape[0]
        angles = torch.as_tensor(angles, dtype=torch.float32, device="cpu")
        idx, w = _tables(angles, self.im_shape, self.num_det)
        self.register_buffer("angles", angles.to(device))
        self.register_buffer("idx", idx.to(device))
        self.register_buffer("weights", w.to(device=device, dtype=dtype))
        self.n_samples = self.im_shape[0]

    @property
    def in_size(self) -> int:
        return self.im_shape[0] * self.im_shape[1]

    @property
    def out_size(self) -> int:
        return self.angles.shape[0] * self.num_det

    @property
    def dtype(self):
        return self.weights.dtype

    def mv(self, x):
        lead = x.shape[:-1]
        xpad = torch.cat([x.to(self.dtype), x.new_zeros((*lead, 1), dtype=self.dtype)], dim=-1)
        vals = None
        for k in range(4):
            part = self.weights[k] * xpad.index_select(-1, self.idx[k])
            vals = part if vals is None else vals + part
        return vals.reshape(*lead, self.out_size, self.n_samples).sum(dim=-1)

    def rmv(self, y):
        lead = y.shape[:-1]
        y = y.to(self.dtype).reshape(-1, self.out_size)
        rays = y.T.repeat_interleave(self.n_samples, dim=0)  # (samples, problems)
        out = y.new_zeros((self.in_size + 1, y.shape[0]))
        for k in range(4):
            out.index_add_(0, self.idx[k], self.weights[k][:, None] * rays)
        return out[: self.in_size].T.reshape(*lead, self.in_size)
