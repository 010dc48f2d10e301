"""Plain PyTorch versions of the pieces the two CUDA kernels share.

Counterparts of ``rls_tpu/kernels/_fgp_common.py``:

  * ``fgp_t2_schedule`` ← ``_fgp_t2_schedule`` (:621-633);
  * ``fgp_fold`` ← the fold FGP ``_fgp_unrolled_fold`` (:733-773), the
    TV prox inside the fused and tiled PGM-TV kernels; ``fgp_fold_warm``
    ← the stateful FGP of ``make_tv_fgp_stateful`` (:978-1034), which
    starts from carried λ-scaled duals (the fold form of its unrolled
    loop, :670-730);
  * ``fgp_loop`` ← the fori FGP ``fgp_loop`` of ``make_tv_fgp``
    (:939-964), the standalone TV prox kernel;
  * ``sepconv_stencil_normal`` ← the stencil Gram of
    ``make_sepconv_stencil_ops`` (:303-371), ``AᴴA u`` as four
    zero-padded shift-and-add passes;
  * ``tiled_halo`` and ``tile_windows`` ← the window rules of
    ``make_sepconv_normal_stencil_window`` (:381-429) and
    ``make_tv_fgp_window`` (:432-580) as the row-tiled kernel applies them.

``csrc/fgp_common.cuh`` holds the device functions both kernels share
(gradient, adjoint, stencil pass) and follows these op for op. Images are
(B, H, W) with the batch leading; per-problem scalars are (B, 1, 1).

Roll semantics, as on the TPU: ``gv(u) = u[i+1] − u[i]`` wraps at the
last row, which the zero clip bound (or the mask) kills; ``gt`` reads the
duals' row/column −1 from the wrapped LAST row/column, which is exactly 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.conv_direct import stencil_pass

__all__ = [
    "fgp_t2_schedule",
    "fgp_t2_table",
    "fgp_fold",
    "fgp_fold_warm",
    "fgp_loop",
    "sepconv_stencil_normal",
    "tiled_halo",
    "tile_windows",
]


def fgp_t2_schedule(iterations: int):
    """FGP momentum coefficients t2_i = (t_i − 1)/t_{i+1} as Python floats
    (f64 recurrence)."""
    t = 1.0
    out = []
    for _ in range(iterations):
        t_new = (1.0 + math.sqrt(1.0 + 4.0 * t * t)) / 2.0
        out.append((t - 1.0) / t_new)
        t = t_new
    return out


def fgp_t2_table(iterations: int, dtype=np.float32) -> np.ndarray:
    """(iterations, 2) rows ``[1 + t2_i, t2_i]``: the momentum constants of
    the fold FGP exactly as the JAX kernel rounds them (the sum ``1 + t2``
    is formed in f64, then rounded to `dtype`)."""
    t2 = fgp_t2_schedule(iterations)
    return np.asarray([[1.0 + t, t] for t in t2], np.float64).astype(dtype).reshape(
        iterations, 2
    )


def _masks(H, W, like):
    not_last_row = (torch.arange(H, device=like.device) < H - 1).to(like.dtype)
    not_last_col = (torch.arange(W, device=like.device) < W - 1).to(like.dtype)
    return not_last_row[:, None], not_last_col[None, :]


def _gv(u):
    return torch.roll(u, -1, dims=-2) - u


def _gh(u):
    return torch.roll(u, -1, dims=-1) - u


def _gt(pv, ph):
    return (torch.roll(pv, 1, dims=-2) - pv) + (torch.roll(ph, 1, dims=-1) - ph)


def _fgp_fold(xg, lam_tv, t2tab, duals):
    """Fold FGP from zero duals (``duals=None``, iteration 0 collapses to
    one gradient and a clip) or from carried ones; returns
    ``(x, (pv, ph))``."""
    H, W = xg.shape[-2:]
    mrow, mcol = _masks(H, W, xg)
    bv = lam_tv * mrow
    bh = lam_tv * mcol
    if duals is None:
        if t2tab.shape[0] == 0:
            return xg, None
        y = xg * 0.125
        pv = torch.clamp(_gv(y), -bv, bv)
        ph = torch.clamp(_gh(y), -bh, bh)
        start = 1
    else:
        pv, ph = duals
        start = 0
    rv, rh = pv, ph  # the dual momentum restarts every call: r ← p, t ← 1
    for i in range(start, t2tab.shape[0]):
        c1, c2 = t2tab[i, 0], t2tab[i, 1]
        y = (xg - _gt(rv, rh)) * 0.125
        qv = torch.clamp(rv + _gv(y), -bv, bv)
        qh = torch.clamp(rh + _gh(y), -bh, bh)
        rv = c1 * qv - c2 * pv
        rh = c1 * qh - c2 * ph
        pv, ph = qv, qh
    return xg - _gt(pv, ph), (pv, ph)


def fgp_fold(xg, lam_tv, t2tab):
    """Fold FGP: the λ-scaled dual loop with the boundary mask folded into
    the clip bounds ±λ·mask and the exact ×⅛ scale applied once per
    iteration. `xg` (B, H, W); `lam_tv` broadcastable to it; `t2tab` the
    ``fgp_t2_table`` rows (one per dual iteration)."""
    return _fgp_fold(xg, lam_tv, t2tab, None)[0]


def fgp_fold_warm(xg, lam_tv, t2tab, duals):
    """Fold FGP started from the λ-scaled duals ``(pv, ph)`` of the
    previous call (zeros at the first): returns ``(x, (pv, ph))``. Row 0
    of `t2tab` is ``[1, 0]``, so the first iteration is the plain step.
    With zero duals this is `fgp_fold` up to the sign of zeros. The carry
    is consistent only while `lam_tv` is the same at every call (FISTA's
    ρλ)."""
    return _fgp_fold(xg, lam_tv, t2tab, duals)


def fgp_loop(xg, lam_tv, iterations: int):
    """Fori FGP with the per-iteration t recurrence computed in the
    working dtype. `xg` (B, H, W); `lam_tv` broadcastable to it."""
    H, W = xg.shape[-2:]
    mrow, mcol = _masks(H, W, xg)
    lam_safe = torch.where(lam_tv > 0, lam_tv, torch.ones_like(lam_tv))
    inv8 = 1.0 / (8.0 * lam_safe)
    zeros = torch.zeros_like(xg)
    pv = ph = rv = rh = zeros
    t = torch.ones((), dtype=xg.dtype, device=xg.device)
    for _ in range(iterations):
        xtmp = xg - lam_tv * _gt(rv, rh)
        qv = rv + _gv(xtmp) * inv8
        qh = rh + _gh(xtmp) * inv8
        qv = torch.clamp(qv, -1.0, 1.0) * mrow
        qh = torch.clamp(qh, -1.0, 1.0) * mcol
        t_new = (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) / 2.0
        t2 = (t - 1.0) / t_new
        rv = (1.0 + t2) * qv - t2 * pv
        rh = (1.0 + t2) * qh - t2 * ph
        pv, ph, t = qv, qh, t_new
    return xg - lam_tv * _gt(pv, ph)


def sepconv_stencil_normal(u, taps_h, taps_w):
    """``AᴴA u`` of a separable conv as four zero-padded stencil passes:
    column pass, its adjoint, row pass, its adjoint (exact f32, no
    matmul). `u` (..., H, W)."""
    v = stencil_pass(u, taps_h, -2, adjoint=False)
    v = stencil_pass(v, taps_h, -2, adjoint=True)
    v = stencil_pass(v, taps_w, -1, adjoint=False)
    return stencil_pass(v, taps_w, -1, adjoint=True)


def tiled_halo(tv_iterations: int, kh: int) -> int:
    """Halo rows of a row tile: the dependence cone of one PGM iteration,
    two column stencil passes (2·(kh//2)) and the FGP (one row per dual
    iteration plus the final adjoint), plus one row to spare:
    ``(tv_iterations + 1) + 2·(kh//2) + 1`` (``fista_tv_tiled.py:726``,
    without the TPU's rounding up to 8 rows)."""
    return (tv_iterations + 1) + 2 * (kh // 2) + 1


def tile_windows(H: int, tile_rows: int, halo: int):
    """``(lo, hi, i0, i1)`` per row tile: the window is image rows
    [lo, hi), the tile's rows [t·TR, (t+1)·TR) clamped to the image and
    widened by `halo` on each side; its interior is window rows [i0, i1).

    A clamped window is treated as an image of its own: the stencil
    passes read zeros past its edges and the FGP masks its last row, as
    the whole-image functions do. At the image's top and bottom those are
    the image's own zero padding and masks (what the JAX window factories
    get from masks by global row); at an edge inside the image they are
    wrong, but only within the cone of `tiled_halo` rows, so the
    interior of every window equals the whole-image result. Tiling adds
    halo recompute, not approximation."""
    out = []
    for r0 in range(0, H, tile_rows):
        r1 = min(H, r0 + tile_rows)
        lo, hi = max(0, r0 - halo), min(H, r1 + halo)
        out.append((lo, hi, r0 - lo, r1 - lo))
    return out
