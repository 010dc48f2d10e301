"""Direct and separable (banded-matmul) 2-D convolution operators.

PyTorch counterpart of ``rls_tpu/ops/conv_direct.py``:
``DirectConvOperator`` with ``_conv2d_same`` (:27-80), a SAME zero-padded
convolution by ``torch.nn.functional.conv2d`` (a cross-correlation, as
``lax.conv_general_dilated`` is) with cuDNN's TF32 kept off inside the
operator; and ``SeparableConvOperator`` (:106-296) with ``_banded``
(:83-95):
``from_taps`` / ``from_kernel`` build the banded factors in f64 on the
host and put them on ``device`` (default ``"cuda"``); ``mv``, ``rmv`` and
``normal`` are plain banded products; ``taps_hw`` and the exact
shift-and-add adjoint ``rmv_stencil`` are kept.

Dropped: the ``cat`` factors and the ``_split_bf16`` hi/lo compensation
(:239-252). They exist because the TPU rounds every matmul input to bf16;
the H100 computes f32 matmuls natively (TF32 must stay off, which is
PyTorch's default for ``torch.matmul``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .base import LinearOperator, no_tf32

__all__ = ["DirectConvOperator", "SeparableConvOperator", "shift_zero"]


def _conv2d_same(img, kern):
    """SAME zero-padded 2-D cross-correlation of img (B, H, W) with kern
    (kh, kw): (kh − 1)//2 rows of zeros before and kh//2 after (XLA's SAME
    split), the same along the columns."""
    kh, kw = kern.shape
    img = F.pad(img[:, None], ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    with no_tf32():
        return F.conv2d(img, kern[None, None])[:, 0]


class DirectConvOperator(LinearOperator):
    """2-D SAME zero-padded convolution of a flattened real image with any
    kernel (kh, kw); the adjoint is the correlation with the flipped
    conjugate kernel (exact for odd sizes, as in ``rls_tpu``)."""

    def __init__(self, kernel, im_shape, device="cuda"):
        super().__init__()
        self.register_buffer("kernel", torch.as_tensor(kernel, device=device))
        self.im_shape = tuple(int(s) for s in im_shape)

    @property
    def in_size(self) -> int:
        h, w = self.im_shape
        return h * w

    @property
    def out_size(self) -> int:
        return self.in_size

    @property
    def dtype(self):
        return self.kernel.dtype

    def _conv(self, x, kern):
        return _conv2d_same(x.reshape(-1, *self.im_shape), kern).reshape(x.shape)

    def mv(self, x):
        return self._conv(x, self.kernel)

    def rmv(self, y):
        return self._conv(y, self.kernel.conj().flip((0, 1)))


def _banded(n: int, taps) -> np.ndarray:
    """Dense (n, n) matrix of SAME zero-padded 1-D convolution with `taps`
    (odd length), built in float64 so the normal-op factors are exact to
    working-precision roundoff."""
    taps = np.asarray(taps, np.float64)
    k = taps.shape[0]
    m = np.zeros((n, n), np.float64)
    for i, t in enumerate(taps):
        off = i - k // 2
        m += np.diag(np.full(n - abs(off), float(t), np.float64), k=off)
    return m


def shift_zero(u: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """``out[i] = u[i + s]`` along `dim`, zero where ``i + s`` falls
    outside (a zero-padded shift, no wrap-around)."""
    if s == 0:
        return u
    n = u.shape[dim]
    if abs(s) >= n:
        return torch.zeros_like(u)
    pad_shape = list(u.shape)
    pad_shape[dim] = abs(s)
    zeros = u.new_zeros(pad_shape)
    if s > 0:
        return torch.cat([u.narrow(dim, s, n - s), zeros], dim=dim)
    return torch.cat([zeros, u.narrow(dim, 0, n + s)], dim=dim)


def stencil_pass(img: torch.Tensor, taps, dim: int, adjoint: bool):
    """One zero-padded 1-D correlation pass ``Σ_k t_k u[i + s_k]``
    (``s_k = k − K//2``, negated for the adjoint), summed in tap order —
    the order of ``SeparableConvOperator._stencil_pass`` (:263-279)."""
    r = len(taps) // 2
    acc = None
    for i, t in enumerate(taps):
        s = i - r
        if adjoint:
            s = -s
        term = t * shift_zero(img, s, dim)
        acc = term if acc is None else acc + term
    return acc


class SeparableConvOperator(LinearOperator):
    """2-D SAME zero-padded convolution with a separable (rank-1) kernel
    ``k = outer(taps_h, taps_w)``, evaluated as two banded matrix products
    ``Y = A_h X A_wᵀ``; the fused ``normal`` applies the Gram factors
    ``B = AᵀA`` (built in f64 on host): ``AᴴA X = B_h X B_wᵀ``.

    ``taps`` holds the 1-D taps as Python floats rounded to the factors'
    dtype (what ``rls_tpu``'s ``taps_hw()`` re-extracts from its banded
    factors); the stencil paths need them.
    """

    def __init__(self, ah, aw, bh, bw, im_shape, taps=None):
        super().__init__()
        for name, val in (("ah", ah), ("aw", aw), ("bh", bh), ("bw", bw)):
            self.register_buffer(name, torch.as_tensor(val))
        self.im_shape = tuple(int(s) for s in im_shape)
        self.taps = (
            None if taps is None
            else tuple(tuple(float(t) for t in tp) for tp in taps)
        )

    @classmethod
    def from_taps(cls, taps_h, taps_w, im_shape, dtype=torch.float32, device="cuda"):
        h, w = im_shape
        a_h = _banded(h, taps_h)
        a_w = _banded(w, taps_w)
        b_h = a_h.T @ a_h
        b_w = a_w.T @ a_w
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        # taps as rls_tpu's taps_hw() reads them back: row k//2 of the
        # factor in its own dtype
        taps = tuple(
            tuple(float(t) for t in mat.astype(np_dtype)[len(tp) // 2, : len(tp)])
            for mat, tp in ((a_h, np.ravel(taps_h)), (a_w, np.ravel(taps_w)))
        )
        return cls(
            ah=torch.as_tensor(a_h, dtype=dtype, device=device),
            aw=torch.as_tensor(a_w, dtype=dtype, device=device),
            bh=torch.as_tensor(b_h, dtype=dtype, device=device),
            bw=torch.as_tensor(b_w, dtype=dtype, device=device),
            im_shape=(h, w),
            taps=taps,
        )

    @classmethod
    def from_kernel(cls, kernel, im_shape, dtype=torch.float32, rank_tol=1e-6, device="cuda"):
        """Factor a 2-D kernel via SVD; requires numerical rank 1."""
        k = np.asarray(kernel, np.float64)
        u, s, vt = np.linalg.svd(k)
        if s.shape[0] > 1 and s[1] > rank_tol * s[0]:
            raise ValueError(
                f"kernel is not separable (σ2/σ1 = {s[1]/s[0]:.2e}); "
                "use DirectConvOperator"
            )
        taps_h = u[:, 0] * np.sqrt(s[0])
        taps_w = vt[0] * np.sqrt(s[0])
        # fix sign so the dominant tap is positive (pure convention)
        if taps_h[len(taps_h) // 2] < 0:
            taps_h, taps_w = -taps_h, -taps_w
        return cls.from_taps(taps_h, taps_w, im_shape, dtype, device)

    @property
    def in_size(self) -> int:
        h, w = self.im_shape
        return h * w

    @property
    def out_size(self) -> int:
        return self.in_size

    @property
    def dtype(self):
        return self.ah.dtype

    def taps_hw(self):
        """The 1-D (taps_h, taps_w) as Python floats."""
        if self.taps is None:
            raise ValueError("operator was built without tap metadata")
        return self.taps

    def _sandwich(self, x, left, right_t):
        img = x.reshape(*x.shape[:-1], *self.im_shape)
        return (left @ img @ right_t).reshape(x.shape)

    def mv(self, x):
        return self._sandwich(x, self.ah, self.aw.T)

    def rmv(self, y):
        return self._sandwich(y, self.ah.T, self.aw)

    def normal(self, x):
        return self._sandwich(x, self.bh, self.bw.T)

    def rmv_stencil(self, y):
        """Exact adjoint via shift-and-add stencil passes (no matmul);
        O(k·n) per axis, so only sensible for short taps."""
        self.check_device(y)
        taps_h, taps_w = self.taps_hw()
        img = y.reshape(*y.shape[:-1], *self.im_shape)
        img = stencil_pass(img, taps_h, -2, adjoint=True)
        img = stencil_pass(img, taps_w, -1, adjoint=True)
        return img.reshape(y.shape)
