"""Orthogonal discrete wavelet transform operator (sparsifying transform).

PyTorch counterpart of ``rls_tpu/ops/wavelet.py``: ``WAVELET_FILTERS``,
``_qmf``, ``_analysis``, ``_synthesis``, ``max_wavelet_levels`` and
``WaveletOperator`` (:49-267). A periodized orthogonal DWT (Haar and
Daubechies) on 1-D or 2-D signals: each analysis step is ``L`` rolls
(``torch.roll``) and one stride-2 slice along an image axis, and ``rmv``
is its written transpose (zero-upsample and rolls the other way), which
orthogonality makes the exact inverse, so ``normal`` is the identity.
Several levels recurse on the low band in the packed quadrant layout
(approximation in the top-left corner). The filters are real, so complex
signals transform componentwise.

The signal is flat along the last axis; leading axes are a batch.
"""

from __future__ import annotations

import math

import torch

from .base import LinearOperator

__all__ = ["WaveletOperator", "WAVELET_FILTERS", "max_wavelet_levels"]


# Orthonormal scaling (low-pass analysis) filters. High-pass follows from the
# quadrature-mirror relation g[j] = (-1)^j h[L-1-j].
_SQRT2 = math.sqrt(2.0)
_SQRT3 = math.sqrt(3.0)
WAVELET_FILTERS: dict[str, tuple[float, ...]] = {
    "haar": (1.0 / _SQRT2, 1.0 / _SQRT2),
    "db2": (
        (1.0 + _SQRT3) / (4.0 * _SQRT2),
        (3.0 + _SQRT3) / (4.0 * _SQRT2),
        (3.0 - _SQRT3) / (4.0 * _SQRT2),
        (1.0 - _SQRT3) / (4.0 * _SQRT2),
    ),
    "db4": (
        0.23037781330885523,
        0.7148465705525415,
        0.6308807679295904,
        -0.02798376941698385,
        -0.18703481171888114,
        0.030841381835986965,
        0.032883011666982945,
        -0.010597401784997278,
    ),
    "db6": (
        0.11154074335008017,
        0.4946238903983854,
        0.7511339080215775,
        0.3152503517092432,
        -0.22626469396516913,
        -0.12976686756709563,
        0.09750160558707936,
        0.02752286553001629,
        -0.031582039318031156,
        0.0005538422009938016,
        0.004777257511010651,
        -0.001077301085308479,
    ),
    "db8": (
        0.05441584224308161,
        0.31287159091446592,
        0.67563073629801285,
        0.58535468365486909,
        -0.01582910525602,
        -0.28401554296242809,
        0.00047248457399797254,
        0.128747426620186,
        -0.01736930100202211,
        -0.044088253931064719,
        0.013981027917015516,
        0.0087460940470156547,
        -0.0048703529930106603,
        -0.00039174037299597711,
        0.00067544940599855677,
        -0.00011747678400228192,
    ),
    # Symlet-4: Daubechies-4 moments with near-linear phase.
    "sym4": (
        0.0322231006040427,
        -0.012603967262037833,
        -0.09921954357684722,
        0.29785779560527736,
        0.8037387518059161,
        0.49761866763201545,
        -0.02963552764599851,
        -0.07576571478927333,
    ),
}
WAVELET_FILTERS["db1"] = WAVELET_FILTERS["haar"]


def _qmf(h: tuple[float, ...]) -> tuple[float, ...]:
    L = len(h)
    return tuple(((-1.0) ** j) * h[L - 1 - j] for j in range(L))


def _every_other(ndim, dim):
    sl = [slice(None)] * ndim
    sl[dim] = slice(0, None, 2)
    return tuple(sl)


def _analysis(x, h, g, dim):
    """One periodized analysis step along `dim` → (low, high) bands."""
    acc_lo = h[0] * x
    acc_hi = g[0] * x
    for j in range(1, len(h)):
        xs = torch.roll(x, -j, dims=dim)
        acc_lo = acc_lo + h[j] * xs
        acc_hi = acc_hi + g[j] * xs
    sl = _every_other(x.ndim, dim)
    return acc_lo[sl], acc_hi[sl]


def _synthesis(lo, hi, h, g, dim):
    """Transpose of :func:`_analysis` (its inverse, by orthogonality)."""
    shape = list(lo.shape)
    shape[dim] = 2 * shape[dim]
    sl = _every_other(lo.ndim, dim)
    u_lo = lo.new_zeros(shape)
    u_lo[sl] = lo
    u_hi = hi.new_zeros(shape)
    u_hi[sl] = hi
    acc = h[0] * u_lo + g[0] * u_hi
    for j in range(1, len(h)):
        acc = acc + h[j] * torch.roll(u_lo, j, dims=dim)
        acc = acc + g[j] * torch.roll(u_hi, j, dims=dim)
    return acc


def max_wavelet_levels(im_shape: tuple[int, ...], wavelet: str = "db2") -> int:
    """Deepest usable level count: every dim must stay even and at least as
    long as the filter at each level (Wavelets.jl ``maxtransformlevels``,
    tightened by the filter length for the periodized transform)."""
    L = len(WAVELET_FILTERS[wavelet])
    lev = 0
    dims = list(im_shape)
    while all(d % 2 == 0 and d >= max(L, 2) for d in dims):
        lev += 1
        dims = [d // 2 for d in dims]
    return lev


class WaveletOperator(LinearOperator):
    """Orthogonal periodized DWT on a flattened 1-D/2-D signal.

    ``mv`` = analysis (image → packed coefficients), ``rmv`` = synthesis
    (the exact inverse), ``normal`` = the identity."""

    def __init__(self, im_shape, wavelet: str = "db2", levels=None, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        im_shape = (im_shape,) if isinstance(im_shape, int) else tuple(int(s) for s in im_shape)
        if wavelet not in WAVELET_FILTERS:
            raise ValueError(f"unknown wavelet {wavelet!r}; available: {sorted(WAVELET_FILTERS)}")
        if len(im_shape) not in (1, 2):
            raise ValueError(f"WaveletOperator supports 1-D and 2-D signals, got shape {im_shape}")
        if levels is None:
            levels = max_wavelet_levels(im_shape, wavelet)
        if levels < 1:
            raise ValueError("levels must be >= 1")
        L = len(WAVELET_FILTERS[wavelet])
        for d in im_shape:
            if d % (1 << levels):
                raise ValueError(f"dim {d} not divisible by 2^levels = {1 << levels}")
            if (d >> (levels - 1)) < max(L, 2):
                raise ValueError(f"dim {d} too short for {levels} levels of {wavelet!r} "
                                 f"(filter length {L})")
        self.im_shape = im_shape
        self.wavelet = wavelet
        self.levels = int(levels)
        self._dtype = dtype
        self._device = torch.device(device)

    @property
    def in_size(self) -> int:
        return math.prod(self.im_shape)

    @property
    def out_size(self) -> int:
        return self.in_size

    @property
    def dtype(self):
        return self._dtype

    def _filters(self):
        h = WAVELET_FILTERS[self.wavelet]
        return h, _qmf(h)

    def _fwd(self, im, level):
        if level == 0:
            return im
        h, g = self._filters()
        if len(self.im_shape) == 1:
            lo, hi = _analysis(im, h, g, -1)
            return torch.cat([self._fwd(lo, level - 1), hi], dim=-1)
        lo0, hi0 = _analysis(im, h, g, -2)
        ll, lh = _analysis(lo0, h, g, -1)
        hl, hh = _analysis(hi0, h, g, -1)
        top = torch.cat([self._fwd(ll, level - 1), lh], dim=-1)
        bot = torch.cat([hl, hh], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def _inv(self, c, level):
        if level == 0:
            return c
        h, g = self._filters()
        if len(self.im_shape) == 1:
            n2 = c.shape[-1] // 2
            lo = self._inv(c[..., :n2], level - 1)
            return _synthesis(lo, c[..., n2:], h, g, -1)
        H2, W2 = c.shape[-2] // 2, c.shape[-1] // 2
        ll = self._inv(c[..., :H2, :W2], level - 1)
        lo0 = _synthesis(ll, c[..., :H2, W2:], h, g, -1)
        hi0 = _synthesis(c[..., H2:, :W2], c[..., H2:, W2:], h, g, -1)
        return _synthesis(lo0, hi0, h, g, -2)

    def _image(self, x):
        return x.reshape(*x.shape[:-1], *self.im_shape)

    def mv(self, x):
        return self._fwd(self._image(x), self.levels).reshape(x.shape)

    def rmv(self, y):
        return self._inv(self._image(y), self.levels).reshape(y.shape)

    def normal(self, x):
        return x  # WᴴW = I for orthogonal filters
