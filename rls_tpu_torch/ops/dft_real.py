"""Subsampled 2-D DFT and multi-coil SENSE in split real/imaginary form.

PyTorch counterpart of ``rls_tpu/ops/dft_real.py``:
``SubsampledDFT2RealOperator`` (:105-187, ``from_mask``,
``from_sample_idx``) and ``SenseDFT2RealOperator`` (:190-293,
``from_maps``). The API keeps the split-real layout:

  * an image is a flat real vector, (H·W,) for the subsampled DFT, or
    ``[re; im]`` of length 2·H·W for SENSE;
  * measurements are ``[re; im]`` of the masked spectrum (2·H·W), or
    (C, 2, H, W) flattened for C coils.

Inside, the operators compute with ``torch.fft.fft2`` / ``ifft2``
(``norm="ortho"``, cuFFT on the card) on complex tensors. The JAX
package evaluates the unitary DFT as dense real matrix products with bf16
hi/lo compensation because its TPU runtime has neither FFT nor complex
dtypes; the stacked factors (``cat``), the ``compensated`` switch and the
factor fields (:57-86) have no counterpart here. ``mask``, ``coils_r``,
``coils_i`` and ``im_shape`` keep their JAX names. The fused kernels of
the CS and SENSE solves (``kernels/fista_l1_dft_fused.py``,
``kernels/sense_fused.py``, ``kernels/splitbregman_fused.py``) run their
own FFT and read ``mask`` and the coil maps from these operators.

Leading batch axes pass through.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import LinearOperator

__all__ = ["SubsampledDFT2RealOperator", "SenseDFT2RealOperator"]


def _fft2(u):
    return torch.fft.fft2(u, norm="ortho")


def _ifft2(k):
    return torch.fft.ifft2(k, norm="ortho")


class SubsampledDFT2RealOperator(LinearOperator):
    """Real-valued subsampled unitary 2-D DFT on a REAL (H, W) image.

    in: flat real image (H·W,); out: stacked real/imag samples (2·H·W,),
    zero at the unsampled frequencies.
    """

    def __init__(self, mask, im_shape):
        super().__init__()
        self.im_shape = tuple(int(s) for s in im_shape)
        self.register_buffer("mask", torch.as_tensor(mask).reshape(self.im_shape))

    @classmethod
    def from_mask(cls, mask, im_shape, dtype=torch.float32, device="cuda"):
        m = torch.as_tensor(np.asarray(mask), dtype=dtype, device=device)
        return cls(m.reshape(tuple(im_shape)), im_shape)

    @classmethod
    def from_sample_idx(cls, sample_idx, im_shape, dtype=torch.float32, device="cuda"):
        """Same sampling convention as SubsampledFFTOperator: int indices
        into the flattened (row-major) frequency plane."""
        h, w = im_shape
        m = torch.zeros(h * w, dtype=dtype, device=device)
        m[torch.as_tensor(np.asarray(sample_idx), device=device).to(torch.int64)] = 1.0
        return cls(m.reshape(h, w), im_shape)

    @property
    def in_size(self) -> int:
        h, w = self.im_shape
        return h * w

    @property
    def out_size(self) -> int:
        return 2 * self.in_size

    @property
    def dtype(self):
        return self.mask.dtype

    def _image(self, x):
        return x.reshape(*x.shape[:-1], *self.im_shape)

    def mv(self, x):
        k = _fft2(self._image(x))
        lead = x.shape[:-1]
        return torch.cat([(k.real * self.mask).reshape(*lead, -1),
                          (k.imag * self.mask).reshape(*lead, -1)], dim=-1)

    def rmv(self, y):
        n = self.in_size
        kr = self._image(y[..., :n]) * self.mask
        ki = self._image(y[..., n:]) * self.mask
        return _ifft2(torch.complex(kr, ki)).real.reshape(*y.shape[:-1], n)

    def normal(self, x):
        return _ifft2(_fft2(self._image(x)) * self.mask).real.reshape(x.shape)


class SenseDFT2RealOperator(LinearOperator):
    """Multi-coil SENSE MRI operator ``A = stack_c (M ∘ F ∘ C_c)`` in split
    real/imaginary form: the complex image x is the flat real vector [xr;
    xi] (2·H·W,), each coil multiplies it by its complex sensitivity map,
    the unitary DFT and the k-space mask follow, and the measurements stack
    as (C, 2, H, W), flattened. BASELINE configuration #4's measurement
    model."""

    def __init__(self, coils_r, coils_i, mask, im_shape):
        super().__init__()
        self.im_shape = tuple(int(s) for s in im_shape)
        self.register_buffer("coils_r", torch.as_tensor(coils_r))
        self.register_buffer("coils_i", torch.as_tensor(coils_i))
        self.register_buffer("mask", torch.as_tensor(mask).reshape(self.im_shape))

    @classmethod
    def from_maps(cls, coil_maps, mask, im_shape, dtype=torch.float32, device="cuda"):
        """coil_maps: complex (C, H, W) array; mask: (H, W) binary."""
        cm = np.asarray(coil_maps)
        h, w = im_shape

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return cls(t(cm.real), t(cm.imag), t(mask).reshape(h, w), im_shape)

    @property
    def n_coils(self) -> int:
        return self.coils_r.shape[0]

    @property
    def in_size(self) -> int:
        h, w = self.im_shape
        return 2 * h * w

    @property
    def out_size(self) -> int:
        h, w = self.im_shape
        return 2 * self.n_coils * h * w

    @property
    def dtype(self):
        return self.coils_r.dtype

    def _maps(self):
        return torch.complex(self.coils_r, self.coils_i)

    def _coil_images(self, x):
        """The coil images C_c x, (..., C, H, W) complex."""
        n = self.in_size // 2
        lead = x.shape[:-1]
        z = torch.complex(x[..., :n], x[..., n:]).reshape(*lead, 1, *self.im_shape)
        return self._maps() * z

    def _coil_adj_sum(self, v, lead):
        """Σ_c conj(C_c) v_c as the flat [re; im] vector."""
        x = (self._maps().conj() * v).sum(dim=-3).reshape(*lead, -1)
        return torch.cat([x.real, x.imag], dim=-1)

    def mv(self, x):
        k = _fft2(self._coil_images(x)) * self.mask
        return torch.stack([k.real, k.imag], dim=-3).reshape(*x.shape[:-1], -1)

    def rmv(self, y):
        h, w = self.im_shape
        lead = y.shape[:-1]
        k = y.reshape(*lead, self.n_coils, 2, h, w) * self.mask
        return self._coil_adj_sum(_ifft2(torch.complex(k[..., 0, :, :], k[..., 1, :, :])), lead)

    def normal(self, x):
        v = _ifft2(_fft2(self._coil_images(x)) * self.mask)
        return self._coil_adj_sum(v, x.shape[:-1])
