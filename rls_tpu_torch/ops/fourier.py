"""FFT-based operators: subsampled Fourier (compressed sensing) and
circular convolution (deblurring).

PyTorch counterpart of ``rls_tpu/ops/fourier.py``: ``FFTOperator``
(:26-54), ``SubsampledFFTOperator`` (:57-98) and ``ConvolutionOperator``
(:101-151), on native complex tensors and ``torch.fft`` (cuFFT on the
card). The unitary operators use ``norm="ortho"`` where the JAX package
does; the convolution keeps the unnormalized pair. The normal operators
are fused as FFT → diagonal multiply → IFFT, with no gather or scatter.

Leading batch axes pass through; the image is flat along the last axis.
"""

from __future__ import annotations

import math

import torch

from .base import LinearOperator

__all__ = ["FFTOperator", "SubsampledFFTOperator", "ConvolutionOperator"]


def _image_dims(im_shape):
    return tuple(range(-len(im_shape), 0))


class _ShapedOperator(LinearOperator):
    """An operator on a flat image of shape `im_shape`."""

    im_shape: tuple

    @property
    def in_size(self) -> int:
        return math.prod(self.im_shape)

    @property
    def dtype(self):
        return torch.complex64

    def _image(self, x):
        return x.reshape(*x.shape[:-1], *self.im_shape)

    def _fftn(self, x, norm):
        return torch.fft.fftn(self._image(x), dim=_image_dims(self.im_shape), norm=norm)

    def _ifftn(self, k, norm):
        out = torch.fft.ifftn(k, dim=_image_dims(self.im_shape), norm=norm)
        return out.reshape(*out.shape[: -len(self.im_shape)], -1)


class FFTOperator(_ShapedOperator):
    """Unitary (ortho-normalized) n-D FFT on a flattened image."""

    def __init__(self, im_shape, device="cuda"):
        super().__init__()
        self.im_shape = tuple(int(s) for s in im_shape)
        self._device = torch.device(device)

    @property
    def out_size(self) -> int:
        return self.in_size

    def mv(self, x):
        k = self._fftn(x, "ortho")
        return k.reshape(*k.shape[: -len(self.im_shape)], -1)

    def rmv(self, y):
        return self._ifftn(self._image(y), "ortho")

    def normal(self, x):
        return x  # unitary


class SubsampledFFTOperator(_ShapedOperator):
    """``A = S ∘ F``: unitary FFT followed by sampling of `sample_idx`
    (indices into the flattened frequency plane). ``normal(x) = Fᴴ Sᵀ S F
    x`` is fused as FFT → binary mask → IFFT."""

    def __init__(self, sample_idx, im_shape, device="cuda"):
        super().__init__()
        self.im_shape = tuple(int(s) for s in im_shape)
        idx = torch.as_tensor(sample_idx, device=device).to(torch.int64)
        self.register_buffer("sample_idx", idx)

    @property
    def out_size(self) -> int:
        return self.sample_idx.shape[0]

    def _mask(self):
        m = torch.zeros(self.in_size, dtype=torch.float32, device=self.sample_idx.device)
        m[self.sample_idx] = 1.0
        return m.reshape(self.im_shape)

    def mv(self, x):
        k = self._fftn(x, "ortho")
        return k.reshape(*k.shape[: -len(self.im_shape)], -1)[..., self.sample_idx]

    def rmv(self, y):
        k = y.new_zeros(*y.shape[:-1], self.in_size)
        k[..., self.sample_idx] = y
        return self._ifftn(self._image(k), "ortho")

    def normal(self, x):
        return self._ifftn(self._fftn(x, "ortho") * self._mask(), "ortho")


class ConvolutionOperator(_ShapedOperator):
    """Circular convolution with a PSF given by its OTF (frequency
    response): ``mv = ifft(otf · fft(x))``, ``normal = ifft(|otf|² ·
    fft(x))``."""

    def __init__(self, otf, im_shape):
        super().__init__()
        self.im_shape = tuple(int(s) for s in im_shape)
        self.register_buffer("otf", torch.as_tensor(otf))

    @classmethod
    def from_kernel(cls, kernel, im_shape, device="cuda"):
        """Build from a spatial kernel (zero-padded, centred at index 0)."""
        kernel = torch.as_tensor(kernel, device=device).to(torch.complex64)
        pad = torch.zeros(tuple(im_shape), dtype=torch.complex64, device=device)
        pad[tuple(slice(0, k) for k in kernel.shape)] = kernel
        # centre the kernel at the origin for symmetric blurs
        shifts = tuple(-(k // 2) for k in kernel.shape)
        pad = torch.roll(pad, shifts, dims=tuple(range(len(im_shape))))
        return cls(otf=torch.fft.fftn(pad), im_shape=im_shape)

    @property
    def out_size(self) -> int:
        return self.in_size

    @property
    def dtype(self):
        return self.otf.dtype

    def mv(self, x):
        return self._ifftn(self.otf * self._fftn(x, "backward"), "backward")

    def rmv(self, y):
        return self._ifftn(self.otf.conj() * self._fftn(y, "backward"), "backward")

    def normal(self, x):
        return self._ifftn(self.otf.abs() ** 2 * self._fftn(x, "backward"), "backward")
