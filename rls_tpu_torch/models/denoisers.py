"""Tiny CNN denoiser for plug-and-play priors.

PyTorch counterpart of ``rls_tpu/models/denoisers.py``: the 3-layer
residual CNN ``cnn_denoise`` (3×3 conv 1→C, relu, 3×3 conv C→C, relu, 3×3
conv C→1; ``denoise(x) = x − net(x)``), its He initialisation, its
training on synthetic piecewise-constant phantoms, and the callable
``PlugAndPlayRegularization`` takes. The convolutions are
``torch.nn.functional.conv2d`` with SAME padding, as the JAX package
computes them with ``lax.conv_general_dilated`` outside any Pallas
kernel. ``convert_cnn_params`` carries the JAX CNN's weights across, so
both packages denoise with the same network.

Deviations: the weights start from a seeded ``torch.Generator`` (the JAX
package splits a ``PRNGKey``), and ``train_denoiser`` steps
``torch.optim.Adam`` where the JAX package steps optax's Adam (the same
rule and defaults); the phantoms and the noise come from the same numpy
generator.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["init_cnn_params", "cnn_denoise", "train_denoiser", "make_pnp_model",
           "convert_cnn_params"]

_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def init_cnn_params(gen: torch.Generator, channels: int = 8, device="cuda"):
    """He-initialised weights of the 3-layer residual CNN on `device`, drawn
    from `gen` on gen's own device."""

    def he(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return (w * float(np.sqrt(2.0 / fan_in))).to(device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return {
        "w1": he((channels, 1, 3, 3), 9),
        "b1": zeros(channels),
        "w2": he((channels, channels, 3, 3), 9 * channels),
        "b2": zeros(channels),
        "w3": he((1, channels, 3, 3), 9 * channels),
        "b3": zeros(1),
    }


def convert_cnn_params(params, device="cuda"):
    """The JAX CNN's parameters (``rls_tpu`` ``init_cnn_params`` or
    ``train_denoiser``, arrays by name) as tensors on `device`."""
    return {k: torch.from_numpy(np.array(params[k])).to(device) for k in _NAMES}


def _conv(x, w, b):
    # x: (N, C_in, H, W), w: (C_out, C_in, 3, 3): SAME padding
    return F.conv2d(x, w, b, padding=1)


def cnn_denoise(params, img):
    """Residual denoise ``x − net(x)`` of a batch of images (B, H, W), one
    image (H, W), or a flat vector of square length, in one call."""
    shp = img.shape
    if img.ndim == 1:
        n = int(round(np.sqrt(img.shape[0])))
        img = img.reshape(n, n)
    x = img.reshape(-1, 1, *img.shape[-2:])
    h = torch.relu(_conv(x, params["w1"], params["b1"]))
    h = torch.relu(_conv(h, params["w2"], params["b2"]))
    noise = _conv(h, params["w3"], params["b3"])
    return (x - noise).reshape(shp)


def _phantom_batch(rng, n, batch):
    imgs = np.zeros((batch, n, n), np.float32)
    for b in range(batch):
        for _ in range(5):
            i0, j0 = rng.integers(0, n - n // 4, size=2)
            w, h = rng.integers(n // 8, n // 3, size=2)
            imgs[b, i0 : i0 + w, j0 : j0 + h] += rng.uniform(0.2, 0.8)
    return np.clip(imgs, 0.0, 1.0)


def train_denoiser(
    n: int,
    channels: int = 8,
    steps: int = 200,
    noise_sigma: float = 0.1,
    batch: int = 8,
    seed: int = 0,
    lr: float = 2e-3,
    device="cuda",
    losses=None,
):
    """Train the CNN on synthetic piecewise-constant phantoms plus gaussian
    noise (MSE, Adam) on `device`; returns the trained parameters. The
    phantoms and noise come from ``np.random.default_rng(seed)``, the
    initial weights from a ``torch.Generator`` seeded with `seed`. Each
    step's loss is appended to `losses` where a list is given."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {k: v.requires_grad_() for k, v in init_cnn_params(gen, channels, device).items()}
    opt = torch.optim.Adam(params.values(), lr=lr)
    for _ in range(steps):
        clean = _phantom_batch(rng, n, batch)
        noisy = clean + rng.normal(0, noise_sigma, clean.shape).astype(np.float32)
        clean_t = torch.from_numpy(clean).to(device)
        noisy_t = torch.from_numpy(noisy).to(device)
        loss = torch.mean((cnn_denoise(params, noisy_t) - clean_t) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if losses is not None:
            losses.append(float(loss.detach()))
    return {k: v.detach() for k, v in params.items()}


def make_pnp_model(params):
    """Wrap trained parameters as the callable PlugAndPlayRegularization
    expects: a batch of images (B, H, W), or of flat images (B, n) of
    square length, → its denoised batch."""

    def model(x):
        if x.ndim == 2:  # (B, n): each row a flat square image
            s = int(round(np.sqrt(x.shape[-1])))
            return cnn_denoise(params, x.reshape(-1, s, s)).reshape(x.shape)
        return cnn_denoise(params, x)

    return model
