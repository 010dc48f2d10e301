"""Multi-coil SENSE MRI reconstruction in split real/imaginary form.

The torch counterpart of examples/mri_sense_split_real.py. The
measurement model is BASELINE configuration #4: ``A = stack_c (M ∘ F ∘
C_c)`` on the split-real SENSE operator `SenseDFT2RealOperator` (the
image, the coil maps and k-space carried as real planes; the port's
transform is torch.fft). The complex L1 of the split vector is
``L21Regularization(λ, slices=2)``: the group ℓ2 over (re, im) pairs is
the complex magnitude soft-threshold.

    PYTHONPATH=. python examples/torch/mri_sense_split_real.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device


def main(dev):
    rng = np.random.default_rng(0)
    H = W = 96
    n = H * W
    C = 6

    # smooth complex coil sensitivities, sum-of-squares normalized to 1
    yy, xx = np.mgrid[0:H, 0:W] / H
    maps = np.stack([
        (np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) * 2.0) + 0.15)
        * np.exp(1j * (cx * yy - cy * xx) * 2)
        for cy, cx in rng.uniform(0, 1, size=(C, 2))
    ]).astype(np.complex64)
    maps /= np.sqrt((np.abs(maps) ** 2).sum(0))

    # 45% random k-space sampling + a fully sampled calibration center
    mask = (rng.uniform(size=(H, W)) < 0.45).astype(np.float32)
    mask[H // 2 - 8:H // 2 + 8, W // 2 - 8:W // 2 + 8] = 1.0
    op = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (H, W), device=dev)

    # complex phantom with a spatial phase
    img = np.zeros((H, W), np.complex64)
    for _ in range(5):
        i0, j0 = rng.integers(4, H - 28, 2)
        img[i0:i0 + 20, j0:j0 + 20] += rng.uniform(0.4, 1.0) * np.exp(1j * rng.uniform(0, 1))
    x_true = torch.from_numpy(np.concatenate([img.real.reshape(-1), img.imag.reshape(-1)])
                              ).to(dev)
    b = op.mv(x_true)

    # FISTA with complex L1 (L21 over the re/im pairs)
    solver = rtt.FISTA.create(op, reg=rtt.L21Regularization(1e-4, slices=2), iterations=80,
                              rho=0.95)
    x = rtt.solve(solver, b).cpu().numpy()

    rec = x[:n] + 1j * x[n:]
    err = np.linalg.norm(rec.reshape(H, W) - img) / np.linalg.norm(img)
    zf = op.rmv(b).cpu().numpy()
    zf_err = np.linalg.norm((zf[:n] + 1j * zf[n:]).reshape(H, W) - img) / np.linalg.norm(img)
    print(f"zero-filled rel err: {zf_err:.3f}")
    print(f"FISTA complex-L1 rel err: {err:.3f}")
    assert err < zf_err


if __name__ == "__main__":
    main(example_device(__doc__))
