"""The regularization system, explained: parameterized terms, projection
terms, and nested terms (soft-thresholding in the wavelet domain).

The torch counterpart of examples/regularization_explained.py: build
core terms, call prox with an overriding λ, nest L1 around a wavelet
transform, and walk the nesting with `sink` and `reg_chain`.

    PYTHONPATH=. python examples/torch/regularization_explained.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device


def main(dev):
    # parameterized terms: λ at construction, overridable per prox call
    l2 = rtt.L2Regularization(0.3)
    one = torch.ones(1, device=dev)
    print("prox_L2(1.0):", float(l2.prox(one)[0]))  # 1/(1+2λ)
    param = l2.lam
    print("prox_L2(1.0, λ*0.2):", float(l2.prox(one, param * 0.2)[0]))

    # projection terms: the prox is the projection onto a convex set
    positive = rtt.PositiveRegularization()
    print("prox_+([2.0, -0.2]):",
          positive.prox(torch.tensor([2.0, -0.2], device=dev)).cpu().numpy())

    # nested terms: L1 soft-thresholding in the wavelet domain
    N = 64
    yy, xx = np.mgrid[0:N, 0:N]
    image = ((xx - N / 2) ** 2 / 400 + (yy - N / 2) ** 2 / 200 < 1).astype(np.float32)
    image += 0.5 * ((xx - N / 3) ** 2 + (yy - N / 3) ** 2 < 30)
    x = torch.from_numpy(image.reshape(-1)).to(dev)

    wop = rtt.WaveletOperator((N, N), wavelet="db2", device=dev)
    core = rtt.L1Regularization(0.1)
    reg = rtt.TransformedRegularization(core, wop)

    img_prox_image = core.prox(x)  # thresholds the pixels
    img_prox_wavelet = reg.prox(x)  # thresholds the wavelet coefficients

    # thresholding in the wavelet domain keeps the piecewise-smooth image
    # far better than thresholding pixels at the same λ
    err_img = float(torch.linalg.norm(img_prox_image - x) / torch.linalg.norm(x))
    err_wav = float(torch.linalg.norm(img_prox_wavelet - x) / torch.linalg.norm(x))
    print(f"rel. change, image-domain prox:   {err_img:.3f}")
    print(f"rel. change, wavelet-domain prox: {err_wav:.3f}")
    assert err_wav < err_img

    # the wavelet coefficients are sparse where the pixels are not
    frac = float((wop.mv(x).abs() > 0.1).float().mean())
    print(f"fraction of wavelet coeffs > 0.1: {frac:.3f}")
    assert frac < 0.2

    # walking the nesting: every nested term exposes its inner term, and
    # `sink` returns the core
    assert reg.inner is core
    assert rtt.sink(reg) is core
    for r in rtt.reg_chain(reg):
        print(type(r).__name__)


if __name__ == "__main__":
    main(example_device(__doc__))
