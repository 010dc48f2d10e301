"""Plug-and-play priors: a denoiser as the proximal map.

The torch counterpart of examples/plug_and_play.py. Any torch callable on
a batch of images works as the model: first a hand-rolled smoother, then
the small residual CNN of ``rls_tpu_torch.models.denoisers``, trained here in a
few seconds on synthetic phantoms.

    PYTHONPATH=. python examples/torch/plug_and_play.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device
from rls_tpu_torch.models.denoisers import make_pnp_model, train_denoiser
from rls_tpu_torch.models.regularization import IdentityTransform


def rel(x, ref):
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def main(dev):
    rng = np.random.default_rng(0)
    N = 16

    img = np.zeros((N, N), np.float32)
    img[4:12, 4:12] = 1.0
    x_true = torch.from_numpy(img.reshape(-1)).to(dev)

    A = rtt.DenseOperator(rng.normal(size=(3 * N * N // 2, N * N)).astype(np.float32) / N,
                          device=dev)
    b = A.mv(x_true)

    def denoiser(x):
        """Toy model: local averaging (a stand-in for a trained CNN)."""
        im = x.reshape(-1, N, N)
        sm = (im + im.roll(1, -2) + im.roll(-1, -2) + im.roll(1, -1) + im.roll(-1, -1)) / 5.0
        return sm.reshape(x.shape)

    pnp = rtt.PnPRegularization(0.3, model=denoiser, shape=(N * N,),
                                input_transform=IdentityTransform)
    solver = rtt.ADMM.create(A, reg=pnp, iterations=30, rho=0.1)
    print("PnP-ADMM rel. error:", rel(rtt.solve(solver, b), x_true))

    # a learned prior: the small residual CNN, trained in-process
    n2 = 32
    params = train_denoiser(n2, channels=6, steps=150, noise_sigma=0.08, device=dev)
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    kern = np.outer(g, g)
    kern /= kern.sum()
    op = rtt.SeparableConvOperator.from_kernel(kern, im_shape=(n2, n2), device=dev)
    img2 = np.zeros((n2, n2), np.float32)
    img2[6:10, 4:20] = 0.7
    img2[14:28, 10:22] = 0.4
    x2_true = torch.from_numpy(img2.reshape(-1)).to(dev)
    noise = np.random.default_rng(1).normal(size=(n2 * n2,)).astype(np.float32)
    b2 = op.mv(x2_true) + 0.02 * torch.from_numpy(noise).to(dev)
    pnp_cnn = rtt.PnPRegularization(0.3, model=make_pnp_model(params), shape=(n2 * n2,),
                                    input_transform=IdentityTransform)
    s_cnn = rtt.ADMM.create(op, reg=pnp_cnn, iterations=25, iterations_cg=6, rho=0.5)
    print("PnP-ADMM (trained CNN) rel. error:", rel(rtt.solve(s_cnn, b2), x2_true))


if __name__ == "__main__":
    main(example_device(__doc__))
