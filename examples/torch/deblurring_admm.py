"""Image deblurring with ADMM + TV (BASELINE configuration #3: ADMM with
TV regularization, CG inner solve, a 2-D convolution operator).

The torch counterpart of examples/deblurring_admm.py. ADMM applies the
prox apart from the transform: L1 on the gradient domain with
``reg_trafo = GradientOperator``.

    PYTHONPATH=. python examples/torch/deblurring_admm.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device


def main(dev):
    rng = np.random.default_rng(0)
    N = 64

    img = np.zeros((N, N), np.float32)
    img[12:40, 20:52] = 1.0
    img[30:55, 8:24] = 0.5
    x_true = torch.from_numpy(img.reshape(-1)).to(dev)

    # Gaussian blur through the direct convolution operator
    k = 7
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * 1.5**2))
    kern = np.outer(g, g)
    kern /= kern.sum()
    op = rtt.DirectConvOperator(kernel=kern.astype(np.float32), im_shape=(N, N), device=dev)
    noise = torch.from_numpy(rng.normal(size=(N * N,)).astype(np.float32)).to(dev)
    b = op.mv(x_true) + 0.01 * noise

    grad = rtt.GradientOperator(im_shape=(N, N), dtype=torch.float32, device=dev)
    solver = rtt.ADMM.create(op, reg=rtt.L1Regularization(2e-3), reg_trafo=grad, rho=1e-1,
                             iterations=30, iterations_cg=10)
    x = rtt.solve(solver, b)
    err_blur = float(torch.linalg.norm(b - x_true) / torch.linalg.norm(x_true))
    err = float(torch.linalg.norm(x - x_true) / torch.linalg.norm(x_true))
    print("blurred rel. error:", err_blur)
    print("ADMM-TV rel. error:", err)


if __name__ == "__main__":
    main(example_device(__doc__))
