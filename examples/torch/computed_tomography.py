"""Sparse-view computed tomography.

The torch counterpart of examples/computed_tomography.py: Radon
projections at 30 angles, reconstructed with CGNR (Tikhonov) and FISTA-TV.
`RadonOperator` builds its ray tables once on the host; its adjoint is the
exact backprojection.

    PYTHONPATH=. python examples/torch/computed_tomography.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device


def main(dev):
    N = 48
    rng = np.random.default_rng(0)

    # a couple of ellipses
    yy, xx = np.mgrid[0:N, 0:N]
    cy, cx = (N - 1) / 2, (N - 1) / 2
    img = ((((yy - cy) / (0.4 * N)) ** 2 + ((xx - cx) / (0.3 * N)) ** 2) <= 1).astype(
        np.float32)
    img -= 0.5 * ((((yy - cy) / (0.2 * N)) ** 2 + ((xx - cx - 4) / (0.12 * N)) ** 2) <= 1
                  ).astype(np.float32)
    x_true = torch.from_numpy(img.reshape(-1)).to(dev)

    angles = np.linspace(0, np.pi, 30, endpoint=False)
    R = rtt.RadonOperator(angles=angles, im_shape=(N, N), device=dev)
    noise = torch.from_numpy(rng.normal(size=(R.out_size,)).astype(np.float32)).to(dev)
    b = R.mv(x_true) + 0.1 * noise

    def rel(x):
        return float(torch.linalg.norm(x - x_true) / torch.linalg.norm(x_true))

    # CGNR with Tikhonov
    cg = rtt.CGNR.create(R, reg=rtt.L2Regularization(1.0), iterations=20)
    err_cg = rel(rtt.solve(cg, b))
    print("CGNR rel. error:", err_cg)

    # FISTA with TV
    fista = rtt.FISTA.create(R, reg=rtt.TVRegularization(1.0, shape=(N, N), iterations_tv=20),
                             iterations=30)
    err_tv = rel(rtt.solve(fista, b))
    print("FISTA-TV rel. error:", err_tv)


if __name__ == "__main__":
    main(example_device(__doc__))
