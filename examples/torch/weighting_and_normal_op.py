"""Weighted least squares and fused normal operators.

The torch counterpart of examples/weighting_and_normal_op.py. The weighted
problem argmin ½‖W(Ax − b)‖², two equivalent routes:
  * ProdOperator(WeightingOperator(w), A): the weighted forward operator;
  * NormalOperator(A, weights=w²): the fused AᴴW A normal operator passed
    as AHA (the solver then takes the back-projection AᴴWb).

    PYTHONPATH=. python examples/torch/weighting_and_normal_op.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device


def main(dev):
    rng = np.random.default_rng(0)
    A = rtt.DenseOperator(rng.normal(size=(40, 16)).astype(np.float32), device=dev)
    x_true = torch.from_numpy(rng.normal(size=(16,)).astype(np.float32)).to(dev)
    b = A.mv(x_true)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, size=(40,)).astype(np.float32)).to(dev)

    # route 1: the weighted operator
    WA = rtt.ProdOperator(rtt.WeightingOperator(w, device=dev), A)
    s1 = rtt.CGNR.create(WA, reg=rtt.L2Regularization(1e-6), iterations=40)
    x1 = rtt.solve(s1, w * b)

    # route 2: the fused normal operator AᴴW²A (one pass fewer over the data)
    AHA = rtt.NormalOperator(A, weights=w**2, device=dev)
    s2 = rtt.CGNR.create(AHA=AHA, reg=rtt.L2Regularization(1e-6), iterations=40)
    x2 = rtt.solve(s2, A.rmv(w**2 * b))

    for name, x in (("route1", x1), ("route2", x2)):
        print(f"{name} rel. error:",
              float(torch.linalg.norm(x - x_true) / torch.linalg.norm(x_true)))
    agree = bool(torch.allclose(x1, x2, atol=1e-3))
    print("routes agree:", agree)
    assert agree


if __name__ == "__main__":
    main(example_device(__doc__))
