"""Callbacks and convergence tracing.

The torch counterpart of examples/callbacks_and_tracing.py. Two modes:
  * host callbacks through `solve_with_callbacks` (called at iteration 0
    and after every step);
  * `solve_trace`: the per-iteration solutions and metrics stacked on the
    device.

    PYTHONPATH=. python examples/torch/callbacks_and_tracing.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device


def main(dev):
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(24, 12)).astype(np.float32)).to(dev)
    x_true = torch.from_numpy(rng.normal(size=(12,)).astype(np.float32)).to(dev)
    b = A @ x_true

    solver = rtt.FISTA.create(rtt.DenseOperator(A, device=dev), reg=rtt.L1Regularization(1e-5),
                              iterations=20)

    # host callbacks
    conv = rtt.StoreConvergenceCallback()
    cmp = rtt.CompareSolutionCallback(x_true, cmp=rtt.nrmsd)
    x = rtt.solve_with_callbacks(solver, b, callbacks=[conv, cmp])
    print("residuals:", [float(r) for r in conv.conv_meas["residual"][:5]], "...")
    print("nrmsd trace:", [round(float(r), 4) for r in cmp.results[:5]], "...")

    # the on-device trace
    x_tr, (xs, metrics, active) = rtt.solve_trace(solver, b)
    print("traced solutions shape:", tuple(xs.shape))
    print("final residual:", float(metrics["residual"][-1]))
    assert torch.allclose(x_tr, x, atol=1e-6)


if __name__ == "__main__":
    main(example_device(__doc__))
