"""Getting started: solve argmin_x ½‖Ax − b‖² + λ‖x‖₁.

The torch counterpart of examples/getting_started.py: build a solver with
its class or with `create_linear_solver`, call `solve`.

    PYTHONPATH=. python examples/torch/getting_started.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device


def main(dev):
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32)).to(dev)
    x_true = torch.from_numpy(rng.normal(size=(16,)).astype(np.float32)).to(dev)
    b = A @ x_true
    op = rtt.DenseOperator(A, device=dev)

    # 1. the explicit class API
    solver = rtt.ADMM.create(op, reg=rtt.L1Regularization(1e-4), iterations=50)
    x = rtt.solve(solver, b)
    err_admm = float(torch.linalg.norm(x - x_true) / torch.linalg.norm(x_true))
    print("ADMM rel. error:", err_admm)

    # 2. the factory API with kwarg filtering (warns about unknown kwargs)
    solver = rtt.create_linear_solver("FISTA", op, reg=rtt.L1Regularization(1e-4),
                                      iterations=100)
    x = rtt.solve(solver, b)
    err_fista = float(torch.linalg.norm(x - x_true) / torch.linalg.norm(x_true))
    print("FISTA rel. error:", err_fista)
    assert err_admm < 1e-2 and err_fista < 1e-2

    # 3. which solvers can handle a given set of regularizers?
    print("applicable:",
          [s.__name__ for s in rtt.applicable_solver_list([rtt.L1Regularization(0.1)])])


if __name__ == "__main__":
    main(example_device(__doc__))
