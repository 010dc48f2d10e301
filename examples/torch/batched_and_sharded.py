"""Multi-RHS batching and sharding over devices.

The torch counterpart of examples/batched_and_sharded.py: `solve_batched`
advances every problem (a column of B) at once with a per-problem
convergence mask; `rtt.parallel` cuts the columns over the devices of a
mesh and solves each chunk on its own device. On one card the mesh names
it twice, and the two shards run in turn.

    PYTHONPATH=. python examples/torch/batched_and_sharded.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device
from rls_tpu_torch.parallel import make_mesh, solve_batched_sharded


def main(dev):
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(48, 24)).astype(np.float32)).to(dev)
    X = torch.from_numpy(rng.normal(size=(24, 8)).astype(np.float32)).to(dev)
    B = A @ X  # 8 problems as columns

    solver = rtt.FISTA.create(rtt.DenseOperator(A, device=dev), reg=rtt.L1Regularization(1e-4),
                              iterations=60)

    # one device: the batch with per-problem early stopping
    Xr = rtt.solve_batched(solver, B)
    print("batched rel. error:", float(torch.linalg.norm(Xr - X) / torch.linalg.norm(X)))

    # a mesh: every card, or this device twice where there is one
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    devices = [torch.device("cuda", i) for i in range(count)] if count > 1 else [dev, dev]
    mesh = make_mesh(devices=devices)
    Xs = solve_batched_sharded(solver, B, mesh)
    print(f"sharded over {mesh.size} entries of {sorted({str(d) for d in devices})}: "
          f"matches {bool(torch.allclose(Xs, Xr, atol=1e-4))}")
    assert torch.allclose(Xs, Xr, atol=1e-4)


if __name__ == "__main__":
    main(example_device(__doc__))
