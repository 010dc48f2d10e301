"""Row-action solving with Kaczmarz and its randomized variants.

The torch counterpart of examples/efficient_kaczmarz.py: the cyclic,
shuffled, randomized and greedy modes timed with `rtt.time_solver`, a
vector-λ Tikhonov, the streamed whole-solve kernel (``csrc/kaczmarz.cu``;
its plain PyTorch version on the CPU), sparse rows in a padded CSR
operator, and the greedy solve kernel (``csrc/kaczmarz_greedy.cu``).

    PYTHONPATH=. python examples/torch/efficient_kaczmarz.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device


def main(dev):
    rng = np.random.default_rng(0)
    A_np = rng.normal(size=(200, 64)).astype(np.float32)
    A = rtt.DenseOperator(A_np, device=dev)
    x_true = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)).to(dev)
    b = A.mv(x_true)

    def rel(x):
        return float(torch.linalg.norm(x - x_true) / torch.linalg.norm(x_true))

    for kw in [
        {},  # cyclic
        {"shuffle_rows": True},
        {"randomized": True, "sub_matrix_fraction": 0.5},
        {"greedy_randomized": True},
    ]:
        solver = rtt.Kaczmarz.create(A, reg=rtt.L2Regularization(1e-6), iterations=20, **kw)
        stats = rtt.time_solver(rtt.solve, solver, b, reps=3)
        x = rtt.solve(solver, b)
        print(f"{kw or 'cyclic'}: rel_err={rel(x):.2e} mean_time={stats['mean_s'] * 1e3:.1f} ms")

    # vector-λ Tikhonov (standard-form transform, solution rescaled)
    lam_vec = torch.from_numpy(rng.uniform(0.5, 2.0, size=(64,)).astype(np.float32)).to(dev)
    solver = rtt.Kaczmarz.create(A, reg=rtt.L2Regularization(lam_vec * 1e-6), iterations=20)
    print("vector-λ rel. error:", rel(rtt.solve(solver, b)))

    # the streamed whole-solve kernel: every sweep of every problem in one
    # launch, the randomized order drawn at construction
    solver = rtt.Kaczmarz.create(
        A, reg=rtt.L2Regularization(1e-6), iterations=20, randomized=True,
        sub_matrix_fraction=0.5, precompute_order=True,
    )
    X = rtt.solve_kaczmarz_streamed(solver, b[:, None])
    print(f"streamed randomized: rel_err={rel(X[:, 0]):.2e}")

    # sparse systems: PaddedCSROperator gives O(nnz_row) row actions
    A_sp = A_np.copy()
    A_sp[np.random.default_rng(0).uniform(size=A_sp.shape) < 0.7] = 0.0
    csr = rtt.PaddedCSROperator.from_dense(A_sp, device=dev)
    b_sp = torch.from_numpy(A_sp).to(dev) @ x_true
    solver = rtt.Kaczmarz.create(csr, reg=rtt.L2Regularization(1e-6), iterations=30)
    print("padded-CSR sparse rel_err:", rel(rtt.solve(solver, b_sp)))

    # ...and sparse storage rides the streamed kernel too
    solver = rtt.Kaczmarz.create(csr, reg=rtt.L2Regularization(1e-6), iterations=30,
                                 randomized=True, sub_matrix_fraction=0.5,
                                 precompute_order=True)
    Xs = rtt.solve_kaczmarz_streamed(solver, b_sp[:, None])
    print("padded-CSR streamed rel_err:", rel(Xs[:, 0]))

    # greedy-randomized mode (residual-driven sampling): the whole solve in
    # one launch of the greedy kernel
    solver = rtt.Kaczmarz.create(A, reg=rtt.L2Regularization(1e-6), iterations=12,
                                 greedy_randomized=True, sub_matrix_fraction=0.25)
    Xg = rtt.solve_kaczmarz_greedy(solver, b[:, None])
    err = rel(Xg[:, 0])
    print("greedy fused rel_err:", err)
    assert err < 1e-2


if __name__ == "__main__":
    main(example_device(__doc__))
