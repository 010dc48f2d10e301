"""Device placement, timing and the fused kernels: the counterpart of
examples/tpu_acceleration.py.

A solve runs where its operator and b lie: build the operator with
``device=`` and put b there, and the whole state follows. `rtt.time_solver`
times a solve (a synchronize around each run on the card). For the
shapes a hand-written kernel covers, `solve_batched_fast` runs the whole
fixed-iteration solve of a batch as ONE launch, and falls back to the
composed driver (with a warning naming why) where none applies.

    PYTHONPATH=. python examples/torch/gpu_acceleration.py [--device cpu]
"""

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device
from rls_tpu_torch.kernels import fista_tv_fused


def main(dev):
    rng = np.random.default_rng(0)
    print("running on:", torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev)

    A = rtt.DenseOperator(rng.normal(size=(64, 32)).astype(np.float32), device=dev)
    x_true = torch.from_numpy(rng.normal(size=(32,)).astype(np.float32)).to(dev)
    b = A.mv(x_true)

    solver = rtt.FISTA.create(A, reg=rtt.L1Regularization(1e-4), iterations=50, rel_tol=0.0)
    x = rtt.solve(solver, b)
    print("device of solution:", x.device)
    print("rel. error:", float(torch.linalg.norm(x - x_true) / torch.linalg.norm(x_true)))

    stats = rtt.time_solver(rtt.solve, solver, b)
    print(f"first run {stats['compile_s']:.3f} s, mean solve {stats['mean_s'] * 1e3:.2f} ms")

    # the fused whole-solve kernel: batched FISTA-TV deblurring on a
    # separable convolution, one launch of csrc/fista_tv_fused.cu on the
    # card (its plain PyTorch version on the CPU)
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    kern = np.outer(g, g)
    kern /= kern.sum()
    sep = rtt.SeparableConvOperator.from_kernel(kern, im_shape=(32, 32), device=dev)
    tv_solver = rtt.FISTA.create(
        sep, reg=rtt.TVRegularization(1e-3, shape=(32, 32), iterations_tv=5), iterations=20,
        rho=0.95, rel_tol=0.0, track_residual=False,
    )
    imgs = torch.from_numpy(rng.normal(size=(4, 32 * 32)).astype(np.float32)).to(dev)
    B = sep.mv(imgs).T
    launches = fista_tv_fused.fista_tv_fused.launches
    X = rtt.solve_batched_fast(tv_solver, B)
    launched = fista_tv_fused.fista_tv_fused.launches - launches
    print(f"fused batched FISTA-TV: {tuple(X.shape)}, finite: {bool(torch.isfinite(X).all())}, "
          f"kernel launches: {launched}")
    assert bool(torch.isfinite(X).all())
    assert launched == int(dev.type == "cuda")  # the plain version on the CPU
    torch.testing.assert_close(X, rtt.solve_batched_unrolled(tv_solver, B), rtol=0, atol=1e-4)


if __name__ == "__main__":
    main(example_device(__doc__))
