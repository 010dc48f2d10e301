"""rls_tpu_torch composed FISTA and drivers against rls_tpu on the same
numpy inputs (solve, solve_batched, solve_batched_unrolled, all three
restart modes, float32 and float64), and power_iterations against the
dense Gram's eigenvalues."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu_torch.convert import convert
from rls_tpu_torch.ops.base import NormalOperator

N = 12
K = 3


def _problem(rng, dtype, restart, reg_kind):
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    jdt = getattr(jnp, dtype)
    op = rt.SeparableConvOperator.from_taps(g / g.sum(), g[::-1] / g.sum(), (N, N),
                                            dtype=jdt, compensated=False)
    if reg_kind == "tv":
        reg = rt.TVRegularization(2e-2, shape=(N, N), iterations_tv=4)
        norm = rt.MeasurementBasedNormalization()
    else:
        reg = [rt.L1Regularization(1e-2), rt.PositiveRegularization()]
        norm = rt.NoNormalization()
    solver = rt.FISTA.create(op, reg=reg, iterations=6, rho=0.9, restart=restart,
                             normalize_reg=norm)
    X = rng.normal(size=(K, N * N))
    B = np.stack([np.asarray(op.mv(jnp.asarray(x, jdt))) for x in X], axis=1)
    return solver, B.astype(dtype)


@pytest.mark.parametrize("restart", ["none", "gradient", "gradient_mapping"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
def test_composed_fista_matches_jax(rng, restart, dtype, tol):
    reg_kind = "tv" if restart != "gradient" else "l1"
    with jax.enable_x64(dtype == "float64"):
        jsolver, B = _problem(rng, dtype, restart, reg_kind)
        want_one = np.asarray(rt.solve(jsolver, jnp.asarray(B[:, 0])))
        want_b = np.asarray(rt.solve_batched(jsolver, jnp.asarray(B)))
        want_u = np.asarray(rt.solve_batched_unrolled(jsolver, jnp.asarray(B)))
    tsolver = convert(jsolver, device="cpu")
    Bt = torch.from_numpy(B)
    got_one = rtt.solve(tsolver, Bt[:, 0])
    got_b = rtt.solve_batched(tsolver, Bt)
    got_u = rtt.solve_batched_unrolled(tsolver, Bt)
    assert got_b.dtype == got_u.dtype == Bt.dtype
    np.testing.assert_allclose(got_one.numpy(), want_one, rtol=0, atol=tol)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=tol)
    np.testing.assert_allclose(got_u.numpy(), want_u, rtol=0, atol=tol)
    # a matrix b goes to the batched driver
    np.testing.assert_array_equal(rtt.solve(tsolver, Bt).numpy(), got_b.numpy())


def test_solve_batched_freezes_converged_problems(rng):
    """The active mask stops each problem at its own convergence: a
    problem with b = 0 converges at once and stays at zero while the
    others run on."""
    with jax.enable_x64(True):
        jsolver, B = _problem(rng, "float64", "none", "tv")
    jsolver = rt.FISTA.create(jsolver.A, reg=jsolver.reg, iterations=30, rho=0.9,
                              rel_tol=1e-3)
    B[:, 1] = 0.0
    tsolver = convert(jsolver, device="cpu")
    got = rtt.solve_batched(tsolver, torch.from_numpy(B))
    np.testing.assert_array_equal(got[:, 1].numpy(), 0.0)
    for j in (0, 2):
        np.testing.assert_allclose(
            got[:, j].numpy(), rtt.solve(tsolver, torch.from_numpy(B[:, j])).numpy(),
            rtol=0, atol=1e-12,
        )


@pytest.mark.parametrize("taps", ["symmetric", "asymmetric"])
def test_power_iterations_matches_eigvalsh(taps):
    """The two packages draw different random starts, so the estimate is
    held against the dense Gram's top eigenvalue. The asymmetric taps
    have a small spectral gap: the default rtol stops ~2% low there (in
    both packages), so that case runs to a tighter rtol."""
    th = np.exp(-((np.arange(5) - 2) ** 2) / 2.0) if taps == "symmetric" else np.array(
        [0.1, 0.5, 0.25, -0.2, 0.05])
    op = rtt.SeparableConvOperator.from_taps(th, th[::-1], (10, 9), dtype=torch.float64,
                                             device="cpu")
    dense = op.to_dense().numpy()
    want = np.linalg.eigvalsh(dense.T @ dense)[-1]
    kw = {} if taps == "symmetric" else {"rtol": 1e-7, "maxiter": 300}
    got = float(rtt.power_iterations(NormalOperator(op), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-2)
    if taps == "symmetric":
        # FISTA's default step is 0.95 / λmax
        solver = rtt.FISTA.create(op, reg=rtt.L1Regularization(0.0))
        np.testing.assert_allclose(float(solver.rho), 0.95 / got, rtol=1e-12)
