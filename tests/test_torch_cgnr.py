"""The dense-matrix solvers of rls_tpu_torch against rls_tpu on the same
numpy inputs: L2Regularization, the composed CGNR through the drivers,
solve_cgnr_refined, DirectSolver (both routes) and PseudoInverse, and
convert.

Tolerances: 1e-10 in float64 and 1e-5 in float32 (the same ops in another
order, on systems with cond(A) ≤ ~3 so f32 rounding stays near 1e-6).
DirectSolver and PseudoInverse in f32 compare torch.linalg's SVD with
rls_tpu's Jacobi SVD: 1e-5 as well on these systems."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.models.solvers.cgnr import solve_cgnr_refined as jax_refined
from rls_tpu_torch.convert import convert
from rls_tpu_torch.models.regularization import MeasurementBasedNormalization
from rls_tpu_torch.models.solvers import direct as tdirect

TOL = {"float32": 1e-5, "float64": 1e-10, "complex64": 1e-5, "complex128": 1e-10}
X64 = ("float64", "complex128")


def _system(dtype, m=80, n=20, K=3, seed=5):
    """A tall, well-conditioned dense A (cond ≈ 3), K measurement columns
    of noisy phantoms, in `dtype`."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)) / np.sqrt(m)
    X = rng.normal(size=(n, K))
    if dtype.startswith("complex"):
        A = A + 1j * rng.normal(size=(m, n)) / np.sqrt(m)
        X = X + 1j * rng.normal(size=(n, K))
    B = A @ X + 0.01 * rng.normal(size=(m, K))
    return A.astype(dtype), B.astype(dtype)


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=TOL[dtype] * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("lam", ["scalar", "vector", "per-problem"])
def test_l2_regularization_matches_jax(dtype, lam):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7)).astype(dtype)
    lams = {"scalar": 0.3, "vector": rng.uniform(0.1, 1.0, size=7).astype(dtype),
            "per-problem": rng.uniform(0.1, 1.0, size=3).astype(dtype)}[lam]
    reg = rtt.L2Regularization(torch.as_tensor(lams) if np.ndim(lams) else lams)
    with jax.enable_x64(dtype == "float64"):
        jreg = rt.L2Regularization(jnp.asarray(lams) if np.ndim(lams) else lams)
        if lam == "per-problem":  # one λ per row, as vmap over the problems
            want_p = np.stack([np.asarray(jreg.prox(jnp.asarray(xi), li))
                               for xi, li in zip(x, lams)])
            want_v = np.stack([np.asarray(jreg.value(jnp.asarray(xi), li))
                               for xi, li in zip(x, lams)])
        else:
            want_p = np.stack([np.asarray(jreg.prox(jnp.asarray(xi))) for xi in x])
            want_v = np.stack([np.asarray(jreg.value(jnp.asarray(xi))) for xi in x])
    xt = torch.from_numpy(x)
    _close(reg.prox(xt), want_p, dtype)
    _close(reg.value(xt), want_v, dtype)


def _cgnr(A, dtype, case, iterations=30):
    jdt = getattr(jnp, dtype)
    reg = [rt.L2Regularization(1e-2)]
    kw = {}
    if case == "positive":
        reg.append(rt.PositiveRegularization())
    elif case == "real":
        reg.append(rt.RealRegularization())
    elif case == "measurement":
        kw["normalize_reg"] = rt.MeasurementBasedNormalization()
    elif case == "rel_tol":
        kw["rel_tol"] = 1e-3
    return rt.CGNR.create(rt.DenseOperator(jnp.asarray(A, jdt)), reg=reg,
                          iterations=iterations, **kw)


@pytest.mark.parametrize("case,dtype", [
    ("l2", "float32"), ("positive", "float32"), ("measurement", "float32"),
    ("rel_tol", "float32"), ("x0", "float32"), ("l2", "float64"), ("positive", "float64"),
    ("x0", "float64"), ("real", "complex64"), ("measurement", "complex64"),
    ("l2", "complex128"), ("real", "complex128"),
])
def test_composed_cgnr_matches_jax(case, dtype):
    A, B = _system(dtype)
    x0 = np.full(A.shape[1], 0.1, dtype) if case == "x0" else None
    with jax.enable_x64(dtype in X64):
        js = _cgnr(A, dtype, case)
        Bj = jnp.asarray(B)
        x0j = None if x0 is None else jnp.asarray(x0)
        want_u = np.asarray(rt.solve_batched_unrolled(js, Bj, x0j))
        want_1 = np.asarray(rt.solve(js, Bj[:, 0], x0j))
        want_b = np.asarray(rt.solve_batched(js, Bj, x0j))
    ts = convert(js, device="cpu")
    assert ts.A is ts.AHA.A
    assert ts.total_steps == min(30, A.shape[1])
    Bt = torch.from_numpy(B)
    x0t = None if x0 is None else torch.from_numpy(x0)
    got_u = rtt.solve_batched_unrolled(ts, Bt, x0t)
    assert got_u.dtype == Bt.dtype
    _close(got_u, want_u, dtype)
    _close(rtt.solve(ts, Bt[:, 0], x0t), want_1, dtype)
    _close(rtt.solve_batched(ts, Bt, x0t), want_b, dtype)
    if case == "positive":
        assert float(got_u.real.min()) >= 0.0


def test_cgnr_create_follows_the_reference_ctor():
    A, _ = _system("float32")
    At = torch.from_numpy(A)
    op = rtt.DenseOperator(At, device="cpu")
    s = rtt.CGNR.create(op, reg=[rtt.PositiveRegularization(), rtt.L2Regularization(0.5)],
                        iterations=100)
    assert s.l2.lam == 0.5 and len(s.constr) == 1 and s.total_steps == A.shape[1]
    assert rtt.CGNR.create(op).l2.lam == 0.0
    with pytest.raises(ValueError, match="additional regularization"):
        rtt.CGNR.create(op, reg=[rtt.L2Regularization(0.1), rtt.L1Regularization(0.1)])


@pytest.mark.parametrize("dtype,rounds", [("float32", 1), ("float32", 3), ("float64", 3),
                                          ("complex128", 3)])
def test_cgnr_refined_matches_jax(dtype, rounds):
    A, B = _system(dtype, m=48, n=32, K=2)
    with jax.enable_x64(dtype in X64):
        js = _cgnr(A, dtype, "positive" if dtype == "float32" else "l2", iterations=40)
        want = np.stack([np.asarray(jax_refined(js, jnp.asarray(b), rounds=rounds))
                         for b in B.T])
    ts = convert(js, device="cpu")
    got = rtt.solve_cgnr_refined(ts, torch.from_numpy(B.T.copy()), rounds=rounds)
    _close(got, want, dtype)


def test_cgnr_refined_reaches_the_regularized_solution():
    """On an ill-conditioned system (cond(A) ≈ 200) the refined f32 solve
    lands within 1e-4 of the f64 normal-equation solution, where one plain
    f32 CG run of the same length does not reach 1e-3."""
    rng = np.random.default_rng(0)
    u, _ = np.linalg.qr(rng.normal(size=(48, 48)))
    v, _ = np.linalg.qr(rng.normal(size=(32, 32)))
    A = (u[:, :32] * np.geomspace(1.0, 5e-3, 32)) @ v.T
    B = A @ rng.normal(size=(32, 2))
    lam = 1e-6
    exact = np.linalg.solve(A.T @ A + lam * np.eye(32), A.T @ B)
    op = rtt.DenseOperator(torch.from_numpy(A.astype(np.float32)), device="cpu")
    s = rtt.CGNR.create(op, reg=rtt.L2Regularization(lam), iterations=32)
    Bt = torch.from_numpy(B.T.astype(np.float32))
    got = rtt.solve_cgnr_refined(s, Bt).numpy().T
    plain = rtt.solve_batched_unrolled(s, Bt.T).numpy()

    def err(x):
        return np.linalg.norm(x - exact) / np.linalg.norm(exact)

    assert err(got) < 1e-4 < 1e-3 < err(plain)


@pytest.mark.parametrize("method,dtype,proj", [
    ("auto", "float32", True), ("jacobi", "float32", False), ("lu", "float32", False),
    ("auto", "float64", True), ("auto", "complex64", False),
])
def test_direct_solver_matches_jax(method, dtype, proj):
    A, B = _system(dtype)
    reg = [rt.L2Regularization(1e-2)] + ([rt.PositiveRegularization()] if proj else [])
    with jax.enable_x64(dtype in X64):
        js = rt.DirectSolver.create(rt.DenseOperator(jnp.asarray(A)), reg=reg,
                                    normalize_reg=rt.MeasurementBasedNormalization(),
                                    svd_method=method)
        want = np.asarray(rt.solve_batched_unrolled(js, jnp.asarray(B)))
        want_1 = np.asarray(rt.solve(js, jnp.asarray(B[:, 0])))
    ts = convert(js, device="cpu")
    Bt = torch.from_numpy(B)
    _close(rtt.solve_batched_unrolled(ts, Bt), want, dtype)
    _close(rtt.solve(ts, Bt[:, 0]), want_1, dtype)
    # built in the port: the same route, and the same solution
    own = rtt.DirectSolver.create(
        rtt.DenseOperator(torch.from_numpy(A), device="cpu"),
        reg=[rtt.L2Regularization(1e-2)] + ([rtt.PositiveRegularization()] if proj else []),
        normalize_reg=MeasurementBasedNormalization(),
        svd_method=method,
    )
    assert (own.U is None) == (js.U is None)
    _close(rtt.solve_batched_unrolled(own, Bt), want, dtype)


@pytest.mark.parametrize("shape,method,svd", [((40, 24), "auto", True), ((24, 40), "auto", True),
                                              ((200, 130), "auto", False),
                                              ((200, 130), "jacobi", True),
                                              ((40, 24), "lu", False)])
def test_direct_solver_routes_like_jax(shape, method, svd):
    from rls_tpu.models.prox import _use_jacobi

    A = np.zeros(shape, np.float32)
    assert tdirect._use_svd(torch.from_numpy(A), method) is svd
    assert (method != "lu" and _use_jacobi(jnp.asarray(A), method)) is svd
    assert not tdirect._use_svd(torch.from_numpy(A.astype(np.float64)), method)


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64"])
def test_pseudo_inverse_matches_jax(dtype):
    A, B = _system(dtype, m=24, n=40)  # wide: the SVD of the transpose in rls_tpu
    with jax.enable_x64(dtype in X64):
        js = rt.PseudoInverse.create(rt.DenseOperator(jnp.asarray(A)),
                                     reg=rt.L2Regularization(1e-2))
        want = np.asarray(rt.solve_batched_unrolled(js, jnp.asarray(B)))
    ts = convert(js, device="cpu")
    Bt = torch.from_numpy(B)
    _close(rtt.solve_batched_unrolled(ts, Bt), want, dtype)
    own = rtt.PseudoInverse.create(rtt.DenseOperator(torch.from_numpy(A), device="cpu"),
                                   reg=rtt.L2Regularization(1e-2))
    _close(rtt.solve_batched_unrolled(own, Bt), want, dtype)


def test_direct_solvers_refuse_a_second_term():
    op = rtt.DenseOperator(torch.eye(3), device="cpu")
    for cls in (rtt.DirectSolver, rtt.PseudoInverse):
        with pytest.raises(ValueError, match="more than one L2"):
            cls.create(op, reg=[rtt.L2Regularization(0.1), rtt.L1Regularization(0.1)])


def test_convert_dense_pieces():
    A, _ = _system("float32")
    jop = rt.DenseOperator(jnp.asarray(A))
    top = convert(jop, device="cpu")
    assert isinstance(top, rtt.DenseOperator)
    np.testing.assert_array_equal(top.mat.numpy(), A)
    vec = convert(rt.L2Regularization(jnp.arange(3.0)), device="cpu")
    np.testing.assert_array_equal(vec.lam.numpy(), [0.0, 1.0, 2.0])
    assert convert(rt.L2Regularization(0.25), device="cpu").lam == 0.25
    # the kernel checks rely on the identity solver.A is solver.AHA.A
    for js in (rt.CGNR.create(jop), rt.FISTA.create(jop, reg=rt.L1Regularization(0.1), rho=0.5)):
        ts = convert(js, device="cpu")
        assert ts.A is ts.AHA.A
