"""PDHG of rls_tpu_torch against rls_tpu on the same numpy inputs:
Grad8Operator and its true adjoint, the sequential 8-direction conjugate
prox, the composed PDHG (8dir, isotropic and L1, with and without the
Positive projection, with the gap), the plain version of the fused PDHG
kernel against the JAX fused kernel in interpret mode, the fused PGM-TV and
ADMM-TV kernels on a rectangular image with unequal taps, the dispatch and
convert.

Tolerances: 1e-5 relative in float32 and 1e-10 in float64 for the
composed solver (the same ops in another order); 1e-5 relative between the
plain kernel version and the JAX kernel, the JAX package's own bar between
its kernel and its composed path (tests/test_kernels.py:1540)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.models.solvers.pdhg import prox_tv_conj_8dir as jax_prox8
from rls_tpu.ops.grad import Grad8Operator as JaxGrad8
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import admm_tv_fused as tadmm
from rls_tpu_torch.kernels import auto
from rls_tpu_torch.kernels import fista_tv_fused as tfused
from rls_tpu_torch.kernels import pdhg_fused as tpdhg

jpdhg = importlib.import_module("rls_tpu.kernels.pdhg_fused")
jadmm = importlib.import_module("rls_tpu.kernels.admm_tv_fused")
jfused = importlib.import_module("rls_tpu.kernels.fista_tv_fused")
G5 = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
G5 = G5 / G5.sum()
G3 = np.array([0.25, 0.5, 0.25])
TOL = {"float32": 1e-5, "float64": 1e-10}
RECT = (20, 28)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("shape", [(6, 7), (9, 5)])
def test_grad8_matches_jax(shape):
    rng = np.random.default_rng(0)
    n = shape[0] * shape[1]
    x = rng.normal(size=(3, n)).astype(np.float32)
    y = rng.normal(size=(3, 8 * n)).astype(np.float32)
    jop = JaxGrad8(im_shape=shape, _dtype=jnp.float32)
    top = rtt.Grad8Operator(shape, torch.float32, device="cpu")
    want_mv = np.asarray(jax.jit(jax.vmap(jop.mv))(jnp.asarray(x)))
    want_rmv = np.asarray(jax.jit(jax.vmap(jop.rmv))(jnp.asarray(y)))
    np.testing.assert_allclose(top.mv(torch.from_numpy(x)).numpy(), want_mv, rtol=0, atol=1e-6)
    np.testing.assert_allclose(top.rmv(torch.from_numpy(y)).numpy(), want_rmv, rtol=0, atol=1e-5)
    # the adjoint identity in float64, and the JAX adjoint in float64
    t64 = rtt.Grad8Operator(shape, torch.float64, device="cpu")
    x64, y64 = torch.from_numpy(x.astype(np.float64)), torch.from_numpy(y.astype(np.float64))
    lhs = (t64.mv(x64) * y64).sum(dim=-1)
    rhs = (x64 * t64.rmv(y64)).sum(dim=-1)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-12, atol=1e-12)
    with jax.enable_x64(True):
        j64 = JaxGrad8(im_shape=shape, _dtype=jnp.float64)
        want64 = np.asarray(jax.jit(jax.vmap(j64.rmv))(jnp.asarray(y64.numpy())))
    np.testing.assert_allclose(t64.rmv(y64).numpy(), want64, rtol=0, atol=1e-12)


def test_prox_tv_conj_8dir_matches_jax():
    rng = np.random.default_rng(1)
    shape = (5, 6)
    p = rng.normal(size=(3, 8 * 30)).astype(np.float32)
    alpha = np.array([0.4, 0.05, 2.0], np.float32)
    want = np.stack([np.asarray(jax_prox8(jnp.asarray(v), float(a), shape))
                     for v, a in zip(p, alpha)])
    got = rtt.prox_tv_conj_8dir(torch.from_numpy(p), torch.from_numpy(alpha), shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _pdhg(dtype, kind, positive, shape=(12, 12), iterations=15, taps=(G5, G5), P=3, tau=0.3,
          **kw):
    """A deblurring PDHG problem in rls_tpu (plain f32 / f64 factors) with
    the named dual kind, and its P measurement columns."""
    jdt = getattr(jnp, dtype)
    op = rt.SeparableConvOperator.from_taps(*taps, shape, dtype=jdt, compensated=False)
    extra = dict(enforce_positive=True, enforce_real=True) if positive else {}
    if kind == "l1":
        reg = rt.L1Regularization(1e-3)
        extra["normalize_reg"] = rt.MeasurementBasedNormalization()
    else:
        reg = rt.TVRegularization(5e-3, shape=shape)
        extra["tv_scheme"] = "8dir" if kind == "tv8" else "isotropic"
    s = rt.PDHG.create(op, reg=reg, iterations=iterations, sigma=0.5, tau=tau, **extra, **kw)
    X = np.abs(np.random.default_rng(2).normal(size=(P, shape[0] * shape[1])))
    B = np.stack([np.asarray(op.mv(jnp.asarray(x, jdt))) for x in X], axis=1).astype(dtype)
    return s, B


@pytest.mark.parametrize("positive", [False, True])
@pytest.mark.parametrize("kind", ["tv8", "tviso", "l1"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_composed_pdhg_matches_jax(dtype, kind, positive):
    """All eight iterations of one column (x and the gap) in both dtypes,
    rls_tpu's step jitted once (a jit of its whole unrolled solve takes
    seconds to compile per case), and the port's batched fixed-iteration
    solve against the same x."""
    steps = 8
    with jax.enable_x64(dtype == "float64"):
        js, B = _pdhg(dtype, kind, positive, iterations=steps)
        state = js.init(jnp.asarray(B[:, 1]))
        step = jax.jit(js.step)
        for _ in range(steps):
            state = step(state)
        want_x, want_gap = np.asarray(state.x), float(state.gap)
    ts = convert(js, device="cpu")
    assert ts.tv_scheme == js.tv_scheme and ts.tau == float(js.tau)
    Bt = torch.from_numpy(B)
    tstate = ts.init(Bt.T)
    for _ in range(steps):
        tstate = ts.step(tstate)
    assert tstate.gap.shape == (3,) and tstate.x.dtype == Bt.dtype
    assert _rel(tstate.x[1], want_x) < TOL[dtype], _rel(tstate.x[1], want_x)
    assert abs(float(tstate.gap[1]) - want_gap) <= TOL[dtype] * abs(want_gap)
    got = rtt.solve_batched_unrolled(ts, Bt)
    assert got.shape == (B.shape[0], 3) and got.dtype == Bt.dtype
    assert _rel(got[:, 1], want_x) < TOL[dtype], _rel(got[:, 1], want_x)
    if positive:
        assert float(got.min()) >= 0.0


def test_pdhg_stops_on_the_gap():
    """``solve`` stops once the gap falls below eps, as rls_tpu's does."""
    js, B = _pdhg("float32", "l1", False, iterations=200, eps=5e-2)
    want = np.asarray(rt.solve(js, jnp.asarray(B[:, 0])))
    ts = convert(js, device="cpu")
    b = torch.from_numpy(B[:, 0])
    got = rtt.solve(ts, b)
    assert _rel(got, want) < 1e-5
    state = ts.init(b)
    steps = 0
    while not bool(ts.done(state)):
        state, steps = ts.step(state), steps + 1
    assert steps < 200 and float(state.gap) < 5e-2


def test_pdhg_create_follows_the_reference_ctor():
    js, _ = _pdhg("float32", "tv8", True)
    op = convert(js.A, device="cpu")
    ts = rtt.PDHG.create(op, reg=rtt.TVRegularization(5e-3, shape=(12, 12)), iterations=15,
                         sigma=0.5, enforce_positive=True, enforce_real=True)
    # τ = 0.9/(σ·L²) from the port's own power iteration on AᴴA + ΦᴴΦ, held
    # to the exact λmax of the dense matrices in float64 (rls_tpu's power
    # iteration in eager JAX takes seconds here: every step transposes
    # Grad8Operator anew)
    eye = torch.eye(144)
    at, gt = op.mv(eye).double(), ts.trafo.mv(eye).double()  # Aᵀ and Φᵀ, row by row
    exact = 0.9 / (0.5 * float(torch.linalg.eigvalsh(at @ at.T + gt @ gt.T).max()))
    assert abs(ts.tau / exact - 1) < 2e-2, (ts.tau, exact)
    assert ts.tv_scheme == "8dir" and isinstance(ts.trafo, rtt.Grad8Operator)
    assert [type(p).__name__ for p in ts.proj] == ["PositiveRegularization"]
    # a 3-D shape and a complex operator fall back to the isotropic scheme
    s3 = rtt.PDHG.create(rtt.DenseOperator(torch.randn(40, 18), device="cpu"),
                         reg=rtt.TVRegularization(1e-4, shape=(2, 3, 3)), tau=0.1)
    assert s3.tv_scheme == "isotropic" and isinstance(s3.trafo, rtt.GradientOperator)
    sc = rtt.PDHG.create(rtt.DenseOperator(torch.randn(40, 9, dtype=torch.complex64),
                                           device="cpu"),
                         reg=rtt.TVRegularization(1e-4, shape=(3, 3)), tau=0.1)
    assert sc.tv_scheme == "isotropic"
    sl = rtt.PDHG.create(op, reg=rtt.L1Regularization(1e-3), tau=0.1)
    assert sl.reg_kind == "l1" and isinstance(sl.trafo, rtt.IdentityOperator)


@pytest.mark.parametrize("positive", [False, True])
@pytest.mark.parametrize("kind", ["tv8", "tviso", "l1"])
def test_pdhg_fused_plain_matches_jax_fused(kind, positive):
    """On a 20×28 image with a 5-tap and a 3-tap factor."""
    js, B = _pdhg("float32", kind, positive, shape=RECT, iterations=12, taps=(G5, G3), P=2)
    want = np.asarray(jpdhg.solve_pdhg_fused(js, jnp.asarray(B), interpret=True))
    before = tpdhg.pdhg_fused.launches
    got = rtt.solve_pdhg_fused(convert(js, device="cpu"), torch.from_numpy(B))
    assert tpdhg.pdhg_fused.launches == before  # CPU: the plain version
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < 1e-5, _rel(got, want)
    # and the port's composed solve
    comp = rtt.solve_batched_unrolled(convert(js, device="cpu"), torch.from_numpy(B))
    assert _rel(got, comp) < 1e-5


def test_rectangular_pgm_tv_fused_matches_jax():
    """The fused FISTA-TV kernel's plain version on 20×28 with a 5-tap and a
    3-tap factor (rows and columns differ everywhere)."""
    # compensated factors, as the JAX fused path requires (on a 20×28 image
    # it routes to its exact-f32 stencil Gram all the same)
    op = rt.SeparableConvOperator.from_taps(G5, G3, RECT)
    s = rt.FISTA.create(op, reg=rt.TVRegularization(1e-3, shape=RECT, iterations_tv=4,
                                                     backend="pallas"),
                        iterations=6, rho=0.9, rel_tol=0.0, track_residual=False)
    X = np.random.default_rng(3).normal(size=(2, RECT[0] * RECT[1])).astype(np.float32)
    B = np.array(jax.vmap(op.mv)(jnp.asarray(X)).T)
    want = np.asarray(jfused.solve_pgm_tv_fused(s, jnp.asarray(B), interpret=True,
                                                fgp_unroll=True, fgp_opt="fold"))
    before = tfused.fista_tv_fused.launches
    got = rtt.solve_fista_tv_fused(convert(s, device="cpu"), torch.from_numpy(B))
    assert tfused.fista_tv_fused.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("prox", ["none", "positive"])
def test_rectangular_admm_tv_fused_matches_jax(prox):
    op = rt.SeparableConvOperator.from_taps(G5, G3, RECT, compensated=False)
    X = np.random.default_rng(0).normal(size=(2, RECT[0] * RECT[1])).astype(np.float32)
    b = jax.vmap(op.mv)(jnp.asarray(X))
    x0 = np.array(jax.vmap(op.rmv_stencil)(b)).reshape(2, *RECT)
    rho = np.array([0.1, 0.3], np.float32)
    lam = np.array([1e-3, 2e-3], np.float32)
    taps = op.taps_hw()
    zeros = jnp.zeros((1, 1), jnp.float32)
    want = np.asarray(jadmm.admm_tv_fused(
        jnp.asarray(x0), zeros, zeros, jnp.asarray(rho), jnp.asarray(lam), 6, 5, 4, 1e-5,
        interpret=True, taps=taps, prox=prox, fgp_unroll=True))
    got = tadmm.admm_tv_fused(torch.from_numpy(x0), taps, torch.from_numpy(rho),
                              torch.from_numpy(lam), 6, 5, 4, 1e-5, prox=prox)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_pdhg_dispatch_and_rejections():
    js, B = _pdhg("float32", "tv8", False, iterations=3)
    ts = convert(js, device="cpu")
    name, _, reasons = auto.select_fast_path(ts)
    assert name == "pdhg", reasons
    assert len(reasons) == 9  # every earlier row rejected it
    got = rtt.solve_batched_fast(ts, torch.from_numpy(B))
    assert _rel(got, rtt.solve_pdhg_fused(ts, torch.from_numpy(B))) == 0.0
    with pytest.raises(ValueError, match="requires a PDHG solver"):
        tpdhg.check_pdhg_fused(rtt.FISTA.create(ts.A, reg=rtt.L1Regularization(1e-3), rho=0.5))
    dense = rtt.PDHG.create(rtt.DenseOperator(torch.randn(144, 144), device="cpu"),
                            reg=rtt.L1Regularization(1e-3), tau=0.1)
    with pytest.raises(ValueError, match="requires a SeparableConvOperator"):
        tpdhg.check_pdhg_fused(dense)
    op = ts.A
    bare = rtt.SeparableConvOperator(op.ah, op.aw, op.bh, op.bw, op.im_shape)
    with pytest.raises(ValueError, match="tap metadata"):
        tpdhg.check_pdhg_fused(rtt.PDHG.create(bare, reg=rtt.L1Regularization(1e-3), tau=0.1))
    with pytest.raises(ValueError, match="real data only"):
        tpdhg.solve_pdhg_fused(ts, torch.from_numpy(B).to(torch.complex64))
    wrong = rtt.PDHG.create(op, reg=rtt.TVRegularization(1e-3, shape=(6, 24)), tau=0.1)
    with pytest.raises(ValueError, match="TV shape must equal"):
        tpdhg.check_pdhg_fused(wrong)


def test_convert_carries_pdhg():
    js, _ = _pdhg("float32", "tv8", True)
    ts = convert(js, device="cpu")
    assert isinstance(ts, rtt.PDHG) and isinstance(ts.trafo, rtt.Grad8Operator)
    assert (ts.sigma, ts.tau, ts.eps, ts.iterations) == (0.5, 0.3, float(js.eps), 15)
    assert ts.reg_kind == "tv" and ts.shape == (12, 12) and ts.trafo.im_shape == (12, 12)
    assert [type(p).__name__ for p in ts.proj] == ["PositiveRegularization"]
