"""SplitBregman in rls_tpu_torch against rls_tpu on the same numpy inputs:
the composed solver on the SENSE operator with L21 + TV (BASELINE
configuration #4's shape at test_kernels.py:490-515's size, 16², 3 coils,
2 outer × 3 inner × 5 CG steps) through the solve entry points, the plain version of
the fused SplitBregman kernel against the JAX kernel in interpret mode, the
dispatch with its rejections, and convert.

Tolerances: the composed solver 1e-8 in float64 (JAX under a scoped
``enable_x64`` on its uncompensated operator: the same ops, an FFT against
matrix products) and 3e-4 in float32 against the JAX composed path on its
compensated operator, the bar the JAX suite sets between its kernel and
its composed path (tests/test_kernels.py:515). The plain kernel 3e-4
against the JAX kernel (``fgp_unroll=True``, the fold FGP both run): the
JAX kernel forms its DFT from 3-way bf16 splits and seeds x0hat with that
compensated adjoint, the port runs an exact f32 FFT and the operator's own
adjoint.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import auto
from rls_tpu_torch.kernels import splitbregman_fused as tsb

jsb = importlib.import_module("rls_tpu.kernels.splitbregman_fused")
H = W = 16


def _problem(dtype="float32", compensated=True, reg_order="l21-tv", rho=(0.01, 0.02), batch=2,
             **kw):
    """The SENSE SplitBregman problem of test_kernels.py:490-515 in
    rls_tpu, with its measurement columns (numpy)."""
    rng = np.random.default_rng(12)
    n = H * W
    jdt = getattr(jnp, dtype)
    C = 3
    maps = rng.normal(size=(C, H, W)) + 1j * rng.normal(size=(C, H, W))
    maps /= np.sqrt((np.abs(maps) ** 2).sum(0))
    mask = (rng.uniform(size=(H, W)) < 0.6).astype(np.float32)
    op = rt.SenseDFT2RealOperator.from_maps(maps.astype(np.complex64), mask, (H, W),
                                            compensated=compensated, dtype=jdt)
    l21 = rt.L21Regularization(1e-3, slices=2)
    tv = rt.TVRegularization(1e-3, shape=(2, H, W), dims=(1, 2), iterations_tv=4, unroll=True)
    reg = [l21, tv] if reg_order == "l21-tv" else [tv, l21]
    kw.setdefault("reg_trafo", [rt.IdentityOperator(2 * n, jdt), rt.IdentityOperator(2 * n, jdt)])
    kw.setdefault("unroll_cg", True)
    solver = rt.SplitBregman.create(op, reg=reg, iterations=2, iterations_inner=3,
                                    iterations_cg=5, rho=list(rho), **kw)
    X = rng.normal(size=(batch, 2 * n))
    B = np.array(jax.vmap(op.mv)(jnp.asarray(X, jdt)).T)
    return solver, B


@pytest.mark.parametrize("case,dtype", [
    (case, dtype) for case in ("default", "tv-first", "rho-zero", "early-cg", "measurement")
    for dtype in ("float32", "float64")
    # float32 runs the JAX compensated operator, slow to compile: the
    # cases that change the solve's code path
    if dtype == "float64" or case in ("default", "early-cg", "measurement")
])
def test_composed_splitbregman_matches_jax(case, dtype):
    kw = {}
    if case == "tv-first":
        kw["reg_order"] = "tv-l21"
    elif case == "rho-zero":
        kw["rho"] = (0.0, 0.02)
    elif case == "early-cg":
        kw["unroll_cg"] = False
    elif case == "measurement":
        kw["normalize_reg"] = rt.MeasurementBasedNormalization()
    with jax.enable_x64(dtype == "float64"):
        jsolver, B = _problem(dtype, compensated=dtype == "float32", **kw)
        Bj = jnp.asarray(B)
        want_u = np.asarray(jax.jit(lambda bb: rt.solve_batched_unrolled(jsolver, bb))(Bj))
        # one problem through the while-loop solve (eager in JAX: slow)
        want_1 = np.asarray(rt.solve(jsolver, Bj[:, 0])) if case == "default" else None
    tsolver = convert(jsolver, device="cpu")
    Bt = torch.from_numpy(B)
    got_u = rtt.solve_batched_unrolled(tsolver, Bt)
    assert got_u.dtype == Bt.dtype and got_u.shape == want_u.shape
    tol = 1e-8 if dtype == "float64" else 3e-4
    np.testing.assert_allclose(got_u.numpy(), want_u, rtol=0, atol=tol)
    if want_1 is not None:
        np.testing.assert_allclose(rtt.solve(tsolver, Bt[:, 0]).numpy(), want_1, rtol=0,
                                   atol=tol)


def test_solve_batched_matches_the_unrolled_solve():
    """solve_batched with its done mask: the fixed schedule stops after
    iterations × iterations_inner steps, as the unrolled solve does."""
    with jax.enable_x64(True):
        jsolver, B = _problem("float64", compensated=False)
    tsolver = convert(jsolver, device="cpu")
    Bt = torch.from_numpy(B)
    state = tsolver.init(Bt.T)
    steps = 0
    while not bool(tsolver.done(state).all()):
        state = tsolver.step(state)
        steps += 1
    assert steps == tsolver.total_steps == 6
    assert state.iter_cnt.tolist() == [3, 3]
    np.testing.assert_allclose(rtt.solve_batched(tsolver, Bt).numpy(),
                               rtt.solve_batched_unrolled(tsolver, Bt).numpy(), rtol=0, atol=1e-12)
    conv = tsolver.convergence(state)
    assert conv["primal"].shape == (2, 2) and conv["dual"].shape == (2, 2)


# (ρ per term, tol_inner): a tol_inner of 0.05 makes the CG freeze
_KERNEL_CASES = {"default": ((0.01, 0.02), 1e-5), "rho-zero": ((0.0, 0.02), 1e-5),
                 "freeze": ((0.01, 0.02), 5e-2)}


@pytest.mark.parametrize("case", sorted(_KERNEL_CASES))
def test_splitbregman_plain_matches_jax_kernel(case):
    rho, tol = _KERNEL_CASES[case]
    jsolver, B = _problem(rho=rho, tol_inner=tol)
    want = np.asarray(jsb.solve_splitbregman_l1_tv_fused(jsolver, jnp.asarray(B), interpret=True,
                                                          fgp_unroll=True))
    tsolver = convert(jsolver, device="cpu")
    assert auto.select_fast_path(tsolver)[0] == "splitbregman_l1_tv"
    before = tsb.splitbregman_l1_tv_fused.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = rtt.solve_batched_fast(tsolver, torch.from_numpy(B))
    assert tsb.splitbregman_l1_tv_fused.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-4)
    # the live CG steps: all 2 × 3 × 5 unless the freeze fires
    op = tsolver.A
    x0 = op.rmv(torch.from_numpy(B.T)).reshape(-1, 2, H, W)
    _, live = tsb.splitbregman_l1_tv_fused(x0, op.mask, op.coils_r, op.coils_i, rho[0], rho[1],
                                           1e-3, 1e-3, 2, 3, 5, 4, tol, with_counts=True)
    if case == "freeze":
        assert max(live.tolist()) < 30, live
    else:
        assert live.tolist() == [30, 30]


def test_splitbregman_plain_matches_the_composed_solver():
    """The plain kernel version against the port's own composed solver in
    float64 (the same algorithm; the kernel's fold FGP and the composed
    fori FGP round differently)."""
    with jax.enable_x64(True):
        jsolver, B = _problem("float64", compensated=False)
    tsolver = convert(jsolver, device="cpu")
    Bt = torch.from_numpy(B)
    op = tsolver.A
    x0 = op.rmv(Bt.T).reshape(-1, 2, H, W)
    got = tsb.splitbregman_l1_tv_fused(x0, op.mask, op.coils_r, op.coils_i, 0.01, 0.02, 1e-3,
                                       1e-3, 2, 3, 5, 4, 1e-5)
    assert got.dtype == torch.float64
    want = rtt.solve_batched_unrolled(tsolver, Bt)
    np.testing.assert_allclose(got.reshape(2, -1).T.numpy(), want.numpy(), rtol=0, atol=1e-10)


def _port_solver(n=16, **kw):
    mask = np.ones((n, n), np.float32)
    maps = np.ones((2, n, n), np.complex64) / np.sqrt(2)
    op = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (n, n), device="cpu")
    l21 = rtt.L21Regularization(1e-3, slices=2)
    tv = rtt.TVRegularization(1e-3, shape=(2, n, n), dims=(1, 2), iterations_tv=3)
    kw.setdefault("reg", [l21, tv])
    return rtt.SplitBregman.create(op, iterations=2, iterations_inner=2, iterations_cg=3,
                                   unroll_cg=True, rho=0.01, **kw)


def test_splitbregman_rejections_name_the_reason():
    n = 16
    l21 = rtt.L21Regularization(1e-3, slices=2)
    tv = rtt.TVRegularization(1e-3, shape=(2, n, n), dims=(1, 2), iterations_tv=3)
    cases = [
        (dict(reg=[l21]), "exactly two reg terms"),
        (dict(reg=[l21, rtt.L1Regularization(1e-3)]), "one L21Regularization and one TV"),
        (dict(reg=[rtt.L21Regularization(1e-3, slices=4), tv]), r"slices=2"),
        (dict(reg=[l21, rtt.TVRegularization(1e-3, shape=(n, 2 * n))]), r"shape \(2, H, W\)"),
        (dict(reg=[l21, tv, rtt.PositiveRegularization()]), "projection"),
        (dict(precon=lambda v: v), "preconditioner"),
        (dict(rel_tol=1e-3), "abs_tol/rel_tol"),
        (dict(reg_trafo=[rtt.IdentityOperator(2 * n * n, torch.float32, device="cpu"),
                         rtt.GradientOperator((2, n, n), dtype=torch.float32, device="cpu")]),
         "identity reg_trafos"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            tsb.check_splitbregman_l1_tv_fused(_port_solver(n, **kw))
    tsb.check_splitbregman_l1_tv_fused(_port_solver(n))
    with pytest.raises(ValueError, match="requires a SplitBregman solver"):
        tsb.check_splitbregman_l1_tv_fused(rtt.ADMM.create(_port_solver(n).A, reg=[l21, tv]))
    # a size the in-kernel FFT does not take: the dispatch names it and
    # falls back to the composed solver
    name, _, reasons = auto.select_fast_path(_port_solver(24))
    assert name is None
    assert any(r.startswith("splitbregman_l1_tv: the in-kernel FFT takes H and W that are "
                            "powers of two") for r in reasons), reasons


def test_convert_carries_splitbregman():
    jsolver, _ = _problem(abs_tol=1e-6, tol_inner=1e-3, reg_order="tv-l21")
    t = convert(jsolver, device="cpu")
    assert isinstance(t, rtt.SplitBregman) and t.AHA.A is t.A
    assert isinstance(t.A, rtt.SenseDFT2RealOperator)
    assert t.rho0 == (0.01, 0.02)
    assert (t.abs_tol, t.rel_tol, t.tol_inner) == (1e-6, None, 1e-3)
    assert (t.iterations, t.iterations_inner, t.iterations_cg, t.unroll_cg) == (2, 3, 5, True)
    assert [type(r).__name__ for r in t.reg] == ["TVRegularization", "L21Regularization"]
    assert t.reg[0].shape == (2, H, W) and t.reg[0].dims == (1, 2)
    assert all(isinstance(e, rtt.IdentityOperator) and e.n == 2 * H * W for e in t.reg_trafo)
    with pytest.raises(NotImplementedError, match="preconditioner"):
        convert(rt.SplitBregman.create(jsolver.A, reg=rt.L1Regularization(1e-3),
                                       precon=lambda v: v), device="cpu")
