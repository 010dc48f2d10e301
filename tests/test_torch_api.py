"""The API surface of rls_tpu_torch against rls_tpu on the same numpy inputs:
``solve_with_callbacks`` (the iteration-0 call, the callbacks' nrmsd and
convergence lists, verbose printing), ``solve_trace`` with problems that
stop early, a custom scheduler through ``solve_batched(scheduler=)``, the
registry (``create_linear_solver`` by name for all twelve solvers with the
dropped-kwarg warning, ``filter_kwargs``, ``is_applicable`` and
``applicable_solver_list`` for every regularizer type), the deprecated
shims, checkpoints of FISTA and randomized Kaczmarz resumed bit for bit,
``time_solver`` and ``trace``, and the export list against rls_tpu's.

Tolerance: float64 (JAX x64, scoped), 1e-10 relative."""

import dataclasses
import inspect
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu import deprecated as jdep
from rls_tpu import registry as jreg
from rls_tpu_torch import deprecated as tdep
from rls_tpu_torch import registry as treg
from rls_tpu_torch.convert import convert
from rls_tpu_torch.models.solvers.base import state_where

TOL = 1e-10


def _close(got, want, tol=TOL, what=""):
    """Equal where not finite (a residual starts at inf), else within `tol`
    of max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    err = float(np.abs(got[fin] - want[fin]).max(initial=0.0))
    assert err <= tol * max(float(np.abs(want[fin]).max(initial=0.0)), 1e-30), (what, err)


@pytest.fixture
def problem(rng):
    """A float64 dense system (12 x 8) with two right-hand sides, the
    second inconsistent, and the rls_tpu FISTA + L1 built on it."""
    A = rng.normal(size=(12, 8))
    X = rng.normal(size=(8, 2))
    B = A @ X
    B[:, 1] = rng.normal(size=12)
    return A, X, B


def _fista(A, rel_tol=None, iterations=10):
    with jax.enable_x64(True):
        return rt.FISTA.create(jnp.asarray(A), reg=rt.L1Regularization(1e-3),
                               iterations=iterations, rel_tol=rel_tol)


def test_solve_with_callbacks_matches_jax(problem, capsys):
    """Per-iteration nrmsd and residual lists of one problem equal JAX's, with
    the iteration-0 call; the stored solutions are copies; a batch gives
    the same per-problem values; verbose prints each iteration."""
    A, X, B = problem
    js = _fista(A)
    with jax.enable_x64(True):
        jcmp, jconv = rt.CompareSolutionCallback(X[:, 0]), rt.StoreConvergenceCallback()
        jx = rt.solve_with_callbacks(js, jnp.asarray(B[:, 0]), callbacks=[jcmp, jconv])
    ts = convert(js, device="cpu")
    cmp = rtt.CompareSolutionCallback(torch.from_numpy(X[:, 0]))
    conv, store, seen = rtt.StoreConvergenceCallback(), rtt.StoreSolutionCallback(), []
    x = rtt.solve_with_callbacks(ts, torch.from_numpy(B[:, 0]),
                                 callbacks=[cmp, conv, store, lambda run, it: seen.append(it)])
    assert seen == list(range(11))
    _close(x.numpy(), jx, what="x")
    _close(cmp.results, jcmp.results, what="nrmsd")
    _close(torch.stack(conv.conv_meas["residual"]).numpy(),
           np.stack(jconv.conv_meas["residual"]), what="residual")
    assert len(store.solutions) == 11 and float(store.solutions[0].abs().max()) == 0.0
    assert torch.equal(store.solutions[-1], x)
    # a batch (2, m): each problem's values
    cmp2 = rtt.CompareSolutionCallback(torch.from_numpy(X.T))
    x2 = rtt.solve_with_callbacks(ts, torch.from_numpy(B.T), callbacks=cmp2)
    assert cmp2.results[-1].shape == (2,)
    _close(x2[0].numpy(), jx, what="batched x")  # a (2, m) product rounds as a gemm
    _close(torch.stack(cmp2.results)[:, 0].numpy(), jcmp.results, what="batched nrmsd")
    # verbose
    rtt.solve_with_callbacks(dataclasses.replace(ts, verbose=True), torch.from_numpy(B[:, 0]))
    out = capsys.readouterr().out
    assert "Iteration 1; {'residual':" in out and "Iteration 10;" in out


def test_solve_trace_with_early_done_problems_matches_jax(problem):
    """FISTA with rel_tol 0.03: the two problems stop after different
    numbers of steps, each short of 30; the port's batched trace
    (solutions (2, T, n), residuals and flags (2, T)) equals JAX's
    per-problem traces."""
    A, _, B = problem
    js = _fista(A, rel_tol=0.03, iterations=30)
    ts = convert(js, device="cpu")
    x, (xs, metrics, active) = rtt.solve_trace(ts, torch.from_numpy(B.T))
    assert xs.shape == (2, 30, 8) and metrics["residual"].shape == active.shape == (2, 30)
    for k in range(2):
        with jax.enable_x64(True):
            jx, (jxs, jm, jact) = rt.solve_trace(js, jnp.asarray(B[:, k]))
        np.testing.assert_array_equal(active[k].numpy(), np.asarray(jact))
        _close(xs[k].numpy(), jxs, what="xs")
        _close(metrics["residual"][k].numpy(), jm["residual"], what="residual")
        _close(x[k].numpy(), jx, what="x")
    steps = active.sum(dim=1).tolist()
    assert steps[0] != steps[1] and max(steps) < 30, steps
    x1, trace1 = rtt.solve_trace(ts, torch.from_numpy(B[:, 0]), metrics=False)
    assert len(trace1) == 2 and trace1[0].shape == (30, 8)
    _close(x1.numpy(), x[0].numpy(), what="one problem")


def test_custom_scheduler_equals_the_default(problem):
    """A chunked scheduler (the first half of the problems to the end, then
    the second) through solve_batched(scheduler=) gives the default's
    bits; the default is masked_vmap_scheduler."""
    A, _, B = problem
    ts = convert(_fista(A, rel_tol=0.03, iterations=30), device="cpu")
    Bt = torch.from_numpy(np.concatenate([B, B[:, ::-1]], axis=1))
    calls = []

    def chunked(solver, state, active0):
        K = active0.shape[0]
        for lo, hi in ((0, K // 2), (K // 2, K)):
            live = torch.zeros_like(active0)
            live[lo:hi] = active0[lo:hi]
            while bool(live.any()):
                state = state_where(live, solver.step(state), state)
                live = live & ~solver.done(state)
            calls.append((lo, hi))
        return state

    want = rtt.solve_batched(ts, Bt)
    assert torch.equal(rtt.solve_batched(ts, Bt, scheduler=rtt.masked_vmap_scheduler), want)
    assert torch.equal(rtt.solve_batched(ts, Bt, scheduler=chunked), want)
    assert calls == [(0, 2), (2, 4)]


def _dense(A):
    return rtt.DenseOperator(torch.from_numpy(A), device="cpu")


def _create_kwargs(name):
    """Arguments each solver needs on a 12 x 8 dense system."""
    l2 = name in ("Kaczmarz", "CGNR", "DirectSolver", "PseudoInverse")
    if name.startswith("Dax"):
        return {"lam": 1e-4, "iterations": 2}
    kw = {"reg": "l2" if l2 else "l1", "iterations": 3}
    if name == "PDHG":
        kw.update(tau=0.01)
    return kw


@pytest.mark.parametrize("name", [c.__name__ for c in jreg.linear_solver_list_real()])
def test_create_linear_solver_by_name(problem, name):
    """Every solver of linear_solver_list_real by its name (any case): the
    same class as rls_tpu builds, a warning naming the dropped kwarg, and
    filter_kwargs keeping what rls_tpu's keeps."""
    A, _, _ = problem
    kw = _create_kwargs(name)
    treg_kw = dict(kw)
    if "reg" in kw:
        treg_kw["reg"] = rtt.L2Regularization(1e-4) if kw["reg"] == "l2" else \
            rtt.L1Regularization(1e-4)
    with pytest.warns(UserWarning, match="filtered out: bogus_kwarg"):
        s = rtt.create_linear_solver(name.lower(), _dense(A), bogus_kwarg=1, **treg_kw)
    assert type(s).__name__ == name and type(s) is treg.solver_by_name(name)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rtt.create_linear_solver(name, _dense(A), kwarg_warning=False, bogus_kwarg=1, **treg_kw)
    jcls = jreg.solver_by_name(name)
    every = {k: 0 for k in inspect.signature(jcls.create).parameters} | {"bogus_kwarg": 0}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert set(treg.filter_kwargs(type(s), every)) == set(jreg.filter_kwargs(jcls, every))
    rtt.deinit(s)


def _reg_cases(mod):
    """One of every regularizer type, decorated and in lists, built in
    package `mod`."""
    model = (lambda x: x)
    return {
        "l1": mod.L1Regularization(0.1),
        "l2": mod.L2Regularization(0.1),
        "l21": mod.L21Regularization(0.1, slices=2),
        "tv": mod.TVRegularization(0.1, shape=(4, 4)),
        "tv_int": mod.TVRegularization(0.1, shape=(4, 4), dims=1),
        "nuclear": mod.NuclearRegularization(0.1, svt_shape=(4, 4)),
        "llr": mod.LLRRegularization(0.1, shape=(4, 4)),
        "pnp": mod.PnPRegularization(0.3, model=model, shape=(4, 4)),
        "positive": mod.PositiveRegularization(),
        "real": mod.RealRegularization(),
        "projection": mod.ProjectionRegularizationTerm(proj_func=model),
        "fixed_scaled_l2": mod.FixedScaledRegularization(mod.L2Regularization(0.1), 2.0),
        "masked_l1": mod.MaskedRegularization(mod.L1Regularization(0.1), (True, False)),
        "l2_positive": [mod.L2Regularization(0.1), mod.PositiveRegularization()],
        "l1_l2": [mod.L1Regularization(0.1), mod.L2Regularization(0.1)],
        "l1_l2_tv": [mod.L1Regularization(0.1), mod.L2Regularization(0.1),
                     mod.TVRegularization(0.1, shape=(4, 4))],
        "l2_l2": [mod.L2Regularization(0.1), mod.L2Regularization(0.2)],
        "nothing": [],
    }


def test_applicability_matches_jax():
    """is_applicable for every solver and applicable_solver_list for every
    regularizer type equal rls_tpu's."""
    jcases, tcases = _reg_cases(rt), _reg_cases(rtt)
    names = [c.__name__ for c in jreg.linear_solver_list_real()]
    assert [c.__name__ for c in treg.linear_solver_list_real()] == names
    assert [c.__name__ for c in treg.linear_solver_list()] == \
        [c.__name__ for c in jreg.linear_solver_list()]
    for key in jcases:
        want = [c.__name__ for c in jreg.applicable_solver_list(jcases[key])]
        assert [c.__name__ for c in treg.applicable_solver_list(tcases[key])] == want, key
        for name in names:
            assert treg.is_applicable(treg.solver_by_name(name), tcases[key]) == \
                jreg.is_applicable(jreg.solver_by_name(name), jcases[key]), (key, name)
    for tup in ("ROW_ACTION_SOLVERS", "PROXIMAL_GRADIENT_SOLVERS", "PRIMAL_DUAL_SOLVERS",
                "KRYLOV_SOLVERS", "DIRECT_SOLVERS", "DAX_SOLVERS"):
        assert [c.__name__ for c in getattr(treg, tup)] == \
            [c.__name__ for c in getattr(jreg, tup)], tup
    with pytest.raises(KeyError, match="unknown solver"):
        treg.solver_by_name("nope")


def test_deprecated_shims_match_jax(problem):
    A, _, _ = problem
    with pytest.warns(DeprecationWarning, match="create_linear_solver_x"):
        s = tdep.create_linear_solver_x("CGNR", _dense(A), torch.zeros(8),
                                        reg=rtt.L2Regularization(1e-3), iterations=2)
    assert isinstance(s, rtt.CGNR)
    l1 = rtt.L1Regularization(0.1)
    with pytest.warns(DeprecationWarning, match="vec_reg"):
        assert tdep.vec_reg(l1) == [l1]
    with pytest.warns(DeprecationWarning):
        assert tdep.vec_reg((l1, l1)) == [l1, l1]
    with pytest.raises(RuntimeError) as got:
        tdep.ConstraintTransformedRegularization()
    with pytest.raises(RuntimeError) as want:
        jdep.ConstraintTransformedRegularization()
    assert str(got.value) == str(want.value)
    assert rtt.deprecated is tdep and tdep.__all__ == jdep.__all__


def _stepped(solver, b, k):
    """The state after k steps of the masked loop (solve_batched's)."""
    state = solver.init(b)
    active = ~solver.done(state)
    for _ in range(k):
        state = state_where(active, solver.step(state), state)
        active = active & ~solver.done(state)
    return state


@pytest.mark.parametrize("case", ["fista", "kaczmarz_randomized"])
def test_checkpoint_resumes_bit_for_bit(tmp_path, problem, case):
    """A state saved after 4 of 10 steps, loaded into a fresh state and
    resumed, ends on the uninterrupted solve's bits; the randomized
    Kaczmarz state's generator is saved at save time (step advances it in
    place), so the resumed run draws the same rows."""
    A, _, B = problem
    At, Bt = _dense(A), torch.from_numpy(B.T)
    if case == "fista":
        s = rtt.FISTA.create(At, reg=rtt.L1Regularization(1e-3), iterations=10)
    else:
        s = rtt.Kaczmarz.create(At, reg=rtt.L2Regularization(1e-4), iterations=10,
                                randomized=True, sub_matrix_fraction=0.5, seed=3)
    want, _ = rtt.resume(s, s.init(Bt))
    path = os.path.join(tmp_path, "state.pt")
    mid = _stepped(s, Bt, 4)
    rtt.save_state(path, mid)
    if case != "fista":  # the live generator moves on; the checkpoint does not
        _stepped(s, Bt, 0)
        s.step(mid)
    loaded = rtt.load_state(path, s.init(Bt))
    assert int(loaded.iteration.max()) == 4
    got, final = rtt.resume(s, loaded)
    assert torch.equal(got, want) and bool(s.done(final).all())
    with pytest.raises(TypeError, match="holds a"):
        rtt.load_state(path, rtt.CGNR.create(At, reg=rtt.L2Regularization(1e-3)).init(Bt))


def test_time_solver_keys_and_trace_file(tmp_path, problem):
    A, _, B = problem
    s = rtt.FISTA.create(_dense(A), reg=rtt.L1Regularization(1e-3), iterations=5)
    out = rtt.time_solver(rtt.solve_batched, s, torch.from_numpy(B), reps=2)
    assert set(out) == {"compile_s", "mean_s", "per_rep_s"} and len(out["per_rep_s"]) == 2
    assert out["mean_s"] == pytest.approx(sum(out["per_rep_s"]) / 2)
    logdir = os.path.join(tmp_path, "trace")
    with rtt.trace(logdir):
        rtt.solve_batched(s, torch.from_numpy(B))
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0


# rls_tpu's public names (dir(rls_tpu) less the leading underscores) and the
# six the port leaves out (ROADMAP.md "What not to port"); the subpackage
# rls_tpu.parallel, which rls_tpu binds only once imported, is held apart
# in the test below
JAX_PUBLIC = (
    "ADMM", "AutoScaledRegularization", "CGNR", "CompareSolutionCallback",
    "ConvolutionOperator", "DaxConstrained", "DaxKaczmarz", "DenseOperator",
    "DirectConvOperator", "DirectSolver", "FFTOperator", "FISTA",
    "FixedParameterRegularization", "FixedScaledRegularization", "FunctionOperator",
    "Grad8Operator", "GradientOperator", "IdentityOperator", "Kaczmarz", "L1Regularization",
    "L21Regularization", "L2Regularization", "LLRRegularization", "MaskedRegularization",
    "MeasurementBasedNormalization", "NoNormalization", "NormalOperator",
    "NormalizedRegularization", "NuclearRegularization", "OptISTA", "PDHG", "POGM",
    "PaddedCSROperator", "PlugAndPlayRegularization", "PnPRegularization",
    "PositiveRegularization", "ProdOperator", "ProjectionRegularizationTerm", "PseudoInverse",
    "RadonOperator", "RealRegularization", "SamplingOperator", "SenseDFT2RealOperator",
    "SeparableConvOperator", "SparseOperator", "SplitBregman", "SplitRealSolver",
    "StackedOperator", "StoreConvergenceCallback", "StoreSolutionCallback",
    "SubsampledDFT2RealOperator", "SubsampledFFTOperator", "SystemMatrixBasedNormalization",
    "TVRegularization", "TransformedRegularization", "WaveletOperator", "WeightingOperator",
    "applicable_solver_list", "backend_supports_complex", "build_split_real_solver",
    "callbacks", "create_linear_solver", "deinit", "denoisers", "deprecated", "find_sinks",
    "is_applicable", "jacobi_svd", "jacobi_svdvals", "kernels", "linear_solver_list",
    "linear_solver_list_real", "load_state", "masked_vmap_scheduler", "max_wavelet_levels",
    "models", "nrmsd", "ops", "pcg", "power_iterations", "prox", "reg_chain", "registry",
    "regularization", "resume", "save_state", "sink", "sink_type", "solve", "solve_batched",
    "solve_batched_fast", "solve_batched_unrolled", "solve_cgnr_fused",
    "solve_kaczmarz_streamed", "solve_pdhg_fused", "solve_splitbregman_l1_tv_fused",
    "solve_trace", "solve_unrolled", "solve_with_callbacks", "solver_convergence",
    "solver_solution", "svt_jacobi", "time_solver", "trace", "utils",
)
EXCLUDED = ("SplitRealSolver", "backend_supports_complex", "build_split_real_solver",
            "jacobi_svd", "jacobi_svdvals", "svt_jacobi")


def test_export_surface_covers_rls_tpu():
    """dir(rls_tpu_torch) covers rls_tpu's public names less exactly the six
    excluded ones; rtt.parallel is a module with rls_tpu.parallel's
    __all__; __all__ names only what is bound."""
    import rls_tpu.parallel as jax_parallel

    public = {n for n in dir(rt) if not n.startswith("_")}
    extra = public - set(JAX_PUBLIC)  # submodules other tests imported, e.g. parallel
    assert all(isinstance(getattr(rt, n), types.ModuleType) for n in extra), extra
    assert set(JAX_PUBLIC) <= public
    assert rtt.EXCLUDED == EXCLUDED
    port = {n for n in dir(rtt) if not n.startswith("_")}
    missing = sorted(set(JAX_PUBLIC) - port)
    assert missing == sorted(EXCLUDED), missing
    assert not port & set(EXCLUDED)
    assert all(hasattr(rtt, n) for n in rtt.__all__)
    assert isinstance(rtt.parallel, types.ModuleType)
    assert rtt.parallel.__all__ == jax_parallel.__all__
    for name in ("utils", "deprecated", "denoisers", "prox", "regularization", "callbacks",
                 "registry", "parallel"):
        assert name in rtt.__all__ and isinstance(getattr(rtt, name), types.ModuleType)
