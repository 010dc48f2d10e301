"""The regularizer decorators, transforms and user projection of
rls_tpu_torch against rls_tpu on the same numpy inputs: Nested (through
``reg_chain`` / ``sink`` / ``find_sinks``), FixedScaled, FixedParameter,
AutoScaled (live and latched, per problem), Normalized, Transformed,
Masked, the MinMax / Identity / Z / ClampedScaling transforms and
ProjectionRegularizationTerm; Masked, Transformed and AutoScaled inside a
composed FISTA solve, decorated L2 terms in CGNR and Kaczmarz; the
dispatch decision of solve_batched_fast for every decorated or composite
solver, and for TV with an integer dims, Nuclear, LLR and PnP, row by row,
against the JAX checks (on the CPU, no kernel runs);
and ``convert`` of each.

Tolerances: float64 (JAX x64, scoped) 1e-12 relative, float32 1e-5 of
max|x|. A batch (leading axis) is held per problem against a JAX
``vmap``."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.kernels import auto as jauto
from rls_tpu.models import regularization as jreg
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import auto as tauto
from rls_tpu_torch.models import regularization as treg

TOL = {"float32": 1e-5, "float64": 1e-12}
P, N = 3, 16


def _close(got, want, dtype, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * max(float(np.abs(want).max()), 1e-30), (what, err)


def _x(rng, dtype, shape=(P, N)):
    return rng.normal(size=shape).astype(dtype)


def test_sink_through_decorators():
    """reg_chain, sink, find_sink and find_sinks walk through the
    decorators, as in rls_tpu (tests/test_regularization.py:15-23)."""
    l1 = rtt.L1Regularization(0.5)
    scaled = rtt.FixedScaledRegularization(l1, 2.0)
    norm = rtt.NormalizedRegularization(scaled, 3.0)
    assert list(rtt.reg_chain(norm)) == [norm, scaled, l1]
    assert rtt.sink(norm) is l1 and rtt.sink_type(norm) is rtt.L1Regularization
    regs = [norm, rtt.FixedParameterRegularization(rtt.L2Regularization(0.1)),
            rtt.MaskedRegularization(rtt.PositiveRegularization(), (True, False))]
    assert rtt.find_sink(rtt.L1Regularization, regs) == 0
    assert rtt.find_sinks(treg.ParameterizedRegularization, regs) == [0, 1]
    assert rtt.find_sinks(treg.ProjectionRegularization, regs) == [2]
    assert float(norm.get_lam()) == pytest.approx(3.0)  # 0.5 · 2 · 3
    assert isinstance(norm, treg.NestedRegularization) and norm.inner is scaled


def _decorated(mod, lam, dtype):
    """The decorators over L1 (TV-free, so the same on both sides), each
    under its name, built in package `mod` (rt or rtt)."""
    l1 = mod.L1Regularization(lam)
    return {
        "fixed_scaled": mod.FixedScaledRegularization(l1, 2.0),
        "fixed_parameter": mod.FixedParameterRegularization(l1),
        "auto_scaled": mod.AutoScaledRegularization(l1),
        "normalized": mod.NormalizedRegularization(l1, 0.25),
        "masked": mod.MaskedRegularization(l1, mask=tuple(i % 3 != 1 for i in range(N))),
        "nested_two": mod.FixedScaledRegularization(mod.NormalizedRegularization(l1, 0.5), 4.0),
    }


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["fixed_scaled", "fixed_parameter", "auto_scaled",
                                  "normalized", "masked", "nested_two"])
def test_decorator_matches_jax(rng, dtype, name):
    """prox and value with λ = None (the decorator's own), a shared λ and a
    λ per problem, on a batch held per problem against JAX's vmap."""
    X = _x(rng, dtype)
    lams = rng.uniform(0.05, 0.3, size=P).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        jr = _decorated(rt, 0.1, dtype)[name]
        tr = _decorated(rtt, 0.1, dtype)[name]
        Xt = torch.from_numpy(X)
        Xc = Xt.clone()
        for what in ("prox", "value"):
            jf, tf = getattr(jr, what), getattr(tr, what)
            _close(tf(Xt), jax.vmap(jf)(jnp.asarray(X)), dtype, f"{what}, own λ")
            _close(tf(Xt, 0.2), jax.vmap(lambda x: jf(x, 0.2))(jnp.asarray(X)), dtype,
                   f"{what}, shared λ")
            _close(tf(Xt, torch.from_numpy(lams)), jax.vmap(jf)(jnp.asarray(X), jnp.asarray(lams)),
                   dtype, f"{what}, λ per problem")
        np.testing.assert_allclose(float(tr.get_lam()), float(jr.get_lam()), rtol=1e-7)
        assert torch.equal(Xt, Xc)  # the caller's x is never written


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_auto_scaled_per_problem(rng, dtype):
    """AutoScaled takes max|x| per problem, live and latched
    (tests/test_regularization.py:44-69): the latched factor has one entry
    per problem and get_lam carries it."""
    X0 = _x(rng, dtype)
    X0[1] *= 7.0  # problems of different scale
    X1 = 3.0 * X0
    with jax.enable_x64(dtype == "float64"):
        l1j, l1t = rt.L1Regularization(0.1), rtt.L1Regularization(0.1)
        live = rtt.AutoScaledRegularization(l1t)
        want = jax.vmap(rt.AutoScaledRegularization(l1j).prox)(jnp.asarray(X1))
        _close(live.prox(torch.from_numpy(X1)), want, dtype, "live")
        latched = live.latched(torch.from_numpy(X0))
        assert tuple(latched.factor.shape) == (P,)
        for p in range(P):
            jl = rt.AutoScaledRegularization(l1j).latched(jnp.asarray(X0[p]))
            _close(latched.prox(torch.from_numpy(X1))[p], jl.prox(jnp.asarray(X1[p])), dtype,
                   f"latched, problem {p}")
            np.testing.assert_allclose(float(latched.get_lam()[p]), float(jl.get_lam()),
                                       rtol=1e-6)
        # a latched factor is not the live one: the scale of X0, not of X1
        assert not torch.allclose(latched.prox(torch.from_numpy(X1)),
                                  live.prox(torch.from_numpy(X1)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_transformed_matches_jax(rng, dtype):
    """Transformed L1 in a 2-D wavelet domain and in a 1-D unitary FFT
    domain (tests/test_regularization.py:81-91), batched."""
    shape = (8, 16)
    X = _x(rng, dtype, (P, 128))
    cdt = "complex64" if dtype == "float32" else "complex128"
    Xc = (rng.normal(size=(P, N)) + 1j * rng.normal(size=(P, N))).astype(cdt)
    with jax.enable_x64(dtype == "float64"):
        jw = rt.WaveletOperator(im_shape=shape, wavelet="db2", _dtype=getattr(jnp, dtype))
        tw = rtt.WaveletOperator(shape, "db2", dtype=getattr(torch, dtype), device="cpu")
        for jtr, ttr, V in ((jw, tw, X),
                            (rt.FFTOperator(im_shape=(N,)), rtt.FFTOperator((N,), device="cpu"),
                             Xc)):
            jr = rt.TransformedRegularization(rt.L1Regularization(0.1), jtr)
            tr = rtt.TransformedRegularization(rtt.L1Regularization(0.1), ttr)
            for what in ("prox", "value"):
                jf = getattr(jr, what)
                _close(getattr(tr, what)(torch.from_numpy(V)),
                       jax.jit(jax.vmap(jf))(jnp.asarray(V)), dtype, what)
                _close(getattr(tr, what)(torch.from_numpy(V), 0.05),
                       jax.jit(jax.vmap(lambda v, f=jf: f(v, 0.05)))(jnp.asarray(V)), dtype,
                       what)


def test_masked_writes_a_new_tensor():
    """tests/test_regularization.py:72-78, batched: Positive on the masked
    entries only, the input untouched."""
    x = -torch.ones((2, 4))
    masked = rtt.MaskedRegularization(rtt.PositiveRegularization(), mask=[True, False, True, False])
    out = masked.prox(x)
    np.testing.assert_array_equal(out.numpy(), [[0.0, -1.0, 0.0, -1.0]] * 2)
    assert bool((x == -1).all())
    np.testing.assert_array_equal(masked.value(out).numpy(), [0.0, 0.0])


def _transforms(mod, x):
    kinds = {"minmax": mod.MinMaxTransform, "z": mod.ZTransform,
             "identity": mod.IdentityTransform}
    out = {k: T(x) for k, T in kinds.items()}
    out["clamped"] = mod.ClampedScalingTransform(x, -0.5, 0.75)
    return out


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_transforms_match_jax(rng, dtype):
    """Each transform of a flattened image, per problem, against JAX's of
    each problem's image: forward, backward and the round trip; ZTransform
    uses the population std (ddof 0)."""
    X = (2.0 * rng.normal(size=(P, 8, 8)) + 0.5).astype(dtype).reshape(P, 64)
    Y = rng.uniform(size=(P, 64)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        tts = _transforms(treg, torch.from_numpy(X))
        for p in range(P):
            jts = _transforms(jreg, jnp.asarray(X[p]))
            for k, jt in jts.items():
                tt = tts[k]
                _close(tt.forward(torch.from_numpy(X))[p], jt.forward(jnp.asarray(X[p])), dtype,
                       f"{k} forward")
                _close(tt.backward(torch.from_numpy(Y))[p], jt.backward(jnp.asarray(Y[p])), dtype,
                       f"{k} backward")
        for k, tt in tts.items():
            _close(tt.backward(tt.forward(torch.from_numpy(X))), X, dtype, f"{k} round trip")
    np.testing.assert_allclose(tts["z"].std[:, 0].numpy(), X.std(axis=-1, ddof=0),
                               rtol=TOL[dtype])
    assert not np.allclose(tts["z"].std[:, 0].numpy(), X.std(axis=-1, ddof=1), rtol=1e-3)


def test_projection_term(rng):
    """A user projection (reference ProxProj.jl) on a batch: prox is the
    callable, value 0 where x is feasible and ∞ elsewhere, per problem."""
    X = _x(rng, "float64")
    X[2] = np.abs(X[2])
    tr = rtt.ProjectionRegularizationTerm(lambda v: torch.clamp(v, min=0.0))
    jr = rt.ProjectionRegularizationTerm(proj_func=lambda v: jnp.maximum(v, 0.0))
    with jax.enable_x64():
        _close(tr.prox(torch.from_numpy(X)), jax.vmap(jr.prox)(jnp.asarray(X)), "float64")
        np.testing.assert_array_equal(tr.value(torch.from_numpy(X)).numpy(),
                                      np.asarray(jax.vmap(jr.value)(jnp.asarray(X))))
    assert tr.value(torch.from_numpy(X)).tolist() == [np.inf, np.inf, 0.0]
    assert rtt.find_sinks(treg.ProjectionRegularization, [rtt.L1Regularization(0.1), tr]) == [1]


def _fista_pair(rng, reg_of, iterations=12):
    """FISTA on one dense 20 × 16 system, float64, with the regularizer
    built by `reg_of(mod)` in each package; 3 problems."""
    A = rng.normal(size=(20, N)) / np.sqrt(20)
    Xt = rng.normal(size=(N, P)) * (rng.uniform(size=(N, P)) < 0.4)
    B = A @ Xt
    rho = 0.95 / np.linalg.norm(A, 2) ** 2
    js = rt.FISTA.create(rt.DenseOperator(jnp.asarray(A)), reg=reg_of(rt), iterations=iterations,
                         rho=rho)
    ts = rtt.FISTA.create(rtt.DenseOperator(A, device="cpu"), reg=reg_of(rtt),
                          iterations=iterations, rho=rho)
    return js, ts, B


SOLVE_REGS = {
    "masked_l1": lambda mod: mod.MaskedRegularization(
        mod.L1Regularization(0.05), mask=tuple(i % 4 != 0 for i in range(N))),
    "transformed_l1_wavelet": lambda mod: mod.TransformedRegularization(
        mod.L1Regularization(0.05),
        rt.WaveletOperator(im_shape=(N,), wavelet="haar", _dtype=jnp.float64) if mod is rt
        else rtt.WaveletOperator((N,), "haar", dtype=torch.float64, device="cpu")),
    "auto_scaled_l1": lambda mod: mod.AutoScaledRegularization(mod.L1Regularization(0.05)),
    "fixed_scaled_l1_positive": lambda mod: [
        mod.FixedScaledRegularization(mod.L1Regularization(0.025), 2.0),
        mod.FixedParameterRegularization(mod.PositiveRegularization())],
}


@pytest.mark.parametrize("name", sorted(SOLVE_REGS))
def test_decorated_fista_solve_matches_jax(rng, name):
    """A composed FISTA solve with a decorated term, float64, batched,
    against JAX's solve_batched_unrolled (1e-12 relative)."""
    with jax.enable_x64():
        js, ts, B = _fista_pair(rng, SOLVE_REGS[name])
        want = rt.solve_batched_unrolled(js, jnp.asarray(B))
        got = rtt.solve_batched_unrolled(ts, torch.from_numpy(B))
        _close(got, want, "float64", name)
        # the converted JAX solver is the same solver
        _close(rtt.solve_batched_unrolled(convert(js, "cpu"), torch.from_numpy(B)), want,
               "float64", f"{name}, converted")


@pytest.mark.parametrize("l2", ["fixed_scaled", "fixed_parameter", "normalized"])
def test_decorated_l2_in_cgnr_and_kaczmarz(rng, l2):
    """A decorated L2 reaches CGNR and Kaczmarz through sink / get_lam, as
    in rls_tpu (float64, 1e-12 relative)."""
    make = {
        "fixed_scaled": lambda mod: mod.FixedScaledRegularization(mod.L2Regularization(0.025), 4.0),
        "fixed_parameter": lambda mod: mod.FixedParameterRegularization(mod.L2Regularization(0.1)),
        "normalized": lambda mod: mod.NormalizedRegularization(mod.L2Regularization(0.2), 0.5),
    }[l2]
    A = rng.normal(size=(24, 12))
    B = A @ rng.normal(size=(12, P))
    with jax.enable_x64():
        for cls, kw in (("CGNR", dict(iterations=8)), ("Kaczmarz", dict(iterations=4))):
            js = getattr(rt, cls).create(rt.DenseOperator(jnp.asarray(A)), reg=make(rt), **kw)
            ts = getattr(rtt, cls).create(rtt.DenseOperator(A, device="cpu"), reg=make(rtt), **kw)
            _close(rtt.solve_batched_unrolled(ts, torch.from_numpy(B)),
                   rt.solve_batched_unrolled(js, jnp.asarray(B)), "float64", f"{cls}, {l2}")


def _sepconv(mod, n=16):
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    if mod is rt:
        return rt.SeparableConvOperator.from_taps(g, g, (n, n))
    return rtt.SeparableConvOperator.from_taps(g, g, (n, n), device="cpu")


def _dispatch_cases():
    """(name, a function building the rls_tpu solver): each is converted to the
    port, and both packages' dispatch tables are asked row by row."""
    n = 16
    rng = np.random.default_rng(7)
    A = jnp.asarray(rng.normal(size=(24, 12)).astype(np.float32))
    wav = rt.WaveletOperator(im_shape=(n, n), wavelet="db2")
    tv = lambda lam: rt.TVRegularization(lam, shape=(n, n), iterations_tv=4)  # noqa: E731
    mask = np.zeros((n, n), np.float32)
    mask[::2] = 1.0
    maps = np.ones((2, n, n), np.complex64)
    sense = rt.SenseDFT2RealOperator.from_maps(maps, mask, (n, n))
    cs = rt.SubsampledDFT2RealOperator.from_mask(mask, (n, n))
    coil = rt.ProdOperator(rt.ProdOperator(
        rt.SamplingOperator(idx=jnp.asarray(np.flatnonzero(mask), jnp.int32), n=n * n),
        rt.FFTOperator(im_shape=(n, n))), rt.WeightingOperator(jnp.asarray(maps[0].ravel())))
    stack = rt.StackedOperator(ops=(coil, coil))
    kz = dict(iterations=2, randomized=True, precompute_order=True, sub_matrix_fraction=0.5)
    return {
        "fista_tv": lambda: rt.FISTA.create(_sepconv(rt), reg=tv(1e-3), rho=0.9, iterations=5),
        "fista_fixed_scaled_tv": lambda: rt.FISTA.create(
            _sepconv(rt), reg=rt.FixedScaledRegularization(tv(1e-3), 1.0), rho=0.9, iterations=5),
        "pogm_normalized_tv": lambda: rt.POGM.create(
            _sepconv(rt), reg=rt.NormalizedRegularization(tv(1e-3), 2.0), rho=0.9, iterations=5),
        "fista_tv_direct_conv": lambda: rt.FISTA.create(
            rt.DirectConvOperator(kernel=jnp.ones((3, 3), jnp.float32) / 9, im_shape=(n, n)),
            reg=tv(1e-3), rho=0.9, iterations=5),
        "fista_tv_radon": lambda: rt.FISTA.create(
            rt.RadonOperator(angles=jnp.linspace(0, np.pi, 6, endpoint=False), im_shape=(n, n)),
            reg=tv(1e-3), rho=1e-3, iterations=5),
        "admm_fixed_scaled_tv": lambda: rt.ADMM.create(
            _sepconv(rt), reg=rt.FixedScaledRegularization(tv(1e-3), 1.0), rho=0.1,
            iterations=3, iterations_cg=3),
        "pdhg_fixed_scaled_tv": lambda: rt.PDHG.create(
            _sepconv(rt), reg=rt.FixedScaledRegularization(tv(2e-3), 0.5), iterations=5, tau=0.1),
        "cgnr_fixed_scaled_l2": lambda: rt.CGNR.create(
            A, reg=rt.FixedScaledRegularization(rt.L2Regularization(2.5e-4), 4.0), iterations=4),
        "cgnr_fixed_parameter_l2": lambda: rt.CGNR.create(
            A, reg=rt.FixedParameterRegularization(rt.L2Regularization(1e-3)), iterations=4),
        "fista_auto_scaled_l1_dense": lambda: rt.FISTA.create(
            A, reg=rt.AutoScaledRegularization(rt.L1Regularization(1e-3)), rho=0.01, iterations=5),
        "fista_masked_l1_dense": lambda: rt.FISTA.create(
            A, reg=rt.MaskedRegularization(rt.L1Regularization(1e-3), (True,) * 6 + (False,) * 6),
            rho=0.01, iterations=5),
        "fista_l1_weighted_dense": lambda: rt.FISTA.create(
            rt.WeightingOperator(jnp.ones(24, jnp.float32)) @ rt.DenseOperator(A),
            reg=rt.L1Regularization(1e-3), rho=0.01, iterations=5),
        "fista_fixed_scaled_l1_cs": lambda: rt.FISTA.create(
            cs, reg=rt.FixedScaledRegularization(rt.L1Regularization(1e-3), 1.0), rho=0.9,
            iterations=5),
        "fista_fixed_scaled_l21_sense": lambda: rt.FISTA.create(
            sense, reg=rt.FixedScaledRegularization(rt.L21Regularization(1e-3, slices=2), 1.0),
            rho=0.9, iterations=5),
        "fista_transformed_l1_stacked_sense": lambda: rt.FISTA.create(
            stack, reg=rt.TransformedRegularization(rt.L1Regularization(1e-3), wav), rho=0.4,
            iterations=5),
        "kaczmarz_fixed_parameter_l2": lambda: rt.Kaczmarz.create(
            A, reg=[rt.FixedParameterRegularization(rt.L2Regularization(1e-6)),
                    rt.PositiveRegularization()], **kz),
        "kaczmarz_fixed_parameter_positive": lambda: rt.Kaczmarz.create(
            A, reg=[rt.L2Regularization(1e-6),
                    rt.FixedParameterRegularization(rt.PositiveRegularization())], **kz),
        "kaczmarz_greedy_fixed_scaled_l2": lambda: rt.Kaczmarz.create(
            A, reg=rt.FixedScaledRegularization(rt.L2Regularization(2.5e-7), 4.0),
            greedy_randomized=True, iterations=2),
        "kaczmarz_weighted_prod": lambda: rt.Kaczmarz.create(
            rt.WeightingOperator(jnp.ones(24, jnp.float32)) @ rt.DenseOperator(A),
            reg=rt.L2Regularization(1e-6), iterations=2),
        "dax_kaczmarz": lambda: rt.DaxKaczmarz.create(A, lam=1e-6, enforce_real=True,
                                                      enforce_positive=True),
        "dax_constrained": lambda: rt.DaxConstrained.create(A, lam=1e-6),
        "fista_tv_integer_dims": lambda: rt.FISTA.create(
            _sepconv(rt), reg=rt.TVRegularization(1e-3, shape=(n, n), dims=1), rho=0.9,
            iterations=5),
        "fista_nuclear_dense": lambda: rt.FISTA.create(
            A, reg=rt.NuclearRegularization(1e-3, svt_shape=(3, 4)), rho=0.01, iterations=5),
        "fista_llr_dense": lambda: rt.FISTA.create(
            A, reg=rt.LLRRegularization(1e-3, shape=(2, 2)), rho=0.01, iterations=5),
        "admm_pnp": lambda: rt.ADMM.create(
            _sepconv(rt), reg=rt.PnPRegularization(0.3, model=lambda v: v, shape=(n, n)),
            rho=0.1, iterations=3, iterations_cg=3),
    }


# the cases whose rls_tpu solver carries a JAX callable: the port's twin is
# built in rls_tpu_torch (convert refuses the callable)
_PORT_BUILT = {
    "admm_pnp": lambda: rtt.ADMM.create(
        _sepconv(rtt), reg=rtt.PnPRegularization(0.3, model=lambda v: v, shape=(16, 16)),
        rho=0.1, iterations=3, iterations_cg=3),
}


def _accepts(table, solver):
    """The names of the rows whose check passes (a check raises ValueError
    to reject, as both dispatchers read it)."""
    out = []
    for row in table:
        try:
            row[1](solver)
        except ValueError:
            continue
        out.append(row[0])
    return out


DISPATCH_CASES = (
    "fista_tv", "fista_fixed_scaled_tv", "pogm_normalized_tv", "fista_tv_direct_conv",
    "fista_tv_radon", "admm_fixed_scaled_tv", "pdhg_fixed_scaled_tv", "cgnr_fixed_scaled_l2",
    "cgnr_fixed_parameter_l2", "fista_auto_scaled_l1_dense", "fista_masked_l1_dense",
    "fista_l1_weighted_dense", "fista_fixed_scaled_l1_cs", "fista_fixed_scaled_l21_sense",
    "fista_transformed_l1_stacked_sense", "kaczmarz_fixed_parameter_l2",
    "kaczmarz_fixed_parameter_positive", "kaczmarz_greedy_fixed_scaled_l2",
    "kaczmarz_weighted_prod", "dax_kaczmarz", "dax_constrained", "fista_tv_integer_dims",
    "fista_nuclear_dense", "fista_llr_dense", "admm_pnp",
)


def test_dispatch_cases_listed():
    assert sorted(DISPATCH_CASES) == sorted(_dispatch_cases())


@pytest.mark.parametrize("name", DISPATCH_CASES)
def test_dispatch_decision_matches_jax(name):
    """Each dispatch row accepts or rejects the converted solver exactly as
    its JAX check does; where no row accepts, solve_batched_fast warns and
    falls back (checked on the CPU: no kernel runs)."""
    js = _dispatch_cases()[name]()
    ts = _PORT_BUILT[name]() if name in _PORT_BUILT else convert(js, device="cpu")
    want = _accepts(jauto._FUSED_WRAPPERS, js)
    assert [r[0] for r in tauto._FUSED_WRAPPERS] == [r[0] for r in jauto._FUSED_WRAPPERS]
    assert _accepts(tauto._FUSED_WRAPPERS, ts) == want
    picked, _, reasons = tauto.select_fast_path(ts)
    assert picked == (want[0] if want else None)
    if not want:
        B = torch.zeros((ts.A.out_size, 1), dtype=ts.A.dtype)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tauto.solve_batched_fast(ts, B)
        assert any("falling back" in str(w.message) for w in caught)
        assert len(reasons) == len(tauto._FUSED_WRAPPERS)


@pytest.mark.parametrize("name", ["fixed_scaled", "fixed_parameter", "auto_scaled",
                                  "normalized", "masked", "nested_two"])
def test_convert_decorators(rng, name):
    """convert carries each decorator, its factor, mask or latched factor."""
    X = _x(rng, "float32")
    jr = _decorated(rt, 0.1, "float32")[name]
    tr = convert(jr, device="cpu")
    assert type(tr).__name__ == type(jr).__name__ and rtt.sink(tr) == rtt.L1Regularization(0.1)
    _close(tr.prox(torch.from_numpy(X)), jax.vmap(jr.prox)(jnp.asarray(X)), "float32", name)
    if name == "auto_scaled":
        jl = jr.latched(jnp.asarray(X[0]))
        tl = convert(jl, device="cpu")
        _close(tl.prox(torch.from_numpy(X[1])), jl.prox(jnp.asarray(X[1])), "float32", "latched")


def test_convert_transforms_and_refusals(rng):
    """convert carries the transforms (their statistics, not recomputed)
    and a Transformed term's operator; it refuses a JAX callable by name."""
    x = jnp.asarray(rng.normal(size=(32,)).astype(np.float32))
    y = rng.uniform(size=(32,)).astype(np.float32)
    for jt in (jreg.MinMaxTransform(x), jreg.ZTransform(x), jreg.IdentityTransform(x),
               jreg.ClampedScalingTransform(x, -0.5, 0.5)):
        tt = convert(jt, device="cpu")
        assert type(tt).__name__ == type(jt).__name__
        _close(tt.backward(torch.from_numpy(y)), jt.backward(jnp.asarray(y)), "float32")
        _close(tt.forward(torch.from_numpy(y)), jt.forward(jnp.asarray(y)), "float32")
    jr = rt.TransformedRegularization(rt.L1Regularization(0.1),
                                      rt.WaveletOperator(im_shape=(32,), wavelet="db2"))
    tr = convert(jr, device="cpu")
    assert isinstance(tr.trafo, rtt.WaveletOperator) and tr.trafo.levels == jr.trafo.levels
    _close(tr.prox(torch.from_numpy(y)), jax.jit(jr.prox)(jnp.asarray(y)), "float32")
    with pytest.raises(TypeError, match="ProjectionRegularizationTerm"):
        convert(rt.ProjectionRegularizationTerm(proj_func=lambda v: v), device="cpu")
