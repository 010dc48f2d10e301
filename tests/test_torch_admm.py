"""The ADMM-TV slice of rls_tpu_torch against rls_tpu on the same numpy
inputs: pcg in both forms, the composed ADMM (identity and gradient
trafos, projections, ρ adaptation, normalization) through the drivers,
the plain versions of the fused and tiled ADMM-TV kernels against the
JAX kernels in interpret mode, the window rule of the tiled CUDA kernel,
the dispatch with its rejections, and convert.

Tolerances: pcg and the composed ADMM 1e-5 in f32 and 1e-10 in f64 (the
same ops in another order). The fused kernel's plain version 1e-5 against
the JAX fused kernel run in its fold form (both the exact f32 stencil
Gram and the fold FGP). The tiled route 1e-5 against the JAX tiled kernel,
which in interpret mode runs the fori window FGP where the port runs the
fold form: the same f32 math up to ≤ 1 ulp per op, the bar the JAX suite
itself sets between the two forms (tests/test_kernels.py:224-226)."""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.models.solvers.base import pcg as jax_pcg
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import _fgp_common, auto
from rls_tpu_torch.kernels import admm_tv_fused as tadmm
from rls_tpu_torch.kernels import admm_tv_tiled as tadmm_tiled

jadmm = importlib.import_module("rls_tpu.kernels.admm_tv_fused")
jadmm_tiled = importlib.import_module("rls_tpu.kernels.admm_tv_tiled")
GAUSS5 = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
TOL = {"float32": 1e-5, "float64": 1e-10}


def _spd(rng, n, dtype):
    """A well-conditioned SPD matrix and 3 right-hand sides; the first is an
    eigenvector, so CG converges in one step and the freeze fires."""
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    evals = np.linspace(0.5, 4.0, n)
    M = (q * evals) @ q.T
    b = rng.normal(size=(3, n))
    b[0] = q[:, 3] * 2.0
    return M.astype(dtype), b.astype(dtype)


@pytest.mark.parametrize("unroll", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pcg_matches_jax(rng, unroll, dtype):
    M, b = _spd(rng, 20, dtype)
    x0 = np.zeros_like(b)
    x0[2] = 0.1
    with jax.enable_x64(dtype == "float64"):
        Mj = jnp.asarray(M)
        run = jax.vmap(lambda bb, xx: jax_pcg(lambda v: Mj @ v, bb, xx, 8, 1e-4, unroll=unroll))
        want = np.asarray(run(jnp.asarray(b), jnp.asarray(x0)))
    Mt = torch.from_numpy(M)
    got = rtt.pcg(lambda v: v @ Mt.T, torch.from_numpy(b), torch.from_numpy(x0), 8,
                  torch.tensor(1e-4, dtype=Mt.dtype), unroll=unroll)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])
    # the freeze fires: problem 0 stops after its first step
    one = rtt.pcg(lambda v: v @ Mt.T, torch.from_numpy(b), torch.from_numpy(x0), 1,
                  torch.tensor(1e-4, dtype=Mt.dtype), unroll=unroll)
    np.testing.assert_array_equal(got[0].numpy(), one[0].numpy())
    assert not np.array_equal(got[1].numpy(), one[1].numpy())


def _admm_problem(dtype, case):
    """A 12² deblurring problem in rls_tpu with an ADMM solver of the named
    kind, and its 3 measurement columns."""
    N = 12
    jdt = getattr(jnp, dtype)
    op = rt.SeparableConvOperator.from_taps(GAUSS5 / GAUSS5.sum(), GAUSS5[::-1] / GAUSS5.sum(),
                                            (N, N), dtype=jdt, compensated=False)
    tv = rt.TVRegularization(2e-2, shape=(N, N), iterations_tv=4)
    kw = dict(reg=tv, iterations=5, iterations_cg=4, rho=0.2, unroll_cg=True)
    if case == "l1-gradient":
        kw.update(reg=rt.L1Regularization(2e-2), unroll_cg=False,
                  reg_trafo=rt.GradientOperator(im_shape=(N, N), _dtype=jdt))
    elif case == "positive":
        kw.update(reg=[tv, rt.PositiveRegularization()])
    elif case == "balance":
        kw.update(vary_rho="balance")
    elif case == "pnp":
        kw.update(vary_rho="PnP", unroll_cg=False, rho=5.0, iterations=8)
    elif case == "measurement":
        kw.update(normalize_reg=rt.MeasurementBasedNormalization(), unroll_cg=False)
    solver = rt.ADMM.create(op, **kw)
    X = np.random.default_rng(3).normal(size=(3, N * N))
    B = np.stack([np.asarray(op.mv(jnp.asarray(x, jdt))) for x in X], axis=1).astype(dtype)
    return solver, B


@pytest.mark.parametrize("case", ["tv", "l1-gradient", "positive", "balance", "pnp",
                                  "measurement"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_composed_admm_matches_jax(case, dtype):
    with jax.enable_x64(dtype == "float64"):
        jsolver, B = _admm_problem(dtype, case)
        Bj = jnp.asarray(B)
        want_u = np.asarray(jax.jit(lambda bb: rt.solve_batched_unrolled(jsolver, bb))(Bj))
        want_1 = np.asarray(rt.solve(jsolver, Bj[:, 0]))
        want_b = np.asarray(rt.solve_batched(jsolver, Bj))
    tsolver = convert(jsolver, device="cpu")
    Bt = torch.from_numpy(B)
    got_u = rtt.solve_batched_unrolled(tsolver, Bt)
    assert got_u.dtype == Bt.dtype
    np.testing.assert_allclose(got_u.numpy(), want_u, rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(rtt.solve(tsolver, Bt[:, 0]).numpy(), want_1, rtol=0,
                               atol=TOL[dtype])
    np.testing.assert_allclose(rtt.solve_batched(tsolver, Bt).numpy(), want_b, rtol=0,
                               atol=TOL[dtype])
    if case in ("balance", "pnp"):
        # the adaptation really fires on this problem
        state = tsolver.init(Bt.T)
        for _ in range(tsolver.iterations):
            state = tsolver.step(state)
        assert bool((state.rho[0] != tsolver.rho0[0]).any()), state.rho
        assert tsolver.convergence(state)["primal"].shape == (3, 1)


def _kernel_inputs(n=24, k=3):
    """x0hat = Aᴴb (exact stencil adjoint) of blurred noise, per-problem ρ
    (one of them 0) and λ, and the taps."""
    op = rt.SeparableConvOperator.from_taps(GAUSS5 / GAUSS5.sum(), GAUSS5 / GAUSS5.sum(), (n, n),
                                            compensated=False)
    X = np.random.default_rng(0).normal(size=(k, n * n)).astype(np.float32)
    b = jax.vmap(op.mv)(jnp.asarray(X))
    x0 = np.array(jax.vmap(op.rmv_stencil)(b)).reshape(k, n, n)
    rho = np.array([0.1, 0.3, 0.0][:k], np.float32)
    lam = np.array([1e-3, 2e-3, 5e-3][:k], np.float32)
    return x0, rho, lam, op.taps_hw()


# prox, tol_inner; a tol_inner of 0.05 makes the CG freeze
_KERNEL_CASES = {"none": ("none", 1e-5), "positive": ("positive", 1e-5),
                 "freeze": ("none", 5e-2)}


@pytest.mark.parametrize("case", sorted(_KERNEL_CASES))
def test_admm_fused_plain_matches_jax_fused(case):
    prox, tol = _KERNEL_CASES[case]
    x0, rho, lam, taps = _kernel_inputs()
    zeros = jnp.zeros((1, 1), jnp.float32)
    want = np.asarray(jadmm.admm_tv_fused(
        jnp.asarray(x0), zeros, zeros, jnp.asarray(rho), jnp.asarray(lam), 6, 5, 4, tol,
        interpret=True, taps=taps, prox=prox, fgp_unroll=True))
    before = tadmm.admm_tv_fused.launches
    got, live = tadmm.admm_tv_fused(torch.from_numpy(x0), taps, torch.from_numpy(rho),
                                    torch.from_numpy(lam), 6, 5, 4, tol, prox=prox,
                                    with_counts=True)
    assert tadmm.admm_tv_fused.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if case == "freeze":
        assert max(live.tolist()) < 6 * 5, live
    else:
        assert live.tolist() == [30, 30, 30]


@pytest.mark.parametrize("prox", ["none", "positive"])
def test_admm_tiled_matches_jax_tiled(prox):
    x0, rho, lam, taps = _kernel_inputs()
    want = np.asarray(jadmm_tiled.admm_tv_tiled(
        jnp.asarray(x0), taps, jnp.asarray(rho), jnp.asarray(lam), 6, 5, 4, 1e-5, tile_rows=8,
        interpret=True, prox=prox))
    before = tadmm_tiled.admm_tv_tiled.launches
    got = tadmm_tiled.admm_tv_tiled(torch.from_numpy(x0), taps, torch.from_numpy(rho),
                                    torch.from_numpy(lam), 6, 5, 4, 1e-5, prox=prox, tile_rows=8)
    assert tadmm_tiled.admm_tv_tiled.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("taps,tv_iterations,tile_rows", [
    (GAUSS5, 4, 8), ((0.2, 0.6, 0.2), 3, 7), ((0.1, 0.5, 0.25, -0.2, 0.05, 0.3, 0.6), 5, 10),
])
def test_tiled_windows_reproduce_the_whole_image(taps, tv_iterations, tile_rows):
    """The tiled CUDA kernel's window rule: the matvec (AᴴA + ρI) on each
    clamped window with `matvec_halo` rows a side, and the z-update's FGP
    on windows with `fgp_halo`, give exactly the whole-image values on the
    interior rows; one row less than the dependence cone does not."""
    H, W = 61, 13
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.normal(size=(2, H, W)).astype(np.float32))
    lam = torch.tensor([2.0, 5.0]).view(-1, 1, 1)  # the duals rarely saturate
    t2 = torch.from_numpy(_fgp_common.fgp_t2_table(tv_iterations))

    def matvec(v):
        return _fgp_common.sepconv_stencil_normal(v, taps, taps) + 0.1 * v

    def fgp(v):
        return _fgp_common.fgp_fold(v, lam, t2)

    for fn, halo, cone in ((matvec, tadmm_tiled.matvec_halo(len(taps)), 2 * (len(taps) // 2)),
                           (fgp, tadmm_tiled.fgp_halo(tv_iterations), tv_iterations)):
        whole = fn(u)
        assert halo >= cone
        for h, exact in ((halo, True), (cone - 1, False)):
            rows = [fn(u[:, lo:hi])[:, i0:i1]
                    for lo, hi, i0, i1 in _fgp_common.tile_windows(H, tile_rows, h)]
            assert torch.equal(torch.cat(rows, dim=1), whole) == exact


def _slice_problem(n, normalize):
    """An ADMM-TV problem in rls_tpu of BASELINE #3's form (the JAX fused
    check needs the compensated factors), with 3 measurement columns."""
    op = rt.SeparableConvOperator.from_taps(GAUSS5 / GAUSS5.sum(), GAUSS5 / GAUSS5.sum(), (n, n))
    reg = rt.TVRegularization(2e-3, shape=(n, n), iterations_tv=4, unroll=True)
    solver = rt.ADMM.create(op, reg=reg, iterations=5, iterations_cg=4, unroll_cg=True, rho=0.1,
                            normalize_reg=normalize)
    X = np.random.default_rng(9).normal(size=(3, n * n)).astype(np.float32)
    return solver, np.array(jax.vmap(op.mv)(jnp.asarray(X)).T)


@pytest.mark.parametrize("normalize", [None, "measurement"])
def test_slice_solve_batched_fast_matches_jax(normalize):
    """The whole slice: the JAX problem, converted, through the port's
    dispatch (the fused row's plain version on CPU, no fallback warning)
    against the JAX fused wrapper in its fold form."""
    norm = rt.MeasurementBasedNormalization() if normalize else rt.NoNormalization()
    solver, B = _slice_problem(24, norm)
    want = np.asarray(jadmm.solve_admm_tv_fused(solver, jnp.asarray(B), interpret=True,
                                                fgp_unroll=True))
    tsolver = convert(solver, device="cpu")
    assert auto.select_fast_path(tsolver)[0] == "admm_tv"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = rtt.solve_batched_fast(tsolver, torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    tiled = rtt.solve_admm_tv_tiled(tsolver, torch.from_numpy(B), tile_rows=8)
    np.testing.assert_array_equal(tiled.numpy(), got.numpy())


def _port_solver(n, **kw):
    op = rtt.SeparableConvOperator.from_taps(GAUSS5, GAUSS5, (n, n), device="cpu")
    kw.setdefault("reg", rtt.TVRegularization(5e-4, shape=(n, n), iterations_tv=10,
                                              backend="cuda"))
    return rtt.ADMM.create(op, iterations=10, iterations_cg=5, unroll_cg=True, rho=0.1, **kw)


@pytest.mark.parametrize("n,row", [(24, "admm_tv"), (256, "admm_tv"), (512, "admm_tv_tiled")])
def test_dispatch_sends_large_images_to_the_tiled_kernel(n, row):
    name, run, reasons = auto.select_fast_path(_port_solver(n))
    assert name == row
    assert reasons[:4] == ["cgnr_dense: fused CGNR path requires a CGNR solver",
                           "pgm_tv: fused path requires FISTA, OptISTA, or POGM",
                           "pgm_dense: fused dense PGM path covers FISTA/OptISTA/POGM solvers",
                           "fista_tv_tiled: tiled path requires FISTA, OptISTA, or POGM"]
    if row == "admm_tv_tiled":
        assert run is tadmm_tiled.solve_admm_tv_tiled
        assert reasons[4] == (
            f"admm_tv: a {n}x{n} image goes to the row-tiled kernel (the dispatch sends "
            f"the fused kernel images of at most {auto.FUSED_MAX_PIXELS} pixels)"
        )


def test_admm_rejections_name_the_reason():
    n = 16
    tv = rtt.TVRegularization(1e-3, shape=(n, n), iterations_tv=3)
    cases = [
        (dict(vary_rho="balance"), "does not support vary_rho"),
        (dict(precon=lambda v: v), "does not support a preconditioner"),
        (dict(reg=[tv, rtt.L1Regularization(1e-3)]), "exactly one TVRegularization term"),
        (dict(reg=tv, reg_trafo=rtt.GradientOperator((n, n), dtype=torch.float32,
                                                     device="cpu")),
         "requires an identity reg_trafo"),
        (dict(reg=rtt.TVRegularization(1e-3, shape=(n, n), dims=(0,))),
         "requires 2-D TV over both axes"),
    ]
    for kw, match in cases:
        solver = _port_solver(n, **kw)
        for check in (tadmm.check_admm_tv_fused, tadmm_tiled.check_admm_tv_tiled):
            with pytest.raises(ValueError, match=match):
                check(solver)
    with pytest.raises(ValueError, match="fused path requires an ADMM solver"):
        tadmm.check_admm_tv_fused(rtt.FISTA.create(_port_solver(n).A, reg=tv, rho=0.9))
    with pytest.raises(ValueError, match="unknown prox"):
        tadmm.admm_tv_fused(torch.zeros(1, 8, 8), (GAUSS5, GAUSS5), 0.1, 0.1, 2, 2, 2, 1e-5,
                            prox="real")


def test_convert_carries_admm():
    n = 12
    op = rt.SeparableConvOperator.from_taps(GAUSS5, GAUSS5, (n, n), compensated=False)
    solver = rt.ADMM.create(
        op,
        reg=[rt.L1Regularization(1e-3), rt.TVRegularization(1e-3, shape=(n, n)),
             rt.RealRegularization()],
        reg_trafo=[rt.GradientOperator(im_shape=(n, n), _dtype=jnp.float32),
                   rt.IdentityOperator(n * n, jnp.float32)],
        rho=[0.1, 0.3], vary_rho="PnP", abs_tol=1e-6, rel_tol=1e-4, tol_inner=1e-3,
        iterations=7, iterations_cg=3, unroll_cg=True,
    )
    t = convert(solver, device="cpu")
    assert isinstance(t, rtt.ADMM) and t.AHA.A is t.A
    assert t.rho0 == (0.1, 0.3) and t.vary_rho == "PnP"
    assert (t.abs_tol, t.rel_tol, t.tol_inner) == (1e-6, 1e-4, 1e-3)
    assert (t.iterations, t.iterations_cg, t.unroll_cg) == (7, 3, True)
    assert [type(r).__name__ for r in t.reg] == ["L1Regularization", "TVRegularization"]
    assert [type(p).__name__ for p in t.proj] == ["RealRegularization"]
    grad, eye = t.reg_trafo
    assert isinstance(grad, rtt.GradientOperator) and grad.im_shape == (n, n)
    assert isinstance(eye, rtt.IdentityOperator) and eye.n == n * n
    assert eye.dtype == torch.float32 and eye.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="preconditioner"):
        convert(rt.ADMM.create(op, reg=rt.L1Regularization(1e-3), precon=lambda v: v),
                device="cpu")
