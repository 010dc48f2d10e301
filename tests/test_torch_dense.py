"""The dense kernels of rls_tpu_torch (fused CGNR, fused dense FISTA /
OptISTA / POGM, real and complex) against rls_tpu's Pallas kernels run in
interpret mode on the same numpy inputs: the plain PyTorch versions, which
the wrappers run on CPU tensors; the checks with their rejections; the
dispatch.

Tolerance: 1e-5 of max|x|. The systems are tall and well-conditioned
(cond(A) ≈ 3) and run to iterations = n, the JAX suite's own pattern
(tests/test_kernels.py:1481-1495): the JAX kernels form every product
from 4-term bf16 hi/lo splits summed in f32, the plain versions sum in
float64 and round to f32, so the two round differently at ~1e-7 per
product, which these systems keep near 1e-6 after the solve."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import auto
from rls_tpu_torch.kernels import cgnr_fused as tcgnr
from rls_tpu_torch.kernels import pgm_dense_fused as tpgm

jcgnr = importlib.import_module("rls_tpu.kernels.cgnr_fused")
jpgm = importlib.import_module("rls_tpu.kernels.pgm_dense_fused")
M, N, P = 72, 24, 3


def _system(cplx_a=False, cplx_b=False, seed=11):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, N)) / np.sqrt(M)
    if cplx_a:
        A = (A + 1j * rng.normal(size=(M, N)) / np.sqrt(M)) / np.sqrt(2)
    X = rng.normal(size=(N, P)) * (rng.uniform(size=(N, P)) < 0.5)
    B = A @ X + 0.01 * rng.normal(size=(M, P))
    if cplx_b:
        B = B + 1j * rng.normal(size=(M, P))
    dt = np.complex64 if (cplx_a or cplx_b) else np.float32
    return A.astype(np.complex64 if cplx_a else np.float32), B.astype(dt)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


CGNR_CASES = {
    # name: (complex A, complex b, projection, normalization, iterations)
    "real": (False, False, None, None, N),
    "positive-past-convergence": (False, False, "positive", None, 200),
    "measurement": (False, False, None, "measurement", N),
    "complex-positive": (True, False, "positive", None, 2 * N),
    "complex-real": (True, True, "real", None, 2 * N),
    "real-a-complex-b": (False, True, None, None, 2 * N),
}


@pytest.mark.parametrize("case", sorted(CGNR_CASES))
def test_cgnr_plain_matches_jax_kernel(case):
    """The embedding's (2m, 2n) system runs 2n steps; the projections act on
    the reassembled complex iterate."""
    cplx_a, cplx_b, proj, norm, iterations = CGNR_CASES[case]
    A, B = _system(cplx_a, cplx_b)
    reg = [rt.L2Regularization(1e-3)]
    if proj == "positive":
        reg.append(rt.PositiveRegularization())
    elif proj == "real":
        reg.append(rt.RealRegularization())
    kw = {"normalize_reg": rt.MeasurementBasedNormalization()} if norm else {}
    js = rt.CGNR.create(rt.DenseOperator(jnp.asarray(A)), reg=reg, iterations=iterations, **kw)
    want = np.array(jcgnr.solve_cgnr_fused(js, jnp.asarray(B), interpret=True))
    ts = convert(js, device="cpu")
    assert tcgnr.check_cgnr_fused(ts) == jcgnr.check_cgnr_fused(js)
    before = tcgnr.cgnr_fused.launches
    got = tcgnr.solve_cgnr_fused(ts, torch.from_numpy(B))
    assert tcgnr.cgnr_fused.launches == before  # the plain version ran
    assert got.dtype == torch.from_numpy(want).dtype
    _close(got, want)
    if proj == "positive":
        assert float(got.real.min()) >= 0.0
    if proj is not None and got.is_complex():
        assert not bool(got.imag.any())


def test_cgnr_plain_past_convergence_is_the_identity():
    """On A = I with λ = 0 the first step solves exactly; the guards make
    every later step the identity (no 0/0), and b = 0 stays at x = 0."""
    b = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 8)).astype(np.float32))
    b[1] = 0.0
    got = tcgnr.cgnr_fused(b, torch.eye(8), torch.zeros(2), 20)
    assert torch.equal(got, b)


PGM_CASES = {
    # name: (class, restart, reg, projection)
    "fista-l1": ("FISTA", "none", "l1", None),
    "fista-l1-gradient": ("FISTA", "gradient", "l1", None),
    "fista-l1-gradient_mapping": ("FISTA", "gradient_mapping", "l1", None),
    "fista-l2-positive": ("FISTA", "none", "l2", "positive"),
    "fista-l1-gradient-positive": ("FISTA", "gradient", "l1", "positive"),
    "optista-l1": ("OptISTA", "none", "l1", None),
    "optista-l2": ("OptISTA", "none", "l2", None),
    "pogm-l1": ("POGM", "none", "l1", None),
    "pogm-l2-positive": ("POGM", "none", "l2", "positive"),
}


def _rho(A):
    """0.9 / ‖A‖₂²: a step that converges."""
    return 0.9 / float(np.linalg.norm(A, 2)) ** 2


def _pgm_solver(A, case, lam=2e-2, iterations=N):
    cls, restart, kind, proj = case
    reg = [rt.L1Regularization(lam) if kind == "l1" else rt.L2Regularization(lam)]
    if proj == "positive":
        reg.append(rt.PositiveRegularization())
    elif proj == "real":
        reg.append(rt.RealRegularization())
    kw = {"restart": restart} if cls != "OptISTA" else {}
    return getattr(rt, cls).create(rt.DenseOperator(jnp.asarray(A)), reg=reg, rho=_rho(A),
                                   iterations=iterations, **kw)


@pytest.mark.parametrize("case", sorted(PGM_CASES))
def test_pgm_dense_plain_matches_jax_kernel(case):
    A, B = _system()
    js = _pgm_solver(A, PGM_CASES[case])
    want = np.asarray(jpgm.solve_pgm_dense_fused(js, jnp.asarray(B), interpret=True))
    ts = convert(js, device="cpu")
    assert tpgm.check_pgm_dense_fused(ts) == jpgm.check_pgm_dense_fused(js)
    before = tpgm.pgm_dense_fused.launches
    got = tpgm.solve_pgm_dense_fused(ts, torch.from_numpy(B))
    assert tpgm.pgm_dense_fused.launches == before
    _close(got, want)


CPLX_CASES = {
    # name: (class, restart, reg, projection, complex A)
    "fista-l1-gradient-real": ("FISTA", "gradient", "l1", "real", True),
    "fista-l1-gradient_mapping": ("FISTA", "gradient_mapping", "l1", None, True),
    "fista-l2-positive": ("FISTA", "none", "l2", "positive", True),
    "optista-l1": ("OptISTA", "none", "l1", None, True),
    "pogm-l1": ("POGM", "none", "l1", None, True),
    "pogm-l1-positive": ("POGM", "none", "l1", "positive", True),
    "real-a-complex-b-fista-real": ("FISTA", "gradient", "l1", "real", False),
    "real-a-complex-b-pogm": ("POGM", "none", "l1", None, False),
}


@pytest.mark.parametrize("case", sorted(CPLX_CASES))
def test_pgm_dense_cplx_plain_matches_jax_kernel(case):
    """Complex A, or a real A with complex b: the plane kernel, whose
    planes couple through the joint scalars; Real and Positive zero the
    imaginary plane, also with a real A."""
    *spec, cplx_a = CPLX_CASES[case]
    A, B = _system(cplx_a=cplx_a, cplx_b=True)
    js = _pgm_solver(A, spec)
    want = np.asarray(jpgm.solve_pgm_dense_fused(js, jnp.asarray(B), interpret=True))
    ts = convert(js, device="cpu")
    before = tpgm.pgm_dense_fused_cplx.launches
    got = tpgm.solve_pgm_dense_fused(ts, torch.from_numpy(B))
    assert tpgm.pgm_dense_fused_cplx.launches == before
    assert got.dtype == torch.complex64
    _close(got, want)
    if spec[3] is not None:
        assert not bool(got.imag.any())


@pytest.mark.parametrize("method", ["fista", "optista", "pogm"])
def test_plain_versions_return_the_restart_counts(method):
    """FISTA's gradient restart fires on this system, and its count is the
    number of iterations whose restart dot was positive; the table methods
    count none."""
    A, B = _system()
    b, At = torch.from_numpy(B.T.copy()), torch.from_numpy(A)
    restart = "gradient" if method == "fista" else "none"
    x, fires = tpgm.pgm_dense_fused(b, At, 2e-2, _rho(A), 1.0, 40, method=method,
                                    restart=restart, with_counts=True)
    assert fires.dtype == torch.int32 and tuple(fires.shape) == (P,)
    assert (int(fires.min()) > 0) == (method == "fista")
    br, bi = b, torch.zeros_like(b)
    xr, xi, fires_c = tpgm.pgm_dense_fused_cplx(br, bi, At, torch.zeros_like(At), 2e-2,
                                                _rho(A), 1.0, 40, method=method,
                                                restart=restart, with_counts=True)
    # zero imaginary planes: the real solve up to the rounding of the group
    # threshold's other op order, and the same restarts
    _close(xr, x)
    assert not bool(xi.any()) and fires_c.tolist() == fires.tolist()


@pytest.mark.parametrize("shape,jax_accepts", [((1024, 512), True), ((16, 36000), True),
                                               ((2048, 512), False)])
def test_checks_take_every_shape(shape, jax_accepts):
    """Both checks accept the JAX gate's largest shapes, and larger ones
    (the planes live in global memory; there is no VMEM gate)."""
    A = np.zeros(shape, np.float32)
    jop, top = rt.DenseOperator(jnp.asarray(A)), rtt.DenseOperator(torch.from_numpy(A),
                                                                    device="cpu")
    js = rt.CGNR.create(jop, reg=rt.L2Regularization(1e-3))
    jf = rt.FISTA.create(jop, reg=rt.L1Regularization(1e-3), rho=0.5)
    ts = rtt.CGNR.create(top, reg=rtt.L2Regularization(1e-3))
    tf = rtt.FISTA.create(top, reg=rtt.L1Regularization(1e-3), rho=0.5)
    assert tcgnr.check_cgnr_fused(ts) == "none"
    assert tpgm.check_pgm_dense_fused(tf) == ("fista", "l1", "none")
    for check, solver in ((jcgnr.check_cgnr_fused, js), (jpgm.check_pgm_dense_fused, jf)):
        if jax_accepts:
            check(solver)
        else:
            with pytest.raises(ValueError, match="VMEM"):
                check(solver)


def _rejections():
    """(name, rls_tpu solver, message) of what the dense checks refuse."""
    A, _ = _system()
    op = rt.DenseOperator(jnp.asarray(A))
    other = rt.DenseOperator(jnp.asarray(A))
    g = np.ones(3) / 3
    conv = rt.SeparableConvOperator.from_taps(g, g, (6, 6), compensated=False)
    l2 = rt.L2Regularization(1e-3)
    return [
        ("cgnr", "not-cgnr", rt.FISTA.create(op, reg=rt.L1Regularization(0.1), rho=0.5),
         "requires a CGNR solver"),
        ("cgnr", "custom-aha", rt.CGNR.create(op, AHA=rt.NormalOperator(other), reg=l2),
         "default AHA"),
        ("cgnr", "weighted", rt.CGNR.create(op, AHA=rt.NormalOperator(op, jnp.ones(M)),
                                            reg=l2), "default AHA"),
        ("cgnr", "vector-lam", rt.CGNR.create(op, reg=rt.L2Regularization(jnp.ones(N))),
         "scalar L2"),
        ("pgm", "not-pgm", rt.CGNR.create(op, reg=l2), "covers FISTA/OptISTA/POGM"),
        ("pgm", "conv", rt.FISTA.create(conv, reg=rt.L1Regularization(0.1), rho=0.5),
         "requires a dense operator"),
        ("pgm", "tv", rt.FISTA.create(op, reg=rt.TVRegularization(0.1, shape=(N,)), rho=0.5),
         "plain L1/L2"),
        ("pgm", "vector-lam", rt.FISTA.create(op, reg=rt.L2Regularization(jnp.ones(N)),
                                              rho=0.5), "scalar λ"),
        ("pgm", "pogm-restart", rt.POGM.create(op, reg=rt.L1Regularization(0.1), rho=0.5,
                                               restart="gradient"), "restart needs"),
        ("pgm", "optista-positive",
         rt.OptISTA.create(op, reg=[rt.L1Regularization(0.1), rt.PositiveRegularization()],
                           rho=0.5), "OptISTA applies no projection"),
    ]


@pytest.mark.parametrize("index", range(10))
def test_checks_reject_what_jax_rejects(index):
    kernel, _, js, match = _rejections()[index]
    jcheck, tcheck = {
        "cgnr": (jcgnr.check_cgnr_fused, tcgnr.check_cgnr_fused),
        "pgm": (jpgm.check_pgm_dense_fused, tpgm.check_pgm_dense_fused),
    }[kernel]
    with pytest.raises(ValueError):
        jcheck(js)
    try:
        ts = convert(js, device="cpu")
    except (NotImplementedError, TypeError):
        return  # a piece the port does not carry (the 1-D TV)
    with pytest.raises(ValueError, match=match):
        tcheck(ts)


def test_wrappers_refuse_bad_arguments():
    b, A = torch.zeros(2, 5), torch.zeros(5, 3)
    with pytest.raises(ValueError, match="unknown prox"):
        tcgnr.cgnr_fused(b, A, torch.zeros(2), 3, prox="real")
    with pytest.raises(ValueError, match="rows"):
        tcgnr.cgnr_fused(b, A.T, torch.zeros(2), 3)
    with pytest.raises(ValueError, match="unknown prox kind"):
        tpgm.pgm_dense_fused(b, A, 0.1, 0.5, 1.0, 3, kind="l21")
    with pytest.raises(ValueError, match="identity on real data"):
        tpgm.pgm_dense_fused(b, A, 0.1, 0.5, 1.0, 3, prox="real")
    with pytest.raises(ValueError, match="restart needs"):
        tpgm.pgm_dense_fused(b, A, 0.1, 0.5, 1.0, 3, method="optista", restart="gradient")


def _route(js):
    return auto.select_fast_path(convert(js, device="cpu"))[0]


def test_dispatch_routes_dense_and_keeps_the_tv_routes():
    """cgnr_dense first, pgm_dense right after pgm_tv: a dense CGNR and a
    dense FISTA / OptISTA / POGM take their kernels; the flagship's
    FISTA-TV and the ADMM-TV cells keep their routes, since the dense
    checks refuse a SeparableConvOperator; solve_batched_fast on CPU
    tensors runs the plain versions."""
    A, B = _system()
    op = rt.DenseOperator(jnp.asarray(A))
    assert _route(rt.CGNR.create(op, reg=rt.L2Regularization(1e-3))) == "cgnr_dense"
    for cls in ("FISTA", "OptISTA", "POGM"):
        js = getattr(rt, cls).create(op, reg=rt.L1Regularization(1e-2), rho=0.6, iterations=8)
        assert _route(js) == "pgm_dense"
    g = np.ones(3) / 3
    # PGM-TV goes tiled past six planes of a band (385²), ADMM-TV past 256²
    for n, fista, admm in ((16, "pgm_tv", "admm_tv"), (257, "pgm_tv", "admm_tv_tiled"),
                           (385, "fista_tv_tiled", "admm_tv_tiled")):
        conv = rt.SeparableConvOperator.from_taps(g, g, (n, n), compensated=False)
        tv = rt.TVRegularization(1e-3, shape=(n, n))
        assert _route(rt.FISTA.create(conv, reg=tv, rho=0.9)) == fista
        assert _route(rt.ADMM.create(conv, reg=tv, rho=0.1, unroll_cg=True)) == admm
    js = rt.FISTA.create(op, reg=rt.L1Regularization(1e-2), rho=0.6, iterations=8)
    ts = convert(js, device="cpu")
    Bt = torch.from_numpy(B)
    torch.testing.assert_close(rtt.solve_batched_fast(ts, Bt), tpgm.solve_pgm_dense_fused(ts, Bt),
                               rtol=0, atol=0)
