"""The compressed-sensing and SENSE slice of rls_tpu_torch against rls_tpu
on the same numpy inputs: the Fourier and split-real DFT operators, the
plain FFT the kernels share, L21 and the 3-D TV prox, the plain versions of
the fused FISTA-L1-DFT and FISTA-L21-SENSE kernels against the JAX kernels
in interpret mode, the composed FISTA on the DFT operators, the dispatch
with its size rule, and convert.

Tolerances: the operators 1e-10 in float64 (JAX under a scoped
``enable_x64``; both are exact DFTs, one by FFT and one by matrix
products) and 1e-5 relative in float32 against the uncompensated JAX
operators; the plain FFT 1e-12 against ``torch.fft`` in float64. The plain
kernel versions 2e-4 against the JAX kernels, the bar the JAX suite sets
between its kernels and its composed path (tests/test_kernels.py:369-386,
463-479): the JAX kernels form every DFT product from bf16 hi/lo splits
(~2⁻¹⁶ per product), the port runs an exact f32 FFT.
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
from rls_tpu_torch.kernels import _dft_common, auto
from rls_tpu_torch.kernels import fista_l1_dft_fused as tl1
from rls_tpu_torch.kernels import sense_fused as tsense
from rls_tpu_torch.ops.base import NormalOperator

jl1 = importlib.import_module("rls_tpu.kernels.fista_l1_dft_fused")
jsense = importlib.import_module("rls_tpu.kernels.sense_fused")
SHAPES = [(16, 16), (16, 32)]


def _maps(rng, C, h, w):
    maps = rng.normal(size=(C, h, w)) + 1j * rng.normal(size=(C, h, w))
    return (maps / np.sqrt((np.abs(maps) ** 2).sum(0))).astype(np.complex128)


def _ops(kind, shape, dtype):
    """The same operator in rls_tpu (float64 or uncompensated float32) and,
    converted, in the port, with the real or complex dtype of its input."""
    h, w = shape
    rng = np.random.default_rng(7)
    jdt = getattr(jnp, dtype)
    mask = (rng.uniform(size=shape) < 0.4).astype(dtype)
    if kind == "subsampled_dft":
        op = rt.SubsampledDFT2RealOperator.from_mask(mask, shape, compensated=False, dtype=jdt)
        return op, dtype
    if kind == "sense":
        maps = _maps(rng, 3, h, w)
        op = rt.SenseDFT2RealOperator.from_maps(maps, mask, shape, compensated=False, dtype=jdt)
        return op, dtype
    cdt = "complex128" if dtype == "float64" else "complex64"
    if kind == "fft":
        return rt.FFTOperator(im_shape=shape), cdt
    if kind == "subsampled_fft":
        idx = np.sort(rng.choice(h * w, size=h * w // 3, replace=False)).astype(np.int32)
        return rt.SubsampledFFTOperator(sample_idx=jnp.asarray(idx), im_shape=shape), cdt
    kern = np.outer(np.hanning(5), np.hanning(5))
    return rt.ConvolutionOperator.from_kernel(jnp.asarray(kern / kern.sum()), shape), cdt


def _vec(rng, n, dtype, k=2):
    v = rng.normal(size=(k, n))
    if dtype.startswith("complex"):
        v = v + 1j * rng.normal(size=(k, n))
    return v.astype(dtype)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["subsampled_dft", "sense", "fft", "subsampled_fft",
                                  "convolution"])
def test_operators_match_jax(kind, dtype, shape):
    rng = np.random.default_rng(1)
    with jax.enable_x64(dtype == "float64"):
        jop, vdt = _ops(kind, shape, dtype)
        x = _vec(rng, jop.in_size, vdt)
        y = _vec(rng, jop.out_size, vdt if kind not in ("subsampled_dft", "sense") else dtype)
        want = [np.asarray(jax.vmap(f)(jnp.asarray(a))) for f, a in
                ((jop.mv, x), (jop.rmv, y), (jop.normal, x))]
    top = convert(jop, device="cpu")
    got = [f(torch.from_numpy(a)).numpy() for f, a in ((top.mv, x), (top.rmv, y), (top.normal, x))]
    tol = 1e-10 if dtype == "float64" else 1e-5
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        np.testing.assert_allclose(g, wnt, rtol=0, atol=tol * max(1.0, np.abs(wnt).max()))
    # adjointness: <A x, y> = <x, Aᴴ y>
    lhs = np.vdot(y, top.mv(torch.from_numpy(x)).numpy())
    rhs = np.vdot(top.rmv(torch.from_numpy(y)).numpy(), x)
    assert abs(lhs - rhs) <= tol * 10 * max(1.0, abs(lhs))


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
def test_plain_fft_stages_match_torch_fft(n):
    rng = np.random.default_rng(n)
    z = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    tw = torch.from_numpy(_dft_common.twiddles(n, np.float64))
    rev = _dft_common.bit_reverse(n)
    re, im = _dft_common.fft_dif(torch.from_numpy(z.real), torch.from_numpy(z.imag), tw)
    want = torch.fft.fft(torch.from_numpy(z))[:, rev]
    np.testing.assert_allclose((re + 1j * im).numpy(), want.numpy(), rtol=0, atol=1e-12 * n)
    zr = z[:, rev]  # the inverse takes bit-reversed order
    re, im = _dft_common.ifft_dit(torch.from_numpy(zr.real), torch.from_numpy(zr.imag), tw)
    want = torch.fft.ifft(torch.from_numpy(z)) * n
    np.testing.assert_allclose((re + 1j * im).numpy(), want.numpy(), rtol=0, atol=1e-12 * n)


@pytest.mark.parametrize("shape", [(16, 16), (16, 32), (64, 8)])
def test_plain_normal_ops_match_torch_fft(shape):
    """The kernels' normal ops (rows, columns, spectral weights, back) and
    the SENSE coil sum against the composed torch.fft forms in float64."""
    rng = np.random.default_rng(2)
    mask = torch.from_numpy((rng.uniform(size=shape) < 0.5).astype(np.float64))
    tables = _dft_common.dft_tables(mask, torch.float64)
    x = torch.from_numpy(rng.normal(size=(2, *shape)))
    want = torch.fft.ifft2(torch.fft.fft2(x, norm="ortho") * mask, norm="ortho").real
    np.testing.assert_allclose(_dft_common.real_normal(x, tables).numpy(), want.numpy(),
                               rtol=0, atol=1e-12)
    maps = _maps(rng, 3, *shape)
    op = rtt.SenseDFT2RealOperator.from_maps(maps, mask.numpy(), shape, dtype=torch.float64,
                                             device="cpu")
    xs = torch.from_numpy(rng.normal(size=(2, 2 * shape[0] * shape[1])))
    n = shape[0] * shape[1]
    nr, ni = _dft_common.sense_normal(xs[:, :n].reshape(2, *shape), xs[:, n:].reshape(2, *shape),
                                      op.coils_r, op.coils_i, tables)
    got = torch.cat([nr.reshape(2, -1), ni.reshape(2, -1)], dim=1)
    np.testing.assert_allclose(got.numpy(), op.normal(xs).numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(24, 24), (16, 12), (2048, 16), (1, 16)])
def test_fft_size_gate_names_the_reason(shape):
    with pytest.raises(ValueError, match="powers of two"):
        _dft_common.check_fft_shape(*shape)


@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("per_problem", [False, True])
def test_l21_matches_jax(slices, per_problem):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 48)).astype(np.float32)
    x[0, :12] = 0.0  # a zero group: the gn == 0 guard
    lam = np.array([0.3, 1.0, 2.5], np.float32) if per_problem else 0.7
    jreg = rt.L21Regularization(0.7, slices=slices)
    lams = lam if per_problem else [lam] * 3
    want_p = np.stack([np.asarray(jreg.prox(jnp.asarray(x[k]), lams[k])) for k in range(3)])
    want_v = np.array([float(jreg.value(jnp.asarray(x[k]), lams[k])) for k in range(3)])
    treg = convert(jreg, device="cpu")
    assert isinstance(treg, rtt.L21Regularization) and treg.slices == slices
    lt = torch.from_numpy(lam) if per_problem else lam
    np.testing.assert_allclose(treg.prox(torch.from_numpy(x), lt).numpy(), want_p, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(treg.value(torch.from_numpy(x), lt).numpy(), want_v, rtol=1e-6)


def test_tv_over_split_planes_matches_jax():
    """TV over shape (2, H, W), dims (1, 2): the composed FGP on the 3-D
    GradientOperator, as SplitBregman's TV term runs it."""
    h, w = 12, 10
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 2 * h * w)).astype(np.float32)
    jreg = rt.TVRegularization(0.05, shape=(2, h, w), dims=(1, 2), iterations_tv=6)
    want = np.stack([np.asarray(jreg.prox(jnp.asarray(v))) for v in x])
    treg = convert(jreg, device="cpu")
    np.testing.assert_allclose(treg.prox(torch.from_numpy(x)).numpy(), want, rtol=0, atol=1e-5)
    # no gradient couples the two planes
    one = treg.prox(torch.from_numpy(x[:, : h * w].copy()).repeat(1, 2))
    assert torch.equal(one[:, : h * w], one[:, h * w:])


def _cs_problem(n=16, batch=3, lam=1e-3, normalize=None):
    """test_kernels.py:369-386's FISTA-L1 CS problem in rls_tpu."""
    rng = np.random.default_rng(5)
    N2 = n * n
    idx = jnp.asarray(sorted(rng.choice(N2, size=N2 // 3, replace=False)), jnp.int32)
    op = rt.SubsampledDFT2RealOperator.from_sample_idx(idx, (n, n))
    kw = {} if normalize is None else {"normalize_reg": normalize}
    solver = rt.FISTA.create(op, reg=rt.L1Regularization(lam), iterations=8, rho=0.95,
                             rel_tol=0.0, track_residual=False, **kw)
    X = jnp.asarray(rng.normal(size=(batch, N2)), jnp.float32)
    return solver, np.array(jax.vmap(op.mv)(X).T)


def _sense_problem(h=16, w=16, C=3, batch=2):
    """test_kernels.py:463-479's FISTA-L21 SENSE problem in rls_tpu."""
    rng = np.random.default_rng(6)
    maps = _maps(rng, C, h, w).astype(np.complex64)
    mask = (rng.uniform(size=(h, w)) < 0.5).astype(np.float32)
    op = rt.SenseDFT2RealOperator.from_maps(maps, mask, (h, w))
    solver = rt.FISTA.create(op, reg=rt.L21Regularization(1e-3, slices=2), iterations=8,
                             rho=0.95, rel_tol=0.0, track_residual=False)
    X = jnp.asarray(rng.normal(size=(batch, 2 * h * w)), jnp.float32)
    return solver, np.array(jax.vmap(op.mv)(X).T)


@pytest.mark.parametrize("normalize", [None, "measurement"])
def test_fista_l1_dft_plain_matches_jax_kernel(normalize):
    norm = rt.MeasurementBasedNormalization() if normalize else None
    solver, B = _cs_problem(normalize=norm)
    want = np.asarray(jl1.solve_fista_l1_dft_fused(solver, jnp.asarray(B), interpret=True))
    tsolver = convert(solver, device="cpu")
    assert auto.select_fast_path(tsolver)[0] == "fista_l1_dft"
    before = tl1.fista_l1_dft_fused.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = rtt.solve_batched_fast(tsolver, torch.from_numpy(B))
    assert tl1.fista_l1_dft_fused.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    composed = rtt.solve_batched_unrolled(tsolver, torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), composed.numpy(), rtol=0, atol=1e-5)


def test_fista_l1_dft_plain_per_problem_lam():
    """λ per problem: each column equals its own single-λ solve."""
    solver, B = _cs_problem()
    op = convert(solver, device="cpu").A
    x0 = op.rmv(torch.from_numpy(B.T)).reshape(-1, 16, 16)
    lam = torch.tensor([1e-3, 5e-2, 0.0])
    got = tl1.fista_l1_dft_fused(x0, op.mask, 0.95, lam, 8)
    for k in range(3):
        one = tl1.fista_l1_dft_fused(x0[k : k + 1], op.mask, 0.95, float(lam[k]), 8)
        assert torch.equal(got[k], one[0])
    assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("shape", [(16, 16), (16, 32)])
def test_fista_l21_sense_plain_matches_jax_kernel(shape):
    solver, B = _sense_problem(*shape)
    want = np.asarray(jsense.solve_fista_l21_sense_fused(solver, jnp.asarray(B), interpret=True))
    tsolver = convert(solver, device="cpu")
    assert auto.select_fast_path(tsolver)[0] == "fista_l21_sense"
    before = tsense.fista_l21_sense_fused.launches
    got = rtt.solve_batched_fast(tsolver, torch.from_numpy(B))
    assert tsense.fista_l21_sense_fused.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    composed = rtt.solve_batched_unrolled(tsolver, torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), composed.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["cs", "sense"])
def test_composed_fista_matches_jax(kind):
    """The composed FISTA on the port's torch.fft operators against the
    JAX composed path on its uncompensated float64 operators."""
    with jax.enable_x64(True):
        solver, B = _cs_problem() if kind == "cs" else _sense_problem()
        op = solver.A
        if kind == "cs":
            op64 = rt.SubsampledDFT2RealOperator.from_mask(np.asarray(op.mask), op.im_shape,
                                                           dtype=jnp.float64)
        else:
            maps = np.asarray(op.coils_r) + 1j * np.asarray(op.coils_i)
            op64 = rt.SenseDFT2RealOperator.from_maps(maps, np.asarray(op.mask), op.im_shape,
                                                      dtype=jnp.float64)
        s64 = rt.FISTA.create(op64, reg=solver.reg, iterations=8, rho=0.95, rel_tol=0.0,
                              track_residual=False)
        B64 = B.astype(np.float64)
        want = np.asarray(rt.solve_batched_unrolled(s64, jnp.asarray(B64)))
    got = rtt.solve_batched_unrolled(convert(s64, device="cpu"), torch.from_numpy(B64))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


def test_dispatch_rejects_sizes_the_fft_does_not_take():
    """A 24² compressed-sensing problem: every FFT row names the size, and
    the call falls back to the composed path with a warning."""
    n = 24
    mask = (np.random.default_rng(8).uniform(size=(n, n)) < 0.4).astype(np.float32)
    op = rtt.SubsampledDFT2RealOperator.from_mask(mask, (n, n), device="cpu")
    solver = rtt.FISTA.create(op, reg=rtt.L1Regularization(1e-3), iterations=4, rho=0.95)
    name, _, reasons = auto.select_fast_path(solver)
    assert name is None
    size = ("the in-kernel FFT takes H and W that are powers of two from 2 to 1024, got 24x24; "
            "use the composed solve path")
    assert f"fista_l1_dft: {size}" in reasons
    B = op.mv(torch.ones(2, n * n)).T
    with pytest.warns(UserWarning, match="fista_l1_dft: the in-kernel FFT takes"):
        got = rtt.solve_batched_fast(solver, B)
    np.testing.assert_array_equal(got.numpy(), rtt.solve_batched_unrolled(solver, B).numpy())


def test_fft_rejections_name_the_reason():
    n = 16
    mask = np.ones((n, n), np.float32)
    op = rtt.SubsampledDFT2RealOperator.from_mask(mask, (n, n), device="cpu")
    sense = rtt.SenseDFT2RealOperator.from_maps(np.ones((2, n, n), np.complex64), mask, (n, n),
                                                device="cpu")
    l1 = rtt.L1Regularization(1e-3)
    fista = rtt.FISTA.create
    cs, mri = tl1.check_fista_l1_dft_fused, tsense.check_fista_l21_sense_fused
    cases = [
        (cs, rtt.POGM.create(op, reg=l1, rho=0.9), "requires a FISTA solver"),
        (cs, fista(op, reg=rtt.L2Regularization(1e-3), rho=0.9), "requires L1Regularization"),
        (cs, fista(op, reg=l1, rho=0.9, restart="gradient"), "does not support restart"),
        (cs, fista(op, reg=[l1, rtt.PositiveRegularization()], rho=0.9), "projection"),
        (cs, fista(op, reg=l1, rho=0.9, theta=2.0), "theta=1"),
        (cs, fista(sense, reg=l1, rho=0.9), "requires SubsampledDFT2RealOperator"),
        (cs, fista(AHA=NormalOperator(op, device="cpu"), reg=l1, rho=0.9),
         "solver.A to be the SubsampledDFT2RealOperator itself"),
        (mri, fista(sense, reg=l1, rho=0.9), r"L21Regularization\(slices=2\)"),
        (mri, fista(op, reg=l1, rho=0.9), "requires SenseDFT2RealOperator"),
    ]
    for check, solver, match in cases:
        with pytest.raises(ValueError, match=match):
            check(solver)


def test_convert_carries_the_fourier_slice():
    n = 16
    rng = np.random.default_rng(9)
    idx = np.sort(rng.choice(n * n, size=80, replace=False)).astype(np.int32)
    sub = rt.SubsampledDFT2RealOperator.from_sample_idx(jnp.asarray(idx), (n, n))
    t = convert(sub, device="cpu")
    assert isinstance(t, rtt.SubsampledDFT2RealOperator) and t.im_shape == (n, n)
    assert t.dtype == torch.float32 and int(t.mask.sum()) == 80
    sense = rt.SenseDFT2RealOperator.from_maps(_maps(rng, 4, n, n), np.ones((n, n)), (n, n))
    t = convert(sense, device="cpu")
    assert isinstance(t, rtt.SenseDFT2RealOperator) and t.n_coils == 4
    assert (t.in_size, t.out_size) == (2 * n * n, 8 * n * n)
    s = rt.FISTA.create(sense, reg=rt.L21Regularization(2e-3, slices=2), iterations=7, rho=0.9)
    ts = convert(s, device="cpu")
    assert ts.A is ts.AHA.A and isinstance(ts.reg, rtt.L21Regularization)
    assert (ts.reg.lam, ts.reg.slices, ts.iterations) == (2e-3, 2, 7)
    sub_fft = convert(rt.SubsampledFFTOperator(sample_idx=jnp.asarray(idx), im_shape=(n, n)),
                      device="cpu")
    assert isinstance(sub_fft, rtt.SubsampledFFTOperator) and sub_fft.out_size == 80
    assert convert(rt.FFTOperator(im_shape=(n, n)), device="cpu").in_size == n * n
    conv = convert(rt.ConvolutionOperator.from_kernel(jnp.ones((3, 3)) / 9, (n, n)), device="cpu")
    assert isinstance(conv, rtt.ConvolutionOperator) and conv.otf.shape == (n, n)
