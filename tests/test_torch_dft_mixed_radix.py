"""The mixed-radix in-kernel FFT (rls_tpu_torch/kernels/_dft_common.py;
csrc/fft_mixed.cuh) at sides that are not powers of two, on the CPU.

The plain FFT: ``fft_dif`` / ``ifft_dit`` against ``torch.fft`` in float64
in ``digit_reverse`` order at sides with odd factors (1e-12·n), and at
every power of two from 2 to 1024 bit for bit a copy of the radix-2 FFT
the port ran before the odd stages (written out below), in float32 and
float64; the twiddle table and the digit reversal at powers of two as they
were. The size rule: every side from 2 to 1024 is taken, 1, 1025 and 2048
are refused with the reason. The three FFT rows' plain versions through
``rtt.solve_batched_fast`` against the JAX kernels in interpret mode
(2e-4, the bar tests/test_torch_dft.py sets) and against the port's
composed path (1e-5), at (24,
40) and (17, 32) for row 8, (24, 20) with 3 coils for row 9 and (24, 24)
for row 10. The planners: every resident plan at a side with odd factors
covers it (with a cluster size that divides H and W where a power of two
does and fits, else with uneven bands and blocks), every shape the JAX
kernel's VMEM check passes gets a cluster plan for row 8, and the
dispatch takes rows 8, 9 and 10 at 24², 192², 320² and 64 × 448 with no
warning.
The kernels themselves run only on the card (tests/test_torch_cuda.py)."""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import _dft_common as dft
from rls_tpu_torch.kernels import auto
from rls_tpu_torch.kernels import fista_l1_dft_fused as tl1
from rls_tpu_torch.kernels import sense_fused as tsense
from rls_tpu_torch.kernels import splitbregman_fused as tsb
from test_torch_dft_plan import H100_RESIDENT

jl1 = importlib.import_module("rls_tpu.kernels.fista_l1_dft_fused")
jsense = importlib.import_module("rls_tpu.kernels.sense_fused")
jsb = importlib.import_module("rls_tpu.kernels.splitbregman_fused")

MIXED = [3, 6, 12, 17, 24, 40, 96, 192, 320, 448, 704, 1021]
POW2 = [2**k for k in range(1, 11)]


# ---- the radix-2 FFT as the port ran it before the odd stages ---------------

def _bit_reverse(n):
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def _twiddles_pow2(n, dtype):
    k = np.arange(n // 2, dtype=np.float64)
    w = np.exp(-2j * np.pi * k / n)
    return np.stack([w.real, w.imag]).astype(dtype)


def _stage_view(v, m):
    n = v.shape[-1]
    return v.reshape(*v.shape[:-1], n // (2 * m), 2, m)


def _radix2_dif(re, im, tw):
    n = re.shape[-1]
    m = n // 2
    while m >= 1:
        wr = tw[0, :: n // (2 * m)]
        wi = tw[1, :: n // (2 * m)]
        a_r, b_r = _stage_view(re, m).unbind(-2)
        a_i, b_i = _stage_view(im, m).unbind(-2)
        d_r = a_r - b_r
        d_i = a_i - b_i
        re = torch.stack([a_r + b_r, d_r * wr - d_i * wi], dim=-2).reshape(re.shape)
        im = torch.stack([a_i + b_i, d_r * wi + d_i * wr], dim=-2).reshape(im.shape)
        m //= 2
    return re, im


def _radix2_dit(re, im, tw):
    n = re.shape[-1]
    m = 1
    while m < n:
        wr = tw[0, :: n // (2 * m)]
        wi = -tw[1, :: n // (2 * m)]
        a_r, b_r = _stage_view(re, m).unbind(-2)
        a_i, b_i = _stage_view(im, m).unbind(-2)
        t_r = b_r * wr - b_i * wi
        t_i = b_r * wi + b_i * wr
        re = torch.stack([a_r + t_r, a_r - t_r], dim=-2).reshape(re.shape)
        im = torch.stack([a_i + t_i, a_i - t_i], dim=-2).reshape(im.shape)
        m *= 2
    return re, im


# ---- the plain FFT ------------------------------------------------------------

@pytest.mark.parametrize("n", MIXED)
def test_the_plain_fft_matches_torch_fft_in_digit_reversed_order(n):
    rng = np.random.default_rng(n)
    z = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    tw = torch.from_numpy(dft.twiddles(n, np.float64))
    rev = dft.digit_reverse(n)
    re, im = dft.fft_dif(torch.from_numpy(z.real), torch.from_numpy(z.imag), tw)
    want = torch.fft.fft(torch.from_numpy(z))[:, rev]
    np.testing.assert_allclose((re + 1j * im).numpy(), want.numpy(), rtol=0, atol=1e-12 * n)
    zr = z[:, rev]  # the inverse takes digit-reversed order
    re, im = dft.ifft_dit(torch.from_numpy(zr.real), torch.from_numpy(zr.imag), tw)
    want = torch.fft.ifft(torch.from_numpy(z)) * n
    np.testing.assert_allclose((re + 1j * im).numpy(), want.numpy(), rtol=0, atol=1e-12 * n)


@pytest.mark.parametrize("n", POW2)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_at_powers_of_two_the_fft_is_the_radix_2_one_bit_for_bit(n, dtype):
    rng = np.random.default_rng(n + 1)
    re, im = (torch.from_numpy(rng.normal(size=(4, n)).astype(dtype)) for _ in range(2))
    tw = torch.from_numpy(dft.twiddles(n, dtype))
    assert torch.equal(tw, torch.from_numpy(_twiddles_pow2(n, dtype)))
    for got, want in ((dft.fft_dif(re, im, tw), _radix2_dif(re, im, tw)),
                      (dft.ifft_dit(re, im, tw), _radix2_dit(re, im, tw))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert np.array_equal(dft.digit_reverse(n), _bit_reverse(n))


@pytest.mark.parametrize("n,primes", [(3, [3]), (96, [3]), (320, [5]), (704, [11]),
                                      (1021, [1021]), (45, [3, 3, 5]), (1023, [3, 11, 31]),
                                      (1024, []), (2, [])])
def test_the_odd_stages_are_the_odd_primes_ascending(n, primes):
    assert dft.odd_primes(n) == primes


@pytest.mark.parametrize("n", [6, 17, 45, 192, 1021])
def test_the_digit_reversal_is_the_output_order(n):
    """A permutation; position s₁·n/p₁ + u holds frequency s₁ + p₁·f(u):
    a unit impulse at frequency f's inverse lands at its position."""
    rev = dft.digit_reverse(n)
    assert sorted(rev.tolist()) == list(range(n))
    tw = torch.from_numpy(dft.twiddles(n, np.float64))
    for f in (0, 1, n - 1, n // 3):
        x = torch.exp(2j * torch.pi * f * torch.arange(n, dtype=torch.float64) / n)
        re, im = dft.fft_dif(x.real[None], x.imag[None], tw)
        assert int(torch.argmax(re[0] ** 2 + im[0] ** 2)) == int(np.flatnonzero(rev == f)[0])


@pytest.mark.parametrize("n", [3, 17, 192, 320, 1021, 1022])
def test_the_twiddle_table_of_a_size_with_odd_factors(n):
    """⌊n/2⌋ + 1 entries, exp(−2πik/n) computed in float64 and rounded
    once; an entry past n/2 is read as the conjugate of entry n − k."""
    tw = dft.twiddles(n, np.float32)
    assert tw.shape == (2, dft.twiddle_count(n)) == (2, n // 2 + 1)
    k = np.arange(n // 2 + 1)
    want = np.exp(-2j * np.pi * k / n)
    assert np.array_equal(tw, np.stack([want.real, want.imag]).astype(np.float32))
    full = dft._full_twiddles(torch.from_numpy(tw), n)
    k = np.arange(n)
    np.testing.assert_allclose(full[0].numpy() + 1j * full[1].numpy(),
                               np.exp(-2j * np.pi * k / n), rtol=0, atol=1e-7)
    assert torch.equal(full[1, n - 1], -full[1, 1])
    assert dft.twiddle_floats(n, 64) == 2 * (n // 2 + 1) + 64


@pytest.mark.parametrize("shape", [(24, 40), (17, 32), (96, 12), (5, 3)])
def test_the_normal_ops_match_torch_fft_at_odd_factors(shape):
    """Rows, columns, the spectral weights in digit-reversed order and back,
    and the SENSE coil sum, against the composed torch.fft forms in float64."""
    rng = np.random.default_rng(2)
    mask = torch.from_numpy((rng.uniform(size=shape) < 0.5).astype(np.float64))
    tables = dft.dft_tables(mask, torch.float64)
    x = torch.from_numpy(rng.normal(size=(2, *shape)))
    want = torch.fft.ifft2(torch.fft.fft2(x, norm="ortho") * mask, norm="ortho").real
    np.testing.assert_allclose(dft.real_normal(x, tables).numpy(), want.numpy(), rtol=0,
                               atol=1e-12)
    maps = rng.normal(size=(3, *shape)) + 1j * rng.normal(size=(3, *shape))
    op = rtt.SenseDFT2RealOperator.from_maps(maps, mask.numpy(), shape, dtype=torch.float64,
                                             device="cpu")
    n = shape[0] * shape[1]
    xs = torch.from_numpy(rng.normal(size=(2, 2 * n)))
    nr, ni = dft.sense_normal(xs[:, :n].reshape(2, *shape), xs[:, n:].reshape(2, *shape),
                              op.coils_r, op.coils_i, tables)
    got = torch.cat([nr.reshape(2, -1), ni.reshape(2, -1)], dim=1)
    np.testing.assert_allclose(got.numpy(), op.normal(xs).numpy(), rtol=0, atol=1e-12)


# ---- the size rule ------------------------------------------------------------

def test_every_side_from_2_to_1024_is_taken():
    for n in range(2, 1025):
        dft.check_fft_shape(n, 2)
        dft.check_fft_shape(1024, n)


@pytest.mark.parametrize("shape", [(1, 16), (16, 1), (1025, 16), (16, 1025), (2048, 2048)])
def test_sides_past_the_fft_are_refused_with_the_reason(shape):
    with pytest.raises(ValueError, match=rf"takes H and W from 2 to 1024, got "
                                         rf"{shape[0]}x{shape[1]}; use the composed solve path"):
        dft.check_fft_shape(*shape)


# ---- the three rows' plain versions against the JAX kernels ------------------

def _maps(rng, C, h, w):
    maps = rng.normal(size=(C, h, w)) + 1j * rng.normal(size=(C, h, w))
    return (maps / np.sqrt((np.abs(maps) ** 2).sum(0))).astype(np.complex64)


def _fast(tsolver, B, row, module_fn):
    """solve_batched_fast on the CPU: row `row` taken with no warning and
    its plain version run (no launch)."""
    assert auto.select_fast_path(tsolver)[0] == row
    before = module_fn.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = rtt.solve_batched_fast(tsolver, torch.from_numpy(B))
    assert module_fn.launches == before
    return got


@pytest.mark.parametrize("shape", [(24, 40), (17, 32)])
def test_row_8_plain_matches_the_jax_kernel_at_odd_factors(shape):
    h, w = shape
    rng = np.random.default_rng(5)
    n = h * w
    idx = jnp.asarray(sorted(rng.choice(n, size=n // 3, replace=False)), jnp.int32)
    op = rt.SubsampledDFT2RealOperator.from_sample_idx(idx, shape)
    solver = rt.FISTA.create(op, reg=rt.L1Regularization(1e-3), iterations=8, rho=0.95,
                             rel_tol=0.0, track_residual=False)
    X = rng.normal(size=(3, n)).astype(np.float32)
    B = np.array(np.stack([np.asarray(op.mv(jnp.asarray(x))) for x in X]).T)
    want = np.asarray(jl1.solve_fista_l1_dft_fused(solver, jnp.asarray(B), interpret=True))
    tsolver = convert(solver, device="cpu")
    got = _fast(tsolver, B, "fista_l1_dft", tl1.fista_l1_dft_fused)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    composed = rtt.solve_batched_unrolled(tsolver, torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), composed.numpy(), rtol=0, atol=1e-5)


def test_row_9_plain_matches_the_jax_kernel_at_odd_factors():
    h, w, C = 24, 20, 3
    rng = np.random.default_rng(6)
    maps = _maps(rng, C, h, w)
    mask = (rng.uniform(size=(h, w)) < 0.5).astype(np.float32)
    op = rt.SenseDFT2RealOperator.from_maps(maps, mask, (h, w))
    solver = rt.FISTA.create(op, reg=rt.L21Regularization(1e-3, slices=2), iterations=8,
                             rho=0.95, rel_tol=0.0, track_residual=False)
    X = rng.normal(size=(2, 2 * h * w)).astype(np.float32)
    B = np.array(np.stack([np.asarray(op.mv(jnp.asarray(x))) for x in X]).T)
    want = np.asarray(jsense.solve_fista_l21_sense_fused(solver, jnp.asarray(B), interpret=True))
    tsolver = convert(solver, device="cpu")
    got = _fast(tsolver, B, "fista_l21_sense", tsense.fista_l21_sense_fused)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    composed = rtt.solve_batched_unrolled(tsolver, torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), composed.numpy(), rtol=0, atol=1e-5)


def test_row_10_plain_matches_the_jax_kernel_at_odd_factors():
    """BASELINE #4's shape at 24² (3 coils, 2 outer × 3 inner × 5 CG
    steps): against the JAX kernel (fgp_unroll, the fold FGP both run) and
    against the port's composed solver, whose fori FGP rounds otherwise than
    the kernel's fold FGP."""
    h = w = 24
    n = h * w
    rng = np.random.default_rng(12)
    maps = _maps(rng, 3, h, w)
    mask = (rng.uniform(size=(h, w)) < 0.6).astype(np.float32)
    op = rt.SenseDFT2RealOperator.from_maps(maps, mask, (h, w))
    reg = [rt.L21Regularization(1e-3, slices=2),
           rt.TVRegularization(1e-3, shape=(2, h, w), dims=(1, 2), iterations_tv=4, unroll=True)]
    solver = rt.SplitBregman.create(
        op, reg=reg, iterations=2, iterations_inner=3, iterations_cg=5, rho=[0.01, 0.02],
        reg_trafo=[rt.IdentityOperator(2 * n, jnp.float32), rt.IdentityOperator(2 * n, jnp.float32)],
        unroll_cg=True)
    X = rng.normal(size=(2, 2 * n)).astype(np.float32)
    B = np.array(np.stack([np.asarray(op.mv(jnp.asarray(x))) for x in X]).T)
    want = np.asarray(jsb.solve_splitbregman_l1_tv_fused(solver, jnp.asarray(B), interpret=True,
                                                          fgp_unroll=True))
    tsolver = convert(solver, device="cpu")
    got = _fast(tsolver, B, "splitbregman_l1_tv", tsb.splitbregman_l1_tv_fused)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    composed = rtt.solve_batched_unrolled(tsolver, torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), composed.numpy(), rtol=0, atol=1e-5)


# ---- the planners and the dispatch --------------------------------------------

SIDES = [3, 12, 17, 24, 40, 96, 97, 160, 192, 320, 448, 704]


@pytest.mark.parametrize("H", SIDES)
@pytest.mark.parametrize("W", SIDES + [64, 128])
def test_every_plan_at_odd_factors_covers_its_shape(H, W):
    """Row 8: a resident plan's cluster size divides H and W where a power
    of two that does fits (bands and blocks cover them with no remainder),
    else it is any fitting size (uneven parts that differ by one); the
    plan fits the card; no size fits where the plan is the grid's. Rows 9 and
    10: resident exactly where a coil's padded spectrum fits, bands
    covering H."""
    for B in (1, 16):
        plan = tl1.plan_fista_l1_dft(B, H, W, H100_RESIDENT)
        fit = tl1.fitting_sizes(H, W)
        even = [c for c in fit if H % c == 0 and W % c == 0 and c in tl1.CLUSTER_SIZES]
        assert even == list(fit) or not even
        if plan.route == "grid":
            assert not fit
            continue
        c = plan.clusters
        assert c in fit and (plan.rows, plan.cols) == (-(-H // c), -(-W // c))
        bands = [plan.band(q) for q in range(c)]
        blocks = [plan.block(q) for q in range(c)]
        assert [r for b in bands for r in range(*b)] == list(range(H))
        assert [k for b in blocks for k in range(*b)] == list(range(W))
        if even:
            assert (plan.rows * c, plan.cols * c) == (H, W)
        assert plan.smem == tl1.resident_smem_bytes(H, W, c) <= 232_448
    for module, planner in ((tsense, tsense.plan_sense), (tsb, tsb.plan_splitbregman)):
        plan = planner(8, H, W, 6, H100_RESIDENT)
        assert (plan.route == "resident") == (module.resident_smem_bytes(H, W) <= 232_448)
        if plan.route == "resident":
            bands = [plan.band(q) for q in range(plan.clusters)]
            assert bands[0][0] == 0 and bands[-1][1] == H


@pytest.mark.parametrize("shape,fit,c", [((320, 320), (16,), 16), ((24, 40), (1, 2, 4, 8), 1),
                                         ((96, 192), (2, 4, 8, 16), 4), ((17, 32), (1,), 1),
                                         ((192, 192), (4, 8, 16), 4), ((64, 448), (4, 8, 16), 4),
                                         ((64, 704), (8, 16), 8)])
def test_the_cluster_sizes_at_odd_factors(shape, fit, c):
    """The sizes whose bands fit, by the divisibility rule (320² only at
    16: 20-row bands; 24 × 40 up to 8; a prime side only at 1), and the
    planner's pick at batch 16 (the fewest waves × rows per band)."""
    assert tl1.fitting_sizes(*shape) == fit
    plan = tl1.plan_fista_l1_dft(16, *shape, H100_RESIDENT)
    assert (plan.route, plan.clusters) == ("resident", c)


def test_the_global_route_at_odd_factors():
    """Row 8 leaves the clusters only past a cluster of 16 (640², 704²),
    for the grid route, which took the global route's place; the prime 97
    × 128, global before uneven bands, runs on clusters of 3 (bands of 33,
    32 and 32 rows)."""
    assert tl1.fitting_sizes(320, 320) == (16,)
    for shape in ((640, 640), (704, 704)):
        assert tl1.plan_fista_l1_dft(4, *shape, H100_RESIDENT).route == "grid"
    plan = tl1.plan_fista_l1_dft(4, 97, 128, H100_RESIDENT)
    assert (plan.route, plan.clusters, plan.rows, plan.cols) == ("resident", 3, 33, 43)
    assert [plan.band(q) for q in range(3)] == [(0, 33), (33, 65), (65, 97)]
    # rows 9 and 10: 192² splits a coil's spectrum over a team of CTAs; a
    # spectrum that fits no team of 16 (704²) takes the grid route, which
    # took the global route's place
    assert tsense.plan_sense(8, 192, 192, 6, H100_RESIDENT).route == "split"
    assert tsense.plan_sense(8, 704, 704, 6, H100_RESIDENT).route == "grid"
    assert tsense.plan_sense(8, 64, 192, 6, H100_RESIDENT).route == "resident"
    assert tsb.plan_splitbregman(8, 192, 192, 6, H100_RESIDENT).route == "split"
    assert tsb.plan_splitbregman(8, 704, 704, 6, H100_RESIDENT).route == "grid"
    assert tsb.plan_splitbregman(8, 64, 192, 6, H100_RESIDENT).route == "resident"


# rectangles the JAX kernel takes: an 81 % phase field of view, 16:9, a
# prime side, odd sides, thin strips, and the largest sides of each aspect
JAX_RECTANGLES = [(320, 260), (384, 216), (97, 128), (128, 97), (255, 257), (300, 340),
                  (2, 1024), (1024, 2), (17, 1021), (64, 704), (400, 250), (448, 160),
                  (350, 320), (199, 383)]


def _jax_takes(H, W):
    """The JAX kernel's own gate: its VMEM check (and the in-kernel FFT's
    sizes, which the port's kernel shares)."""
    try:
        jl1._check_vmem_fista_l1_dft(H, W)
        dft.check_fft_shape(H, W)
    except ValueError:
        return False
    return True


def test_every_shape_the_jax_kernel_takes_gets_a_cluster_plan():
    """Every square side from 2 to 346 and the rectangles above that the
    JAX kernel's VMEM check passes run row 8 on a cluster of at most 16
    CTAs at batches 1, 4 and 16, not the global route; the first square
    side that fits no cluster (385) is past that check too."""
    shapes = [(n, n) for n in range(2, 400)] + JAX_RECTANGLES
    taken = [shape for shape in shapes if _jax_takes(*shape)]
    assert (346, 346) in taken and (347, 347) not in taken and (320, 260) in taken
    for H, W in taken:
        for B in (1, 4, 16):
            plan = tl1.plan_fista_l1_dft(B, H, W, H100_RESIDENT)
            assert plan.route == "resident" and plan.clusters <= 16, (B, H, W, plan)
    no_cluster = [n for n in range(2, 1025) if not tl1.fitting_sizes(n, n)]
    assert no_cluster[0] == 385 and not _jax_takes(385, 385)


def _cs_solver(shape):
    mask = (np.random.default_rng(1).uniform(size=shape) < 0.35).astype(np.float32)
    op = rtt.SubsampledDFT2RealOperator.from_mask(mask, shape, device="cpu")
    return rtt.FISTA.create(op, reg=rtt.L1Regularization(2e-3), iterations=2, rho=0.95)


def _sense_op(shape, C=2):
    maps = np.ones((C, *shape), np.complex64) / np.sqrt(C)
    return rtt.SenseDFT2RealOperator.from_maps(maps, np.ones(shape, np.float32), shape,
                                               device="cpu")


@pytest.mark.parametrize("shape", [(24, 24), (192, 192), (320, 320), (64, 448), (16, 12)])
def test_the_dispatch_takes_rows_8_9_and_10_at_odd_factors(shape):
    """Every FFT row's check passes, so solve_batched_fast picks its kernel
    with no warning (the shapes the JAX kernels run on their chip, and
    the two the old rule refused: 24² and 16 × 12)."""
    H, W = shape
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert auto.select_fast_path(_cs_solver(shape))[0] == "fista_l1_dft"
        op = _sense_op(shape)
        fista = rtt.FISTA.create(op, reg=rtt.L21Regularization(1e-3, slices=2), iterations=2,
                                 rho=0.95)
        assert auto.select_fast_path(fista)[0] == "fista_l21_sense"
        tv = rtt.TVRegularization(1e-3, shape=(2, H, W), dims=(1, 2), iterations_tv=3)
        sb = rtt.SplitBregman.create(op, reg=[rtt.L21Regularization(1e-3, slices=2), tv],
                                     iterations=2, iterations_inner=2, iterations_cg=3,
                                     unroll_cg=True, rho=0.01)
        assert auto.select_fast_path(sb)[0] == "splitbregman_l1_tv"


def test_a_small_solve_at_odd_factors_runs_its_plain_version_with_no_warning():
    """16 × 12, once refused by the size gate: solve_batched_fast runs row
    8's plain version (no fallback warning) and matches the composed solve."""
    solver = _cs_solver((16, 12))
    B = solver.A.mv(torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 192)).astype(np.float32))).T
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = rtt.solve_batched_fast(solver, B)
    np.testing.assert_allclose(got.numpy(), rtt.solve_batched_unrolled(solver, B).numpy(),
                               rtol=0, atol=1e-5)
