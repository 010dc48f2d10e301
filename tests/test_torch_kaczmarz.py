"""Kaczmarz of rls_tpu_torch against rls_tpu on the same numpy inputs: the
row actions of the dense, padded-CSR, sparse and identity operators, the
composed solver in its cyclic, shuffled and precomputed-randomized modes
(the same rows as rls_tpu) on dense, padded-CSR and complex systems, with a
vector λ, both normalizations and an extra Positive term; the plain
versions of the sweep and streamed kernels against the JAX kernels in
interpret mode; the greedy update pipeline with forced rows, the draw's
distribution and the sampled solve; the checks, the dispatch and convert.

Tolerances: 1e-5 relative in float32 and 1e-10 in float64 for the
composed solver (the dot is summed in another order); 1e-5 relative for
the plain kernel versions (their dots summed in float64) against the JAX
kernels; 2e-5 absolute for the greedy pipeline at λ = 1e-4, the bar of
tests/test_kaczmarz.py:506."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu.kernels.kaczmarz_greedy import solve_kaczmarz_greedy as jax_greedy
from rls_tpu.kernels.kaczmarz_pallas import kaczmarz_sweep_pallas
from rls_tpu.kernels.kaczmarz_pallas import solve_kaczmarz_streamed as jax_streamed
from rls_tpu_torch.convert import convert
from rls_tpu_torch.kernels import auto
from rls_tpu_torch.kernels import kaczmarz_greedy as tgreedy
from rls_tpu_torch.kernels import kaczmarz_streamed as tstream

TOL = {"float32": 1e-5, "float64": 1e-10, "complex64": 1e-5, "complex128": 1e-10}
M, N, P = 24, 16, 2


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _system(dtype="float32", sparse=False, seed=0):
    """A (M, N) with 60 % zeros when `sparse` (column 0 kept full: genuine
    column-0 entries beside the padding), and B (M, P), in `dtype`."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(M, N))
    B = rng.normal(size=(M, P))
    if dtype.startswith("complex"):
        A = A + 1j * rng.normal(size=(M, N))
        B = B + 1j * rng.normal(size=(M, P))
    if sparse:
        A[rng.uniform(size=A.shape) < 0.6] = 0.0
        A[:, 0] = rng.normal(size=M)
    return A.astype(dtype), B.astype(dtype)


def _operator(A, kind):
    if kind == "csr":
        return rt.PaddedCSROperator.from_dense(A)
    if kind == "sparse":
        return rt.SparseOperator.from_dense(A)
    return rt.DenseOperator(jnp.asarray(A))


def test_row_actions_match_jax():
    A, _ = _system(sparse=True)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(P, N)).astype(np.float32)
    y = rng.normal(size=(P, M)).astype(np.float32)
    alpha = np.array([0.7, -1.3], np.float32)
    dense = rtt.DenseOperator(torch.from_numpy(A), device="cpu")
    csr = rtt.PaddedCSROperator.from_dense(A, device="cpu")
    jcsr = rt.PaddedCSROperator.from_dense(A)
    np.testing.assert_array_equal(csr.vals.numpy(), np.asarray(jcsr.vals))
    np.testing.assert_array_equal(csr.cols.numpy(), np.asarray(jcsr.cols))
    sparse = rtt.SparseOperator.from_dense(A, device="cpu")
    jd = rt.DenseOperator(jnp.asarray(A))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    rows = (0, 5, M - 1)
    want_norms = np.asarray(jd.row_norms_sq())
    want_dot = {i: [float(jd.row_dot(i, jnp.asarray(v))) for v in x] for i in rows}
    want_axpy = {i: np.stack([np.asarray(jd.row_axpy(jnp.asarray(v), i, a))
                              for v, a in zip(x, alpha)]) for i in rows}
    for op in (dense, csr, sparse, convert(jcsr, device="cpu"),
               convert(rt.SparseOperator.from_dense(A), device="cpu")):
        np.testing.assert_allclose(op.mv(xt).numpy(), x @ A.T, rtol=0, atol=1e-5)
        np.testing.assert_allclose(op.rmv(yt).numpy(), y @ A, rtol=0, atol=1e-5)
        np.testing.assert_allclose(op.to_dense().numpy(), A, rtol=0, atol=0)
        np.testing.assert_allclose(op.row_norms_sq().numpy(), want_norms, rtol=1e-6)
        for i in rows:
            np.testing.assert_array_equal(op.row(i).numpy(), A[i])
            np.testing.assert_allclose(op.row_dot(i, xt).numpy(), want_dot[i], rtol=0, atol=1e-5)
            np.testing.assert_allclose(op.row_axpy(xt, i, torch.from_numpy(alpha)).numpy(),
                                       want_axpy[i], rtol=0, atol=1e-6)
    eye = rtt.IdentityOperator(5, torch.float32, device="cpu")
    np.testing.assert_array_equal(eye.row(2).numpy(), np.eye(5, dtype=np.float32)[2])


def _kaczmarz(op, case, iterations=4):
    reg = [rt.L2Regularization(1e-3)]
    kw = {}
    if case in ("shuffled",):
        kw["shuffle_rows"] = True
    if case in ("randomized", "positive"):
        kw.update(randomized=True, sub_matrix_fraction=0.3, precompute_order=True)
    if case == "positive":
        reg.append(rt.PositiveRegularization())
    if case == "measurement":
        kw["normalize_reg"] = rt.MeasurementBasedNormalization()
    if case == "system":
        kw["normalize_reg"] = rt.SystemMatrixBasedNormalization()
    if case == "vector":
        lam = np.random.default_rng(5).uniform(0.5, 2.0, size=op.in_size)
        reg = [rt.L2Regularization(jnp.asarray(lam, op.dtype.type(0).real.dtype))]
    if case == "l1":
        reg.append(rt.L1Regularization(1e-2))
    return rt.Kaczmarz.create(op, reg=reg, iterations=iterations, **kw)


_COMPOSED = [
    ("cyclic", "dense", "float32"), ("shuffled", "dense", "float32"),
    ("randomized", "dense", "float32"), ("positive", "dense", "float32"),
    ("cyclic", "csr", "float32"), ("positive", "csr", "float32"),
    ("cyclic", "sparse", "float32"), ("cyclic", "dense", "complex64"),
    ("randomized", "csr", "complex64"), ("vector", "dense", "float32"),
    ("measurement", "dense", "float32"), ("system", "dense", "float32"),
    ("l1", "dense", "float32"), ("cyclic", "dense", "float64"),
    ("positive", "csr", "float64"), ("vector", "dense", "float64"),
    ("system", "dense", "float64"), ("shuffled", "dense", "complex128"),
]


@pytest.mark.parametrize("case,kind,dtype", _COMPOSED)
def test_composed_kaczmarz_matches_jax(case, kind, dtype):
    """The port's three solve entry points against rls_tpu's batched solve
    (its while-loop form: the unrolled one computes the same and takes
    seconds to compile per case)."""
    A, B = _system(dtype, sparse=kind != "dense")
    with jax.enable_x64(dtype in ("float64", "complex128")):
        js = _kaczmarz(_operator(A, kind), case)
        want = np.asarray(rt.solve_batched(js, jnp.asarray(B)))
    ts = convert(js, device="cpu")
    Bt = torch.from_numpy(B)
    got = rtt.solve_batched_unrolled(ts, Bt)
    assert got.dtype == Bt.dtype
    assert _rel(got, want) < TOL[dtype], _rel(got, want)
    assert _rel(rtt.solve(ts, Bt[:, 1]), want[:, 1]) < TOL[dtype]
    assert _rel(rtt.solve_batched(ts, Bt), want) < TOL[dtype]
    if case == "positive":
        assert float(got.real.min()) >= 0.0


@pytest.mark.parametrize("case", ["shuffled", "randomized", "greedy"])
def test_kaczmarz_create_follows_the_reference_ctor(case):
    """The port's own create visits the same rows as rls_tpu's and builds the
    same tables."""
    A, _ = _system(sparse=True)
    kw = {"shuffled": dict(shuffle_rows=True),
          "randomized": dict(randomized=True, sub_matrix_fraction=0.3, precompute_order=True),
          "greedy": dict(greedy_randomized=True, sub_matrix_fraction=0.25)}[case]
    js = rt.Kaczmarz.create(rt.DenseOperator(jnp.asarray(A)), reg=rt.L2Regularization(1e-3),
                            iterations=5, **kw)
    ts = rtt.Kaczmarz.create(rtt.DenseOperator(torch.from_numpy(A), device="cpu"),
                             reg=rtt.L2Regularization(1e-3), iterations=5, **kw)
    np.testing.assert_array_equal(ts.perm.numpy(), np.asarray(js.perm))
    assert ts.sub_matrix_size == js.sub_matrix_size
    if case == "randomized":
        np.testing.assert_allclose(ts.probabilities.numpy(), np.asarray(js.probabilities),
                                   rtol=1e-6)
        np.testing.assert_array_equal(ts.precomputed_order.numpy(),
                                      np.asarray(js.precomputed_order))
    if case == "greedy":
        np.testing.assert_allclose(ts.greedy_B.numpy(), np.asarray(js.greedy_B), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(ts.greedy_norms.numpy(), np.asarray(js.greedy_norms),
                                   rtol=1e-6)
        assert abs(ts.greedy_fnorm / float(js.greedy_fnorm) - 1) < 1e-6


def test_in_loop_randomized_and_greedy_draw_from_a_generator():
    """The in-loop randomized and the composed greedy draws come from a
    seeded torch.Generator: the same seed repeats the solve, and each
    converges on a consistent system like rls_tpu's own draws."""
    rng = np.random.default_rng(6)
    A = rng.normal(size=(40, 12)).astype(np.float32)
    xt = rng.normal(size=12).astype(np.float32)
    b = A @ xt
    for kw in (dict(randomized=True, sub_matrix_fraction=0.8),
               dict(greedy_randomized=True, sub_matrix_fraction=0.5)):
        js = rt.Kaczmarz.create(rt.DenseOperator(jnp.asarray(A)),
                                reg=rt.L2Regularization(1e-6), iterations=40, **kw)
        ts = convert(js, device="cpu")
        x1 = rtt.solve(ts, torch.from_numpy(b))
        np.testing.assert_array_equal(x1.numpy(), rtt.solve(ts, torch.from_numpy(b)).numpy())
        err = _rel(x1, xt)
        err_j = _rel(rt.solve(js, jnp.asarray(b)), xt)
        assert err < max(3 * err_j, 0.05), (kw, err, err_j)


def test_plain_sweep_matches_jax_sweep():
    """12a: the sweep's plain version against kaczmarz_sweep_pallas, and
    backend="cuda" (the plain version on CPU) against backend="pallas"."""
    A, B = _system()
    rng = np.random.default_rng(7)
    x = rng.normal(size=N).astype(np.float32)
    vl = rng.normal(size=M).astype(np.float32)
    denom = rng.uniform(0.02, 0.1, size=M).astype(np.float32)
    idx = rng.permutation(M).astype(np.int32)
    want = kaczmarz_sweep_pallas(jnp.asarray(A), jnp.asarray(x), jnp.asarray(vl),
                                 jnp.asarray(B[:, 0]), jnp.asarray(denom), 0.03,
                                 jnp.asarray(idx), interpret=True)
    before = tstream.kaczmarz_sweep.launches
    got = tstream.kaczmarz_sweep(torch.from_numpy(A), torch.from_numpy(x), torch.from_numpy(vl),
                                 torch.from_numpy(B[:, 0]), torch.from_numpy(denom),
                                 torch.tensor(0.03), torch.from_numpy(idx))
    assert tstream.kaczmarz_sweep.launches == before  # CPU: the plain version
    assert _rel(got[0], want[0]) < 1e-5 and _rel(got[1], want[1]) < 1e-5
    kw = dict(reg=rt.L2Regularization(1e-4), iterations=6, shuffle_rows=True)
    jx = rt.Kaczmarz.create(rt.DenseOperator(jnp.asarray(A)), backend="pallas", **kw)
    ts = convert(jx, device="cpu")
    assert ts.backend == "cuda"
    want = np.asarray(rt.solve_batched(jx, jnp.asarray(B)))
    assert _rel(rtt.solve_batched_unrolled(ts, torch.from_numpy(B)), want) < 1e-5


_STREAMED = {
    "cyclic": ("dense", "float32", "cyclic"),
    "shuffled": ("dense", "float32", "shuffled"),
    "randomized-positive": ("dense", "float32", "positive"),
    "csr-cyclic": ("csr", "float32", "cyclic"),
    "csr-randomized-positive": ("csr", "float32", "positive"),
    "complex": ("dense", "complex64", "cyclic"),
    "complex-randomized": ("dense", "complex64", "randomized"),
    "complex-csr": ("csr", "complex64", "cyclic"),
    "vector": ("dense", "float32", "vector"),
}


@pytest.mark.parametrize("name", sorted(_STREAMED))
def test_plain_streamed_matches_jax_streamed(name):
    """12b: the plain version through solve_kaczmarz_streamed against the
    JAX streamed kernel in three sweeps (block_rows 8: its sweeps of 24
    rows, or 7 sampled ones padded with −1 to 8)."""
    kind, dtype, case = _STREAMED[name]
    A, B = _system(dtype, sparse=kind == "csr")
    js = _kaczmarz(_operator(A, kind), case, iterations=3)
    want = np.asarray(jax_streamed(js, jnp.asarray(B), block_rows=8, interpret=True))
    ts = convert(js, device="cpu")
    before = tstream.kaczmarz_solve.launches
    got = rtt.solve_kaczmarz_streamed(ts, torch.from_numpy(B))
    assert tstream.kaczmarz_solve.launches == before
    assert got.dtype == torch.from_numpy(B).dtype
    assert _rel(got, want) < 1e-5, _rel(got, want)


def test_streamed_real_a_complex_b_and_pads():
    """A real A with a complex b is solved as 2K real problems; −1 entries
    in the index table are skipped exactly."""
    A, _ = _system()
    _, Bc = _system("complex64")
    js = _kaczmarz(_operator(A, "dense"), "cyclic", iterations=3)
    want = np.asarray(jax_streamed(js, jnp.asarray(Bc), block_rows=8, interpret=True))
    ts = convert(js, device="cpu")
    got = rtt.solve_kaczmarz_streamed(ts, torch.from_numpy(Bc))
    assert got.dtype == torch.complex64 and _rel(got, want) < 1e-5
    with pytest.raises(ValueError, match="decouple"):
        rtt.solve_kaczmarz_streamed(convert(_kaczmarz(_operator(A, "dense"), "positive"),
                                            device="cpu"), torch.from_numpy(Bc))
    rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse = tstream.solver_operands(
        convert(_kaczmarz(_operator(A, "csr"), "positive"), device="cpu"),
        torch.from_numpy(_system()[1]))
    padded = torch.full((idx.shape[0], 2 * idx.shape[1] + 3), -1, dtype=torch.int32)
    padded[:, 1::2][:, :idx.shape[1]] = idx
    a = tstream.kaczmarz_solve(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, "positive", cols)
    b = tstream.kaczmarz_solve(rows, padded, x0, vl0, u, denom, eps, sweeps, reuse, "positive",
                               cols)
    for ta, tb in zip(a, b):
        np.testing.assert_array_equal(ta.numpy(), tb.numpy())


def _greedy_problem(lam=1e-4, m=40, n=12, iterations=3, S=6, seed=8, K=1):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    xt = rng.normal(size=(n,)).astype(np.float32)
    B = (A @ xt)[:, None] + 0.0 * rng.normal(size=(m, K)).astype(np.float32)
    js = rt.Kaczmarz.create(rt.DenseOperator(jnp.asarray(A)), reg=rt.L2Regularization(lam),
                            iterations=iterations, greedy_randomized=True,
                            sub_matrix_fraction=S / m)
    return js, B.astype(np.float32), xt


def test_greedy_forced_rows_match_jax():
    """With a pinned row sequence the plain sweep's update pipeline (α, the
    x axpy, the dual bump, r −= r_row·Gt[row], the refresh) equals the JAX
    greedy kernel's, at λ = 1e-4 where rls_tpu's recovered λ is exact
    enough."""
    js, B, _ = _greedy_problem()
    assert js.sub_matrix_size == 6
    forced = np.random.default_rng(9).integers(0, 40, size=(3, 6)).astype(np.int32)
    forced[1, 2] = -1  # one step draws
    forced_all = forced.copy()
    forced_all[1, 2] = 7
    want = np.asarray(jax_greedy(js, jnp.asarray(B), forced_rows=jnp.asarray(forced_all)))
    ts = convert(js, device="cpu")
    got = rtt.solve_kaczmarz_greedy(ts, torch.from_numpy(B),
                                    forced_rows=torch.from_numpy(forced_all))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    # the rows the sweeps report: the forced ones, and one drawn
    _, rows = tgreedy.greedy_solve(ts, torch.from_numpy(B), forced_rows=torch.from_numpy(forced))
    assert rows.shape == (3, 1, 6)
    keep = forced >= 0
    np.testing.assert_array_equal(rows[:, 0].numpy()[keep], forced[keep])
    assert 0 <= int(rows[1, 0, 2]) < 40


def test_greedy_first_draw_follows_the_thresholded_distribution():
    """χ² over 8000 problems with one residual: the first drawn row follows
    w / Σw, w the e_k-thresholded |r|², and a row below the threshold is
    never drawn."""
    js, _, _ = _greedy_problem(m=16, n=8)
    ts = convert(js, device="cpu")
    K = 8000
    A = ts.A.mat
    rn2 = ts.A.row_norms_sq()
    denom = 1.0 / (rn2 + 1e-4)
    norms = ts.greedy_norms
    # five rows whose |r|²/norm lies near the top (they pass the e_k
    # threshold), the rest far below
    share = torch.full((16,), 0.01)
    share[[0, 3, 6, 9, 12]] = torch.tensor([1.0, 0.95, 0.9, 0.97, 0.92])
    r = torch.sqrt(norms * share)
    Gt = ts.greedy_B.T.contiguous()
    fnorm = float(ts.greedy_fnorm)
    rr = r.expand(K, 16).contiguous()
    _, _, _, rows = tgreedy.kaczmarz_greedy_sweep(
        A, Gt, denom, norms, torch.zeros(K, 8), torch.zeros(K, 16), rr,
        torch.full((K,), 1e-2), fnorm, None, 1, 1234, 0)
    r2 = r * r
    dn = float(r2.double().sum())
    ek = 0.5 * (float((r2 * denom).max()) / dn + fnorm)
    w = torch.where(r2 >= ek * dn * norms, r2, torch.zeros_like(r2)).double()
    p = (w / w.sum()).numpy()
    counts = np.bincount(rows[:, 0].numpy(), minlength=16)
    assert counts[p == 0].sum() == 0
    live = p > 0
    assert live.sum() == 5, p
    _, pval = stats.chisquare(counts[live], K * p[live])
    assert pval > 1e-3, (counts, p)


def test_greedy_sampled_solve_converges():
    """Sampled draws: the greedy kernel's plain version solves a consistent
    system to the accuracy class of the composed solve (another stream,
    the same per-step distribution)."""
    js, B, xt = _greedy_problem(lam=1e-6, m=60, n=16, iterations=12, S=15)
    ts = convert(js, device="cpu")
    x_k = rtt.solve_kaczmarz_greedy(ts, torch.from_numpy(B))[:, 0]
    x_c = rtt.solve(ts, torch.from_numpy(B[:, 0]))
    err_k, err_c = _rel(x_k, xt), _rel(x_c, xt)
    assert err_k < max(3 * err_c, 0.05), (err_k, err_c)


def test_kaczmarz_checks_and_dispatch():
    A, B = _system(sparse=True)
    Bt = torch.from_numpy(B)
    dense = _operator(A, "dense")

    def port(op, **kw):
        return convert(rt.Kaczmarz.create(op, iterations=2, **kw), device="cpu")

    l2 = rt.L2Regularization(1e-3)
    cyclic = port(dense, reg=l2)
    assert auto.select_fast_path(cyclic)[0] == "kaczmarz_streamed"
    greedy = port(dense, reg=l2, greedy_randomized=True)
    name, _, reasons = auto.select_fast_path(greedy)
    assert name == "kaczmarz_greedy" and len(reasons) == 10, reasons
    assert auto.select_fast_path(port(_operator(A, "csr"), reg=l2))[0] == "kaczmarz_streamed"
    np.testing.assert_array_equal(rtt.solve_batched_fast(cyclic, Bt).numpy(),
                                  rtt.solve_kaczmarz_streamed(cyclic, Bt).numpy())
    cases = [
        (cyclic, tgreedy.check_kaczmarz_greedy, "greedy_randomized=True"),
        (port(_operator(A, "sparse"), reg=l2, greedy_randomized=True),
         tgreedy.check_kaczmarz_greedy, "dense operator"),
        (port(_operator(_system("complex64")[0], "dense"), reg=l2, greedy_randomized=True),
         tgreedy.check_kaczmarz_greedy, "real float32"),
        (port(dense, reg=rt.L2Regularization(jnp.linspace(0.5, 1.0, N)), greedy_randomized=True),
         tgreedy.check_kaczmarz_greedy, "vector-λ"),
        (port(dense, reg=[l2, rt.L1Regularization(1e-3)], greedy_randomized=True),
         tgreedy.check_kaczmarz_greedy, "Positive/Real"),
        (greedy, tstream.check_kaczmarz_streamed, "greedy"),
        (port(_operator(A, "sparse"), reg=l2), tstream.check_kaczmarz_streamed,
         "dense or padded-CSR"),
        (port(dense, reg=l2, randomized=True), tstream.check_kaczmarz_streamed, "precomputed"),
        (port(dense, reg=[l2, rt.L1Regularization(1e-3)]), tstream.check_kaczmarz_streamed,
         "Positive/Real"),
    ]
    for solver, check, reason in cases:
        with pytest.raises(ValueError, match=reason):
            check(solver)
    # a randomized solver without its precomputed order falls back, naming
    # every rejection
    with pytest.warns(UserWarning, match="kaczmarz_streamed: randomized mode needs"):
        rtt.solve_batched_fast(port(dense, reg=l2, randomized=True), Bt)


def test_wrappers_refuse_indices_out_of_range():
    """The kernels read and write by row (and CSR column) unchecked: the
    wrappers refuse a row outside [−1, m), a column outside [0, n) and a
    forced-row list of the wrong length, on every device."""
    A, B = _system(sparse=True)
    ts = convert(_kaczmarz(_operator(A, "csr"), "positive"), device="cpu")
    rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse = tstream.solver_operands(
        ts, torch.from_numpy(B))
    for bad in (M, -2):
        wrong = idx.clone()
        wrong[0, 0] = bad
        with pytest.raises(ValueError, match=r"row index.*must lie in \[-1, 24\)"):
            tstream.kaczmarz_solve(rows, wrong, x0, vl0, u, denom, eps, sweeps, reuse,
                                   "positive", cols)
    wrong = cols.clone()
    wrong[0, 0] = N
    with pytest.raises(ValueError, match=r"column index.*must lie in \[0, 16\)"):
        tstream.kaczmarz_solve(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, "positive",
                               wrong)
    with pytest.raises(ValueError, match="must lie"):
        tstream.kaczmarz_sweep(torch.from_numpy(A), x0[:, 0], vl0[:, 0], u[:, 0], denom, eps,
                               torch.tensor([0, M], dtype=torch.int32))
    js, Bg, _ = _greedy_problem()
    tg = convert(js, device="cpu")
    forced = torch.zeros((3, 6), dtype=torch.int32)
    forced[2, 5] = 40
    with pytest.raises(ValueError, match=r"forced row.*must lie in \[-1, 40\)"):
        rtt.solve_kaczmarz_greedy(tg, torch.from_numpy(Bg), forced_rows=forced)
    with pytest.raises(ValueError, match="forced_rows of shape"):
        rtt.solve_kaczmarz_greedy(tg, torch.from_numpy(Bg), forced_rows=forced[:, :4])


def test_convert_carries_kaczmarz():
    A, _ = _system(sparse=True)
    js = rt.Kaczmarz.create(rt.PaddedCSROperator.from_dense(A),
                            reg=[rt.L2Regularization(1e-3), rt.PositiveRegularization()],
                            iterations=5, randomized=True, sub_matrix_fraction=0.3,
                            precompute_order=True, seed=77, backend="pallas")
    ts = convert(js, device="cpu")
    assert isinstance(ts, rtt.Kaczmarz) and isinstance(ts.A, rtt.PaddedCSROperator)
    assert (ts.seed, ts.iterations, ts.sub_matrix_size, ts.backend, ts.randomized) == (
        77, 5, js.sub_matrix_size, "cuda", True)
    np.testing.assert_array_equal(ts.precomputed_order.numpy(), np.asarray(js.precomputed_order))
    np.testing.assert_array_equal(ts.probabilities.numpy(), np.asarray(js.probabilities))
    assert [type(r).__name__ for r in ts.reg] == ["PositiveRegularization"]
    assert ts.l2.lam == pytest.approx(1e-3)
