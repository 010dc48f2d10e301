"""DaxKaczmarz and DaxConstrained of rls_tpu_torch against rls_tpu on the
same numpy inputs: the tables built at create (denom = w²/(s² + λ), the
row probabilities, εw = √λ / w, the count of nonzero rows), the batched
solve with the rows JAX drew (``jax.random.split`` / ``choice`` exactly as
``rls_tpu/models/solvers/dax.py:136-137`` draws them, fed through the
private ``_forced_rows``), with weights, a zero row, the projections and
a ``sparse_trafo``; the Lent–Censor solve (no randomness) directly; the
port's own draws by a χ² test; recovery as tests/test_dax_pdhg.py asks
it; and ``convert``.

Tolerances: float64 (JAX x64, scoped) 1e-12 relative, float32 1e-5 of
max|x| (the row dots are summed in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu_torch.convert import convert
from rls_tpu_torch.models.solvers import dax as tdax

TOL = {"float32": 1e-5, "float64": 1e-12}
M, N, P = 16, 6, 3


def _close(got, want, dtype, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * max(float(np.abs(want).max()), 1e-30), (what, err)


def _system(rng, dtype, zero_row=True, positive=False):
    A = rng.normal(size=(M, N))
    if zero_row:
        A[5] = 0.0
    X = rng.normal(size=(N, P))
    if positive:
        X = np.abs(X)
    w = rng.uniform(0.5, 1.5, size=M)
    return A.astype(dtype), (A @ X).astype(dtype), w.astype(np.float32), X


def _jax_rows(js):
    """The rows rls_tpu's DaxKaczmarz.step draws, outer iteration by outer
    iteration: one split of PRNGKey(seed) each, then choice(p=probs)."""
    key = jax.random.PRNGKey(js.seed)
    rows = []
    for _ in range(js.iterations):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.random.choice(
            sub, js.A.out_size, shape=(js.n_nonzero_rows * js.iterations_inner,), p=js.probs)))
    return torch.from_numpy(np.stack(rows).astype(np.int64))


def _pair(rng, dtype, **kw):
    A, B, w, X = _system(rng, dtype, positive=kw.pop("positive", False))
    jop = rt.DenseOperator(jnp.asarray(A))
    top = rtt.DenseOperator(A, device="cpu")
    if kw.pop("weighted", True):
        kw["weights"] = w
    js = rt.DaxKaczmarz.create(jop, **kw)
    ts = rtt.DaxKaczmarz.create(top, **kw)
    return js, ts, B, X


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dax_kaczmarz_tables_match_jax(rng, dtype):
    with jax.enable_x64(dtype == "float64"):
        js, ts, _, _ = _pair(rng, dtype, lam=1e-3, iterations=2)
        for name in ("weights", "denom", "probs", "eps_w"):
            got, want = getattr(ts, name), np.asarray(getattr(js, name))
            assert str(got.dtype).split(".")[-1] == want.dtype.name, name
            _close(got, want, dtype, name)
        assert ts.n_nonzero_rows == js.n_nonzero_rows == M - 1
        assert float(ts.denom[5]) == 0.0 and float(ts.probs[5]) == 0.0
        assert ts.seed == js.seed and ts.reg == ()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("flags", ["none", "real", "real_positive"])
def test_dax_kaczmarz_forced_rows_match_jax(rng, dtype, flags):
    """The batched solve on the rows JAX drew equals JAX's vmapped solve
    (every column there starts from the same key, so visits the same
    rows); `finalize` applies the projections."""
    kw = dict(lam=1e-3, iterations=3, iterations_inner=2, seed=5,
              enforce_real=flags != "none", enforce_positive=flags == "real_positive")
    with jax.enable_x64(dtype == "float64"):
        js, ts, B, _ = _pair(rng, dtype, **kw)
        assert [type(r).__name__ for r in ts.reg] == [type(r).__name__ for r in js.reg]
        forced = dataclasses.replace(ts, _forced_rows=_jax_rows(js))
        want = rt.solve_batched_unrolled(js, jnp.asarray(B))
        _close(rtt.solve_batched_unrolled(forced, torch.from_numpy(B)), want, dtype, flags)
        # the early-exit solves, and one problem alone
        _close(rtt.solve(forced, torch.from_numpy(B[:, 0])), want[:, 0], dtype, "solve")
        _close(rtt.solve_batched(forced, torch.from_numpy(B)), want, dtype, "solve_batched")
        # the converted JAX solver carries the same tables
        conv = dataclasses.replace(convert(js, device="cpu"), _forced_rows=forced._forced_rows)
        _close(rtt.solve_batched_unrolled(conv, torch.from_numpy(B)), want, dtype, "convert")


def test_dax_kaczmarz_sparse_trafo_matches_jax(rng):
    """With a sparse_trafo the projection runs in the transform domain
    (TransformedRegularization, rls_tpu dax.py:50-51)."""
    with jax.enable_x64():
        kw = dict(lam=1e-4, iterations=2, iterations_inner=2, enforce_real=True,
                  enforce_positive=True)
        A, B, w, _ = _system(rng, "float64")
        A16 = np.concatenate([A, A[:, :2] * 0.5 + A[:, 2:4]], axis=1)[:, :8]
        B = A16 @ rng.normal(size=(8, P))
        jw = rt.WaveletOperator(im_shape=(8,), wavelet="haar", _dtype=jnp.float64)
        tw = rtt.WaveletOperator((8,), "haar", dtype=torch.float64, device="cpu")
        js = rt.DaxKaczmarz.create(rt.DenseOperator(jnp.asarray(A16)), sparse_trafo=jw, **kw)
        ts = rtt.DaxKaczmarz.create(rtt.DenseOperator(A16, device="cpu"), sparse_trafo=tw, **kw)
        assert isinstance(ts.reg[0], rtt.TransformedRegularization) and ts.reg[0].trafo is tw
        forced = dataclasses.replace(ts, _forced_rows=_jax_rows(js))
        got = rtt.solve_batched_unrolled(forced, torch.from_numpy(B))
        _close(got, rt.solve_batched_unrolled(js, jnp.asarray(B)), "float64", "sparse_trafo")
        # the wavelet coefficients of the result are nonnegative
        assert float(tw.mv(got.T).min()) >= -1e-12


def test_dax_kaczmarz_draws_chi2():
    """The port's draws: rows ∝ (s² + λ) over the nonzero rows, by χ²
    over many draws; a zero-energy row is never drawn; one sequence per
    outer iteration for the whole batch, repeated by the same seed."""
    rng = np.random.default_rng(11)
    A = rng.normal(size=(M, N)) * rng.uniform(0.2, 2.0, size=(M, 1))
    A[3] = 0.0
    s = rtt.DaxKaczmarz.create(rtt.DenseOperator(A, device="cpu"), lam=1e-2)
    gen = torch.Generator().manual_seed(s.seed)
    n_draw = 40000
    rows = tdax.draw_rows(s.probs, n_draw, gen)
    counts = np.bincount(rows.numpy(), minlength=M)
    assert counts[3] == 0
    p = s.probs.numpy()
    keep = p > 0
    _, pval = stats.chisquare(counts[keep], p[keep] / p[keep].sum() * n_draw)
    assert pval > 1e-3, pval
    # the solver draws from the generator its state holds: two runs of one
    # seed agree, another seed differs
    B = torch.from_numpy(A @ rng.normal(size=(N, 2)))
    x1 = rtt.solve_batched_unrolled(s, B)
    assert torch.equal(x1, rtt.solve_batched_unrolled(s, B))
    assert not torch.equal(x1, rtt.solve_batched_unrolled(dataclasses.replace(s, seed=3), B))
    # every problem of the batch visited the same rows: a column alone
    # solves to the same x as inside the batch
    torch.testing.assert_close(rtt.solve_unrolled(s, B[:, 1]), x1[:, 1], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("trafo", ["identity", "dense"])
def test_dax_constrained_matches_jax(rng, dtype, trafo):
    """The cyclic sweeps and the Lent–Censor sweep (no randomness) against
    JAX directly, batched, with weights; B the identity or a dense basis."""
    A, B, w, _ = _system(rng, dtype, positive=True)
    Bm = (np.eye(N) + 0.3 * rng.normal(size=(N, N))).astype(dtype)
    kw = dict(lam=1e-3, weights=w, iterations=3, iterations_inner=2)
    with jax.enable_x64(dtype == "float64"):
        jt = None if trafo == "identity" else rt.DenseOperator(jnp.asarray(Bm))
        tt = None if trafo == "identity" else rtt.DenseOperator(Bm, device="cpu")
        js = rt.DaxConstrained.create(rt.DenseOperator(jnp.asarray(A)), sparse_trafo=jt, **kw)
        ts = rtt.DaxConstrained.create(rtt.DenseOperator(A, device="cpu"), sparse_trafo=tt, **kw)
        _close(ts.Bnorm2, js.Bnorm2, dtype, "Bnorm2")
        want = rt.solve_batched_unrolled(js, jnp.asarray(B))
        _close(rtt.solve_batched_unrolled(ts, torch.from_numpy(B)), want, dtype, trafo)
        _close(rtt.solve_batched_unrolled(convert(js, device="cpu"), torch.from_numpy(B)), want,
               dtype, "convert")


def test_dax_recovers(rng):
    """tests/test_dax_pdhg.py:19-48 in the port, with the port's draws:
    DaxKaczmarz recovers x, with Positive keeps x ≥ 0, and DaxConstrained
    keeps min x ≥ −1e-4 (B x ≥ 0 with B = I)."""
    A = rng.normal(size=(16, 6)).astype(np.float32)
    xt = rng.normal(size=(6,)).astype(np.float32)
    op = rtt.DenseOperator(A, device="cpu")
    x = rtt.solve(rtt.DaxKaczmarz.create(op, lam=1e-6, iterations=10, iterations_inner=4),
                  torch.from_numpy(A @ xt))
    assert float(np.linalg.norm(x.numpy() - xt) / np.linalg.norm(xt)) < 0.1
    xp = np.abs(xt)
    bp = torch.from_numpy(A @ xp)
    x = rtt.solve(rtt.DaxKaczmarz.create(op, lam=1e-6, iterations=10, iterations_inner=4,
                                         enforce_positive=True, enforce_real=True), bp)
    assert float(x.min()) >= 0
    x = rtt.solve(rtt.DaxConstrained.create(op, lam=1e-6, iterations=10, iterations_inner=3), bp)
    assert float(x.min()) >= -1e-4
    assert float(np.linalg.norm(x.numpy() - xp) / np.linalg.norm(xp)) < 0.1
