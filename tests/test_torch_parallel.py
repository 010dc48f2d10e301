"""rls_tpu_torch.parallel against rls_tpu.parallel on the same numpy inputs,
at the shapes and tolerances of tests/test_sharding.py: the batch-sharded
composed solve (FISTA-L1, 1e-4), the row-sharded normal product (rtol
1e-4), the row-sharded and the 2-D batch × rows CGNR (5e-5), and the five
fused wrappers, JAX's on its 8-device CPU mesh in interpret mode, the
port's on a mesh of 8 CPU entries (its plain versions; CGNR at the port's
own bar against the JAX kernel, see FUSED). Then the port on
its own: each fused wrapper on 4 CPU shards against its unsharded call,
the rejections, a seeded randomized Kaczmarz, what `replicate` shares and
copies, and that every kernel wrapper reads the stream of its input's
card."""

import ast
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rls_tpu as rt
import rls_tpu_torch as rtt
from rls_tpu import parallel as jpar
from rls_tpu.models.solvers import solve_batched as jax_solve_batched
from rls_tpu_torch import parallel as tpar
from rls_tpu_torch.convert import convert
from rls_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")
NDEV = 8  # the conftest's virtual CPU devices


def _jmesh(shape=None, names=("batch",)):
    return jpar.make_mesh(shape=shape, axis_names=names, devices=jax.devices()[:NDEV])


def _tmesh(count=NDEV, shape=None, names=("batch",)):
    return tpar.make_mesh(shape, names, [CPU] * count)


def test_parallel_exports_the_names_of_rls_tpu():
    assert tpar.__all__ == jpar.__all__
    assert all(hasattr(tpar, n) for n in tpar.__all__)
    assert rtt.parallel is tpar


def test_batch_sharded_solve_matches(rng):
    K = NDEV * 2
    A = rng.normal(size=(12, 8)).astype(np.float32)
    B = (A @ rng.normal(size=(8, K))).astype(np.float32)
    js = rt.FISTA.create(jnp.asarray(A), reg=rt.L1Regularization(1e-4), iterations=25)
    want = np.asarray(jpar.solve_batched_sharded(js, jnp.asarray(B), _jmesh()))
    ts = convert(js, device="cpu")
    got = tpar.solve_batched_sharded(ts, torch.from_numpy(B), _tmesh())
    assert tuple(got.shape) == (8, K) and got.device == CPU
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), rtt.solve_batched(ts, torch.from_numpy(B)).numpy(),
                               rtol=0, atol=1e-4)


def test_batch_sharded_solve_takes_x0(rng):
    K = 8
    A = rng.normal(size=(12, 8)).astype(np.float32)
    B = torch.from_numpy((A @ rng.normal(size=(8, K))).astype(np.float32))
    s = rtt.FISTA.create(rtt.DenseOperator(A, device="cpu"), reg=rtt.L1Regularization(1e-4),
                         iterations=5)
    for x0 in (torch.ones(8), torch.from_numpy(rng.normal(size=(K, 8)).astype(np.float32))):
        torch.testing.assert_close(tpar.solve_batched_sharded(s, B, _tmesh(4), x0=x0),
                                   rtt.solve_batched(s, B, x0), rtol=0, atol=1e-6)


def test_row_sharded_normal_op(rng):
    m = NDEV * 16
    mat = rng.normal(size=(m, 24)).astype(np.float32)
    x = rng.normal(size=(24,)).astype(np.float32)
    jop = jpar.row_sharded_operator(mat, _jmesh(names=("rows",)), axis="rows")
    top = tpar.row_sharded_operator(mat, _tmesh(names=("rows",)), axis="rows")
    assert not isinstance(top, rtt.DenseOperator) and len(top.blocks) == NDEV
    got = top.normal(torch.from_numpy(x)).numpy()
    expected = mat.T @ (mat @ x)
    np.testing.assert_allclose(got, expected, rtol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax.jit(jop.normal)(jnp.asarray(x))), rtol=1e-4)
    y = rng.normal(size=(3, m)).astype(np.float32)
    np.testing.assert_allclose(top.mv(torch.from_numpy(x)).numpy(), mat @ x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(top.rmv(torch.from_numpy(y)).numpy(), y @ mat, rtol=1e-4,
                               atol=1e-4)


def test_row_sharded_cgnr(rng):
    m = NDEV * 8
    mat = rng.normal(size=(m, 16)).astype(np.float32)
    xt = rng.normal(size=(16,)).astype(np.float32)
    b = mat @ xt
    jop = jpar.row_sharded_operator(mat, _jmesh(names=("rows",)), axis="rows")
    js = rt.CGNR.create(jop, reg=rt.L2Regularization(1e-6), iterations=40)
    want = np.asarray(jax.jit(rt.solve)(js, jnp.asarray(b)))
    top = tpar.row_sharded_operator(mat, _tmesh(names=("rows",)), axis="rows")
    ts = rtt.CGNR.create(top, reg=rtt.L2Regularization(1e-6), iterations=40)
    got = rtt.solve(ts, torch.from_numpy(b)).numpy()
    assert np.linalg.norm(got - xt) / np.linalg.norm(xt) < 0.02
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_2d_mesh_batch_rows_cgnr(rng):
    rows_nd = NDEV // 2
    m, n, K = 16 * rows_nd, 16, 4
    mat = rng.normal(size=(m, n)).astype(np.float32)
    Bnp = (mat @ rng.normal(size=(n, K))).astype(np.float32)
    jmesh = _jmesh((2, rows_nd), ("batch", "rows"))
    jop = rt.DenseOperator(jax.device_put(
        jnp.asarray(mat), jax.NamedSharding(jmesh, jax.sharding.PartitionSpec("rows", None))))
    js = rt.CGNR.create(jop, reg=rt.L2Regularization(1e-6), iterations=30)
    Bs = jax.device_put(jnp.asarray(Bnp), jax.NamedSharding(
        jmesh, jax.sharding.PartitionSpec("rows", "batch")))
    want = np.asarray(jax.jit(jax_solve_batched)(js, Bs))
    mesh = _tmesh(shape=(2, rows_nd), names=("batch", "rows"))
    top = tpar.row_sharded_operator(mat, mesh, axis="rows")
    assert len(top.blocks) == rows_nd
    ts = rtt.CGNR.create(top, reg=rtt.L2Regularization(1e-6), iterations=30)
    got = tpar.solve_batched_sharded(ts, torch.from_numpy(Bnp), mesh)
    plain = rtt.solve_batched(
        rtt.CGNR.create(rtt.DenseOperator(mat, device="cpu"), reg=rtt.L2Regularization(1e-6),
                        iterations=30), torch.from_numpy(Bnp))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=5e-5)


def _blur(n):
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    kern = np.outer(g, g)
    return kern / kern.sum()


def _fista_tv(rng, batch):
    n = 16
    op = rt.SeparableConvOperator.from_kernel(_blur(n), im_shape=(n, n))
    reg = rt.TVRegularization(1e-3, shape=(n, n), iterations_tv=3, unroll=True)
    s = rt.FISTA.create(op, reg=reg, iterations=4, rho=0.9, rel_tol=0.0, track_residual=False)
    X = jnp.asarray(rng.normal(size=(batch, n * n)), jnp.float32)
    return s, np.array(jax.vmap(op.mv)(X).T)


def _admm_tv(rng, batch):
    n = 16
    op = rt.SeparableConvOperator.from_kernel(_blur(n), im_shape=(n, n))
    reg = rt.TVRegularization(1e-3, shape=(n, n), iterations_tv=3, unroll=True)
    s = rt.ADMM.create(op, reg=reg, iterations=3, iterations_cg=3, unroll_cg=True, rho=0.1)
    X = jnp.asarray(rng.normal(size=(batch, n * n)), jnp.float32)
    return s, np.array(jax.vmap(op.mv)(X).T)


def _cgnr(rng, batch):
    m, n = 24, 16
    A = jnp.asarray(rng.normal(size=(m, n)) / np.sqrt(n), jnp.float32)
    s = rt.CGNR.create(rt.DenseOperator(A), reg=rt.L2Regularization(1e-3), iterations=10)
    return s, np.array(A @ jnp.asarray(rng.normal(size=(n, batch)), jnp.float32))


def _pdhg(rng, batch):
    n = 16
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    g /= g.sum()
    op = rt.SeparableConvOperator.from_taps(g, g, im_shape=(n, n))
    s = rt.PDHG.create(op, reg=rt.TVRegularization(1e-3, shape=(n, n)), iterations=5)
    X = jnp.asarray(rng.normal(size=(batch, n * n)), jnp.float32)
    return s, np.array(jax.vmap(op.mv)(X).T)


def _pgm_dense(rng, batch):
    m, n = 24, 48
    A = jnp.asarray(rng.normal(size=(m, n)) / np.sqrt(m), jnp.float32)
    s = rt.FISTA.create(rt.DenseOperator(A), reg=rt.L1Regularization(1e-3), iterations=8,
                        rho=0.1, track_residual=False)
    return s, rng.normal(size=(m, batch)).astype(np.float32)


# name: (problem, the JAX wrapper's name in rls_tpu.parallel, tolerance).
# The tolerances are tests/test_sharding.py's, but for CGNR: JAX's kernel
# forms every product from bf16 hi/lo splits summed in f32, the port's
# plain version sums in float64, and its 10 steps on this 24 x 16 system
# carry the rounding to 1.4e-5 (4.8e-6 of max|x|), so CGNR keeps the
# port's own bar against the JAX kernel, 1e-5 of max|x|
# (tests/test_torch_dense.py). Sharded against unsharded the port is held
# bit for bit below.
FUSED = {
    "fista_tv": (_fista_tv, "solve_fista_tv_fused_sharded", 1e-6),
    "admm_tv": (_admm_tv, "solve_admm_tv_fused_sharded", 5e-6),
    "cgnr": (_cgnr, "solve_cgnr_fused_sharded", "1e-5 of max|x|"),
    "pdhg": (_pdhg, "solve_pdhg_fused_sharded", 1e-6),
    "pgm_dense": (_pgm_dense, "solve_pgm_dense_fused_sharded", 1e-6),
}


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_sharded_matches_jax(rng, case):
    problem, name, tol = FUSED[case]
    js, B = problem(rng, 2 * NDEV)
    want = np.asarray(getattr(jpar, name)(js, jnp.asarray(B), _jmesh(), interpret=True))
    got = getattr(tpar, name)(convert(js, device="cpu"), torch.from_numpy(B), _tmesh())
    assert tuple(got.shape) == want.shape
    if isinstance(tol, str):
        tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


# the unsharded wrapper of each sharded one
UNSHARDED = {
    "fista_tv": "solve_pgm_tv_fused",
    "admm_tv": "solve_admm_tv_fused",
    "cgnr": "solve_cgnr_fused",
    "pdhg": "solve_pdhg_fused",
    "pgm_dense": "solve_pgm_dense_fused",
}


@pytest.mark.parametrize("case", sorted(FUSED))
def test_fused_sharded_equals_unsharded_on_four_shards(rng, case):
    """Per-problem work does not depend on the batch: 4 shards of 4 give
    the unsharded call's 16 columns bit for bit."""
    problem, name, _ = FUSED[case]
    js, B = problem(rng, 16)
    ts, Bt = convert(js, device="cpu"), torch.from_numpy(B)
    got = getattr(tpar, name)(ts, Bt, _tmesh(4))
    want = getattr(rtt, UNSHARDED[case])(ts, Bt)
    assert torch.equal(got, want)
    # and through the generic entry with the same replicas
    assert torch.equal(tpar.solve_fused_sharded(getattr(rtt, UNSHARDED[case]), ts, Bt,
                                                _tmesh(4)), want)


def test_uneven_batch_raises(rng):
    js, B = _cgnr(rng, 6)
    ts, Bt = convert(js, device="cpu"), torch.from_numpy(B)
    with pytest.raises(ValueError, match="do not split evenly"):
        tpar.solve_cgnr_fused_sharded(ts, Bt, _tmesh(4))
    with pytest.raises(ValueError, match="do not split evenly"):
        tpar.solve_batched_sharded(ts, Bt, _tmesh(4))
    with pytest.raises(ValueError, match="do not split evenly"):
        tpar.shard_batch(Bt, _tmesh(4))
    with pytest.raises(ValueError, match="no axis 'rows'"):
        tpar.solve_batched_sharded(ts, Bt, _tmesh(2), axis="rows")


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()
    with pytest.raises(ValueError, match="2 axes"):
        tpar.make_mesh((2, 2), ("batch",), [CPU] * 4)
    mesh = tpar.make_mesh((2, 2), ("batch", "rows"), [CPU] * 4)
    assert mesh.shape == {"batch": 2, "rows": 2} and mesh.size == 4
    assert tpar.make_mesh(axis_names=("batch", "rows"), devices=["cpu"] * 3).shape == {
        "batch": 3, "rows": 1}


def test_shard_batch_places_contiguous_columns(rng):
    B = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    parts = tpar.shard_batch(B, _tmesh(4))
    assert [tuple(p.shape) for p in parts] == [(5, 2)] * 4
    assert torch.equal(torch.cat(parts, dim=1), B)
    assert tpar.batch_sharding(_tmesh(4)).chunks(8)[1] == slice(2, 4)


def test_seeded_randomized_kaczmarz_sharded_equals_unsharded(rng):
    A = rng.normal(size=(40, 12)).astype(np.float32)
    B = torch.from_numpy((A @ rng.normal(size=(12, 8))).astype(np.float32))
    s = rtt.Kaczmarz.create(rtt.DenseOperator(A, device="cpu"), reg=rtt.L2Regularization(1e-4),
                            iterations=6, randomized=True, sub_matrix_fraction=0.5,
                            precompute_order=True, seed=5)
    want = rtt.solve_batched(s, B)
    assert torch.equal(tpar.solve_batched_sharded(s, B, _tmesh(4)), want)
    assert torch.equal(tpar.solve_batched_sharded(s, B, _tmesh(2)), want)


def test_replicate_shares_what_is_in_place_and_keeps_shared_parts(rng):
    A = rng.normal(size=(12, 8)).astype(np.float32)
    s = rtt.CGNR.create(rtt.DenseOperator(A, device="cpu"), reg=rtt.L2Regularization(1e-3))
    r = tmesh.replicate(s, CPU)
    assert r is not s and r.A is s.A and r.AHA is s.AHA and r.AHA.A is r.A
    gen = torch.Generator().manual_seed(17)
    moved = tmesh.replicate((gen, [torch.ones(2)]), CPU)
    assert moved[0] is not gen and moved[0].initial_seed() == 17
    # a row-sharded operator inside a NormalOperator: one replica, placed
    mesh = _tmesh(4, shape=(2, 2), names=("batch", "rows"))
    top = tpar.row_sharded_operator(A, mesh, axis="rows")
    rs = rtt.CGNR.create(top, reg=rtt.L2Regularization(1e-3))
    rr = tmesh.replicate(rs, mesh.position("batch", 1))
    assert rr.AHA.A is rr.A and isinstance(rr.A, tmesh.RowShardedOperator)
    assert len(rr.A.blocks) == 2 and rr.A.devices == [CPU, CPU]
    assert len(top.placed(CPU).blocks) == 2


def test_fused_replicas_are_cached_and_pin_their_solver(rng):
    js, B = _cgnr(rng, 4)
    ts = convert(js, device="cpu")
    tmesh._FUSED_SHARDED_CACHE.clear()
    tpar.solve_cgnr_fused_sharded(ts, torch.from_numpy(B), _tmesh(2))
    (key, (pinned, replica)), = tmesh._FUSED_SHARDED_CACHE.items()
    assert pinned is ts and key[1:] == (id(ts), CPU)
    tpar.solve_cgnr_fused_sharded(ts, torch.from_numpy(B), _tmesh(2))
    assert tmesh._FUSED_SHARDED_CACHE[key][1] is replica


def test_row_sharded_cgnr_takes_the_composed_path_with_its_reason(rng):
    mat = rng.normal(size=(32, 8)).astype(np.float32)
    B = torch.from_numpy((mat @ rng.normal(size=(8, 3))).astype(np.float32))
    top = tpar.row_sharded_operator(mat, _tmesh(4, names=("rows",)), axis="rows")
    s = rtt.CGNR.create(top, reg=rtt.L2Regularization(1e-6), iterations=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = rtt.solve_batched_fast(s, B)
    msg = " ".join(str(w.message) for w in caught)
    assert "cgnr_dense: fused CGNR path requires a dense operator A" in msg
    torch.testing.assert_close(got, rtt.solve_batched_unrolled(s, B), rtol=0, atol=0)


def test_row_sharded_operator_checks_its_input(rng):
    top = tpar.row_sharded_operator(rng.normal(size=(8, 3)), _tmesh(2, names=("rows",)), "rows")
    with pytest.raises(ValueError, match="do not split evenly"):
        tpar.row_sharded_operator(np.zeros((7, 3)), _tmesh(2, names=("rows",)), "rows")
    with pytest.raises(ValueError, match="lives on|live on"):
        top.mv(torch.zeros(3, device="meta"))


def test_every_kernel_wrapper_reads_the_stream_of_its_inputs_card():
    """Each ``torch.cuda.current_stream()`` of a kernel wrapper is read
    inside ``with torch.cuda.device(...)``: the stream of the card that
    holds the input, never the current device's."""
    root = pathlib.Path(rtt.__file__).parent / "kernels"
    outside = []
    for path in sorted(root.glob("*.py")):
        tree = ast.parse(path.read_text())
        inside = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                ast.unparse(item.context_expr).startswith("torch.cuda.device(")
                for item in node.items
            ):
                inside |= {id(n) for n in ast.walk(node)}
        outside += [f"{path.name}:{n.lineno}" for n in ast.walk(tree)
                    if isinstance(n, ast.Call)
                    and ast.unparse(n.func) == "torch.cuda.current_stream"
                    and id(n) not in inside]
    assert not outside, outside


def test_initialize_multihost_single_process_is_a_noop(monkeypatch):
    import torch.distributed as dist

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    tpar.initialize_multihost()
    tpar.initialize_multihost("127.0.0.1:1", num_processes=1, process_id=0, backend="gloo")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    tpar.initialize_multihost(backend="gloo")
    assert not dist.is_initialized() and not tpar.is_multihost()
    mesh = tpar.global_mesh(devices=[CPU, CPU])
    assert mesh.ranks is None and mesh.shape == {"batch": 2}
