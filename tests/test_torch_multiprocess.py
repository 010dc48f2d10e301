"""Two processes on ``torch.distributed`` (gloo), the counterpart of
tests/test_multiprocess.py: each starts the process group with
``initialize_multihost``, builds ``global_mesh`` over its 2 CPU entries (4
in all, rank by rank), and runs the batch-sharded CGNR on the 16 × 16
system with 4 columns: each process solves its own 2 columns and the
result is gathered, so both end with the whole solve, within 1e-3 of the
truth as in the JAX test, and equal to the one-process solve over 4
entries."""

import os
import socket
import subprocess
import sys
import textwrap

_WORKER = textwrap.dedent(
    """
    import sys
    rank, port = int(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    import rls_tpu_torch as rtt
    from rls_tpu_torch.parallel import (
        global_mesh, initialize_multihost, is_multihost, make_mesh, shard_batch,
        solve_batched_sharded)

    initialize_multihost(f"127.0.0.1:{{port}}", 2, rank, backend="gloo")
    assert is_multihost(), "expected a world of 2"
    cpu = torch.device("cpu")
    mesh = global_mesh(devices=[cpu, cpu])
    assert mesh.size == 4 and list(mesh.ranks) == [0, 0, 1, 1], mesh
    rng = np.random.default_rng(0)
    m = 16
    # well-conditioned system: I + small perturbation
    A = (np.eye(m) + 0.1 * rng.normal(size=(m, m))).astype(np.float32)
    X = rng.normal(size=(m, 4)).astype(np.float32)
    B = torch.from_numpy(A @ X)
    assert [tuple(p.shape) for p in shard_batch(B, mesh)] == [(m, 1), (m, 1)]
    s = rtt.CGNR.create(rtt.DenseOperator(A, device="cpu"),
                        reg=rtt.L2Regularization(1e-8), iterations=60)
    got = solve_batched_sharded(s, B, mesh)
    assert tuple(got.shape) == (m, 4), got.shape
    err = float(np.linalg.norm(got.numpy() - X) / np.linalg.norm(X))
    assert err < 1e-3, err
    # the columns in order: the one-process solve over 4 entries
    assert torch.equal(got, solve_batched_sharded(s, B, make_mesh(devices=[cpu] * 4)))
    dist.destroy_process_group()
    print(f"proc{{rank}} OK err={{err:.2e}}", flush=True)
    """
)


def test_two_process_distributed_solve(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(repo=os.path.dirname(os.path.dirname(__file__))))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{i} failed:\n{out[-3000:]}"
        assert f"proc{i} OK" in out
