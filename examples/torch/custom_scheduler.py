"""Custom batch scheduling for multi-RHS solves.

The torch counterpart of examples/custom_scheduler.py. `solve_batched`
takes a ``scheduler``, any callable

    scheduler(solver, state, active0) -> final state

where ``state`` is the batched state of ``solver.init`` (every tensor
field carries the problem axis first) and ``active0`` the (K,) liveness
mask (see `rtt.masked_vmap_scheduler`, the default policy). Two custom
policies, both checked against the default:

  * CHUNKED: problems advance in chunks of ``c`` columns, each chunk run
    to convergence before the next starts (useful when K problems' state
    does not fit memory at once);
  * FIXED BUDGET: every problem takes exactly ``n`` steps, with no
    convergence test at all (no host read of the mask per step).

    PYTHONPATH=. python examples/torch/custom_scheduler.py [--device cpu]
"""

import dataclasses

import numpy as np
import torch

import rls_tpu_torch as rtt
from _common import example_device
from rls_tpu_torch.models.solvers.base import state_where


def _rows(field, lo, hi):
    """Problems lo:hi of a state field (a tensor, a tuple of them, or a
    field that is no tensor, kept as it is)."""
    if isinstance(field, tuple):
        return tuple(_rows(f, lo, hi) for f in field)
    return field[lo:hi] if torch.is_tensor(field) and field.ndim else field


def _cat(fields):
    first = fields[0]
    if isinstance(first, tuple):
        return tuple(_cat(list(parts)) for parts in zip(*fields))
    return torch.cat(fields) if torch.is_tensor(first) and first.ndim else first


def chunked_scheduler(c):
    """Advance problems in chunks of ``c``: chunk i runs to convergence
    (through the default policy) before chunk i + 1 starts."""

    def schedule(slv, state, active0):
        K = active0.shape[0]
        outs = []
        for lo in range(0, K, c):
            hi = min(lo + c, K)
            chunk = dataclasses.replace(
                state, **{f.name: _rows(getattr(state, f.name), lo, hi)
                          for f in dataclasses.fields(state)})
            outs.append(rtt.masked_vmap_scheduler(slv, chunk, active0[lo:hi]))
        return dataclasses.replace(
            state, **{f.name: _cat([getattr(o, f.name) for o in outs])
                      for f in dataclasses.fields(state)})

    return schedule


def fixed_budget_scheduler(n_steps):
    """Exactly ``n_steps`` steps for every problem, no convergence mask."""

    def schedule(slv, state, active0):
        for _ in range(n_steps):
            state = slv.step(state)
        return state

    return schedule


def main(dev):
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(48, 24)).astype(np.float32)).to(dev)
    X = torch.from_numpy(rng.normal(size=(24, 8)).astype(np.float32)).to(dev)
    B = A @ X  # 8 problems as columns

    solver = rtt.CGNR.create(rtt.DenseOperator(A, device=dev), reg=rtt.L2Regularization(1e-6),
                             iterations=40)

    X_default = rtt.solve_batched(solver, B)
    X_chunked = rtt.solve_batched(solver, B, scheduler=chunked_scheduler(3))
    X_budget = rtt.solve_batched(solver, B,
                                 scheduler=fixed_budget_scheduler(solver.iterations))

    def rel(x, ref):
        return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))

    err_c, err_b, err_x = rel(X_chunked, X_default), rel(X_budget, X_default), rel(X_default, X)
    print("chunked vs default:", err_c)
    print("fixed-budget vs default:", err_b)
    print("default vs truth:", err_x)
    assert err_c < 1e-5, "chunked scheduler diverged from the default policy"
    assert err_b < 1e-5, "fixed-budget scheduler diverged from the default policy"
    assert err_x < 1e-3, "solve did not converge"

    # a custom schedule can also interleave: state_where freezes any subset
    # of problems per step (the default policy's own mechanics)
    _ = state_where


if __name__ == "__main__":
    main(example_device(__doc__))
