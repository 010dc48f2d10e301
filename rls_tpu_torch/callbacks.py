"""Per-iteration callbacks for the host-loop driver.

PyTorch counterpart of ``rls_tpu/callbacks.py`` (reference Callbacks.jl).
Callbacks receive ``(run, iteration)`` where ``run`` is a `SolverRun`
exposing `.solution`, `.convergence` and `.state`. A step may hand the
next state tensors of the last one, so every stored value is a copy.
For a record without host callbacks use `solve_trace`.
"""

from __future__ import annotations

from typing import Callable

import torch

from .utils.misc import nrmsd

__all__ = [
    "CompareSolutionCallback",
    "StoreSolutionCallback",
    "StoreConvergenceCallback",
]


class CompareSolutionCallback:
    """cmp(ref, solution) per iteration, stored in `results`
    (reference Callbacks.jl:2-18): a float for one problem, a CPU tensor
    (one value per problem) for a batch."""

    def __init__(self, ref, cmp: Callable = nrmsd):
        self.ref = ref
        self.cmp = cmp
        self.results: list = []

    def __call__(self, run, iteration):
        v = torch.as_tensor(self.cmp(self.ref, run.solution))
        self.results.append(float(v) if v.ndim == 0 else v.detach().cpu().clone())


class StoreSolutionCallback:
    """Accumulates a copy of the solution per iteration
    (reference Callbacks.jl:20-33)."""

    def __init__(self):
        self.solutions = []

    def __call__(self, run, iteration):
        self.solutions.append(run.solution.detach().clone())


class StoreConvergenceCallback:
    """Accumulates a copy of the convergence metrics per iteration
    (reference Callbacks.jl:35-52)."""

    def __init__(self):
        self.conv_meas: dict[str, list] = {}

    def __call__(self, run, iteration):
        for key, val in run.convergence.items():
            self.conv_meas.setdefault(key, []).append(torch.as_tensor(val).detach().clone())
