"""Solvers and drivers (counterpart of rls_tpu/models/solvers)."""

from .base import solve, solve_batched, solve_batched_unrolled, solve_unrolled
from .fista import FISTA
from .optista import OptISTA
from .pogm import POGM

__all__ = [
    "FISTA",
    "OptISTA",
    "POGM",
    "solve",
    "solve_batched",
    "solve_batched_unrolled",
    "solve_unrolled",
]
