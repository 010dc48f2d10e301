"""Solvers and drivers (counterpart of rls_tpu/models/solvers)."""

from .admm import ADMM
from .base import pcg, solve, solve_batched, solve_batched_unrolled, solve_unrolled
from .cgnr import CGNR, solve_cgnr_refined
from .direct import DirectSolver, PseudoInverse
from .fista import FISTA
from .optista import OptISTA
from .pogm import POGM

__all__ = [
    "ADMM",
    "CGNR",
    "DirectSolver",
    "PseudoInverse",
    "solve_cgnr_refined",
    "FISTA",
    "OptISTA",
    "POGM",
    "pcg",
    "solve",
    "solve_batched",
    "solve_batched_unrolled",
    "solve_unrolled",
]
