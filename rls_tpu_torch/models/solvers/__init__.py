"""Solvers and drivers (counterpart of rls_tpu/models/solvers)."""

from .admm import ADMM
from .base import (
    SolverRun,
    masked_vmap_scheduler,
    pcg,
    solve,
    solve_batched,
    solve_batched_unrolled,
    solve_trace,
    solve_unrolled,
    solve_with_callbacks,
    solver_convergence,
    solver_solution,
)
from .cgnr import CGNR, solve_cgnr_refined
from .dax import DaxConstrained, DaxKaczmarz
from .direct import DirectSolver, PseudoInverse
from .fista import FISTA
from .kaczmarz import Kaczmarz
from .optista import OptISTA
from .pdhg import PDHG
from .pogm import POGM
from .splitbregman import SplitBregman

__all__ = [
    "ADMM",
    "CGNR",
    "DirectSolver",
    "PseudoInverse",
    "solve_cgnr_refined",
    "DaxKaczmarz",
    "DaxConstrained",
    "FISTA",
    "Kaczmarz",
    "OptISTA",
    "PDHG",
    "POGM",
    "SplitBregman",
    "SolverRun",
    "masked_vmap_scheduler",
    "pcg",
    "solve",
    "solve_batched",
    "solve_batched_unrolled",
    "solve_trace",
    "solve_unrolled",
    "solve_with_callbacks",
    "solver_convergence",
    "solver_solution",
]
