"""Solver registry, applicability rules, and the `create_linear_solver`
factory with kwarg filtering.

PyTorch counterpart of ``rls_tpu/registry.py`` (reference
RegularizedLeastSquares.jl:210-294): the taxonomy tuples,
`linear_solver_list` and `linear_solver_list_real` (:213-220),
`is_applicable` (:223-256), `applicable_solver_list` (:265),
`create_linear_solver` and `filter_kwargs` with a warning for dropped
keys (:267-294), and the `deinit` shim. A complex problem builds the
solver itself: the port has no split-real twin (complex tensors run on the
card).
"""

from __future__ import annotations

import inspect
import warnings
from typing import Type, Union

from .models.prox import L2Regularization
from .models.regularization import ParameterizedRegularization, Regularization, find_sinks
from .models.solvers import (
    ADMM,
    CGNR,
    FISTA,
    PDHG,
    POGM,
    DaxConstrained,
    DaxKaczmarz,
    DirectSolver,
    Kaczmarz,
    OptISTA,
    PseudoInverse,
    SplitBregman,
)
from .models.solvers.base import LinearSolver

__all__ = [
    "linear_solver_list",
    "linear_solver_list_real",
    "solver_by_name",
    "is_applicable",
    "applicable_solver_list",
    "create_linear_solver",
    "filter_kwargs",
    "deinit",
    "ROW_ACTION_SOLVERS",
    "PROXIMAL_GRADIENT_SOLVERS",
    "PRIMAL_DUAL_SOLVERS",
    "KRYLOV_SOLVERS",
    "DIRECT_SOLVERS",
]

# solver taxonomy (reference abstract subtypes, RegularizedLeastSquares.jl:135-148)
ROW_ACTION_SOLVERS = (Kaczmarz,)
DAX_SOLVERS = (DaxKaczmarz, DaxConstrained)  # disabled upstream; opt-in here
KRYLOV_SOLVERS = (CGNR,)
PROXIMAL_GRADIENT_SOLVERS = (FISTA, OptISTA, POGM)
PRIMAL_DUAL_SOLVERS = (ADMM, SplitBregman, PDHG)
DIRECT_SOLVERS = (DirectSolver, PseudoInverse)

_ALL = (
    ROW_ACTION_SOLVERS
    + KRYLOV_SOLVERS
    + PROXIMAL_GRADIENT_SOLVERS
    + PRIMAL_DUAL_SOLVERS
    + DIRECT_SOLVERS
)

# the Dax solvers are constructible by name but not in the default list
# (reference linearSolverListReal vs linearSolverList)
_EXTRA = DAX_SOLVERS


def linear_solver_list() -> list[Type[LinearSolver]]:
    """All available solvers (reference linearSolverList)."""
    return list(_ALL)


def linear_solver_list_real() -> list[Type[LinearSolver]]:
    """The full solver list, the upstream-disabled extras included
    (reference linearSolverListReal)."""
    return list(_ALL) + list(_EXTRA)


def deinit(solver: LinearSolver) -> None:
    """Reference API shim (`deinit`): frees per-solve buffers there. A
    state here belongs to the caller and goes with its last reference, so
    there is nothing to release."""
    return None


def solver_by_name(name: str) -> Type[LinearSolver]:
    for cls in _ALL + _EXTRA:
        if cls.__name__.lower() == name.lower():
            return cls
    raise KeyError(f"unknown solver {name!r}; available: "
                   f"{[c.__name__ for c in _ALL + _EXTRA]}")


def _as_reg_list(reg) -> list[Regularization]:
    if isinstance(reg, Regularization):
        return [reg]
    return list(reg)


def is_applicable(solver_type, reg) -> bool:
    """Category applicability rules
    (reference RegularizedLeastSquares.jl:223-256)."""
    if isinstance(solver_type, LinearSolver):
        solver_type = type(solver_type)
    regs = _as_reg_list(reg)
    n_param = len(find_sinks(ParameterizedRegularization, regs))
    n_l2 = len(find_sinks(L2Regularization, regs))
    if solver_type in ROW_ACTION_SOLVERS:
        return n_param <= 2 and n_l2 == 1
    if solver_type in PROXIMAL_GRADIENT_SOLVERS:
        return n_param == 1
    if solver_type in PRIMAL_DUAL_SOLVERS:
        return True
    if solver_type in KRYLOV_SOLVERS or solver_type in DIRECT_SOLVERS:
        # only an L2 sink (plus projections) is supported
        return n_param == n_l2 and n_l2 <= 1
    return False


def applicable_solver_list(reg) -> list[Type[LinearSolver]]:
    return [s for s in _ALL if is_applicable(s, reg)]


def filter_kwargs(solver_type: Type[LinearSolver], kwargs, kwarg_warning=True):
    """Keep only kwargs accepted by `solver_type.create`; warn about the
    rest (reference filterKwargs, RegularizedLeastSquares.jl:267-278)."""
    keys = set(inspect.signature(solver_type.create).parameters) - {"cls", "A", "kwargs", "_"}
    kept = {k: v for k, v in kwargs.items() if k in keys}
    dropped = [k for k in kwargs if k not in keys]
    if dropped and kwarg_warning:
        warnings.warn(
            f"The following arguments were passed but filtered out: "
            f"{', '.join(dropped)}. Please watch closely if this introduces "
            f"unexpected behaviour in your code."
        )
    return kept


def create_linear_solver(
    solver: Union[str, Type[LinearSolver]],
    A=None,
    *,
    AHA=None,
    kwarg_warning: bool = True,
    **kwargs,
) -> LinearSolver:
    """Factory (reference createLinearSolver, :288-294). `solver` may be a
    class or its name (case-insensitive)."""
    if isinstance(solver, str):
        solver = solver_by_name(solver)
    kept = filter_kwargs(solver, kwargs, kwarg_warning)
    if AHA is not None:
        kept["AHA"] = AHA
    return solver.create(A, **kept)
