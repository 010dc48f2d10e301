"""Deprecated-API shims.

PyTorch counterpart of ``rls_tpu/deprecated.py`` (reference
deprecated.jl), with the same three shims, warnings and error text:

* ``create_linear_solver_x(name, A, x, **kw)`` with a positional start
  vector (deprecated.jl:1): warn and forward without it; pass ``x0`` to the
  solve drivers instead.
* ``vec_reg(reg)`` (deprecated.jl:3-11): warn and return the term(s) as a
  list.
* ``ConstraintTransformedRegularization`` (deprecated.jl:14-17): removed
  upstream; raise with the same guidance.
"""

from __future__ import annotations

import warnings

from .registry import create_linear_solver as _create

__all__ = [
    "create_linear_solver_x",
    "vec_reg",
    "ConstraintTransformedRegularization",
]


def create_linear_solver_x(name, A, x, **kwargs):
    """Deprecated ctor form with a positional start vector
    (reference ``createLinearSolver(solver, A, x; kargs...)``)."""
    warnings.warn(
        "create_linear_solver_x(name, A, x, ...) is deprecated; use "
        "create_linear_solver(name, A, ...) and pass x0 to solve()",
        DeprecationWarning,
        stacklevel=2,
    )
    return _create(name, A, **kwargs)


def vec_reg(reg):
    """Deprecated ``vec(reg)`` shim: wrap a single term in a list."""
    warnings.warn(
        "vec_reg(reg) will be removed; use "
        "`reg if isinstance(reg, (list, tuple)) else [reg]` instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return list(reg) if isinstance(reg, (list, tuple)) else [reg]


def ConstraintTransformedRegularization(*args, **kwargs):
    """Removed upstream (deprecated.jl:14-17): same error text."""
    raise RuntimeError(
        "ConstraintTransformedRegularization has been removed. ADMM and "
        "SplitBregman now take the regularizer and the transform as "
        "separate inputs (reg=..., reg_trafo=...)."
    )
