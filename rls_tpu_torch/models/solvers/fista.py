"""FISTA — accelerated proximal gradient with Nesterov momentum and
optional gradient restart.

PyTorch counterpart of ``rls_tpu/models/solvers/fista.py`` (reference
FISTA.jl), both restart modes included (:162-168). The state scalars are
kept in the problem's real dtype, as ``init`` does there (:113-133), and
carry b's leading batch axes: one θ, ρ, residual and iteration count per
problem.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ...ops.base import LinearOperator
from ..regularization import NoNormalization
from .base import LinearSolver, create_args, init_scalars, theta_next

__all__ = ["FISTA", "FISTAState"]


@dataclasses.dataclass(frozen=True)
class FISTAState:
    x: Any
    x0hat: Any  # Aᴴb
    x_old: Any
    rho: Any
    theta: Any
    theta_old: Any
    norm_x0: Any
    rel_res_norm: Any
    lam_scale: Any
    rel_tol: Any
    iteration: Any


def _vdot_real(a, b):
    """Re ⟨a, b⟩ per problem (over the last axis)."""
    return (a.conj() * b).sum(dim=-1).real


@dataclasses.dataclass(frozen=True)
class FISTA(LinearSolver):
    A: Optional[LinearOperator]
    AHA: LinearOperator
    reg: Any
    proj: Tuple = ()
    rho: Any = 1.0
    theta: Any = 1.0
    rel_tol: Any = None
    normalize_reg: Any = NoNormalization()
    iterations: int = 50
    restart: str = "none"
    # skip the per-iteration ‖res‖ reduction (fixed-iteration runs, where
    # early exit is disabled anyway)
    track_residual: bool = True
    # print the convergence metrics every iteration (solve_with_callbacks)
    verbose: bool = False

    @classmethod
    def create(
        cls,
        A=None,
        AHA=None,
        reg=None,
        normalize_reg=NoNormalization(),
        iterations: int = 50,
        rho=None,
        theta=1.0,
        rel_tol=None,
        restart: str = "none",
        track_residual: bool = True,
        verbose: bool = False,
        **_,
    ):
        """Reference ctor semantics (FISTA.jl:57-92): exactly one
        parameterized term plus any number of projections; default step size
        rho = 0.95 / power_iterations(AHA)."""
        if restart not in ("none", "gradient", "gradient_mapping"):
            raise ValueError(f"unknown restart mode {restart!r}")
        return cls(
            **create_args("FISTA", A, AHA, reg, rho),
            theta=theta,
            rel_tol=rel_tol,
            normalize_reg=normalize_reg,
            iterations=iterations,
            restart=restart,
            track_residual=track_residual,
            verbose=verbose,
        )

    # -- protocol --------------------------------------------------------
    def init(self, b, x0=None) -> FISTAState:
        x0hat, x, full, norm_x0, rel_tol, scale = init_scalars(self, b, x0)
        return FISTAState(
            x=x,
            x0hat=x0hat,
            x_old=torch.zeros_like(x),
            rho=full(self.rho),
            theta=full(self.theta),
            theta_old=full(self.theta),
            norm_x0=norm_x0,
            rel_res_norm=full(float("inf")),
            lam_scale=scale,
            rel_tol=rel_tol,
            iteration=torch.zeros(x0hat.shape[:-1], dtype=torch.int32, device=x0hat.device),
        )

    def step(self, state: FISTAState) -> FISTAState:
        # momentum / Nesterov (reference FISTA.jl:144-148)
        alpha = (state.theta_old - 1.0) / state.theta
        x_mom = state.x + alpha.unsqueeze(-1).to(state.x.dtype) * (state.x - state.x_old)
        x_prev = state.x

        # residual + gradient step (FISTA.jl:152-154)
        res = self.AHA.mv(x_mom) - state.x0hat
        x = x_mom - state.rho.unsqueeze(-1).to(res.dtype) * res
        if self.track_residual:
            rel_res = torch.linalg.vector_norm(res, dim=-1) / state.norm_x0
        else:
            rel_res = state.rel_res_norm

        # proximal map (FISTA.jl:164-168)
        lam_eff = self.reg.get_lam() * state.lam_scale
        x = self.reg.prox(x, state.rho * lam_eff)
        for p in self.proj:
            x = p.prox(x)

        # gradient restart (FISTA.jl:171-176): "gradient" is the
        # reference's raw-∇f test; "gradient_mapping" the O'Donoghue–Candès
        # test on the proximal gradient mapping (y − x⁺)·(x⁺ − x) > 0
        theta = state.theta
        if self.restart == "gradient":
            obtuse = _vdot_real(res, x - x_prev) > 0
            theta = torch.where(obtuse, torch.ones_like(theta), theta)
        elif self.restart == "gradient_mapping":
            obtuse = _vdot_real(x_mom - x, x - x_prev) > 0
            theta = torch.where(obtuse, torch.ones_like(theta), theta)

        theta_old = theta
        theta_new = theta_next(theta_old)
        return dataclasses.replace(
            state,
            x=x,
            x_old=x_prev,
            theta=theta_new,
            theta_old=theta_old,
            rel_res_norm=rel_res,
            iteration=state.iteration + 1,
        )

    def done(self, state: FISTAState):
        converged = state.rel_res_norm < state.rel_tol
        return converged | (state.iteration >= self.iterations)

    def convergence(self, state: FISTAState) -> dict:
        return {"residual": state.rel_res_norm * state.norm_x0}
