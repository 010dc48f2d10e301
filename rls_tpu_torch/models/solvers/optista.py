"""OptISTA — optimal ISTA (Jang, Das Gupta, Ryu 2023).

PyTorch counterpart of ``rls_tpu/models/solvers/optista.py`` (reference
OptISTA.jl). The θ schedule depends on the total iteration count: θ_N is
computed at init (:92-97, OptISTA.jl:145-149) and the last iteration takes
the √(1+8θ²) variant (:136-141). Two more image-sized carries than FISTA
(y, z). The state scalars carry b's leading batch axes, in the problem's
real dtype, as in the port's ``fista.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ...ops.base import LinearOperator
from ..regularization import NoNormalization
from .base import LinearSolver, create_args, init_scalars, theta_next

__all__ = ["OptISTA", "OptISTAState"]


@dataclasses.dataclass(frozen=True)
class OptISTAState:
    x: Any
    x0hat: Any
    y: Any
    z: Any
    z_old: Any
    rho: Any
    theta: Any
    theta_n: Any
    norm_x0: Any
    rel_res_norm: Any
    lam_scale: Any
    rel_tol: Any
    iteration: Any


@dataclasses.dataclass(frozen=True)
class OptISTA(LinearSolver):
    A: Optional[LinearOperator]
    AHA: LinearOperator
    reg: Any
    proj: Tuple = ()
    rho: Any = 1.0
    theta: Any = 1.0
    rel_tol: Any = None
    normalize_reg: Any = NoNormalization()
    iterations: int = 50
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
        verbose: bool = False,
        **_,
    ):
        return cls(
            **create_args("OptISTA", A, AHA, reg, rho),
            theta=theta,
            rel_tol=rel_tol,
            normalize_reg=normalize_reg,
            iterations=iterations,
            verbose=verbose,
        )

    def _theta_n(self, full):
        """Final θ_N of the schedule (OptISTA.jl:145-149)."""
        tn = full(self.theta)
        for _ in range(self.iterations - 1):
            tn = theta_next(tn)
        return theta_next(tn, 8.0)

    def init(self, b, x0=None) -> OptISTAState:
        x0hat, x, full, norm_x0, rel_tol, scale = init_scalars(self, b, x0)
        return OptISTAState(
            x=x,
            x0hat=x0hat,
            y=x,
            z=x,
            z_old=x,
            rho=full(self.rho),
            theta=full(self.theta),
            theta_n=self._theta_n(full),
            norm_x0=norm_x0,
            rel_res_norm=full(float("inf")),
            lam_scale=scale,
            rel_tol=rel_tol,
            iteration=torch.zeros(x0hat.shape[:-1], dtype=torch.int32, device=x0hat.device),
        )

    def step(self, state: OptISTAState) -> OptISTAState:
        # inertial parameters (OptISTA.jl:168-176)
        theta = state.theta
        tn2 = state.theta_n * state.theta_n
        gamma = 2.0 * theta / tn2 * (tn2 - 2.0 * (theta * theta) + theta)
        last = state.iteration == self.iterations - 1
        theta_new = torch.where(last, theta_next(theta, 8.0), theta_next(theta))
        alpha = (theta - 1.0) / theta_new
        beta = theta / theta_new

        # gradient step on y (OptISTA.jl:180-184)
        res = self.AHA.mv(state.x) - state.x0hat
        cdt = res.dtype

        def col(v):
            return v.unsqueeze(-1).to(cdt)

        y = state.y - col(state.rho * gamma) * res
        rel_res = torch.linalg.vector_norm(res, dim=-1) / state.norm_x0

        # proximal map (OptISTA.jl:190)
        lam_eff = self.reg.get_lam() * state.lam_scale
        y = self.reg.prox(y, state.rho * gamma * lam_eff)

        # inertia (OptISTA.jl:193-199): z = x + (y − yᵒˡᵈ)/γ;
        # x = z + α(z − zᵒˡᵈ) + β(z − x)
        z = state.x + (y - state.y) / col(gamma)
        x = col(1.0 + alpha + beta) * z - col(alpha) * state.z - col(beta) * state.x
        return dataclasses.replace(
            state,
            x=x,
            y=y,
            z=z,
            z_old=state.z,
            theta=theta_new,
            rel_res_norm=rel_res,
            iteration=state.iteration + 1,
        )

    def done(self, state: OptISTAState):
        converged = state.rel_res_norm < state.rel_tol
        return converged | (state.iteration >= self.iterations)

    def convergence(self, state: OptISTAState) -> dict:
        return {"residual": state.rel_res_norm * state.norm_x0}
