"""POGM — proximal optimized gradient method (Taylor et al. 2017, Kim &
Fessler 2018) with optional gradient restart and σ decrease.

PyTorch counterpart of ``rls_tpu/models/solvers/pogm.py`` (reference
POGM.jl): the inertial parameters (:142-159), the inertia steps
(:161-170), and the gradient restart on the running w plane with
γ = ρ(1+α+β) and σ ← σ·sigma_fac (:178-190). As there, any ``restart``
other than ``"none"`` turns on the last iteration's √(1+8θ²) variant,
and only ``"gradient"`` runs the restart test. The state scalars carry
b's leading batch axes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ...ops.base import LinearOperator
from ..regularization import NoNormalization
from .base import LinearSolver, create_args, init_scalars, theta_next
from .fista import _vdot_real

__all__ = ["POGM", "POGMState"]


@dataclasses.dataclass(frozen=True)
class POGMState:
    x: Any
    x0hat: Any
    y: Any
    z: Any
    w: Any
    rho: Any
    theta: Any
    gamma: Any
    sigma: Any
    norm_x0: Any
    rel_res_norm: Any
    lam_scale: Any
    rel_tol: Any
    iteration: Any


@dataclasses.dataclass(frozen=True)
class POGM(LinearSolver):
    A: Optional[LinearOperator]
    AHA: LinearOperator
    reg: Any
    proj: Tuple = ()
    rho: Any = 1.0
    theta: Any = 1.0
    sigma_fac: Any = 1.0
    rel_tol: Any = None
    normalize_reg: Any = NoNormalization()
    iterations: int = 50
    restart: str = "none"
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
        sigma_fac=1.0,
        rel_tol=None,
        restart: str = "none",
        verbose: bool = False,
        **_,
    ):
        return cls(
            **create_args("POGM", A, AHA, reg, rho),
            theta=theta,
            sigma_fac=sigma_fac,
            rel_tol=rel_tol,
            normalize_reg=normalize_reg,
            iterations=iterations,
            restart=restart,
            verbose=verbose,
        )

    def init(self, b, x0=None) -> POGMState:
        x0hat, x, full, norm_x0, rel_tol, scale = init_scalars(self, b, x0)
        zeros = torch.zeros_like(x)
        return POGMState(
            x=x,
            x0hat=x0hat,
            y=zeros,
            z=zeros,
            w=zeros,
            rho=full(self.rho),
            theta=full(self.theta),
            gamma=full(1.0),
            sigma=full(1.0),
            norm_x0=norm_x0,
            rel_res_norm=full(float("inf")),
            lam_scale=scale,
            rel_tol=rel_tol,
            iteration=torch.zeros(x0hat.shape[:-1], dtype=torch.int32, device=x0hat.device),
        )

    def step(self, state: POGMState) -> POGMState:
        # gradient step (POGM.jl:180-183)
        res = self.AHA.mv(state.x) - state.x0hat
        cdt = res.dtype

        def col(v):
            return v.unsqueeze(-1).to(cdt)

        y = state.x - col(state.rho) * res
        rel_res = torch.linalg.vector_norm(res, dim=-1) / state.norm_x0

        # inertial parameters (POGM.jl:189-202)
        theta_old = state.theta
        if self.restart != "none":
            last = state.iteration == self.iterations - 1
            theta = torch.where(last, theta_next(theta_old, 8.0), theta_next(theta_old))
        else:
            theta = theta_next(theta_old)
        alpha = (theta_old - 1.0) / theta
        beta = state.sigma * theta_old / theta
        if self.restart == "gradient":
            gamma = state.rho * (1.0 + alpha + beta)
        else:
            gamma = state.rho * (2.0 * theta_old + theta - 1.0) / theta

        # inertia steps (POGM.jl:205-213)
        coupling = state.rho * alpha / state.gamma
        z = (
            col(1.0 + alpha + beta) * y
            - col(alpha) * state.y
            - col(beta + coupling) * state.x
            + col(coupling) * state.z
        )

        # proximal map (POGM.jl:216-219)
        lam_eff = self.reg.get_lam() * state.lam_scale
        x = self.reg.prox(z, gamma * lam_eff)
        for p in self.proj:
            x = p.prox(x)

        # gradient restart (POGM.jl:222-232)
        sigma = state.sigma
        w = state.w
        if self.restart == "gradient":
            w = w + y + col(state.rho / gamma) * (x - z)
            crit = (_vdot_real(w, x) - _vdot_real(w, z)) / gamma - _vdot_real(w, res)
            fire = crit < 0
            one = torch.ones_like(sigma)
            sigma = torch.where(fire, one, sigma * self.sigma_fac)
            theta = torch.where(fire, one, theta)
            w = col(state.rho / gamma) * (z - x) - y

        return dataclasses.replace(
            state,
            x=x,
            y=y,
            z=z,
            w=w,
            theta=theta,
            gamma=gamma,
            sigma=sigma,
            rel_res_norm=rel_res,
            iteration=state.iteration + 1,
        )

    def done(self, state: POGMState):
        converged = state.rel_res_norm < state.rel_tol
        return converged | (state.iteration >= self.iterations)

    def convergence(self, state: POGMState) -> dict:
        return {"residual": state.rel_res_norm * state.norm_x0}
