"""ADMM — multi-term consensus ADMM with a CG x-update and ρ adaptation.

PyTorch counterpart of ``rls_tpu/models/solvers/admm.py`` (reference
ADMM.jl): ``ADMM.create`` and ``init`` (:71-174), ``step`` (:176-260),
``_converged``, ``done`` and ``convergence`` (:262-284). The CG matvec is
``AᴴA x + Σᵢ ρᵢ ΦᵢᴴΦᵢ x`` with the per-problem ρᵢ of the state, so
``vary_rho`` ("balance", "PnP") needs no operator rebuild. The inner solve
is ``pcg``: its masked form with ``unroll_cg=True``, its early-exit form
otherwise.

The state carries b's leading batch axes: one ρᵢ, residual, tolerance and
iteration count per problem; ``z`` and ``u`` are tuples with one tensor
per term.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ...ops.base import IdentityOperator, LinearOperator, as_operator
from ..prox import L1Regularization
from ..regularization import NoNormalization, normalization_factor
from .base import LinearSolver, _col, pcg, prepare_operators, split_projection_terms

__all__ = ["ADMM", "ADMMState"]


@dataclasses.dataclass(frozen=True)
class ADMMState:
    x: Any
    x_old: Any
    beta_y: Any  # Aᴴb
    z: Tuple
    u: Tuple
    rho: Tuple
    rk: Tuple
    sk: Tuple
    eps_pri: Tuple
    eps_dua: Tuple
    delta: Tuple
    sigma_abs: Any
    lam_scale: Any
    iteration: Any


def _as_tuple(x, n):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return tuple(x for _ in range(n))


def _norm(v):
    """Per-problem 2-norm over the last axis."""
    return torch.linalg.vector_norm(v, dim=-1)


@dataclasses.dataclass(frozen=True)
class ADMM(LinearSolver):
    A: Optional[LinearOperator]
    AHA: LinearOperator
    reg: Tuple
    reg_trafo: Tuple
    proj: Tuple = ()
    rho0: Tuple = (0.1,)
    precon: Optional[Callable] = None
    normalize_reg: Any = NoNormalization()
    abs_tol: Any = None
    rel_tol: Any = None
    tol_inner: Any = 1e-5
    vary_rho: str = "none"
    iterations: int = 10
    iterations_cg: int = 10
    # masked fixed-count inner CG (pcg's unroll form)
    unroll_cg: bool = False

    @classmethod
    def create(
        cls,
        A=None,
        AHA=None,
        reg=None,
        reg_trafo=None,
        precon=None,
        normalize_reg=NoNormalization(),
        rho=1e-1,
        vary_rho: str = "none",
        iterations: int = 10,
        iterations_cg: int = 10,
        unroll_cg: bool = False,
        abs_tol=None,
        rel_tol=None,
        tol_inner=1e-5,
        **_,
    ):
        """Reference ctor semantics (ADMM.jl:80-163): projection terms split
        off; reg and reg_trafo must match in length; the default Φ is the
        identity on AHA's device."""
        if vary_rho not in ("none", "balance", "PnP"):
            raise ValueError(f"unknown vary_rho {vary_rho!r}")
        A_op, AHA_op = prepare_operators(A, AHA)
        if reg is None:
            reg = L1Regularization(0.0)
        params, proj = split_projection_terms(reg)
        n = AHA_op.in_size
        if reg_trafo is None:
            reg_trafo = [IdentityOperator(n, AHA_op.dtype, device=AHA_op.device) for _ in params]
        elif not isinstance(reg_trafo, (list, tuple)):
            reg_trafo = [reg_trafo]
        reg_trafo = [as_operator(t, device=AHA_op.device) for t in reg_trafo]
        if len(params) != len(reg_trafo):
            raise ValueError("reg and reg_trafo must have the same length")
        rho0 = _as_tuple(rho, len(params))
        return cls(
            A=A_op,
            AHA=AHA_op,
            reg=tuple(params),
            reg_trafo=tuple(reg_trafo),
            proj=proj,
            rho0=tuple(float(r) for r in rho0),
            precon=precon,
            normalize_reg=normalize_reg,
            abs_tol=abs_tol,
            rel_tol=rel_tol,
            tol_inner=tol_inner,
            vary_rho=vary_rho,
            iterations=iterations,
            iterations_cg=iterations_cg,
            unroll_cg=unroll_cg,
        )

    def _composite_mv(self, rho):
        def mv(v):
            out = self.AHA.mv(v)
            for trafo, r in zip(self.reg_trafo, rho):
                out = out + _col(r.to(v.dtype)) * trafo.rmv(trafo.mv(v))
            return out

        return mv

    # -- protocol --------------------------------------------------------
    def init(self, b, x0=None) -> ADMMState:
        beta_y = self.A.rmv(b) if self.A is not None else b
        lead = beta_y.shape[:-1]
        if x0 is not None:
            x = torch.broadcast_to(x0.to(beta_y.dtype), beta_y.shape).clone()
        else:
            x = torch.zeros_like(beta_y)
        rdt = beta_y.real.dtype

        def full(v):
            return torch.as_tensor(v, dtype=rdt, device=beta_y.device).expand(lead)

        z = tuple(t.mv(x) for t in self.reg_trafo)
        u = tuple(torch.zeros_like(zi) for zi in z)
        nreg = len(self.reg)
        abs_tol = self.abs_tol if self.abs_tol is not None else torch.finfo(rdt).eps
        m = torch.as_tensor(float(b.shape[-1]), dtype=rdt, device=beta_y.device)
        abs_tol = torch.as_tensor(abs_tol, dtype=rdt, device=beta_y.device)
        return ADMMState(
            x=x,
            x_old=x,
            beta_y=beta_y,
            z=z,
            u=u,
            rho=tuple(full(r) for r in self.rho0),
            rk=(full(float("inf")),) * nreg,
            sk=(full(float("inf")),) * nreg,
            eps_pri=(full(0.0),) * nreg,
            eps_dua=(full(0.0),) * nreg,
            delta=(full(float("inf")),) * nreg,
            sigma_abs=(torch.sqrt(m) * abs_tol).expand(lead),
            lam_scale=normalization_factor(self.normalize_reg, self.A, b).to(rdt).expand(lead),
            iteration=torch.zeros(lead, dtype=torch.int32, device=beta_y.device),
        )

    def step(self, state: ADMMState) -> ADMMState:
        rdt = state.sigma_abs.dtype
        rel_tol_inner = torch.as_tensor(self.tol_inner, dtype=rdt, device=state.x.device)

        # 1. x-update: argmin ½‖Ax−b‖² + Σ ρᵢ/2‖Φᵢx + uᵢ − zᵢ‖² via CG
        # (reference ADMM.jl:234-244)
        beta = state.beta_y
        for trafo, r, zi, ui in zip(self.reg_trafo, state.rho, state.z, state.u):
            beta = beta + _col(r.to(beta.dtype)) * trafo.rmv(zi - ui)
        x_old = state.x
        x = pcg(
            self._composite_mv(state.rho),
            beta,
            state.x,
            maxiter=self.iterations_cg,
            reltol=rel_tol_inner,
            precon=self.precon,
            unroll=self.unroll_cg,
        )
        for p in self.proj:
            x = p.prox(x)

        # 2./3. per-term z/u updates, residuals and ρ adaptation
        # (reference ADMM.jl:251-309)
        z_new, u_new, rho_new = [], [], []
        rk, sk, eps_pri, eps_dua, delta = [], [], [], [], []
        dx_norm = _norm(x - x_old)
        for i, (reg_i, trafo) in enumerate(zip(self.reg, self.reg_trafo)):
            rho_i = state.rho[i]
            z_old = state.z[i]
            u_old = state.u[i]

            phix = trafo.mv(x)
            zi = phix + u_old
            lam_eff = reg_i.get_lam() * state.lam_scale
            nonzero = rho_i != 0
            zi_prox = reg_i.prox(
                zi, lam_eff / (2.0 * torch.where(nonzero, rho_i, torch.ones_like(rho_i)))
            )
            zi = torch.where(_col(nonzero), zi_prox, zi)

            ui = u_old + phix - zi

            delta_i = dx_norm + _norm(zi - z_old) + _norm(ui - u_old)
            sk_i = rho_i * _norm(trafo.rmv(zi - z_old))
            eps_pri_i = torch.maximum(_norm(phix), _norm(zi))
            rk_i = _norm(phix - zi)
            eps_dua_i = rho_i * _norm(trafo.rmv(ui))

            # ρ adaptation (Boyd :balance / Chang :PnP, ADMM.jl:302-309)
            if self.vary_rho == "balance":
                up = rk_i / eps_pri_i > 10.0 * sk_i / eps_dua_i
                down = sk_i / eps_dua_i > 10.0 * rk_i / eps_pri_i
                rho_i2 = torch.where(up, rho_i * 2, torch.where(down, rho_i / 2, rho_i))
                ui = torch.where(_col(up), ui / 2, torch.where(_col(down), ui * 2, ui))
                rho_i = rho_i2
            elif self.vary_rho == "PnP":
                up = delta_i / state.delta[i] > 0.9
                rho_i = torch.where(up, rho_i * 2, rho_i)
                ui = torch.where(_col(up), ui / 2, ui)

            z_new.append(zi)
            u_new.append(ui)
            rho_new.append(rho_i)
            rk.append(rk_i)
            sk.append(sk_i)
            eps_pri.append(eps_pri_i)
            eps_dua.append(eps_dua_i)
            delta.append(delta_i)

        return dataclasses.replace(
            state,
            x=x,
            x_old=x_old,
            z=tuple(z_new),
            u=tuple(u_new),
            rho=tuple(rho_new),
            rk=tuple(rk),
            sk=tuple(sk),
            eps_pri=tuple(eps_pri),
            eps_dua=tuple(eps_dua),
            delta=tuple(delta),
            iteration=state.iteration + 1,
        )

    def _converged(self, state: ADMMState):
        rdt = state.sigma_abs.dtype
        rel_tol = self.rel_tol if self.rel_tol is not None else torch.finfo(rdt).eps
        rel_tol = torch.as_tensor(rel_tol, dtype=rdt, device=state.sigma_abs.device)
        ok = torch.ones_like(state.iteration, dtype=torch.bool)
        for i in range(len(self.reg)):
            ok = ok & (state.rk[i] < state.sigma_abs + rel_tol * state.eps_pri[i])
            ok = ok & (state.sk[i] < state.sigma_abs + rel_tol * state.eps_dua[i])
        return ok

    def done(self, state: ADMMState):
        return self._converged(state) | (state.iteration >= self.iterations)

    def convergence(self, state: ADMMState) -> dict:
        return {
            "primal": torch.stack(state.rk, dim=-1),
            "dual": torch.stack(state.sk, dim=-1),
        }
