"""SplitBregman — constrained split Bregman (Goldstein & Osher Eq. 4.7).

PyTorch counterpart of ``rls_tpu/models/solvers/splitbregman.py``
(reference SplitBregman.jl): ``create`` (:70-120), ``init`` (:132-167),
``step`` (:169-240), ``_converged``, ``total_steps``, ``done`` and
``convergence`` (:242-271). An ADMM-style inner iteration (the x-update by
``pcg`` on ``AᴴA + Σᵢ ρᵢ ΦᵢᴴΦᵢ``, the z-updates with the prox scale λ/ρ,
not ADMM's λ/2ρ, and the u-updates) plus the outer Bregman update of the
right-hand side, ``β_y += Aᴴb − AᴴA x``, ``z = Φx``, ``u = 0``, taken once
``iterations_inner`` inner steps have run or the residuals have converged.
``iterations=1`` reduces to ADMM.

The batch is an explicit leading axis, as in the port's ADMM: the state
carries one ρᵢ, residual, tolerance and pair of counters per problem, and
where the JAX ``lax.cond`` takes the outer update, the port takes it per
problem by a masked select (and skips it when no problem is due).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from ...ops.base import IdentityOperator, LinearOperator, as_operator
from ..prox import L1Regularization
from ..regularization import NoNormalization, normalization_factor
from .admm import _as_tuple, _norm
from .base import (
    LinearSolver,
    _col,
    pcg,
    prepare_operators,
    split_projection_terms,
    state_where,
)

__all__ = ["SplitBregman", "SplitBregmanState"]


@dataclasses.dataclass(frozen=True)
class SplitBregmanState:
    x: Any
    y: Any  # Aᴴb
    beta_y: Any
    z: Tuple
    u: Tuple
    rho: Tuple
    rk: Tuple
    sk: Tuple
    eps_pri: Tuple
    eps_dua: Tuple
    sigma_abs: Any
    lam_scale: Any
    iteration: Any  # inner counter (starts at 1, reference :199-201)
    iter_cnt: Any  # outer Bregman counter (starts at 1)


@dataclasses.dataclass(frozen=True)
class SplitBregman(LinearSolver):
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
    iterations: int = 10  # outer Bregman iterations
    iterations_inner: int = 10
    iterations_cg: int = 10
    # masked fixed-count inner CG (pcg's unroll form)
    unroll_cg: bool = False
    # print the convergence metrics every iteration (solve_with_callbacks)
    verbose: bool = False

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
        iterations: int = 10,
        iterations_inner: int = 10,
        iterations_cg: int = 10,
        unroll_cg: bool = False,
        abs_tol=None,
        rel_tol=None,
        tol_inner=1e-5,
        verbose: bool = False,
        **_,
    ):
        """Reference ctor semantics (SplitBregman.jl): projection terms
        split off; reg and reg_trafo must match in length; the default Φ is
        the identity on AHA's device."""
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
            iterations=iterations,
            iterations_inner=iterations_inner,
            iterations_cg=iterations_cg,
            unroll_cg=unroll_cg,
            verbose=verbose,
        )

    def _composite_mv(self, rho):
        def mv(v):
            out = self.AHA.mv(v)
            for trafo, r in zip(self.reg_trafo, rho):
                out = out + _col(r.to(v.dtype)) * trafo.rmv(trafo.mv(v))
            return out

        return mv

    # -- protocol --------------------------------------------------------
    def init(self, b, x0=None) -> SplitBregmanState:
        beta_y = self.A.rmv(b) if self.A is not None else b
        lead = beta_y.shape[:-1]
        if x0 is not None:
            x = torch.broadcast_to(x0.to(beta_y.dtype), beta_y.shape).clone()
        else:
            x = torch.zeros_like(beta_y)
        rdt = beta_y.real.dtype
        dev = beta_y.device

        def full(v):
            return torch.as_tensor(v, dtype=rdt, device=dev).expand(lead)

        z = tuple(t.mv(x) for t in self.reg_trafo)
        u = tuple(torch.zeros_like(zi) for zi in z)
        nreg = len(self.reg)
        abs_tol = self.abs_tol if self.abs_tol is not None else torch.finfo(rdt).eps
        m = torch.as_tensor(float(b.shape[-1]), dtype=rdt, device=dev)
        one = torch.ones(lead, dtype=torch.int32, device=dev)
        return SplitBregmanState(
            x=x,
            y=beta_y,
            beta_y=beta_y,
            z=z,
            u=u,
            rho=tuple(full(r) for r in self.rho0),
            rk=(full(float("inf")),) * nreg,
            sk=(full(float("inf")),) * nreg,
            eps_pri=(full(0.0),) * nreg,
            eps_dua=(full(0.0),) * nreg,
            sigma_abs=(torch.sqrt(m) * full(abs_tol)).expand(lead),
            lam_scale=normalization_factor(self.normalize_reg, self.A, b).to(rdt).expand(lead),
            iteration=one,
            iter_cnt=one,
        )

    def step(self, state: SplitBregmanState) -> SplitBregmanState:
        rdt = state.sigma_abs.dtype
        rel_tol_inner = torch.as_tensor(self.tol_inner, dtype=rdt, device=state.x.device)

        # x-update (reference SplitBregman.jl:209-218)
        beta = state.beta_y
        for trafo, r, zi, ui in zip(self.reg_trafo, state.rho, state.z, state.u):
            beta = beta + _col(r.to(beta.dtype)) * trafo.rmv(zi - ui)
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

        # z/u updates and residuals (SplitBregman.jl:225-247); the prox
        # scale is λ/ρ here where ADMM's is λ/2ρ (:235)
        z_new, u_new = [], []
        rk, sk, eps_pri, eps_dua = [], [], [], []
        for i, (reg_i, trafo) in enumerate(zip(self.reg, self.reg_trafo)):
            rho_i = state.rho[i]
            z_old = state.z[i]
            phix = trafo.mv(x)
            zi = phix + state.u[i]
            lam_eff = reg_i.get_lam() * state.lam_scale
            nonzero = rho_i != 0
            zi_prox = reg_i.prox(zi, lam_eff / torch.where(nonzero, rho_i, torch.ones_like(rho_i)))
            zi = torch.where(_col(nonzero), zi_prox, zi)
            ui = state.u[i] + phix - zi

            rk.append(_norm(phix - zi))
            sk.append(rho_i * _norm(trafo.rmv(zi - z_old)))
            eps_pri.append(torch.maximum(_norm(phix), _norm(zi)))
            eps_dua.append(rho_i * _norm(trafo.rmv(ui)))
            z_new.append(zi)
            u_new.append(ui)

        state = dataclasses.replace(
            state,
            x=x,
            z=tuple(z_new),
            u=tuple(u_new),
            rk=tuple(rk),
            sk=tuple(sk),
            eps_pri=tuple(eps_pri),
            eps_dua=tuple(eps_dua),
        )

        # the outer Bregman update of the problems whose inner loop has
        # finished (SplitBregman.jl:257-267)
        do_outer = self._converged(state) | (state.iteration >= self.iterations_inner)
        if bool(do_outer.any()):
            outer = dataclasses.replace(
                state,
                beta_y=state.beta_y + state.y - self.AHA.mv(state.x),
                z=tuple(t.mv(state.x) for t in self.reg_trafo),
                u=tuple(torch.zeros_like(zi) for zi in state.z),
                iter_cnt=state.iter_cnt + 1,
                iteration=torch.zeros_like(state.iteration),
            )
            state = state_where(do_outer, outer, state)
        return dataclasses.replace(state, iteration=state.iteration + 1)

    def _converged(self, state: SplitBregmanState):
        rdt = state.sigma_abs.dtype
        rel_tol = self.rel_tol if self.rel_tol is not None else torch.finfo(rdt).eps
        rel_tol = torch.as_tensor(rel_tol, dtype=rdt, device=state.sigma_abs.device)
        ok = torch.ones_like(state.iteration, dtype=torch.bool)
        for i in range(len(self.reg)):
            ok = ok & (state.rk[i] < state.sigma_abs + rel_tol * state.eps_pri[i])
            ok = ok & (state.sk[i] < state.sigma_abs + rel_tol * state.eps_dua[i])
        return ok

    @property
    def total_steps(self) -> int:
        # step() advances ONE inner iteration; a full solve is the outer
        # Bregman loops times the inner ADMM iterations
        return self.iterations * self.iterations_inner

    def done(self, state: SplitBregmanState):
        over = (state.iteration == 1) & (state.iter_cnt > self.iterations)
        return self._converged(state) | over

    def convergence(self, state: SplitBregmanState) -> dict:
        return {
            "primal": torch.stack(state.rk, dim=-1),
            "dual": torch.stack(state.sk, dim=-1),
        }
