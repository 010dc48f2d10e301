"""CGNR — conjugate gradient on the normal equations (AᴴA + λI)x = Aᴴb.

PyTorch counterpart of ``rls_tpu/models/solvers/cgnr.py``: ``CGNR``
(:29-163), ``_cg_normal_reorth`` (:166-228) and ``solve_cgnr_refined``
(:231-278). The batch is an explicit leading dimension: ``init`` takes b
of shape (..., m) and keeps one λ, one ``z0`` and one tolerance per
problem.

The TPU's compensated bf16 hi/lo projection (``mm_both``) of the
reorthogonalized CG has no counterpart: the card multiplies f32 natively
(with TF32 off, PyTorch's default for matmuls). The double-single TwoSum
accumulation of the refined solve is part of the algorithm and stays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ...ops.base import LinearOperator
from ..prox import L2Regularization, PositiveRegularization, RealRegularization
from ..regularization import NoNormalization, find_sink, find_sinks, normalization_factor
from .base import LinearSolver, effective_lam, prepare_operators

__all__ = ["CGNR", "CGNRState", "solve_cgnr_refined"]


@dataclasses.dataclass(frozen=True)
class CGNRState:
    x: Any
    r: Any  # current Aᴴ-residual (reference's x₀ vector)
    p: Any
    z0: Any
    lam: Any  # effective λ (base λ × normalization factor), per problem
    rel_tol: Any
    iteration: Any


def _vdot(a, b):
    """⟨a, b⟩ = Σ conj(a)·b per problem (over the last axis)."""
    return (a.conj() * b).sum(dim=-1)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _col(v, dtype):
    """A per-problem scalar shaped to broadcast against (..., n) in
    `dtype`."""
    return v.unsqueeze(-1).to(dtype)


@dataclasses.dataclass(frozen=True)
class CGNR(LinearSolver):
    A: Optional[LinearOperator]
    AHA: LinearOperator
    l2: L2Regularization
    constr: Tuple = ()
    normalize_reg: Any = NoNormalization()
    rel_tol: Any = None
    iterations: int = 10

    @classmethod
    def create(
        cls,
        A=None,
        AHA=None,
        reg=None,
        normalize_reg=NoNormalization(),
        iterations: int = 10,
        rel_tol=None,
        **_,
    ):
        """Reference ctor semantics (CGNR.jl:48-89): only an L2 term plus
        optional Real/Positive projections are allowed."""
        A_op, AHA_op = prepare_operators(A, AHA)
        regs = (
            list(reg)
            if isinstance(reg, (list, tuple))
            else ([reg] if reg is not None else [L2Regularization(0.0)])
        )
        idx = find_sink(L2Regularization, regs)
        l2 = L2Regularization(0.0) if idx is None else regs.pop(idx)
        keep = set(find_sinks(RealRegularization, regs) + find_sinks(PositiveRegularization, regs))
        constr = tuple(regs[i] for i in sorted(keep))
        rest = [r for i, r in enumerate(regs) if i not in keep]
        if rest:
            raise ValueError(
                f"CGNR does not allow additional regularization terms, found {len(rest)}"
            )
        return cls(
            A=A_op,
            AHA=AHA_op,
            l2=l2,
            constr=constr,
            normalize_reg=normalize_reg,
            rel_tol=rel_tol,
            iterations=iterations,
        )

    # -- protocol --------------------------------------------------------
    def init(self, b, x0=None) -> CGNRState:
        lead = b.shape[:-1]
        n = self.AHA.in_size
        if x0 is not None:
            if self.A is None:
                raise ValueError("providing x0 requires A to be defined")
            x = torch.broadcast_to(x0.to(b.dtype), (*lead, n)).clone()
            b = b - self.A.mv(x)
        else:
            x = b.new_zeros((*lead, n))
        r = self.A.rmv(b) if self.A is not None else b
        z0 = _norm(r)
        rdt = z0.dtype
        lam = effective_lam(self.l2, normalization_factor(self.normalize_reg, self.A, b), rdt)
        rel_tol = self.rel_tol if self.rel_tol is not None else torch.finfo(rdt).eps
        return CGNRState(
            x=x,
            r=r,
            p=r,
            z0=z0,
            lam=lam.expand(lead),
            rel_tol=torch.as_tensor(rel_tol, dtype=rdt, device=b.device).expand(lead),
            iteration=torch.zeros(lead, dtype=torch.int32, device=b.device),
        )

    def step(self, state: CGNRState) -> CGNRState:
        dt = state.p.dtype
        v = self.AHA.mv(state.p)
        zeta = _norm(state.r) ** 2
        pv = _vdot(state.p, v)
        lam = state.lam
        denom = pv + lam * _norm(state.p) ** 2
        # guarded divisions: at exact convergence r = p = 0 ⇒ ζ = denom = 0,
        # and the raw 0/0 would poison the unrolled (no-early-exit) paths;
        # with the guards the step is the identity there
        alpha = torch.where(
            zeta > 0, zeta / torch.where(denom == 0, torch.ones_like(denom), denom),
            torch.zeros_like(denom),
        )
        x = state.x + _col(alpha, dt) * state.p
        r = state.r - _col(alpha, dt) * v - _col(lam * alpha, dt) * state.p
        beta = _norm(r) ** 2 / torch.where(zeta > 0, zeta, torch.ones_like(zeta))
        p = r + _col(beta, dt) * state.p
        return dataclasses.replace(state, x=x, r=r, p=p, iteration=state.iteration + 1)

    @property
    def total_steps(self) -> int:
        # CG terminates in ≤ n steps (reference CGNR.jl caps the same way)
        return min(self.iterations, self.AHA.in_size)

    def done(self, state: CGNRState):
        converged = _norm(state.r) / state.z0 <= state.rel_tol
        return converged | (state.iteration >= self.total_steps)

    def finalize(self, state: CGNRState) -> CGNRState:
        # projections applied once at convergence (reference CGNR.jl:144-148)
        x = state.x
        for r in self.constr:
            x = r.prox(x)
        return dataclasses.replace(state, x=x)

    def convergence(self, state: CGNRState) -> dict:
        return {"residual": _norm(state.r)}


def _cg_normal_reorth(AHA, lam, rhs, iterations: int):
    """CG on (AᴴA + λ)d = rhs per problem, with FULL residual
    reorthogonalization (twice) against the normalized residuals of the
    run, which restores finite termination in f32: ≤ n steps to the
    attainable floor ~κ·ε where plain f32 CG on cond(AᴴA) ≈ 4e4 stalls
    at ~3e-2. `rhs` is (..., n), `lam` has its leading shape; the basis
    is (..., K, n) with K = min(iterations, n)."""
    n = rhs.shape[-1]
    K = min(iterations, n)
    dt = rhs.dtype
    lead = rhs.shape[:-1]

    def project(Q, r):
        coeffs = (Q.conj() @ r.unsqueeze(-1)).squeeze(-1)  # (..., K)
        return (coeffs.unsqueeze(-2) @ Q).squeeze(-2)

    def vdot(a, b):
        return _vdot(a, b).real

    z00 = vdot(rhs, rhs)
    tiny = torch.finfo(torch.float32).tiny
    qnorm = torch.sqrt(torch.clamp(z00, min=tiny))
    Q = rhs.new_zeros((*lead, K, n))
    Q[..., 0, :] = rhs / _col(qnorm, dt)
    lam_c = _col(lam, dt)
    x, r, p, zeta = torch.zeros_like(rhs), rhs, rhs, z00
    for k in range(K):
        live = (zeta > 1e-14 * z00).to(z00.dtype)
        v = AHA.mv(p) + lam_c * p
        denom = vdot(p, v)
        alpha = (zeta / torch.where(denom > 0, denom, torch.ones_like(denom))) * live
        x = x + _col(alpha, dt) * p
        r = r - _col(alpha, dt) * v
        for _ in range(2):  # full reorthogonalization, twice
            r = r - project(Q, r)
        znew = vdot(r, r)
        beta = znew / torch.where(zeta > 0, zeta, torch.ones_like(zeta))
        p = r + _col(beta, dt) * p
        qrow = r / _col(torch.sqrt(torch.clamp(znew, min=tiny)), dt)
        Q[..., min(k + 1, K - 1), :] = qrow * _col(live, dt)
        zeta = znew
    return x


def solve_cgnr_refined(solver: CGNR, b, rounds: int = 3):
    """CGNR with the reorthogonalized inner CG and iterative refinement:
    f32 accuracy on ill-conditioned normal equations. `b` is (..., m);
    returns (..., n).

    Each refinement round recomputes the TRUE normal-equation residual
    s = Aᴴ(b − A x) − λ_eff·x and solves (AᴴA + λ)d = s for the
    correction; each round contracts the error by the inner solve's
    relative accuracy (~κ·ε), so ``rounds=3`` lands at the ~1e-5 floor of
    evaluating the residual. The iterate is accumulated in double-single
    (an f32 hi/lo pair, TwoSum), so the additions across rounds never
    round at f32 ε.
    """
    if solver.A is None:
        raise ValueError("solve_cgnr_refined requires solver.A")
    state = solver.init(b)  # λ_eff (normalization) and the rhs Aᴴb
    lam = state.lam
    xh = _cg_normal_reorth(solver.AHA, lam, state.r, solver.iterations)
    xl = torch.zeros_like(xh)
    for _ in range(max(0, rounds - 1)):
        x = xh + xl
        s = solver.A.rmv(b - solver.A.mv(x)) - _col(lam, x.dtype) * x
        d = _cg_normal_reorth(solver.AHA, lam, s, solver.iterations)
        # TwoSum: xh + d exactly, the rounding captured in xl
        t = xh + d
        bb = t - xh
        err = (xh - (t - bb)) + (d - bb)
        xh, xl = t, xl + err
    x = xh + xl
    for rg in solver.constr:
        x = rg.prox(x)
    return x
