"""PDHG — Chambolle–Pock-style primal-dual solver.

PyTorch counterpart of ``rls_tpu/models/solvers/pdhg.py:39-243`` (reference
PrimalDualSolver.jl). Solves ½‖Ax − u‖² + λ R(Φx) with

  * dual data update  y₁ ← (y₁ + σ(Ax − u)) / (1 + σ)
  * dual reg update   y₂ ← prox_{σR∗}(y₂ + σ Φ x)
  * primal update     x ← x − τ(Aᴴy₁ + Φᴴy₂), then the projections

The conjugate proxes: L1 (identity Φ) → the elementwise clip to [−λ, λ];
TV with ``tv_scheme="8dir"`` → the reference's weighted sequential
8-direction projection (``prox_tv_conj_8dir``) on ``Grad8Operator``; TV
with ``tv_scheme="isotropic"`` → the same elementwise clip on the 2-plane
``GradientOperator``, which a 3-D shape or a complex operator falls back
to. The state carries b's leading batch axes: one gap, λ scale and
iteration count per problem. ``step`` computes the reference's gap
estimate, whose λ term is λ·‖x‖₁ of the primal x for both kinds;
``done`` stops on gap < eps (the fixed-iteration
``solve_batched_unrolled`` ignores it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ...ops.base import IdentityOperator, LinearOperator, as_operator
from ...ops.grad import Grad8Operator, GradientOperator
from ...utils.power_iterations import power_iterations
from ..prox import L1Regularization, PositiveRegularization, RealRegularization, TVRegularization
from ..regularization import NoNormalization, normalization_factor, sink
from .base import LinearSolver, effective_lam, split_projection_terms

__all__ = ["PDHG", "PDHGState", "prox_tv_conj_8dir", "W8", "clip_conj"]

# per-direction weights of the reference's ProxTVConj
# (PrimalDualSolver.jl:208-302): axial, diagonal, knight-move
_W8 = (
    5.0**0.5 - 2.0,  # p1, p2
    5.0**0.5 - 3.0 * 2.0**0.5 / 2.0,  # p3, p4
    (1.0 + 2.0**0.5 - 5.0**0.5) / 2.0,  # p5..p8
)
# the weight of each of the 8 planes, in plane order
W8 = (_W8[0], _W8[0], _W8[1], _W8[1], _W8[2], _W8[2], _W8[2], _W8[2])


def _lam_planes(lam, like):
    """λ (a number, or one per problem) shaped to broadcast against planes
    of shape (..., m, n)."""
    if torch.is_tensor(lam) and lam.ndim:
        return lam.reshape(*lam.shape, 1, 1)
    return torch.as_tensor(lam, dtype=like.dtype, device=like.device)


def prox_tv_conj_8dir(p, alpha, shape):
    """The reference's weighted 8-direction TV conjugate prox (ProxTVConj):
    the directions are thresholded SEQUENTIALLY — direction k's pointwise
    group norm uses the already-thresholded p₁..p_{k−1} — with
    pₖ ← wₖ·sign(pₖ)·min(‖(p₁..p₈)‖₂, α), the squares summed from plane 0
    upwards. `p` (..., 8·m·n); `alpha` a number or one per problem."""
    m, n = shape
    lead = p.shape[:-1]
    planes = list(p.reshape(*lead, 8, m, n).unbind(dim=-3))
    alpha = _lam_planes(alpha, planes[0])
    for k in range(8):
        gnorm = torch.sqrt(sum(q * q for q in planes))
        planes[k] = W8[k] * torch.sign(planes[k]) * torch.minimum(gnorm, alpha)
    return torch.stack(planes, dim=-3).reshape(*lead, -1)


def clip_conj(p, lam):
    """The elementwise projection onto the λ-ball (reference ProxL1Conj;
    the isotropic TV scheme's per-element clamp): 0 stays 0."""
    mag = p.abs()
    return torch.where(mag > lam, p / torch.clamp(mag, min=1e-30) * lam, p)


@dataclasses.dataclass(frozen=True)
class PDHGState:
    u: Any
    x: Any
    y1: Any
    y2: Any
    gap: Any
    lam_scale: Any
    iteration: Any


@dataclasses.dataclass(frozen=True)
class PDHG(LinearSolver):
    A: LinearOperator
    reg: Any
    trafo: LinearOperator
    proj: Tuple = ()
    sigma: Any = 1.0
    tau: Any = 1.0
    eps: Any = 1e-10
    normalize_reg: Any = NoNormalization()
    reg_kind: str = "l1"  # "l1" | "tv"
    tv_scheme: str = "8dir"  # "8dir" | "isotropic"
    shape: tuple = None
    iterations: int = 10

    @classmethod
    def create(
        cls,
        A,
        reg=None,
        normalize_reg=NoNormalization(),
        shape=None,
        iterations: int = 10,
        sigma=1.0,
        tau=None,
        eps=1e-10,
        enforce_real: bool = False,
        enforce_positive: bool = False,
        tv_scheme: str = "8dir",
        **_,
    ):
        """Reference ctor semantics (``rls_tpu`` :94-170); without `tau`,
        τ = 0.9 / (σ·L²) with L² the power-iteration estimate of
        ‖AᴴA + ΦᴴΦ‖."""
        A_op = as_operator(A)
        n = A_op.in_size
        dev = A_op.device
        if reg is None:
            reg = L1Regularization(1e-4)
        params, proj = split_projection_terms(reg)
        if len(params) != 1:
            raise ValueError("PDHG expects exactly one parameterized reg term")
        term = params[0]
        core = sink(term)
        if isinstance(core, TVRegularization):
            reg_kind = "tv"
            shape = tuple(shape) if shape is not None else tuple(core.shape)
            # the 8-direction scheme is strictly 2-D and real
            if tv_scheme == "8dir" and (len(shape) != 2 or A_op.dtype.is_complex):
                tv_scheme = "isotropic"
            if tv_scheme == "8dir":
                trafo = Grad8Operator(shape, A_op.dtype, device=dev)
            else:
                trafo = GradientOperator(shape, dtype=A_op.dtype, device=dev)
        elif isinstance(core, L1Regularization):
            reg_kind = "l1"
            shape = (n, 1)
            trafo = IdentityOperator(n, A_op.dtype, device=dev)
        else:
            raise ValueError("PDHG supports L1 or TV regularization")
        extra = list(proj)
        if enforce_positive and enforce_real:
            extra.append(PositiveRegularization())
        elif enforce_real:
            extra.append(RealRegularization())
        if tau is None:
            L2 = power_iterations(
                lambda v: A_op.rmv(A_op.mv(v)) + trafo.rmv(trafo.mv(v)),
                n=n, dtype=A_op.dtype, device=dev,
            )
            tau = 0.9 / (float(sigma) * float(L2))
        return cls(
            A=A_op,
            reg=term,
            trafo=trafo,
            proj=tuple(extra),
            sigma=sigma,
            tau=tau,
            eps=eps,
            normalize_reg=normalize_reg,
            reg_kind=reg_kind,
            tv_scheme=tv_scheme,
            shape=shape,
            iterations=iterations,
        )

    def init(self, b, x0=None) -> PDHGState:
        lead = b.shape[:-1]
        n = self.A.in_size
        if x0 is not None:
            x = torch.broadcast_to(x0.to(b.dtype), (*lead, n)).clone()
        else:
            x = b.new_zeros((*lead, n))
        rdt = b.real.dtype if b.is_complex() else b.dtype
        scale = normalization_factor(self.normalize_reg, self.A, b).to(rdt)
        return PDHGState(
            u=b,
            x=x,
            y1=b.new_zeros((*lead, self.A.out_size)),
            y2=b.new_zeros((*lead, self.trafo.out_size)),
            gap=0.5 * torch.linalg.vector_norm(b, dim=-1) ** 2,
            lam_scale=scale,
            iteration=torch.zeros(lead, dtype=torch.int32, device=b.device),
        )

    def _conj_prox(self, p, lam):
        if self.reg_kind == "tv" and self.tv_scheme == "8dir":
            return prox_tv_conj_8dir(p, lam, self.shape)
        return clip_conj(p, lam.unsqueeze(-1) if lam.ndim else lam)

    def step(self, state: PDHGState) -> PDHGState:
        rdt = state.gap.dtype
        dev = state.gap.device
        sigma = torch.as_tensor(self.sigma, dtype=rdt, device=dev)
        tau = torch.as_tensor(self.tau, dtype=rdt, device=dev)
        lam = effective_lam(self.reg, state.lam_scale, rdt)
        xdt = state.x.dtype

        # dual updates
        y1 = (state.y1 + sigma.to(xdt) * (self.A.mv(state.x) - state.u)) / (1.0 + sigma).to(xdt)
        y2 = self._conj_prox(state.y2 + sigma.to(xdt) * self.trafo.mv(state.x), lam)

        # primal update + constraints
        x = state.x - tau.to(xdt) * (self.A.rmv(y1) + self.trafo.rmv(y2))
        for p in self.proj:
            x = p.prox(x)

        # the primal-dual gap as the reference computes it
        # (PrimalDualSolver.jl:109)
        gap = (
            0.5 * torch.linalg.vector_norm(self.A.mv(x) - state.u, dim=-1) ** 2
            + lam * x.abs().sum(dim=-1)
            + 0.5 * torch.linalg.vector_norm(y1, dim=-1) ** 2
            + (y1.conj() * state.u).sum(dim=-1).real
        ).abs().to(rdt)
        return dataclasses.replace(
            state, x=x, y1=y1, y2=y2, gap=gap, iteration=state.iteration + 1
        )

    def done(self, state: PDHGState):
        converged = state.gap < self.eps
        return converged | (state.iteration >= self.iterations)

    def convergence(self, state: PDHGState) -> dict:
        return {"primal_dual_gap": state.gap}
