"""Direct solvers: the regularized normal-equation solve and the SVD
pseudoinverse.

PyTorch counterpart of ``rls_tpu/models/solvers/direct.py``:
``DirectSolver`` solves (AᴴA + λI)x = Aᴴb, ``PseudoInverse`` applies the
Tikhonov-filtered SVD pinv x = V · diag(S/(S²+λ)) · Uᴴ b with the SVD
taken at construction (reference Direct.jl:101-169).

``torch.linalg.svd`` takes the place of the TPU's one-sided Jacobi SVD.
So that the same inputs take the same route as in ``rls_tpu``,
DirectSolver takes the SVD route wherever ``rls_tpu`` would run its Jacobi
SVD (``_use_jacobi``, ``rls_tpu/models/prox.py:283-297``): a real float32
matrix with ``svd_method="jacobi"``, or with ``"auto"`` and
min(m, n) ≤ 128. Otherwise it builds the regularized Gram and calls
``torch.linalg.solve``. PseudoInverse always takes the SVD route.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ...ops.base import LinearOperator, as_operator
from ..prox import L2Regularization
from ..regularization import NoNormalization, find_sink, normalization_factor
from .base import LinearSolver, effective_lam, split_projection_terms

__all__ = ["DirectSolver", "PseudoInverse"]

# the largest min(m, n) that "auto" sends to the SVD route
SVD_AUTO_MAX = 128


def _split_l2(reg):
    regs = (
        list(reg)
        if isinstance(reg, (list, tuple))
        else ([reg] if reg is not None else [L2Regularization(0.0)])
    )
    idx = find_sink(L2Regularization, regs)
    l2 = L2Regularization(0.0) if idx is None else regs.pop(idx)
    params, proj = split_projection_terms(regs)
    if params:
        raise ValueError(
            "direct solvers do not allow for more than one L2 regularization "
            f"term, found {len(params)} additional terms"
        )
    return l2, proj


def _use_svd(Ad, method: str) -> bool:
    """Where ``rls_tpu`` runs its Jacobi SVD: real float32, and
    ``"jacobi"``, or ``"auto"`` with min(m, n) ≤ SVD_AUTO_MAX."""
    if Ad.dtype != torch.float32:
        return False
    return method == "jacobi" or (method == "auto" and min(Ad.shape[-2:]) <= SVD_AUTO_MAX)


def _thin_svd(Ad):
    return torch.linalg.svd(Ad, full_matrices=False)


def _tikhonov_apply(U, S, Vh, lam, b):
    """x = V · S/(S²+λ) · Uᴴ b (Direct.jl:158) for b of shape (..., m) and
    λ of its leading shape."""
    D = S / (S**2 + lam.unsqueeze(-1))
    tmp = b @ U.conj()  # (Uᴴ b) per problem
    return (D.to(tmp.dtype) * tmp) @ Vh.conj()


@dataclasses.dataclass(frozen=True)
class DirectState:
    x: Any
    b: Any
    lam: Any
    iteration: Any


def _init(b, n, lam, x0=None):
    lead = b.shape[:-1]
    if x0 is not None:
        x = torch.broadcast_to(x0.to(b.dtype), (*lead, n)).clone()
    else:
        x = b.new_zeros((*lead, n))
    return DirectState(
        x=x, b=b, lam=lam.expand(lead),
        iteration=torch.zeros(lead, dtype=torch.int32, device=b.device),
    )


def _project(proj, x):
    for p in proj:
        x = p.prox(x)
    return x


@dataclasses.dataclass(frozen=True)
class DirectSolver(LinearSolver):
    A: LinearOperator
    l2: Any
    proj: Tuple = ()
    normalize_reg: Any = NoNormalization()
    U: Any = None
    S: Any = None
    Vh: Any = None
    iterations: int = 1

    @classmethod
    def create(cls, A, reg=None, normalize_reg=NoNormalization(), svd_method: str = "auto",
               **_):
        l2, proj = _split_l2(reg)
        op = as_operator(A)
        U = S = Vh = None
        if svd_method != "lu":
            Ad = op.to_dense()
            if _use_svd(Ad, svd_method):
                U, S, Vh = _thin_svd(Ad)
        return cls(A=op, l2=l2, proj=proj, normalize_reg=normalize_reg, U=U, S=S, Vh=Vh)

    def init(self, b, x0=None) -> DirectState:
        rdt = b.real.dtype
        scale = normalization_factor(self.normalize_reg, self.A, b)
        return _init(b, self.A.in_size, effective_lam(self.l2, scale, rdt), x0)

    def step(self, state: DirectState) -> DirectState:
        if self.U is not None:
            x = _tikhonov_apply(self.U, self.S, self.Vh, state.lam, state.b)
        else:
            Ad = self.A.to_dense()
            n = Ad.shape[1]
            eye = torch.eye(n, dtype=Ad.dtype, device=Ad.device)
            gram = Ad.conj().T @ Ad + state.lam.to(Ad.dtype)[..., None, None] * eye
            rhs = state.b @ Ad.conj()  # Aᴴ b per problem
            x = torch.linalg.solve(gram, rhs.unsqueeze(-1)).squeeze(-1)
        return dataclasses.replace(
            state, x=_project(self.proj, x), iteration=state.iteration + 1
        )

    def done(self, state: DirectState):
        return state.iteration >= 1


@dataclasses.dataclass(frozen=True)
class PseudoInverse(LinearSolver):
    U: Any
    S: Any
    Vh: Any
    l2: Any
    proj: Tuple = ()
    normalize_reg: Any = NoNormalization()
    iterations: int = 1

    @classmethod
    def create(cls, A, reg=None, normalize_reg=NoNormalization(), **_):
        """The SVD always: ``svd_method`` picks among the TPU's SVDs in
        ``rls_tpu`` and is accepted and ignored here."""
        l2, proj = _split_l2(reg)
        U, S, Vh = _thin_svd(as_operator(A).to_dense())
        return cls(U=U, S=S, Vh=Vh, l2=l2, proj=proj, normalize_reg=normalize_reg)

    def init(self, b, x0=None) -> DirectState:
        rdt = b.real.dtype
        scale = normalization_factor(self.normalize_reg, None, b)
        return _init(b, self.Vh.shape[1], effective_lam(self.l2, scale, rdt))

    def step(self, state: DirectState) -> DirectState:
        x = _tikhonov_apply(self.U, self.S, self.Vh, state.lam, state.b)
        return dataclasses.replace(
            state, x=_project(self.proj, x), iteration=state.iteration + 1
        )

    def done(self, state: DirectState):
        return state.iteration >= 1
