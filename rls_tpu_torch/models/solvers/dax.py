"""Dax row-relaxation solvers.

PyTorch counterpart of ``rls_tpu/models/solvers/dax.py`` (:43-273), the
reference's DAXKaczmarz.jl and DAXConstrained.jl:

  * DaxKaczmarz — Dax (1993) row relaxation: each outer iteration
    recomputes the residual b_k = u − A x, runs weighted-probability
    randomized Kaczmarz on min ε‖x‖² + ‖W(Ax − b_k)‖² for
    n_nonzero_rows · iterations_inner row updates, and adds its x_l.
  * DaxConstrained — the same with cyclic sweeps and a Lent–Censor sweep
    enforcing B x ≥ 0 after each (B defaults to the identity).

Both run on the shared ``kaczmarz_row_update``; the batch is a leading
axis of b, and every problem of a batch visits the same rows.

Draws: ``rls_tpu`` draws DaxKaczmarz's rows with
``jax.random.choice(p=probs)``, which torch cannot repeat. Here they come
from a ``torch.Generator`` seeded with `seed`, held in the state, by the
same inverse CDF (the first row whose cumulative weight reaches
(1 − U)·total): one sequence per outer iteration for the whole batch, as
the vmapped JAX solve shares one key. The private ``_forced_rows``
((iterations, n_inner) row indices) replaces the draws, so that a run can
visit the rows another run drew.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ...ops.base import IdentityOperator, LinearOperator, as_operator
from ..prox import PositiveRegularization, RealRegularization
from ..regularization import TransformedRegularization
from .base import LinearSolver, kaczmarz_row_update

__all__ = ["DaxKaczmarz", "DaxConstrained", "DaxState", "draw_rows"]


@dataclasses.dataclass(frozen=True)
class DaxState:
    u: Any
    x: Any
    bk: Any
    key: Any  # the torch.Generator of DaxKaczmarz's draws, or None
    iteration: Any


def _build_reg(enforce_real, enforce_positive, sparse_trafo):
    reg = []
    if enforce_positive and enforce_real:
        reg.append(PositiveRegularization())
    elif enforce_real:
        reg.append(RealRegularization())
    if reg and sparse_trafo is not None:
        reg = [TransformedRegularization(r, sparse_trafo) for r in reg]
    return tuple(reg)


def draw_rows(probs, count: int, gen):
    """`count` rows drawn with replacement ∝ `probs`, by
    ``jax.random.choice``'s inverse CDF, with uniforms from `gen`."""
    cdf = torch.cumsum(probs, dim=0)
    u = torch.rand(count, generator=gen, dtype=cdf.dtype, device=cdf.device)
    return torch.searchsorted(cdf, cdf[-1] * (1.0 - u)).clamp(max=cdf.shape[0] - 1)


def _row_tables(A_op, lam, weights):
    """(w, s², nonzero rows, denom = w²/(s² + λ), εw = √λ / w) of the
    weighted system, as ``rls_tpu`` builds them at create."""
    m = A_op.out_size
    dev = A_op.device
    w = (torch.as_tensor(weights, dtype=torch.float32, device=dev) if weights is not None
         else torch.ones((m,), dtype=torch.float32, device=dev))
    s2 = A_op.row_norms_sq() * w**2
    nz = s2 > 0
    denom = torch.where(nz, w**2 / (s2 + lam), 0.0)
    lam32 = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    eps_w = torch.where(w > 0, torch.sqrt(lam32) / w, 0.0)
    return w, s2, nz, denom, eps_w


def _x0(b, n, x0):
    lead = b.shape[:-1]
    if x0 is not None:
        return torch.broadcast_to(x0.to(b.dtype), (*lead, n)).clone()
    return b.new_zeros((*lead, n))


@dataclasses.dataclass(frozen=True)
class DaxKaczmarz(LinearSolver):
    A: LinearOperator
    reg: Tuple = ()
    lam: Any = 0.0
    weights: Any = None
    denom: Any = None  # w²/(s² + λ) per row (0 for zero rows)
    probs: Any = None  # sampling probabilities ∝ (s² + λ) over nonzero rows
    eps_w: Any = None  # √λ / w per row
    iterations: int = 3
    iterations_inner: int = 2
    seed: int = 42
    # the reference's rowindex length: rows with nonzero energy
    # (DAXKaczmarz.jl:115), counted at create
    n_nonzero_rows: int = 0
    _forced_rows: Any = None

    @classmethod
    def create(
        cls,
        A,
        lam: float = 0.0,
        weights=None,
        sparse_trafo=None,
        enforce_real: bool = False,
        enforce_positive: bool = False,
        iterations: int = 3,
        iterations_inner: int = 2,
        seed: int = 42,
        **_,
    ):
        A_op = as_operator(A)
        w, s2, nz, denom, eps_w = _row_tables(A_op, lam, weights)
        probs = torch.where(nz, s2 + lam, 0.0)
        return cls(
            A=A_op,
            reg=_build_reg(enforce_real, enforce_positive, sparse_trafo),
            lam=float(lam),
            weights=w,
            denom=denom,
            probs=probs / probs.sum(),
            eps_w=eps_w,
            n_nonzero_rows=int(nz.sum()),
            iterations=iterations,
            iterations_inner=iterations_inner,
            seed=seed,
        )

    def init(self, b, x0=None) -> DaxState:
        key = torch.Generator(device=b.device)
        key.manual_seed(self.seed)
        return DaxState(
            u=b,
            x=_x0(b, self.A.in_size, x0),
            bk=torch.zeros_like(b),
            key=key,
            iteration=torch.zeros(b.shape[:-1], dtype=torch.int32, device=b.device),
        )

    def _rows(self, state):
        if self._forced_rows is not None:
            it = int(state.iteration.reshape(-1)[0]) if state.iteration.numel() else 0
            return self._forced_rows[it]
        return draw_rows(self.probs.to(state.x.device), self.n_nonzero_rows * self.iterations_inner,
                         state.key)

    def step(self, state: DaxState) -> DaxState:
        bk = state.u - self.A.mv(state.x)
        xl = torch.zeros_like(state.x)
        yl = state.x.new_zeros(bk.shape)
        for j in self._rows(state).tolist():
            xl, yl = kaczmarz_row_update(self.A, xl, yl, j, bk[..., j], self.denom[j],
                                         self.eps_w[j])
        return dataclasses.replace(state, x=state.x + xl, bk=bk, iteration=state.iteration + 1)

    def done(self, state: DaxState):
        return state.iteration >= self.iterations

    def finalize(self, state: DaxState) -> DaxState:
        x = state.x
        for r in self.reg:
            x = r.prox(x)
        return dataclasses.replace(state, x=x)

    def convergence(self, state: DaxState) -> dict:
        return {"residual": torch.linalg.vector_norm(state.bk, dim=-1)}


@dataclasses.dataclass(frozen=True)
class DaxConstrained(LinearSolver):
    """Dax method for Ax ≈ b s.t. Bx ≥ 0 (Lent–Censor scheme)."""

    A: LinearOperator
    B: LinearOperator  # constraint basis (the identity by default)
    Bnorm2: Any = None
    lam: Any = 0.0
    weights: Any = None
    denom: Any = None
    eps_w: Any = None
    iterations: int = 3
    iterations_inner: int = 2

    @classmethod
    def create(
        cls,
        A,
        lam: float = 0.0,
        weights=None,
        sparse_trafo=None,
        iterations: int = 3,
        iterations_inner: int = 2,
        **_,
    ):
        A_op = as_operator(A)
        w, _, _, denom, eps_w = _row_tables(A_op, lam, weights)
        B_op = (as_operator(sparse_trafo, device=A_op.device) if sparse_trafo is not None
                else IdentityOperator(A_op.in_size, torch.float32, device=A_op.device))
        return cls(
            A=A_op,
            B=B_op,
            Bnorm2=B_op.row_norms_sq(),
            lam=float(lam),
            weights=w,
            denom=denom,
            eps_w=eps_w,
            iterations=iterations,
            iterations_inner=iterations_inner,
        )

    def init(self, b, x0=None) -> DaxState:
        return DaxState(
            u=b,
            x=_x0(b, self.A.in_size, x0),
            bk=torch.zeros_like(b),
            key=None,
            iteration=torch.zeros(b.shape[:-1], dtype=torch.int32, device=b.device),
        )

    def step(self, state: DaxState) -> DaxState:
        m, nB = self.A.out_size, self.B.out_size
        bk = state.u - self.A.mv(state.x)
        xl = torch.zeros_like(state.x)
        yl = state.x.new_zeros(bk.shape)
        yc = state.x.new_zeros((*bk.shape[:-1], nB))
        for _ in range(self.iterations_inner):
            for j in range(m):
                xl, yl = kaczmarz_row_update(self.A, xl, yl, j, bk[..., j], self.denom[j],
                                             self.eps_w[j])
            # Lent–Censor: enforce (B(x + xl))_i ≥ 0 with the dual memory yc
            bc = state.x + xl
            for i in range(nB):
                brow = self.B.row(i)
                d = (brow * bc).sum(dim=-1) / self.Bnorm2[i].to(bc.dtype)
                d = torch.where(d.real < yc[..., i].real, -d, -yc[..., i])
                yc[..., i] += d
                step = d.unsqueeze(-1) * brow.conj()
                xl = xl + step
                bc = bc + step
        return dataclasses.replace(state, x=state.x + xl, bk=bk, iteration=state.iteration + 1)

    def done(self, state: DaxState):
        return state.iteration >= self.iterations

    def convergence(self, state: DaxState) -> dict:
        return {"residual": torch.linalg.vector_norm(state.bk, dim=-1)}
