"""Kaczmarz / ART — the regularized row-action solver.

PyTorch counterpart of ``rls_tpu/models/solvers/kaczmarz.py:45-405``
(reference Kaczmarz.jl) with its four row orders: cyclic, shuffled,
randomized (row-energy sampling without replacement, drawn in the loop or
precomputed at construction) and greedy randomized (residual-driven,
e_k-thresholded). The implicit dual ``vl`` realizes the L2 term with
εw = √λ; a vector λ (a diagonal Tikhonov matrix) is the standard-form
transform Â = A·diag(1/√λ) with the solution rescaled.

Row orders and draws:

* ``perm`` (shuffled) and ``precomputed_order`` (randomized with
  ``precompute_order=True``) come from numpy ``default_rng(seed)``
  exactly as ``rls_tpu`` draws them, so both packages visit the same
  rows (``convert`` carries them over as well).
* The in-loop randomized draw and the greedy draw come from
  ``jax.random`` there, which torch cannot repeat. Here they come from a
  ``torch.Generator`` seeded with `seed`, held in the state: one draw per
  sweep for the whole batch (the S rows of a randomized sweep; the S
  uniforms of a greedy sweep, each problem inverting its own distribution
  with them), as the vmapped JAX solve shares one key.

The batch is a leading axis of b: every problem of a batch visits the same
rows in a sweep (the greedy draw aside). ``backend="cuda"`` runs the
cyclic and shuffled sweeps of a real dense system on the hand-written
sweep kernel (``kernels/kaczmarz_streamed.py``), which runs its plain
PyTorch version for CPU tensors; the row orders are checked once, at
construction, and a sweep reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ...ops.base import DenseOperator, LinearOperator, as_operator
from ..prox import L2Regularization
from ..regularization import (
    MeasurementBasedNormalization,
    NoNormalization,
    SystemMatrixBasedNormalization,
    find_sink,
    normalization_factor,
    sink,
)
from .base import LinearSolver, effective_lam, kaczmarz_row_update, split_projection_terms

__all__ = ["Kaczmarz", "KaczmarzState", "BACKENDS"]

BACKENDS = ("torch", "cuda")


@dataclasses.dataclass(frozen=True)
class KaczmarzState:
    u: Any
    x: Any
    vl: Any
    eps_w: Any
    denom: Any
    key: Any  # the torch.Generator of the randomized / greedy draws, or None
    lam_scale: Any
    iteration: Any
    r: Any  # the greedy residual (an empty last axis otherwise)


def _is_vector(lam) -> bool:
    return torch.is_tensor(lam) and lam.ndim > 0


def greedy_table_lam(l2, device):
    """The float32 λ of the greedy tables: the L2 term's λ, with the
    system-matrix normalization already folded in by `Kaczmarz.create`
    (0 for a vector λ, which the Tikhonov transform turns into 1)."""
    lam = sink(l2).lam
    return torch.as_tensor(0.0 if _is_vector(lam) else lam, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Kaczmarz(LinearSolver):
    A: LinearOperator
    l2: Any
    reg: Tuple = ()
    probabilities: Any = None  # row-energy sampling weights (randomized)
    greedy_B: Any = None  # (AAᴴ + λI)·diag(denom) for the greedy residual updates
    greedy_norms: Any = None  # rownorm² + λ
    greedy_fnorm: Any = None  # 1 / (‖A‖_F² + λ)
    tikhonov_inv_sqrt: Any = None  # 1/√λ of a vector λ, for the solution rescale
    theta: Any = None
    perm: Any = None  # row visit order (arange, or shuffled at create)
    precomputed_order: Any = None  # (iterations, S) randomized order
    normalize_reg: Any = NoNormalization()
    backend: str = "torch"  # "torch" | "cuda"
    randomized: bool = False
    sub_matrix_size: int = 1
    shuffle_rows: bool = False
    greedy: bool = False
    seed: int = 1234
    iterations: int = 10

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown Kaczmarz backend {self.backend!r}; one of {BACKENDS}")
        # the row orders, checked once here (dataclasses.replace runs this
        # too), so that the sweep kernel need not read them back every sweep
        for name in ("perm", "precomputed_order"):
            rows = getattr(self, name)
            if rows is not None and rows.numel():
                lo, hi = torch.stack(torch.aminmax(rows)).tolist()
                if lo < 0 or hi >= self.A.out_size:
                    raise ValueError(f"Kaczmarz {name}: rows must lie in "
                                     f"[0, {self.A.out_size}), got [{lo}, {hi}]")

    @classmethod
    def create(
        cls,
        A,
        reg=None,
        normalize_reg=NoNormalization(),
        randomized: bool = False,
        sub_matrix_fraction: float = 0.15,
        shuffle_rows: bool = False,
        seed: int = 1234,
        iterations: int = 10,
        greedy_randomized: bool = False,
        theta: Optional[float] = None,
        backend: str = "torch",
        precompute_order: bool = False,
        **_,
    ):
        """Reference ctor semantics (``rls_tpu`` :86-229, Kaczmarz.jl:77-158).
        ``precompute_order=True`` (randomized mode) samples every sweep's rows
        on the host at construction, as ``rls_tpu`` does; the streamed
        kernel needs it."""
        A_op = as_operator(A)
        dev = A_op.device
        regs = (
            list(reg) if isinstance(reg, (list, tuple))
            else ([reg] if reg is not None else [L2Regularization(0.0)])
        )
        idx = find_sink(L2Regularization, regs)
        l2 = L2Regularization(0.0) if idx is None else regs.pop(idx)

        lam = sink(l2).lam
        lam_is_vec = _is_vector(lam)
        if lam_is_vec and not isinstance(
            normalize_reg, (NoNormalization, SystemMatrixBasedNormalization)
        ):
            raise ValueError(
                "Tikhonov matrix for Kaczmarz is only valid with no or system "
                "matrix based normalization"
            )
        if isinstance(normalize_reg, SystemMatrixBasedNormalization):
            # the factor depends only on A: fold it into λ here, before the
            # vector-λ transform and the greedy tables consume λ
            scale0 = normalization_factor(normalize_reg, A_op, None)
            lam = torch.as_tensor(lam, device=scale0.device) * scale0
            l2 = L2Regularization(lam)
            normalize_reg = NoNormalization()

        params, proj = split_projection_terms(regs)
        other = list(proj)
        if len(params) == 1:
            other.append(params[0])
        elif len(params) > 1:
            raise ValueError(
                "Kaczmarz does not allow for more than one additional "
                f"regularization term, found {len(params)}"
            )

        tikhonov_inv_sqrt = None
        if lam_is_vec:
            inv_sqrt = 1.0 / torch.sqrt(torch.as_tensor(lam, device=dev))
            A_op = DenseOperator(A_op.to_dense() * inv_sqrt[None, :], device=dev)
            tikhonov_inv_sqrt = inv_sqrt

        m = A_op.out_size
        probabilities = precomputed_order = None
        sub_matrix_size = max(1, round(sub_matrix_fraction * m))
        if randomized:
            rn2 = A_op.row_norms_sq()
            probabilities = (rn2 / rn2.sum()).to(torch.float32)
            if precompute_order:
                p_np = probabilities.cpu().numpy().astype(np.float64)
                p_np = p_np / p_np.sum()
                gen = np.random.default_rng(seed)
                order = np.stack([
                    gen.choice(m, size=sub_matrix_size, replace=False, p=p_np)
                    for _ in range(iterations)
                ])
                precomputed_order = torch.as_tensor(order, dtype=torch.int32, device=dev)

        # the reference reshuffles at every init with the same seed: one
        # permutation at construction is the same
        if shuffle_rows and not randomized and not greedy_randomized:
            perm = torch.as_tensor(np.random.default_rng(seed).permutation(m),
                                   dtype=torch.int32, device=dev)
        else:
            perm = torch.arange(m, dtype=torch.int32, device=dev)

        greedy_B = greedy_norms = greedy_fnorm = None
        if greedy_randomized:
            if isinstance(normalize_reg, MeasurementBasedNormalization):
                raise ValueError(
                    "Measurement based regularization normalization is not "
                    "supported for Greedy Kaczmarz"
                )
            lam_s = greedy_table_lam(l2, dev)
            Ad = A_op.to_dense()
            rn2 = A_op.row_norms_sq()
            norms = rn2 + lam_s
            denom0 = torch.where(rn2 > 0, 1.0 / norms, torch.zeros_like(norms))
            B = Ad @ Ad.conj().T + lam_s * torch.eye(m, dtype=Ad.dtype, device=dev)
            greedy_B = B * denom0[None, :].to(Ad.dtype)
            greedy_norms = norms
            greedy_fnorm = 1.0 / (rn2.sum() + lam_s)

        return cls(
            A=A_op,
            l2=l2,
            reg=tuple(other),
            probabilities=probabilities,
            greedy_B=greedy_B,
            greedy_norms=greedy_norms,
            greedy_fnorm=greedy_fnorm,
            tikhonov_inv_sqrt=tikhonov_inv_sqrt,
            theta=theta,
            perm=perm,
            precomputed_order=precomputed_order,
            normalize_reg=normalize_reg,
            backend=backend,
            randomized=randomized,
            sub_matrix_size=sub_matrix_size,
            shuffle_rows=shuffle_rows,
            greedy=greedy_randomized,
            seed=seed,
            iterations=iterations,
        )

    # -- protocol ----------------------------------------------------------
    def init(self, b, x0=None) -> KaczmarzState:
        lead = b.shape[:-1]
        m, n = self.A.out_size, self.A.in_size
        dt = b.dtype
        rdt = b.real.dtype if b.is_complex() else dt
        scale = normalization_factor(self.normalize_reg, self.A, b).to(rdt)
        if self.tikhonov_inv_sqrt is not None:  # λ = 1 after the transform
            lam_eff = torch.ones(lead, dtype=rdt, device=b.device)
            eps_w = torch.ones(lead, dtype=dt, device=b.device)
        else:
            lam_eff = effective_lam(self.l2, scale, rdt)
            eps_w = torch.sqrt(lam_eff).to(dt)
        rn2 = self.A.row_norms_sq().to(rdt)
        lam_col = lam_eff.unsqueeze(-1) if lam_eff.ndim else lam_eff
        denom = torch.where(rn2 > 0, 1.0 / (rn2 + lam_col), torch.zeros_like(rn2 + lam_col))
        key = None
        if self.randomized or self.greedy:
            key = torch.Generator(device=b.device)
            key.manual_seed(self.seed)
        if x0 is not None:
            x = torch.broadcast_to(x0.to(dt), (*lead, n)).clone()
        else:
            x = b.new_zeros((*lead, n))
        r = b - self.A.mv(x) if self.greedy else b.new_zeros((*lead, 0))
        return KaczmarzState(
            u=b,
            x=x,
            vl=b.new_zeros((*lead, m)),
            eps_w=eps_w,
            denom=denom,
            key=key,
            lam_scale=scale,
            iteration=torch.zeros(lead, dtype=torch.int32, device=b.device),
            r=r,
        )

    # -- sweeps ------------------------------------------------------------
    def _sweep_rows(self, state):
        """The rows of this sweep (int64, on the host's side of a loop)."""
        if self.randomized and self.precomputed_order is not None:
            it = int(state.iteration.reshape(-1)[0]) if state.iteration.numel() else 0
            return self.precomputed_order[min(it, self.precomputed_order.shape[0] - 1)]
        if self.randomized:
            return torch.multinomial(self.probabilities.to(state.x.device), self.sub_matrix_size,
                                     replacement=False, generator=state.key)
        return self.perm

    def _standard_sweep(self, state: KaczmarzState):
        idx = self._sweep_rows(state)
        if (
            self.backend == "cuda"
            and not self.randomized
            # the kernel takes a real x and a real dense A
            and not state.x.is_complex()
            and isinstance(self.A, DenseOperator)
            and not self.A.mat.is_complex()
        ):
            from ...kernels.kaczmarz_streamed import solver_sweep

            # perm was checked at construction: no per-sweep read of the host
            x, vl = solver_sweep(self.A.mat, state.x, state.vl, state.u, state.denom,
                                 state.eps_w, idx)
            return dataclasses.replace(state, x=x, vl=vl)
        x, vl = state.x, state.vl.clone()
        for i in idx.tolist():
            x, vl = kaczmarz_row_update(self.A, x, vl, i, state.u[..., i], state.denom[..., i],
                                        state.eps_w)
        return dataclasses.replace(state, x=x, vl=vl)

    def _rows_of(self, rows):
        """(P, n): row rows[p] of A for each problem p."""
        if isinstance(self.A, DenseOperator):
            return self.A.mat[rows]
        return torch.stack([self.A.row(int(i)) for i in rows.reshape(-1).tolist()]).reshape(
            *rows.shape, self.A.in_size)

    def _greedy_sweep(self, state: KaczmarzState):
        """Greedy randomized sweep (reference Kaczmarz.jl:283-317, 393-426):
        per step, each problem draws its row from its own thresholded
        residual distribution by inverse CDF, with the step's uniform that
        the whole batch shares."""
        rdt = state.denom.dtype
        fnorm = torch.as_tensor(self.greedy_fnorm, dtype=rdt, device=state.x.device)
        norms = self.greedy_norms.to(rdt)
        denom = state.denom
        x, vl, r = state.x, state.vl.clone(), state.r
        uniforms = torch.rand(self.sub_matrix_size, generator=state.key, dtype=rdt,
                              device=state.x.device)
        for j in range(self.sub_matrix_size):
            r_probs = r.abs() ** 2
            diff_numb = r_probs.sum(dim=-1, keepdim=True)
            mx = (r_probs * denom).amax(dim=-1, keepdim=True)
            if self.theta is None:
                e_k = 0.5 * (mx / diff_numb + fnorm)
            else:
                th = torch.as_tensor(self.theta, dtype=rdt, device=x.device)
                e_k = th * (mx / diff_numb) + (1.0 - th) * fnorm
            lower = e_k * diff_numb
            r_probs = torch.where(r_probs >= lower * norms, r_probs, torch.zeros_like(r_probs))
            # jax.random.choice's inverse CDF: the first row whose cumulative
            # weight reaches (1 − U)·total
            cdf = torch.cumsum(r_probs / r_probs.sum(dim=-1, keepdim=True), dim=-1)
            target = (cdf[..., -1:] * (1.0 - uniforms[j])).contiguous()
            row = torch.searchsorted(cdf, target).squeeze(-1)
            row = row.clamp(max=r.shape[-1] - 1)
            r_row = r.gather(-1, row[..., None]).squeeze(-1)
            alpha = denom.gather(-1, row[..., None]).squeeze(-1).to(x.dtype) * r_row
            x = x + alpha[..., None] * self._rows_of(row).conj()
            vl = vl.scatter_add(-1, row[..., None], (alpha * state.eps_w)[..., None])
            r = r - r_row[..., None] * self.greedy_B.T[row]
        return dataclasses.replace(state, x=x, vl=vl, r=r)

    def step(self, state: KaczmarzState) -> KaczmarzState:
        state = self._greedy_sweep(state) if self.greedy else self._standard_sweep(state)
        x = state.x
        for r in self.reg:
            lam = r.get_lam()
            if lam is None:
                x = r.prox(x)
            else:
                x = r.prox(x, effective_lam(r, state.lam_scale, state.lam_scale.dtype))
        state = dataclasses.replace(state, x=x)
        if self.greedy:
            # the residual after the projection (reference Kaczmarz.jl:294-297)
            eps = state.eps_w.unsqueeze(-1) if state.eps_w.ndim else state.eps_w
            state = dataclasses.replace(state, r=state.u - eps * state.vl - self.A.mv(state.x))
        return dataclasses.replace(state, iteration=state.iteration + 1)

    def done(self, state: KaczmarzState):
        return state.iteration >= self.iterations

    def solution(self, state: KaczmarzState):
        if self.tikhonov_inv_sqrt is not None:
            return state.x * self.tikhonov_inv_sqrt.to(state.x.dtype)
        return state.x

    def convergence(self, state: KaczmarzState) -> dict:
        res = torch.linalg.vector_norm(self.A.mv(self.solution(state)) - state.u, dim=-1)
        return {"residual": res}
