"""Proximal maps of the flagship slice.

PyTorch counterpart of ``rls_tpu/models/prox.py``: ``soft_threshold`` and
``L1Regularization`` (:57-80), ``L2Regularization`` (:82-97),
``prox_tv_fgp`` (:133-166),
``TVRegularization`` (:205-280), ``PositiveRegularization`` and
``RealRegularization`` (:514-533).

``TVRegularization(backend="cuda")`` takes the place of ``"pallas"``: a
2-D TV over both axes of a real image goes to the hand-written FGP kernel
(``kernels/tv_fgp.py``), which runs its plain PyTorch version on CPU
tensors. ``backend="torch"`` takes the place of ``"xla"``: the composed
FGP on ``GradientOperator``. The TPU's VMEM size gate (:256) has no
counterpart: the CUDA kernel keeps its planes in global memory.

A λ is a scalar or carries x's leading batch axes (one λ per problem).
``L2Regularization`` also takes the reference's vector λ, one per entry
of x (a diagonal Tikhonov matrix).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..ops.grad import GradientOperator
from .regularization import ParameterizedRegularization, ProjectionRegularization

__all__ = [
    "L1Regularization",
    "L2Regularization",
    "TVRegularization",
    "PositiveRegularization",
    "RealRegularization",
    "soft_threshold",
    "prox_tv_fgp",
]


def _real_dtype(dtype):
    return torch.empty((), dtype=dtype).real.dtype


def _lam(lam, x):
    """λ as a tensor of x's real dtype on x's device: 0-d, or one λ per
    problem of shape x.shape[:-1]."""
    return torch.as_tensor(lam, dtype=_real_dtype(x.dtype), device=x.device)


def _lam_col(lam, x):
    """`_lam` shaped to broadcast against x (a per-problem λ gains a
    trailing axis)."""
    lam = _lam(lam, x)
    return lam.unsqueeze(-1) if lam.ndim else lam


def soft_threshold(x, lam):
    """Complex-safe soft threshold (reference ProxL1.jl:18-22):
    ``max(|x|−λ, 0) · (x+ε)/(|x|+ε)``."""
    eps = torch.finfo(_real_dtype(x.dtype)).eps
    mag = x.abs()
    return torch.clamp(mag - _lam_col(lam, x), min=0) * (x + eps) / (mag + eps)


def _enf_real(x):
    return torch.complex(x.real, torch.zeros_like(x.real)) if x.is_complex() else x


def _enf_pos(x):
    if x.is_complex():
        return torch.complex(torch.clamp(x.real, min=0), x.imag)
    return torch.clamp(x, min=0)


@dataclasses.dataclass(frozen=True)
class L1Regularization(ParameterizedRegularization):
    lam: Any

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        return soft_threshold(x, lam)

    def value(self, x, lam=None):
        lam = self.lam if lam is None else lam
        return _lam(lam, x) * x.abs().sum(dim=-1)


def _lam_l2(lam, x):
    """`_lam` shaped to broadcast against x: one λ per problem (x's
    leading shape) gains a trailing axis; a vector λ, one per entry of x,
    broadcasts as it is."""
    lam = _lam(lam, x)
    return lam.unsqueeze(-1) if lam.ndim and lam.shape == x.shape[:-1] else lam


@dataclasses.dataclass(frozen=True)
class L2Regularization(ParameterizedRegularization):
    """Tikhonov term ½·2λ‖x‖²; λ is a scalar, one per problem, or a vector
    (a diagonal Tikhonov matrix, reference ProxL2.jl)."""

    lam: Any

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        return x / (1.0 + 2.0 * _lam_l2(lam, x))

    def value(self, x, lam=None):
        lam = _lam(self.lam if lam is None else lam, x)
        if lam.ndim and lam.shape != x.shape[:-1]:
            return (lam * x.abs() ** 2).sum(dim=-1)
        return lam * (x.abs() ** 2).sum(dim=-1)


def prox_tv_fgp(x, lam, grad_op: GradientOperator, iterations: int):
    """Fast Gradient Projection on the TV dual (Beck & Teboulle 2009),
    mirroring the reference's FGP loop (ProxTV.jl:89-125) op for op."""
    rdt = _real_dtype(x.dtype)
    lam = _lam_col(lam, x)
    lam_safe = torch.where(lam > 0, lam, torch.ones_like(lam))
    G = grad_op

    pq = x.new_zeros(*x.shape[:-1], G.out_size)
    rs = pq
    t = torch.ones((), dtype=rdt, device=x.device)
    for _ in range(iterations):
        xtmp = x - lam * G.rmv(rs)
        pq_new = rs + G.mv(xtmp) / (8.0 * lam_safe)
        pq_new = pq_new / torch.clamp(pq_new.abs(), min=1.0)
        t_new = (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) / 2.0
        t2 = (t - 1.0) / t_new
        rs = (1.0 + t2) * pq_new - t2 * pq
        pq, t = pq_new, t_new
    return x - lam * G.rmv(pq)


@dataclasses.dataclass(frozen=True)
class TVRegularization(ParameterizedRegularization):
    """TV prox by the FGP dual iteration (reference ProxTV.jl:89-125).

    `dims` uses 0-based axes. ``backend`` is ``"torch"`` (composed FGP)
    or ``"cuda"`` (the hand-written kernel for 2-D real images)."""

    lam: Any
    shape: tuple = None
    dims: Any = None
    iterations_tv: int = 10
    backend: str = "torch"

    def __post_init__(self):
        if self.backend not in ("torch", "cuda"):
            raise ValueError(f"unknown TV backend {self.backend!r}")
        if isinstance(self.dims, int):
            raise NotImplementedError(
                "the exact 1-D Condat TV (integer dims) is not yet ported"
            )
        if self.shape is not None:
            object.__setattr__(self, "shape", tuple(self.shape))
        if self.dims is None and self.shape is not None:
            object.__setattr__(self, "dims", tuple(range(len(self.shape))))

    def _grad_op(self, x):
        return GradientOperator(
            im_shape=self.shape, dims=tuple(self.dims), dtype=x.dtype, device=x.device
        )

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        if (
            self.backend == "cuda"
            and not x.is_complex()
            and len(self.shape) == 2
            and tuple(sorted(self.dims)) == (0, 1)
        ):
            from ..kernels.tv_fgp import prox_tv2d_fgp

            return prox_tv2d_fgp(x, lam, self.shape, self.iterations_tv)
        return prox_tv_fgp(x, lam, self._grad_op(x), self.iterations_tv)

    def value(self, x, lam=None):
        lam = self.lam if lam is None else lam
        g = self._grad_op(x).mv(x)
        return _lam(lam, g) * g.abs().sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class PositiveRegularization(ProjectionRegularization):
    def prox(self, x, lam=None):
        return _enf_pos(_enf_real(x))

    def value(self, x, lam=None):
        ok = (self.prox(x) == x).all(dim=-1)
        return torch.where(ok, 0.0, torch.inf)


@dataclasses.dataclass(frozen=True)
class RealRegularization(ProjectionRegularization):
    def prox(self, x, lam=None):
        return _enf_real(x)

    def value(self, x, lam=None):
        ok = (self.prox(x) == x).all(dim=-1)
        return torch.where(ok, 0.0, torch.inf)
