"""Matrix-free linear operator protocol and core implementations.

PyTorch counterpart of ``rls_tpu/ops/base.py``: ``LinearOperator``
(:43-110) with the row actions of the row-action solvers (:74-94),
``DenseOperator`` (:113-166) without its bf16-compensated branch,
``IdentityOperator`` (:169), ``NormalOperator`` (:279-312),
``adjoint_operator`` and ``as_operator`` (:405-418).

Operators are ``nn.Module``s whose array payloads are registered buffers,
so ``.to(device)`` moves them. Vectors are flat along the LAST axis and
may carry any leading batch axes (the batch is an explicit leading
dimension, not ``torch.vmap``). An operator never copies its input to its
own device: a tensor on another device raises.

Every constructor that makes tensors takes ``device=``, default
``"cuda"``: the port runs on the card unless the caller asks for the CPU
(``device="cpu"``). On a machine without a card the default raises
torch's own error.

Protocol:
  * ``mv(x)``     — ``A @ x``
  * ``rmv(y)``    — ``Aᴴ @ y``
  * ``normal(x)`` — ``Aᴴ A x``
  * ``in_size`` / ``out_size`` — static sizes
  * ``row(i)``, ``row_dot(i, x)``, ``row_axpy(x, i, α)`` — row i of A,
    aᵢ·x unconjugated, x + α·conj(aᵢ); α is a number or one per problem
    (x's leading shape)
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "IdentityOperator",
    "NormalOperator",
    "as_operator",
    "adjoint_operator",
    "per_problem",
]


def per_problem(alpha):
    """α shaped to broadcast against (..., n): a number stays as it is, a
    tensor of one α per problem gains a trailing axis."""
    if torch.is_tensor(alpha) and alpha.ndim:
        return alpha.unsqueeze(-1)
    return alpha


class LinearOperator(nn.Module):
    """Base class (protocol) for matrix-free linear operators."""

    @property
    def in_size(self) -> int:
        raise NotImplementedError

    @property
    def out_size(self) -> int:
        raise NotImplementedError

    def mv(self, x):
        raise NotImplementedError

    def rmv(self, y):
        raise NotImplementedError

    def normal(self, x):
        """AᴴA x — override for fused versions."""
        return self.rmv(self.mv(x))

    def forward(self, x):
        return self.mv(x)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.out_size, self.in_size)

    @property
    def dtype(self):
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        """Device of the operator's buffers; a buffer-free operator reports
        the device it was built for (``_device``)."""
        buf = next(self.buffers(), None)
        if buf is not None:
            return buf.device
        return getattr(self, "_device", torch.device("cpu"))

    def check_device(self, t: torch.Tensor) -> None:
        """Raise unless `t` lies on this operator's device (buffer-free
        operators accept any device)."""
        buf = next(self.buffers(), None)
        if buf is not None and t.device != buf.device:
            raise ValueError(
                f"{type(self).__name__} lives on {buf.device} but got a "
                f"tensor on {t.device}; move one of them explicitly"
            )

    def row(self, i):
        """Row i of A as a dense vector (for the row-action solvers)."""
        raise NotImplementedError(f"{type(self).__name__} has no row access")

    def row_norms_sq(self):
        """Vector of squared 2-norms of the rows (reference: rownorm²)."""
        raise NotImplementedError(f"{type(self).__name__} has no row access")

    def row_dot(self, i, x):
        """τ = aᵢ·x over x's last axis, UNconjugated (reference
        ``dot_with_matrix_row``, Utils.jl:96-105). Sparse operators
        override it with an O(nnz_row) gather."""
        return (self.row(i) * x).sum(dim=-1)

    def row_axpy(self, x, i, alpha):
        """x + α·conj(aᵢ) (reference ``kaczmarz_update!``,
        Kaczmarz.jl:532-539). Sparse operators override it with an
        O(nnz_row) scatter-add."""
        return x + per_problem(alpha) * self.row(i).conj()

    def to_dense(self):
        """Materialize as a dense matrix (small operators only)."""
        eye = torch.eye(self.in_size, dtype=self.dtype, device=self.device)
        return self.mv(eye).T

    def __matmul__(self, other):
        if isinstance(other, LinearOperator):
            raise NotImplementedError("ProdOperator is not yet ported")
        return self.mv(other)

    @property
    def H(self) -> "LinearOperator":
        return adjoint_operator(self)


class DenseOperator(LinearOperator):
    """Dense matrix operator (plain ``Matrix`` system matrices)."""

    def __init__(self, mat, device="cuda"):
        super().__init__()
        self.register_buffer("mat", torch.as_tensor(mat, device=device))

    @property
    def in_size(self) -> int:
        return self.mat.shape[1]

    @property
    def out_size(self) -> int:
        return self.mat.shape[0]

    @property
    def dtype(self):
        return self.mat.dtype

    def mv(self, x):
        return x @ self.mat.T

    def rmv(self, y):
        return y @ self.mat.conj()

    def row(self, i):
        return self.mat[i]

    def row_norms_sq(self):
        return (self.mat.abs() ** 2).sum(dim=1)

    def to_dense(self):
        return self.mat


class IdentityOperator(LinearOperator):
    """opEye analog."""

    def __init__(self, n: int, dtype=torch.complex64, device="cuda"):
        super().__init__()
        self.n = int(n)
        self._dtype = dtype
        self._device = torch.device(device)

    @property
    def in_size(self) -> int:
        return self.n

    @property
    def out_size(self) -> int:
        return self.n

    @property
    def dtype(self):
        return self._dtype

    def mv(self, x):
        return x

    def rmv(self, y):
        return y

    def normal(self, x):
        return x

    def row(self, i):
        e = torch.zeros((self.n,), dtype=self._dtype, device=self.device)
        e[i] = 1
        return e

    def row_norms_sq(self):
        return torch.ones((self.n,), dtype=torch.float32, device=self.device)


class NormalOperator(LinearOperator):
    """Wraps A (and optional weights W) as the normal operator AᴴWA."""

    def __init__(self, A: LinearOperator, weights=None, device="cuda"):
        super().__init__()
        self.A = A
        if weights is None:
            self.weights: Optional[torch.Tensor] = None
        else:
            self.register_buffer("weights", torch.as_tensor(weights, device=device))

    @property
    def in_size(self) -> int:
        return self.A.in_size

    @property
    def out_size(self) -> int:
        return self.A.in_size

    @property
    def dtype(self):
        return self.A.dtype

    def mv(self, x):
        if self.weights is None:
            return self.A.normal(x)
        return self.A.rmv(self.weights * self.A.mv(x))

    def rmv(self, y):
        return self.mv(y)  # hermitian

    def normal(self, x):
        return self.mv(self.mv(x))


class _AdjointOperator(LinearOperator):
    def __init__(self, inner: LinearOperator):
        super().__init__()
        self.inner = inner

    @property
    def in_size(self) -> int:
        return self.inner.out_size

    @property
    def out_size(self) -> int:
        return self.inner.in_size

    @property
    def dtype(self):
        return self.inner.dtype

    def mv(self, x):
        return self.inner.rmv(x)

    def rmv(self, y):
        return self.inner.mv(y)


def adjoint_operator(op: LinearOperator) -> LinearOperator:
    if isinstance(op, _AdjointOperator):
        return op.inner
    return _AdjointOperator(op)


def as_operator(A, device="cuda") -> LinearOperator:
    """Coerce a raw matrix / operator into a LinearOperator (a matrix goes
    to `device`; an operator stays where it is)."""
    if isinstance(A, LinearOperator):
        return A
    A = torch.as_tensor(A, device=device)
    if A.ndim != 2:
        raise ValueError(f"expected 2-D matrix, got shape {tuple(A.shape)}")
    return DenseOperator(A, device=device)
