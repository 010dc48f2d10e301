"""Matrix-free linear operator protocol and core implementations.

PyTorch counterpart of ``rls_tpu/ops/base.py``: ``LinearOperator``
(:43-110) with the row actions of the row-action solvers (:74-94),
``DenseOperator`` (:113-166) without its bf16-compensated branch,
``IdentityOperator`` (:169), the composites ``WeightingOperator``
(:205-237), ``ProdOperator`` (:240-276), ``StackedOperator`` (:314-349)
and ``SamplingOperator`` (:352-380), ``NormalOperator`` (:279-312),
``adjoint_operator`` and ``as_operator`` (:405-418).

Operators are ``nn.Module``s whose array payloads are registered buffers,
so ``.to(device)`` moves them. Vectors are flat along the LAST axis and
may carry any leading batch axes (the batch is an explicit leading
dimension, not ``torch.vmap``). An operator never copies its input to its
own device: a tensor on another device raises. A composite lives where
its factors live, and raises when they lie on different devices.

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

import contextlib
from typing import Optional

import torch
from torch import nn

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "IdentityOperator",
    "WeightingOperator",
    "ProdOperator",
    "NormalOperator",
    "StackedOperator",
    "SamplingOperator",
    "as_operator",
    "adjoint_operator",
    "per_problem",
]


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full f32 (no TF32) for the duration, whatever
    the caller's setting; matmuls keep PyTorch's default, which is f32."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


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
        """Device of the operator's buffers, those of its factors included; a
        buffer-free operator reports the device it was built for
        (``_device``). Raises when the parts lie on different devices."""
        found = []
        for mod in self.modules():
            own = [b.device for b in mod.buffers(recurse=False)]
            if not own and "_device" in vars(mod):
                own = [mod._device]
            found.extend(own)
        if not found:
            return torch.device("cpu")
        # "cuda" (no index) is the current card, the same as "cuda:<k>"
        dev = max(found, key=lambda d: d.index is not None)
        for d in found:
            if d.type != dev.type or d.index not in (None, dev.index):
                raise ValueError(
                    f"{type(self).__name__} has parts on {dev} and on {d}; "
                    "move them to one device"
                )
        return dev

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
            return ProdOperator(self, other)
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


class WeightingOperator(LinearOperator):
    """Diagonal weighting, reference ``WeightingOp``."""

    def __init__(self, weights, device="cuda"):
        super().__init__()
        self.register_buffer("weights", torch.as_tensor(weights, device=device))

    @property
    def in_size(self) -> int:
        return self.weights.shape[0]

    @property
    def out_size(self) -> int:
        return self.weights.shape[0]

    @property
    def dtype(self):
        return self.weights.dtype

    def mv(self, x):
        return self.weights * x

    def rmv(self, y):
        return self.weights.conj() * y

    def normal(self, x):
        return self.weights.abs() ** 2 * x

    def row(self, i):
        e = torch.zeros_like(self.weights)
        e[i] = self.weights[i]
        return e

    def row_norms_sq(self):
        return self.weights.abs() ** 2


class ProdOperator(LinearOperator):
    """Composition ``A ∘ B`` (apply B first), reference ``ProdOp(A, B)``.
    Its dtype is B's; A and B must lie on one device."""

    def __init__(self, A: LinearOperator, B: LinearOperator):
        super().__init__()
        self.A = A
        self.B = B
        self.device  # raises on factors on different devices

    @property
    def in_size(self) -> int:
        return self.B.in_size

    @property
    def out_size(self) -> int:
        return self.A.out_size

    @property
    def dtype(self):
        return self.B.dtype

    def mv(self, x):
        return self.A.mv(self.B.mv(x))

    def rmv(self, y):
        return self.B.rmv(self.A.rmv(y))

    def row(self, i):
        # only Weighting ∘ B, the reference's weighted Kaczmarz
        # (Kaczmarz.jl:455-458)
        if isinstance(self.A, WeightingOperator):
            return self.A.weights[i] * self.B.row(i)
        raise NotImplementedError("row access only for Weighting ∘ B products")

    def row_norms_sq(self):
        if isinstance(self.A, WeightingOperator):
            return self.A.weights.abs() ** 2 * self.B.row_norms_sq()
        raise NotImplementedError("row access only for Weighting ∘ B products")


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


class StackedOperator(LinearOperator):
    """Vertical stack [A1; A2; ...] (multi-coil / constrained systems): the
    parts' outputs sit one after another along the last axis."""

    def __init__(self, ops):
        super().__init__()
        self.ops = nn.ModuleList(ops)
        self.device  # raises on parts on different devices

    @property
    def in_size(self) -> int:
        return self.ops[0].in_size

    @property
    def out_size(self) -> int:
        return sum(op.out_size for op in self.ops)

    @property
    def dtype(self):
        return self.ops[0].dtype

    def mv(self, x):
        return torch.cat([op.mv(x) for op in self.ops], dim=-1)

    def rmv(self, y):
        out = None
        offset = 0
        for op in self.ops:
            part = op.rmv(y[..., offset : offset + op.out_size])
            out = part if out is None else out + part
            offset += op.out_size
        return out

    def normal(self, x):
        out = None
        for op in self.ops:
            part = op.normal(x)
            out = part if out is None else out + part
        return out


class SamplingOperator(LinearOperator):
    """Sampling of the entries `idx` of the last axis: y = x[..., idx]
    (reference ``SamplingOp``). The adjoint writes y back into zeros; with
    a repeated index the entry written last is undefined, as in
    ``rls_tpu``. Its dtype is complex64, as there."""

    def __init__(self, idx, n: int, device="cuda"):
        super().__init__()
        self.register_buffer("idx", torch.as_tensor(idx, device=device).to(torch.int64))
        self.n = int(n)

    @property
    def in_size(self) -> int:
        return self.n

    @property
    def out_size(self) -> int:
        return self.idx.shape[0]

    @property
    def dtype(self):
        return torch.complex64

    def mv(self, x):
        return x.index_select(-1, self.idx)

    def rmv(self, y):
        return y.new_zeros((*y.shape[:-1], self.n)).index_copy(-1, self.idx, y)

    def normal(self, x):
        mask = torch.zeros((self.n,), dtype=torch.float32, device=x.device)
        return x * mask.index_fill(0, self.idx, 1.0).to(x.dtype)


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
