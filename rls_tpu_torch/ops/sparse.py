"""Sparse operators for the row-action solvers.

PyTorch counterpart of ``rls_tpu/ops/sparse.py:35-155`` (reference:
SparseMatrixCSC system matrices with ``rownorm²`` /
``dot_with_matrix_row`` / ``kaczmarz_update!``, Utils.jl:26-31, 96-105,
Kaczmarz.jl:532-539):

* ``SparseOperator`` — a torch sparse COO matrix (a CSR one is taken and
  kept as COO); matvecs are sparse products, a row is an O(nnz) masked
  scatter over the whole matrix.
* ``PaddedCSROperator`` — row-major padded storage ``vals`` / ``cols`` of
  shape (m, k_max), every row padded with (val 0, col 0) to the largest
  row population. ``row_dot`` / ``row_axpy`` are O(k_max) gathers and
  scatter-adds, so a Kaczmarz sweep costs O(m·k_max); the streamed CUDA
  kernel reads the rows in place (``kernels/kaczmarz_streamed.py``).

Leading batch axes of x and y pass through, as for the dense operators.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import LinearOperator, per_problem

__all__ = ["SparseOperator", "PaddedCSROperator"]


class SparseOperator(LinearOperator):
    """A sparse matrix held as a coalesced torch sparse COO tensor."""

    def __init__(self, mat):
        super().__init__()
        if mat.layout != torch.sparse_coo:
            mat = mat.to_sparse_coo()
        self.register_buffer("mat", mat.coalesce())

    @classmethod
    def from_dense(cls, dense, device="cuda"):
        return cls(torch.as_tensor(dense, device=device).to_sparse())

    @property
    def in_size(self) -> int:
        return self.mat.shape[1]

    @property
    def out_size(self) -> int:
        return self.mat.shape[0]

    @property
    def dtype(self):
        return self.mat.dtype

    def _product(self, M, v):
        """M @ v over v's last axis, M sparse (k, l), v (..., l)."""
        v2 = v.reshape(-1, v.shape[-1]).to(self.dtype)
        return torch.sparse.mm(M, v2.T).T.reshape(*v.shape[:-1], M.shape[0])

    def mv(self, x):
        return self._product(self.mat, x)

    def rmv(self, y):
        # Aᴴy = conj(Aᵀ conj(y))
        return self._product(self.mat.t(), y.conj()).conj()

    def row(self, i):
        idx, val = self.mat.indices(), self.mat.values()
        rowmask = (idx[0] == i).to(val.dtype)
        out = torch.zeros((self.in_size,), dtype=val.dtype, device=val.device)
        return out.index_add_(0, idx[1], val * rowmask)

    def row_norms_sq(self):
        idx, val = self.mat.indices(), self.mat.values()
        out = torch.zeros((self.out_size,), dtype=val.abs().dtype, device=val.device)
        return out.index_add_(0, idx[0], val.abs() ** 2)

    def to_dense(self):
        return self.mat.to_dense()


class PaddedCSROperator(LinearOperator):
    """Row-major padded sparse storage with O(k_max) row actions.

    ``vals`` / ``cols`` are (m, k_max); rows with fewer nonzeros are padded
    with val 0 at col 0, which gathers and scatters nothing."""

    def __init__(self, vals, cols, n: int, device="cuda"):
        super().__init__()
        self.register_buffer("vals", torch.as_tensor(vals, device=device))
        self.register_buffer("cols", torch.as_tensor(cols, dtype=torch.int32, device=device))
        self.n = int(n)

    @classmethod
    def from_dense(cls, dense, k_max: int | None = None, device="cuda"):
        """Build from a dense numpy matrix on the host, exactly as
        ``rls_tpu``'s ``from_dense`` does (:92-110)."""
        d = np.asarray(dense)
        m, n = d.shape
        counts = (d != 0).sum(axis=1)
        k = int(counts.max()) if k_max is None else int(k_max)
        if (counts > k).any():
            raise ValueError(f"k_max={k} below max row population {counts.max()}")
        k = max(k, 1)
        vals = np.zeros((m, k), d.dtype)
        cols = np.zeros((m, k), np.int32)
        for i in range(m):
            nz = np.nonzero(d[i])[0][:k]
            vals[i, : nz.size] = d[i, nz]
            cols[i, : nz.size] = nz
        return cls(torch.from_numpy(vals), torch.from_numpy(cols), n, device=device)

    @property
    def in_size(self) -> int:
        return self.n

    @property
    def out_size(self) -> int:
        return self.vals.shape[0]

    @property
    def k_max(self) -> int:
        return self.vals.shape[1]

    @property
    def dtype(self):
        return self.vals.dtype

    def mv(self, x):
        return (self.vals * x[..., self.cols.long()]).sum(dim=-1)

    def rmv(self, y):
        contrib = self.vals.conj() * y[..., :, None]
        out = torch.zeros((*y.shape[:-1], self.n), dtype=contrib.dtype, device=contrib.device)
        return out.index_add_(-1, self.cols.reshape(-1).long(),
                              contrib.reshape(*y.shape[:-1], -1))

    def row(self, i):
        out = torch.zeros((self.n,), dtype=self.dtype, device=self.vals.device)
        return out.index_add_(0, self.cols[i].long(), self.vals[i])

    def row_dot(self, i, x):
        return (self.vals[i] * x[..., self.cols[i].long()]).sum(dim=-1)

    def row_axpy(self, x, i, alpha):
        contrib = (per_problem(alpha) * self.vals[i].conj()).to(x.dtype)
        contrib = contrib.expand(*x.shape[:-1], self.k_max)
        return x.index_add(-1, self.cols[i].long(), contrib)

    def row_norms_sq(self):
        return (self.vals.abs() ** 2).sum(dim=1)

    def to_dense(self):
        m = self.out_size
        rows = torch.arange(m, device=self.vals.device)[:, None].expand(m, self.k_max)
        out = torch.zeros((m, self.n), dtype=self.dtype, device=self.vals.device)
        return out.index_put_((rows.reshape(-1), self.cols.reshape(-1).long()),
                              self.vals.reshape(-1), accumulate=True)
