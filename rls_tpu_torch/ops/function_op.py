"""Function-defined matrix-free operators with automatic adjoints.

PyTorch counterpart of ``rls_tpu/ops/function_op.py`` (:23-62), the
reference's function-based LinearOperators.jl constructor. ``mv_fn`` is a
linear torch callable on one vector (n,); the operator maps it over the
leading batch axes with ``torch.func.vmap``, as the JAX solve functions vmap it.
The adjoint is the pullback of ``torch.func.vjp`` at 0 in place of
``jax.linear_transpose``: for a linear f(x) = A x, torch's complex
convention already gives Aᴴ y, where JAX conjugates by hand (:55-61).
Both run with cuDNN's TF32 off (a wrapped convolution stays f32).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .base import LinearOperator, no_tf32

__all__ = ["FunctionOperator"]


def _map(fn, v, size):
    """fn on each vector of v's last axis: (..., k) → (..., size)."""
    with no_tf32():
        if v.ndim == 1:
            return fn(v)
        out = torch.func.vmap(fn)(v.reshape(-1, v.shape[-1]))
    return out.reshape(*v.shape[:-1], size)


class FunctionOperator(LinearOperator):
    """Wraps a linear function ``mv_fn: (n,) -> (m,)``; ``rmv_fn``, when
    given, replaces the automatic adjoint."""

    def __init__(self, mv_fn: Callable, rmv_fn: Optional[Callable] = None, n: int = 0,
                 m: int = 0, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.mv_fn = mv_fn
        self.rmv_fn = rmv_fn
        self.n = int(n)
        self.m = int(m)
        self._dtype = dtype
        self._device = torch.device(device)

    @property
    def in_size(self) -> int:
        return self.n

    @property
    def out_size(self) -> int:
        return self.m

    @property
    def dtype(self):
        return self._dtype

    def mv(self, x):
        return _map(self.mv_fn, x, self.m)

    def rmv(self, y):
        if self.rmv_fn is not None:
            return _map(self.rmv_fn, y, self.n)
        zero = torch.zeros((self.n,), dtype=self._dtype, device=y.device)
        _, pullback = torch.func.vjp(self.mv_fn, zero)
        return _map(lambda v: pullback(v)[0], y, self.n)
