"""Spectral norm estimation of a normal operator via power iterations.

PyTorch counterpart of ``rls_tpu/utils/power_iterations.py`` (reference
``power_iterations``, Utils.jl:245-287); FISTA's default step size
``rho = 0.95 / power_iterations(AHA)`` comes from it
(``rls_tpu/models/solvers/fista.py:87-88``). The random start is drawn
from a seeded ``torch.Generator`` on the operator's device, so it differs
from the JAX package's start (compare eigenvalues, not iterates).
"""

from __future__ import annotations

from typing import Callable, Union

import torch

__all__ = ["power_iterations"]


def power_iterations(
    AHA: Union[Callable, "object"],
    n: int | None = None,
    dtype=None,
    device=None,
    rtol: float = 1e-3,
    maxiter: int = 50,
    min_iter: int = 8,
    seed: int = 0,
):
    """Estimate the max eigenvalue of the (hermitian PSD) operator ``AHA``.

    ``AHA`` is a LinearOperator (uses .mv / .in_size / .dtype / .device)
    or a callable ``x -> AHA x`` (then ``n`` and ``dtype`` must be given,
    and the start vector goes to ``device``, the card by default).
    Returns a 0-d tensor of the real dtype.
    """
    if callable(AHA) and not hasattr(AHA, "mv"):
        op = AHA
        if n is None:
            raise ValueError("power_iterations with a callable needs n=")
        dt = dtype or torch.complex64
        dev = torch.device(device or "cuda")
    else:
        op = AHA.mv
        n = AHA.in_size
        dt = dtype or AHA.dtype
        dev = torch.device(device) if device is not None else AHA.device

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    b = torch.randn((n,), generator=gen, dtype=dt, device=dev)

    # one unconditional iteration so λ is finite before the rtol test;
    # min_iter guard: when the start is nearly orthogonal to the dominant
    # eigenvector, the estimate briefly stabilizes at a SUBDOMINANT
    # eigenvalue, which would make the 0.95/λmax default step divergent
    lam = float("inf")
    for i in range(maxiter):
        bn = b / torch.linalg.vector_norm(b)
        b = op(bn)
        lam_old, lam = lam, torch.vdot(bn, b).abs()
        if i + 1 >= min_iter and bool((lam / lam_old - 1.0).abs() < rtol):
            break
    return lam
