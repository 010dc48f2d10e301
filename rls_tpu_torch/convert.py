"""Carry a problem built with ``rls_tpu`` over to the port.

``convert(obj)`` turns an ``rls_tpu`` object into its ``rls_tpu_torch``
counterpart: ``SeparableConvOperator``, ``NormalOperator``,
``TVRegularization``, ``L1Regularization``, ``PositiveRegularization``,
``RealRegularization``, the three normalization strategies, ``FISTA``,
``OptISTA`` and ``POGM``.
Fields are read by attribute name with ``np.asarray`` (``ah``, ``aw``,
``bh``, ``bw``, ``taps_hw()``, ``lam``, ``rho``, ``iterations``,
``iterations_tv``, ...), and objects are recognised by class name, so
this module imports neither ``jax`` nor ``rls_tpu``. The converted
tensors land on the CPU with the source arrays' dtype; move operators
with ``.to(device)``.

TV backends map ``"xla"`` → ``"torch"`` and ``"pallas"`` → ``"cuda"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import prox, regularization
from .models.solvers.fista import FISTA
from .models.solvers.optista import OptISTA
from .models.solvers.pogm import POGM
from .ops.base import NormalOperator
from .ops.conv_direct import SeparableConvOperator

__all__ = ["convert"]

_TV_BACKENDS = {"xla": "torch", "pallas": "cuda"}


def _scalar(v):
    return float(np.asarray(v))


def _tensor(v):
    return torch.from_numpy(np.array(v))


# solver class name → (port class, converters of its fields beyond the
# common A, AHA, reg, proj, rho, theta, rel_tol, normalize_reg, iterations)
_SOLVERS = {
    "FISTA": (FISTA, {"restart": str, "track_residual": bool}),
    "OptISTA": (OptISTA, {}),
    "POGM": (POGM, {"restart": str, "sigma_fac": _scalar}),
}


def convert(obj):
    """The ``rls_tpu_torch`` counterpart of the ``rls_tpu`` object `obj`."""
    name = type(obj).__name__
    if name == "SeparableConvOperator":
        return SeparableConvOperator(
            ah=_tensor(obj.ah),
            aw=_tensor(obj.aw),
            bh=_tensor(obj.bh),
            bw=_tensor(obj.bw),
            im_shape=obj.im_shape,
            taps=None if obj.taps_len is None else obj.taps_hw(),
        )
    if name == "NormalOperator":
        weights = None if obj.weights is None else _tensor(obj.weights)
        return NormalOperator(convert(obj.A), weights)
    if name == "TVRegularization":
        if obj.pair_planes:
            raise NotImplementedError("split-real TV (pair_planes) is not yet ported")
        return prox.TVRegularization(
            _scalar(obj.lam),
            shape=obj.shape,
            dims=obj.dims,
            iterations_tv=int(obj.iterations_tv),
            backend=_TV_BACKENDS[obj.backend],
        )
    if name == "L1Regularization":
        return prox.L1Regularization(_scalar(obj.lam))
    if name == "PositiveRegularization":
        return prox.PositiveRegularization()
    if name == "RealRegularization":
        return prox.RealRegularization()
    if name in ("NoNormalization", "MeasurementBasedNormalization",
                "SystemMatrixBasedNormalization"):
        return getattr(regularization, name)()
    if name in _SOLVERS:
        A = None if obj.A is None else convert(obj.A)
        AHA = convert(obj.AHA)
        if A is not None and isinstance(AHA, NormalOperator) and obj.AHA.A is obj.A:
            AHA = NormalOperator(A, AHA.weights)  # keep `solver.A is AHA.A`
        cls, extra = _SOLVERS[name]
        return cls(
            A=A,
            AHA=AHA,
            reg=convert(obj.reg),
            proj=tuple(convert(p) for p in obj.proj),
            rho=_scalar(obj.rho),
            theta=_scalar(obj.theta),
            rel_tol=None if obj.rel_tol is None else _scalar(obj.rel_tol),
            normalize_reg=convert(obj.normalize_reg),
            iterations=int(obj.iterations),
            **{k: f(getattr(obj, k)) for k, f in extra.items()},
        )
    raise TypeError(f"no rls_tpu_torch counterpart for {name}")
