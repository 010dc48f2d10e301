"""Carry a problem built with ``rls_tpu`` over to the port.

``convert(obj, device="cuda")`` turns an ``rls_tpu`` object into its
``rls_tpu_torch`` counterpart: ``SeparableConvOperator``,
``DenseOperator``, ``NormalOperator``, ``IdentityOperator`` and
``GradientOperator`` (ADMM's ``reg_trafo``), ``TVRegularization``,
``L1Regularization``, ``L2Regularization``, ``PositiveRegularization``,
``RealRegularization``, the three normalization strategies, ``FISTA``,
``OptISTA``, ``POGM``, ``ADMM``, ``CGNR``, ``DirectSolver`` and
``PseudoInverse`` (with the SVD ``rls_tpu`` took, where it took one).
Fields are read by attribute name with ``np.asarray`` (``ah``, ``aw``,
``bh``, ``bw``, ``taps_hw()``, ``lam``, ``rho``, ``iterations``,
``iterations_tv``, ...), and objects are recognised by class name, so
this module imports neither ``jax`` nor ``rls_tpu``. The converted
tensors keep the source arrays' dtype and land on ``device``: the card
by default, the CPU with ``device="cpu"``.

TV backends map ``"xla"`` → ``"torch"`` and ``"pallas"`` → ``"cuda"``. An
ADMM preconditioner is a JAX callable and is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import prox, regularization
from .models.solvers.admm import ADMM
from .models.solvers.cgnr import CGNR
from .models.solvers.direct import DirectSolver, PseudoInverse
from .models.solvers.fista import FISTA
from .models.solvers.optista import OptISTA
from .models.solvers.pogm import POGM
from .ops.base import DenseOperator, IdentityOperator, NormalOperator
from .ops.conv_direct import SeparableConvOperator
from .ops.grad import GradientOperator

__all__ = ["convert"]

_TV_BACKENDS = {"xla": "torch", "pallas": "cuda"}


def _scalar(v):
    return float(np.asarray(v))


def _optional(v):
    return None if v is None else _scalar(v)


def _tensor(v, device):
    return torch.from_numpy(np.array(v)).to(device)


def _optional_tensor(v, device):
    return None if v is None else _tensor(v, device)


def _lam(v, device):
    """A λ: a float, or a tensor where it has axes (a vector λ)."""
    return _scalar(v) if np.ndim(v) == 0 else _tensor(v, device)


def _dtype(jdt):
    """The torch dtype of a JAX / numpy dtype."""
    return torch.from_numpy(np.zeros((), np.dtype(jdt))).dtype


# solver class name → (port class, converters of its fields beyond the
# common A, AHA, reg, proj, rho, theta, rel_tol, normalize_reg, iterations)
_SOLVERS = {
    "FISTA": (FISTA, {"restart": str, "track_residual": bool}),
    "OptISTA": (OptISTA, {}),
    "POGM": (POGM, {"restart": str, "sigma_fac": _scalar}),
}


def _operators(obj, device):
    """(A, AHA) of a solver, keeping ``solver.A is solver.AHA.A``."""
    A = None if obj.A is None else convert(obj.A, device)
    AHA = convert(obj.AHA, device)
    if A is not None and isinstance(AHA, NormalOperator) and obj.AHA.A is obj.A:
        AHA = NormalOperator(A, AHA.weights, device=device)
    return A, AHA


def _admm(obj, device):
    if obj.precon is not None:
        raise NotImplementedError("an ADMM preconditioner (a JAX callable) is not carried over")
    A, AHA = _operators(obj, device)
    return ADMM(
        A=A,
        AHA=AHA,
        reg=tuple(convert(r, device) for r in obj.reg),
        reg_trafo=tuple(convert(t, device) for t in obj.reg_trafo),
        proj=tuple(convert(p, device) for p in obj.proj),
        rho0=tuple(_scalar(r) for r in obj.rho0),
        normalize_reg=convert(obj.normalize_reg, device),
        abs_tol=_optional(obj.abs_tol),
        rel_tol=_optional(obj.rel_tol),
        tol_inner=_scalar(obj.tol_inner),
        vary_rho=str(obj.vary_rho),
        iterations=int(obj.iterations),
        iterations_cg=int(obj.iterations_cg),
        unroll_cg=bool(obj.unroll_cg),
    )


def _cgnr(obj, device):
    A, AHA = _operators(obj, device)
    return CGNR(
        A=A,
        AHA=AHA,
        l2=convert(obj.l2, device),
        constr=tuple(convert(c, device) for c in obj.constr),
        normalize_reg=convert(obj.normalize_reg, device),
        rel_tol=_optional(obj.rel_tol),
        iterations=int(obj.iterations),
    )


def _direct(obj, device):
    common = dict(
        l2=convert(obj.l2, device),
        proj=tuple(convert(p, device) for p in obj.proj),
        normalize_reg=convert(obj.normalize_reg, device),
        U=_optional_tensor(obj.U, device),
        S=_optional_tensor(obj.S, device),
        Vh=_optional_tensor(obj.Vh, device),
    )
    if type(obj).__name__ == "PseudoInverse":
        return PseudoInverse(**common)
    return DirectSolver(A=convert(obj.A, device), **common)


def convert(obj, device="cuda"):
    """The ``rls_tpu_torch`` counterpart of the ``rls_tpu`` object `obj`,
    its tensors on `device`."""
    name = type(obj).__name__
    if name == "SeparableConvOperator":
        return SeparableConvOperator(
            ah=_tensor(obj.ah, device),
            aw=_tensor(obj.aw, device),
            bh=_tensor(obj.bh, device),
            bw=_tensor(obj.bw, device),
            im_shape=obj.im_shape,
            taps=None if obj.taps_len is None else obj.taps_hw(),
        )
    if name == "DenseOperator":
        return DenseOperator(_tensor(obj.mat, device), device=device)
    if name == "NormalOperator":
        weights = None if obj.weights is None else _tensor(obj.weights, device)
        return NormalOperator(convert(obj.A, device), weights, device=device)
    if name == "IdentityOperator":
        return IdentityOperator(obj.n, _dtype(obj._dtype), device=device)
    if name == "GradientOperator":
        return GradientOperator(obj.im_shape, obj.dims, _dtype(obj._dtype), device=device)
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
    if name == "L2Regularization":
        return prox.L2Regularization(_lam(obj.lam, device))
    if name == "PositiveRegularization":
        return prox.PositiveRegularization()
    if name == "RealRegularization":
        return prox.RealRegularization()
    if name in ("NoNormalization", "MeasurementBasedNormalization",
                "SystemMatrixBasedNormalization"):
        return getattr(regularization, name)()
    if name == "ADMM":
        return _admm(obj, device)
    if name == "CGNR":
        return _cgnr(obj, device)
    if name in ("DirectSolver", "PseudoInverse"):
        return _direct(obj, device)
    if name in _SOLVERS:
        A, AHA = _operators(obj, device)
        cls, extra = _SOLVERS[name]
        return cls(
            A=A,
            AHA=AHA,
            reg=convert(obj.reg, device),
            proj=tuple(convert(p, device) for p in obj.proj),
            rho=_scalar(obj.rho),
            theta=_scalar(obj.theta),
            rel_tol=_optional(obj.rel_tol),
            normalize_reg=convert(obj.normalize_reg, device),
            iterations=int(obj.iterations),
            **{k: f(getattr(obj, k)) for k, f in extra.items()},
        )
    raise TypeError(f"no rls_tpu_torch counterpart for {name}")
