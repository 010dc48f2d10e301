"""Carry a problem built with ``rls_tpu`` over to the port.

``convert(obj, device="cuda")`` turns an ``rls_tpu`` object into its
``rls_tpu_torch`` counterpart. Objects are recognised by class name, and
their fields are read by attribute name with ``np.asarray``, so this
module imports neither ``jax`` nor ``rls_tpu``. The converted tensors keep
the source arrays' dtype and land on ``device``: the card by default, the
CPU with ``device="cpu"``. It carries:

* operators: ``DenseOperator``, ``IdentityOperator``, ``NormalOperator``,
  the composites ``WeightingOperator``, ``ProdOperator``,
  ``StackedOperator`` and ``SamplingOperator``,
  ``SeparableConvOperator``, ``DirectConvOperator``,
  ``GradientOperator`` (ADMM's ``reg_trafo``) and ``Grad8Operator``
  (PDHG's), ``SparseOperator``, ``PaddedCSROperator``, the split-real
  ``SubsampledDFT2RealOperator`` and ``SenseDFT2RealOperator``,
  ``FFTOperator``, ``SubsampledFFTOperator``, ``ConvolutionOperator``,
  ``WaveletOperator`` and ``RadonOperator``;
* regularization: ``TVRegularization`` (an integer ``dims`` too),
  ``NuclearRegularization`` (its ``svd_method``), ``LLRRegularization``
  (its ``seed``; the port draws its own shifts from it),
  ``L1Regularization``,
  ``L2Regularization``, ``L21Regularization``,
  ``PositiveRegularization``, ``RealRegularization``, the decorators
  ``FixedScaledRegularization``, ``FixedParameterRegularization``,
  ``AutoScaledRegularization`` (with its latched factor),
  ``NormalizedRegularization``, ``TransformedRegularization`` and
  ``MaskedRegularization`` (with its mask), the input transforms
  ``MinMaxTransform``, ``IdentityTransform``, ``ZTransform`` and
  ``ClampedScalingTransform``, and the three normalization strategies;
* solvers: ``FISTA``, ``OptISTA``, ``POGM``, ``ADMM``, ``SplitBregman``,
  ``CGNR``, ``DirectSolver`` and ``PseudoInverse`` (with the SVD
  ``rls_tpu`` took, where it took one), ``PDHG`` (with its τ),
  ``Kaczmarz`` (with its row orders, sampling probabilities and greedy
  tables, so both packages visit the same rows), ``DaxKaczmarz`` (with
  its tables ``denom``, ``probs``, ``eps_w``, its ``n_nonzero_rows`` and
  its seed) and ``DaxConstrained`` (with ``B`` and its row norms).

TV and Kaczmarz backends map ``"xla"`` → ``"torch"`` and ``"pallas"`` →
``"cuda"``. A JAX callable is not carried: an ADMM or SplitBregman
preconditioner, a ``FunctionOperator``, a ``ProjectionRegularizationTerm``
and a ``PlugAndPlayRegularization`` (its ``model``) are refused by name;
the CNN of ``rls_tpu/models/denoisers.py`` crosses by its weights
(``models/denoisers.py`` ``convert_cnn_params``). The DFT operators'
bf16 compensation factors (``cat``) are not carried: the port computes
the DFT with ``torch.fft``.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import prox, regularization
from .models.solvers.admm import ADMM
from .models.solvers.cgnr import CGNR
from .models.solvers.dax import DaxConstrained, DaxKaczmarz
from .models.solvers.direct import DirectSolver, PseudoInverse
from .models.solvers.fista import FISTA
from .models.solvers.kaczmarz import Kaczmarz
from .models.solvers.optista import OptISTA
from .models.solvers.pdhg import PDHG
from .models.solvers.pogm import POGM
from .models.solvers.splitbregman import SplitBregman
from .ops.base import (
    DenseOperator,
    IdentityOperator,
    NormalOperator,
    ProdOperator,
    SamplingOperator,
    StackedOperator,
    WeightingOperator,
)
from .ops.conv_direct import DirectConvOperator, SeparableConvOperator
from .ops.dft_real import SenseDFT2RealOperator, SubsampledDFT2RealOperator
from .ops.fourier import ConvolutionOperator, FFTOperator, SubsampledFFTOperator
from .ops.grad import Grad8Operator, GradientOperator
from .ops.radon import RadonOperator
from .ops.sparse import PaddedCSROperator, SparseOperator
from .ops.wavelet import WaveletOperator

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
    "FISTA": (FISTA, {"restart": str, "track_residual": bool, "verbose": bool}),
    "OptISTA": (OptISTA, {"verbose": bool}),
    "POGM": (POGM, {"restart": str, "sigma_fac": _scalar, "verbose": bool}),
}


def _operators(obj, device):
    """(A, AHA) of a solver, keeping ``solver.A is solver.AHA.A``."""
    A = None if obj.A is None else convert(obj.A, device)
    AHA = convert(obj.AHA, device)
    if A is not None and isinstance(AHA, NormalOperator) and obj.AHA.A is obj.A:
        AHA = NormalOperator(A, AHA.weights, device=device)
    return A, AHA


def _admm(obj, device):
    """ADMM or SplitBregman: the fields they share, and each one's own."""
    name = type(obj).__name__
    if obj.precon is not None:
        raise NotImplementedError(f"a {name} preconditioner (a JAX callable) is not carried over")
    A, AHA = _operators(obj, device)
    if name == "ADMM":
        cls, own = ADMM, dict(vary_rho=str(obj.vary_rho))
    else:
        cls, own = SplitBregman, dict(iterations_inner=int(obj.iterations_inner))
    return cls(
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
        iterations=int(obj.iterations),
        iterations_cg=int(obj.iterations_cg),
        unroll_cg=bool(obj.unroll_cg),
        verbose=bool(obj.verbose),
        **own,
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


def _pdhg(obj, device):
    return PDHG(
        A=convert(obj.A, device),
        reg=convert(obj.reg, device),
        trafo=convert(obj.trafo, device),
        proj=tuple(convert(p, device) for p in obj.proj),
        sigma=_scalar(obj.sigma),
        tau=_scalar(obj.tau),
        eps=_scalar(obj.eps),
        normalize_reg=convert(obj.normalize_reg, device),
        reg_kind=str(obj.reg_kind),
        tv_scheme=str(obj.tv_scheme),
        shape=tuple(obj.shape),
        iterations=int(obj.iterations),
    )


def _kaczmarz(obj, device):
    return Kaczmarz(
        A=convert(obj.A, device),
        l2=convert(obj.l2, device),
        reg=tuple(convert(r, device) for r in obj.reg),
        probabilities=_optional_tensor(obj.probabilities, device),
        greedy_B=_optional_tensor(obj.greedy_B, device),
        greedy_norms=_optional_tensor(obj.greedy_norms, device),
        greedy_fnorm=_optional(obj.greedy_fnorm),
        tikhonov_inv_sqrt=_optional_tensor(obj.tikhonov_inv_sqrt, device),
        theta=_optional(obj.theta),
        perm=_optional_tensor(obj.perm, device),
        precomputed_order=_optional_tensor(obj.precomputed_order, device),
        normalize_reg=convert(obj.normalize_reg, device),
        backend=_TV_BACKENDS[obj.backend],
        randomized=bool(obj.randomized),
        sub_matrix_size=int(obj.sub_matrix_size),
        shuffle_rows=bool(obj.shuffle_rows),
        greedy=bool(obj.greedy),
        seed=int(obj.seed),
        iterations=int(obj.iterations),
    )


def _dax(obj, device):
    common = dict(
        A=convert(obj.A, device),
        lam=_scalar(obj.lam),
        weights=_tensor(obj.weights, device),
        denom=_tensor(obj.denom, device),
        eps_w=_tensor(obj.eps_w, device),
        iterations=int(obj.iterations),
        iterations_inner=int(obj.iterations_inner),
    )
    if type(obj).__name__ == "DaxConstrained":
        return DaxConstrained(B=convert(obj.B, device), Bnorm2=_tensor(obj.Bnorm2, device),
                              **common)
    return DaxKaczmarz(
        reg=tuple(convert(r, device) for r in obj.reg),
        probs=_tensor(obj.probs, device),
        seed=int(obj.seed),
        n_nonzero_rows=int(obj.n_nonzero_rows),
        **common,
    )


# the decorators: class name → the fields beyond `reg`, each with its converter
_DECORATORS = {
    "FixedScaledRegularization": {"factor": _lam},
    "FixedParameterRegularization": {},
    "AutoScaledRegularization": {"factor": lambda v, d: None if v is None else _lam(v, d)},
    "NormalizedRegularization": {"factor": _lam},
    "TransformedRegularization": {"trafo": lambda v, d: convert(v, d)},
    "MaskedRegularization": {"mask": lambda v, d: tuple(v)},
}

# the input transforms: class name → the fields they carry (tensors or
# numbers), set on an instance without recomputing them from an x
_TRANSFORMS = {
    "MinMaxTransform": ("min", "max"),
    "IdentityTransform": (),
    "ZTransform": ("mean", "std"),
    "ClampedScalingTransform": ("v_min", "v_max", "mask", "x"),
}

# objects that carry a JAX callable: refused by name
_CALLABLES = {
    "FunctionOperator": "mv_fn / rmv_fn",
    "ProjectionRegularizationTerm": "proj_func",
    "PlugAndPlayRegularization": "model",
}


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
    if name == "Grad8Operator":
        return Grad8Operator(obj.im_shape, _dtype(obj._dtype), device=device)
    if name == "SparseOperator":
        mat = obj.mat
        idx = torch.from_numpy(np.array(mat.indices).T.astype(np.int64))
        return SparseOperator(torch.sparse_coo_tensor(
            idx, torch.from_numpy(np.array(mat.data)), tuple(mat.shape),
            check_invariants=True).to(device))
    if name == "PaddedCSROperator":
        return PaddedCSROperator(_tensor(obj.vals, device), _tensor(obj.cols, device), obj.n,
                                 device=device)
    if name == "SubsampledDFT2RealOperator":
        return SubsampledDFT2RealOperator(_tensor(obj.mask, device), obj.im_shape)
    if name == "SenseDFT2RealOperator":
        return SenseDFT2RealOperator(_tensor(obj.coils_r, device), _tensor(obj.coils_i, device),
                                     _tensor(obj.mask, device), obj.im_shape)
    if name == "FFTOperator":
        return FFTOperator(obj.im_shape, device=device)
    if name == "SubsampledFFTOperator":
        return SubsampledFFTOperator(_tensor(obj.sample_idx, device), obj.im_shape, device=device)
    if name == "ConvolutionOperator":
        return ConvolutionOperator(_tensor(obj.otf, device), obj.im_shape)
    if name in _CALLABLES:
        hint = ("; the CNN of rls_tpu.models.denoisers crosses by its weights: "
                "rls_tpu_torch.models.denoisers.convert_cnn_params, then make_pnp_model"
                if name == "PlugAndPlayRegularization" else "")
        raise TypeError(f"a {name} carries a JAX callable ({_CALLABLES[name]}) and is not "
                        f"carried over; build it in rls_tpu_torch with a torch callable{hint}")
    if name == "WeightingOperator":
        return WeightingOperator(_tensor(obj.weights, device), device=device)
    if name == "ProdOperator":
        return ProdOperator(convert(obj.A, device), convert(obj.B, device))
    if name == "StackedOperator":
        return StackedOperator([convert(op, device) for op in obj.ops])
    if name == "SamplingOperator":
        return SamplingOperator(_tensor(obj.idx, device), obj.n, device=device)
    if name == "DirectConvOperator":
        return DirectConvOperator(_tensor(obj.kernel, device), obj.im_shape, device=device)
    if name == "WaveletOperator":
        return WaveletOperator(obj.im_shape, obj.wavelet, obj.levels, _dtype(obj._dtype),
                               device=device)
    if name == "RadonOperator":
        return RadonOperator(np.array(obj.angles), obj.im_shape, obj.num_det, device=device)
    if name in _DECORATORS:
        fields = {k: f(getattr(obj, k), device) for k, f in _DECORATORS[name].items()}
        return getattr(regularization, name)(convert(obj.reg, device), **fields)
    if name in _TRANSFORMS:
        out = object.__new__(getattr(regularization, name))
        for k in _TRANSFORMS[name]:
            setattr(out, k, _lam(getattr(obj, k), device))
        return out
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
    if name == "NuclearRegularization":
        return prox.NuclearRegularization(_scalar(obj.lam), svt_shape=obj.svt_shape,
                                          svd_method=str(obj.svd_method))
    if name == "LLRRegularization":
        return prox.LLRRegularization(
            _scalar(obj.lam), shape=obj.shape, block_size=obj.block_size,
            randshift=bool(obj.randshift), fully_overlapping=bool(obj.fully_overlapping),
            L=int(obj.L), seed=int(obj.seed), svd_method=str(obj.svd_method))
    if name == "L1Regularization":
        return prox.L1Regularization(_scalar(obj.lam))
    if name == "L2Regularization":
        return prox.L2Regularization(_lam(obj.lam, device))
    if name == "L21Regularization":
        return prox.L21Regularization(_scalar(obj.lam), slices=int(obj.slices))
    if name == "PositiveRegularization":
        return prox.PositiveRegularization()
    if name == "RealRegularization":
        return prox.RealRegularization()
    if name in ("NoNormalization", "MeasurementBasedNormalization",
                "SystemMatrixBasedNormalization"):
        return getattr(regularization, name)()
    if name in ("ADMM", "SplitBregman"):
        return _admm(obj, device)
    if name == "CGNR":
        return _cgnr(obj, device)
    if name in ("DirectSolver", "PseudoInverse"):
        return _direct(obj, device)
    if name == "PDHG":
        return _pdhg(obj, device)
    if name == "Kaczmarz":
        return _kaczmarz(obj, device)
    if name in ("DaxKaczmarz", "DaxConstrained"):
        return _dax(obj, device)
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
