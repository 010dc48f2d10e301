"""Regularization framework: base types, decorator terms, λ-normalization
and input transforms.

PyTorch counterpart of ``rls_tpu/models/regularization.py``:
``Regularization``, ``ParameterizedRegularization``,
``ProjectionRegularization``, ``reg_chain``, ``sink``, ``sink_type``,
``find_sink`` and ``find_sinks`` (:67-141); the decorators
``NestedRegularization``, ``FixedScaledRegularization``,
``FixedParameterRegularization``, ``AutoScaledRegularization`` and
``NormalizedRegularization`` (:144-247); the three normalization
strategies and ``normalization_factor`` (:253-293);
``TransformedRegularization`` and ``MaskedRegularization`` (:302-345);
the input transforms ``MinMaxTransform``, ``IdentityTransform``,
``ZTransform`` and ``ClampedScalingTransform`` (:351-401); and
``PlugAndPlayRegularization`` with its alias ``PnPRegularization``
(:409-470).

Every term has a pure ``prox(x, lam) -> x`` and ``value(x, lam)``. A λ may
be a scalar or carry the leading batch axes of ``x`` (one λ per problem).
Where ``rls_tpu`` reduces over a problem's vector (AutoScaled's max|x|,
the transforms' statistics), the port reduces over the last axis, one
result per problem.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import torch

__all__ = [
    "Regularization",
    "ParameterizedRegularization",
    "ProjectionRegularization",
    "NestedRegularization",
    "FixedScaledRegularization",
    "FixedParameterRegularization",
    "AutoScaledRegularization",
    "NormalizedRegularization",
    "TransformedRegularization",
    "MaskedRegularization",
    "NoNormalization",
    "MeasurementBasedNormalization",
    "SystemMatrixBasedNormalization",
    "normalization_factor",
    "sink",
    "sink_type",
    "find_sink",
    "find_sinks",
    "reg_chain",
    "MinMaxTransform",
    "IdentityTransform",
    "ZTransform",
    "ClampedScalingTransform",
    "PlugAndPlayRegularization",
    "PnPRegularization",
]


class Regularization:
    """Base for all regularization terms."""

    @property
    def inner(self) -> Optional["Regularization"]:
        return None

    def prox(self, x, lam=None):
        raise NotImplementedError

    def value(self, x, lam=None):
        """Value of the regularization functional (reference: ``norm``)."""
        raise NotImplementedError


class ParameterizedRegularization(Regularization):
    """Term with a regularization parameter λ (field name: ``lam``)."""

    lam: object

    def get_lam(self):
        """Effective λ after decorator scaling (reference: ``λ(reg)``)."""
        return self.lam


class ProjectionRegularization(Regularization):
    """Indicator-function term: prox is a projection, no λ."""

    def get_lam(self):
        return None


def reg_chain(reg: Regularization):
    """Iterate the decorator chain from outermost to innermost."""
    while reg is not None:
        yield reg
        reg = reg.inner


def sink(reg: Regularization) -> Regularization:
    """Innermost term of a decorator chain (reference: ``sink``)."""
    last = reg
    for r in reg_chain(reg):
        last = r
    return last


def sink_type(reg: Regularization) -> type:
    return type(sink(reg))


def find_sink(cls, regs) -> Optional[int]:
    """Index of the unique term whose sink is of type `cls`
    (reference: ``findsink``, errors when ambiguous)."""
    hits = find_sinks(cls, regs)
    if not hits:
        return None
    if len(hits) > 1:
        raise ValueError(
            f"cannot unambiguously retrieve reg term of type {cls.__name__}, "
            f"found {len(hits)}"
        )
    return hits[0]


def find_sinks(cls, regs) -> list[int]:
    """Indices of all terms whose sink is an instance of `cls`."""
    return [i for i, r in enumerate(regs) if isinstance(sink(r), cls)]


# --------------------------------------------------------------------------
# nested / scaled decorators
# --------------------------------------------------------------------------


class NestedRegularization(Regularization):
    """Decorator base: delegates prox/value inward."""

    reg: Regularization

    @property
    def inner(self) -> Regularization:
        return self.reg

    def get_lam(self):
        return self.reg.get_lam()

    def prox(self, x, lam=None):
        if lam is None:
            lam = self.get_lam()
        return self.reg.prox(x, lam)

    def value(self, x, lam=None):
        if lam is None:
            lam = self.get_lam()
        return self.reg.value(x, lam)


@dataclasses.dataclass(frozen=True)
class FixedScaledRegularization(NestedRegularization):
    """λ scaled by a fixed factor (reference ScaledRegularization.jl:26-33)."""

    reg: Regularization
    factor: Any

    def get_lam(self):
        return self.reg.get_lam() * self.factor


@dataclasses.dataclass(frozen=True)
class FixedParameterRegularization(NestedRegularization):
    """Discards any incoming λ and always uses the inner term's own λ
    (reference ScaledRegularization.jl:41-50): it keeps a term out of the
    normalization."""

    reg: Regularization

    def prox(self, x, lam=None):
        return self.reg.prox(x, self.reg.get_lam())

    def value(self, x, lam=None):
        return self.reg.value(x, self.reg.get_lam())


def _abs_max(x):
    """max|x| of each problem (over the last axis)."""
    return x.abs().amax(dim=-1)


@dataclasses.dataclass(frozen=True)
class AutoScaledRegularization(NestedRegularization):
    """λ scaled by max|x| of each problem (reference
    ScaledRegularization.jl:53-78).

    As in ``rls_tpu``, the factor is taken from the current iterate at
    every call unless ``factor`` is given; ``latched(x_first)`` pins it to
    max|x_first|, the reference's one-time ``initFactor!``, one entry per
    problem."""

    reg: Regularization
    factor: Optional[Any] = None

    def latched(self, x) -> "AutoScaledRegularization":
        """Copy with the reference's latched factor max|x| per problem."""
        return AutoScaledRegularization(reg=self.reg, factor=_abs_max(x))

    def get_lam(self):
        if self.factor is None:
            return self.reg.get_lam()
        return self.reg.get_lam() * self.factor

    def _eff_lam(self, x, lam):
        if self.factor is not None:
            # latched: an explicit λ passes through unchanged (the caller
            # already fetched get_lam() · factor); λ = None uses get_lam()
            return self.get_lam() if lam is None else lam
        lam = self.reg.get_lam() if lam is None else lam
        return lam * _abs_max(x)

    def prox(self, x, lam=None):
        return self.reg.prox(x, self._eff_lam(x, lam))

    def value(self, x, lam=None):
        return self.reg.value(x, self._eff_lam(x, lam))


@dataclasses.dataclass(frozen=True)
class NormalizedRegularization(NestedRegularization):
    """λ scaled by a solver-computed normalization factor
    (reference NormalizedRegularization.jl:30-38)."""

    reg: Regularization
    factor: Any

    def get_lam(self):
        return self.reg.get_lam() * self.factor


# --------------------------------------------------------------------------
# normalization strategies
# --------------------------------------------------------------------------


class AbstractNormalization:
    pass


@dataclasses.dataclass(frozen=True)
class NoNormalization(AbstractNormalization):
    pass


@dataclasses.dataclass(frozen=True)
class MeasurementBasedNormalization(AbstractNormalization):
    pass


@dataclasses.dataclass(frozen=True)
class SystemMatrixBasedNormalization(AbstractNormalization):
    pass


def normalization_factor(strategy, A, b):
    """λ scale factor for the given strategy, one per problem: `b` is
    (..., m) and the result has b's leading shape. Returned in float32, as
    ``rls_tpu`` returns it whatever the problem dtype.

    * No: 1
    * MeasurementBased: ‖b‖₁ / length(b)
    * SystemMatrixBased: Σ_m ‖a_m‖² / N   (row energies of A)
    """
    lead = () if b is None else b.shape[:-1]
    if isinstance(strategy, NoNormalization) or strategy is None:
        device = None if b is None else b.device
        return torch.ones(lead, dtype=torch.float32, device=device)
    if isinstance(strategy, MeasurementBasedNormalization):
        if b is None:
            return torch.ones((), dtype=torch.float32)
        return (b.abs().sum(dim=-1) / b.shape[-1]).real.to(torch.float32)
    if isinstance(strategy, SystemMatrixBasedNormalization):
        if A is None:
            raise ValueError(
                "SystemMatrixBasedNormalization requires supplying A to the solver"
            )
        return (A.row_norms_sq().sum() / A.in_size).to(torch.float32).expand(lead)
    raise TypeError(f"unknown normalization strategy {strategy!r}")


# --------------------------------------------------------------------------
# transformed / masked decorators
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TransformedRegularization(NestedRegularization):
    """prox in a transform domain: x ← Φᴴ prox(Φ x)
    (reference TransformedRegularization.jl:28-33); Φ is a
    ``LinearOperator``."""

    reg: Regularization
    trafo: Any

    def prox(self, x, lam=None):
        return self.trafo.rmv(self.reg.prox(self.trafo.mv(x), lam))

    def value(self, x, lam=None):
        return self.reg.value(self.trafo.mv(x), lam)


@dataclasses.dataclass(frozen=True)
class MaskedRegularization(NestedRegularization):
    """prox applied only to the masked entries of the last axis (reference
    MaskedRegularization.jl:31-35). The mask is a static tuple of bools;
    the prox writes into a new tensor, never into the caller's."""

    reg: Regularization
    mask: tuple

    def __post_init__(self):
        mask = tuple(bool(m) for m in self.mask)
        object.__setattr__(self, "mask", mask)
        # the masked entries' indices, once (not a field: eq and hash read the mask)
        object.__setattr__(self, "_idx", torch.tensor([i for i, m in enumerate(mask) if m],
                                                      dtype=torch.int64))

    def prox(self, x, lam=None):
        idx = self._idx.to(x.device)
        return x.index_copy(-1, idx, self.reg.prox(x.index_select(-1, idx), lam))

    def value(self, x, lam=None):
        return self.reg.value(x.index_select(-1, self._idx.to(x.device)), lam)


# --------------------------------------------------------------------------
# input transforms for plug-and-play (reference Transforms.jl): each takes
# its statistics per problem, over the last axis
# --------------------------------------------------------------------------


class MinMaxTransform:
    def __init__(self, x):
        self.min = x.amin(dim=-1, keepdim=True)
        self.max = x.amax(dim=-1, keepdim=True)

    def forward(self, x):
        return (x - self.min) / (self.max - self.min)

    def backward(self, x):
        return x * (self.max - self.min) + self.min


class IdentityTransform:
    def __init__(self, x=None):
        pass

    def forward(self, x):
        return x

    def backward(self, x):
        return x


class ZTransform:
    """(x − mean) / std with the population std (``jnp.std``'s ddof 0)."""

    def __init__(self, x):
        self.mean = x.mean(dim=-1, keepdim=True)
        self.std = x.std(dim=-1, correction=0, keepdim=True)

    def forward(self, x):
        return (x - self.mean) / self.std

    def backward(self, x):
        return x * self.std + self.mean


class ClampedScalingTransform:
    def __init__(self, x, v_min, v_max):
        self.v_min = v_min
        self.v_max = v_max
        self.mask = (x < v_min) | (x >= v_max)
        self.x = x

    def forward(self, x):
        return (torch.clamp(x, self.v_min, self.v_max) - self.v_min) / (self.v_max - self.v_min)

    def backward(self, x):
        out = x * (self.v_max - self.v_min) + self.v_min
        return torch.where(self.mask, self.x, out)


# --------------------------------------------------------------------------
# plug-and-play learned prox
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlugAndPlayRegularization(ParameterizedRegularization):
    """Learned denoiser as proximal map: x ← x − λ(x − model(x)), applied in
    a normalized input range (reference PlugAndPlayRegularization.jl).

    ``model`` is a torch callable on a batch of images (B, *shape), e.g.
    ``models/denoisers.py`` ``make_pnp_model``; with ``shape=None`` it gets
    x's (B, n) as it is. The input transform takes its statistics per
    problem. λ is clipped to [0, 1] (with a warning at construction where
    it lies outside). Complex inputs are denoised as two real problems, or
    only the real part under ``ignore_im``. ``value`` raises: the term has
    no explicit functional."""

    lam: Any
    model: Callable = None
    shape: tuple = None
    input_transform: Any = MinMaxTransform
    ignore_im: bool = False

    def __post_init__(self):
        if self.shape is not None:
            object.__setattr__(self, "shape", tuple(self.shape))
        # reference warns when λ is clipped to [0, 1]
        # (PlugAndPlayRegularization.jl:47-51)
        lam = torch.as_tensor(self.lam)
        if bool(((lam < 0) | (lam > 1)).any()):
            warnings.warn(
                "PlugAndPlayRegularization λ is clipped to the [0, 1] interval at prox time",
                stacklevel=3,
            )

    def _prox_real(self, x, lam):
        lam = torch.clamp(torch.as_tensor(lam, dtype=x.dtype, device=x.device), 0.0, 1.0)
        if lam.ndim:  # one λ per problem
            lam = lam.reshape(-1, 1)
        xb = x.reshape(-1, x.shape[-1])
        tf = self.input_transform(xb)
        z = tf.forward(xb)
        denoised = self.model(z.reshape(-1, *self.shape) if self.shape else z).reshape(z.shape)
        z = z - lam * (z - denoised)
        return tf.backward(z).reshape(x.shape)

    def prox(self, x, lam=None):
        if lam is None:
            lam = self.lam
        if x.is_complex():
            re = self._prox_real(x.real, lam)
            im = x.imag if self.ignore_im else self._prox_real(x.imag, lam)
            return torch.complex(re, im).to(x.dtype)
        return self._prox_real(x, lam)

    def value(self, x, lam=None):
        raise NotImplementedError("PlugAndPlayRegularization has no explicit functional value")


PnPRegularization = PlugAndPlayRegularization
