"""Proximal maps.

PyTorch counterpart of ``rls_tpu/models/prox.py``: ``soft_threshold`` and
``L1Regularization`` (:57-80), ``L2Regularization`` (:82-97),
``L21Regularization`` (:100-125), ``prox_tv_fgp`` (:133-166),
``TVRegularization`` (:205-280), ``NuclearRegularization`` (:331-356),
``LLRRegularization`` with ``_block_partition`` / ``_block_departition``
(:359-511), ``PositiveRegularization``, ``RealRegularization`` and
``ProjectionRegularizationTerm`` (:514-544).

``TVRegularization(backend="cuda")`` takes the place of ``"pallas"``: a
2-D TV over both axes of a real image goes to the hand-written FGP kernel
(``kernels/tv_fgp.py``), which runs its plain PyTorch version on CPU
tensors. ``backend="torch"`` takes the place of ``"xla"``: the composed
FGP on ``GradientOperator``. The TPU's VMEM size gate (:256) has no
counterpart: the CUDA kernel keeps its planes in global memory. An
integer ``dims`` on a real image is the exact 1-D Condat prox along that
axis (``models/tv_condat.py``, on the hand-written kernel
``csrc/tv_condat.cu``), whatever the backend; on a complex image it is the
FGP along that axis alone.

Nuclear and LLR threshold singular values with ``torch.linalg.svd``
(batched over problems and blocks) for every ``svd_method``: the Jacobi
SVD of ``rls_tpu/ops/jacobi_svd.py`` exists for the TPU's bf16 matrix
unit and is not ported. On a CUDA tensor the SVD runs with
``CUDA_SVD_DRIVER``.

A λ is a scalar or carries x's leading batch axes (one λ per problem).
``L2Regularization`` also takes the reference's vector λ, one per entry
of x (a diagonal Tikhonov matrix).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Optional

import torch

from ..ops.grad import GradientOperator
from ..utils.misc import enf_pos, enf_real
from .regularization import ParameterizedRegularization, ProjectionRegularization
from .tv_condat import prox_tv_1d_axis

__all__ = [
    "L1Regularization",
    "L2Regularization",
    "L21Regularization",
    "TVRegularization",
    "NuclearRegularization",
    "LLRRegularization",
    "PositiveRegularization",
    "RealRegularization",
    "ProjectionRegularizationTerm",
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


@dataclasses.dataclass(frozen=True)
class L21Regularization(ParameterizedRegularization):
    """Group soft threshold (reference ProxL21.jl). The last axis is viewed
    as `slices` stacked groups of length ``len / slices``; group g collects
    x[g::sliceLength], so the norms run over the `slices` axis. With
    ``slices=2`` on a split [re; im] vector this is the complex L1 prox."""

    lam: Any
    slices: int = 1

    def _group_scale(self, x, lam):
        sl = x.shape[-1] // self.slices
        x2 = x.reshape(*x.shape[:-1], self.slices, sl)
        gn = torch.sqrt((x2.abs() ** 2).sum(dim=-2))
        safe = torch.where(gn == 0, torch.ones_like(gn), gn)
        scale = torch.clamp((gn - _lam_col(lam, x)) / safe, min=0)
        return x2, gn, scale

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        x2, _, scale = self._group_scale(x, lam)
        return (x2 * scale.unsqueeze(-2)).reshape(x.shape)

    def value(self, x, lam=None):
        lam = self.lam if lam is None else lam
        _, gn, _ = self._group_scale(x, lam)
        return _lam(lam, x) * gn.sum(dim=-1)


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
    """TV prox: exact 1-D Condat when `dims` is a single int (reference
    ProxTV.jl:64-79), the FGP dual iteration otherwise (:89-125).

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
        if self.shape is not None:
            object.__setattr__(self, "shape", tuple(self.shape))
        if self.dims is None and self.shape is not None:
            object.__setattr__(self, "dims", tuple(range(len(self.shape))))

    def _dims(self):
        return (self.dims,) if isinstance(self.dims, int) else tuple(self.dims)

    def _grad_op(self, x):
        return GradientOperator(
            im_shape=self.shape, dims=self._dims(), dtype=x.dtype, device=x.device
        )

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        if isinstance(self.dims, int) and not x.is_complex():
            # the exact 1-D prox along `dims` of each problem's image
            lead = x.shape[:-1]
            img = x.reshape(*lead, *self.shape)
            return prox_tv_1d_axis(img, lam, len(lead) + self.dims).reshape(x.shape)
        if (
            self.backend == "cuda"
            and not x.is_complex()
            and len(self.shape) == 2
            and tuple(sorted(self._dims())) == (0, 1)
        ):
            from ..kernels.tv_fgp import prox_tv2d_fgp

            return prox_tv2d_fgp(x, lam, self.shape, self.iterations_tv)
        return prox_tv_fgp(x, lam, self._grad_op(x), self.iterations_tv)

    def value(self, x, lam=None):
        lam = self.lam if lam is None else lam
        g = self._grad_op(x).mv(x)
        return _lam(lam, g) * g.abs().sum(dim=-1)


# --------------------------------------------------------------------------
# nuclear & locally-low-rank
# --------------------------------------------------------------------------

# the driver of torch.linalg.svd on a CUDA tensor. chip_smoke.py phase 12
# times cuSOLVER's drivers at LLR's cine blocks (1,024 of 64 x 16, complex)
# and Nuclear's 8 matrices of 256 x 256: on an H100, "gesvda" (batched) took
# 0.49 and 10.3 ms with SVT errors of 2.4e-7 and 3.0e-7 of float64's, where
# torch's default (gesvdj here) took 699 and 55 ms with 6.8e-6 and 5.9e-5
# (PERF.md, PR 23). gesvda takes tall matrices: a wide one goes transposed.
CUDA_SVD_DRIVER: Optional[str] = "gesvda"


def _svd(m, compute_uv=True):
    driver = CUDA_SVD_DRIVER if m.device.type == "cuda" else None
    if driver == "gesvda" and m.shape[-2] < m.shape[-1]:
        if not compute_uv:
            return _svd(m.mH, False)
        u, s, vh = _svd(m.mH)  # m = (u s vh)ᴴ = vhᴴ s uᴴ
        return vh.mH, s, u.mH
    if compute_uv:
        return torch.linalg.svd(m, full_matrices=False, driver=driver)
    if driver is None:
        return torch.linalg.svdvals(m)
    return torch.linalg.svdvals(m, driver=driver)


def _svt(m, lam):
    """Batched singular-value soft threshold of the matrices `m` (..., r,
    c); λ is a scalar or carries m's leading axes."""
    u, s, vh = _svd(m)
    s = torch.clamp(s - _lam_col(lam, s), min=0)
    return (u * s.unsqueeze(-2).to(u.dtype)) @ vh


@dataclasses.dataclass(frozen=True)
class NuclearRegularization(ParameterizedRegularization):
    """Singular value soft-thresholding (reference ProxNuclear.jl): each
    problem's vector is viewed as a matrix of `svt_shape`.

    ``svd_method`` is kept ("auto", "jacobi" or "xla"), so that ``convert``
    carries it, but every method runs ``torch.linalg.svd``: the one-sided
    Jacobi SVD of ``rls_tpu/ops/jacobi_svd.py`` answers the TPU's bf16
    matrix unit and is not ported."""

    lam: Any
    svt_shape: tuple = None
    svd_method: str = "auto"

    def __post_init__(self):
        if self.svt_shape is not None:
            object.__setattr__(self, "svt_shape", tuple(self.svt_shape))

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        m = x.reshape(*x.shape[:-1], *self.svt_shape)
        return _svt(m, lam).reshape(x.shape)

    def value(self, x, lam=None):
        lam = self.lam if lam is None else lam
        s = _svd(x.reshape(*x.shape[:-1], *self.svt_shape), compute_uv=False)
        return _lam(lam, s) * s.sum(dim=-1)


def _block_partition(img, block):
    """(B, s0..sn, K) zero-padded → ((B, L, prod(block), K) distinct blocks,
    the padded shape)."""
    B, K = img.shape[0], img.shape[-1]
    shape = img.shape[1:-1]
    nd = len(shape)
    pads = []
    for d in reversed(range(nd)):  # F.pad lists the last axis first
        pads += [0, (-shape[d]) % block[d]]
    xp = torch.nn.functional.pad(img, [0, 0] + pads)
    pshape = xp.shape[1:-1]
    inter = []  # (B, n0, b0, n1, b1, ..., K)
    for d in range(nd):
        inter += [pshape[d] // block[d], block[d]]
    xr = xp.reshape(B, *inter, K)
    # → (B, n0, n1, ..., b0, b1, ..., K)
    perm = [0] + [1 + 2 * d for d in range(nd)] + [2 + 2 * d for d in range(nd)] + [1 + 2 * nd]
    L = math.prod(pshape[d] // block[d] for d in range(nd))
    return xr.permute(perm).reshape(B, L, math.prod(block), K), tuple(pshape)


def _block_departition(blocks, block, pshape, orig_shape, K):
    """Inverse of :func:`_block_partition`, cropped to `orig_shape`."""
    B = blocks.shape[0]
    nd = len(orig_shape)
    nblk = [pshape[d] // block[d] for d in range(nd)]
    xt = blocks.reshape(B, *nblk, *block, K)
    perm = [0]
    for d in range(nd):
        perm += [1 + d, 1 + nd + d]
    perm += [1 + 2 * nd]
    xr = xt.permute(perm).reshape(B, *pshape, K)
    return xr[(slice(None),) + tuple(slice(0, s) for s in orig_shape)]


def llr_shifts(seed: int, block_size) -> tuple:
    """The random block shift of `seed`, one per axis in [0, b): drawn from
    a CPU ``torch.Generator`` seeded with `seed`, a pure function of it
    (``rls_tpu`` draws them with ``jax.random``, which the port cannot
    repeat)."""
    gen = torch.Generator().manual_seed(int(seed))
    return tuple(int(torch.randint(0, int(b), (1,), generator=gen)) for b in block_size)


@dataclasses.dataclass(frozen=True)
class LLRRegularization(ParameterizedRegularization):
    """Locally-low-rank prox: blockwise SVT over image patches with optional
    random block shift and fully-overlapping mode (reference ProxLLR.jl).

    Each problem's vector is an image of `shape` times K (the last,
    fastest axis); all problems' blocks go through ONE batched SVT.
    ``randshift`` rolls the image by :func:`llr_shifts` of `seed` (the
    same shifts in ``prox`` and ``value``); the private ``_shifts`` field,
    set with ``dataclasses.replace``, feeds given shifts instead (the
    tests feed ``rls_tpu``'s)."""

    lam: Any
    shape: tuple = None
    block_size: tuple = None
    randshift: bool = True
    fully_overlapping: bool = False
    L: int = 1
    seed: int = 1234
    svd_method: str = "auto"  # see NuclearRegularization
    _shifts: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.shape is not None:
            object.__setattr__(self, "shape", tuple(self.shape))
        bs = self.block_size
        if bs is None and self.shape is not None:
            bs = tuple(2 for _ in self.shape)
        if bs is not None:
            object.__setattr__(self, "block_size", tuple(bs))

    def shifts(self) -> tuple:
        """The block shift `randshift` applies."""
        if self._shifts is not None:
            return tuple(int(s) for s in self._shifts)
        return llr_shifts(self.seed, self.block_size)

    def _axes(self):
        return tuple(range(1, len(self.shape) + 1))

    def _svt_blocks(self, img, lam):
        blocks, pshape = _block_partition(img, self.block_size)
        lam = _lam(lam, img)
        lam_b = lam.reshape(-1, 1) if lam.ndim else lam  # one λ per problem's blocks
        recon = _svt(blocks, lam_b)
        return _block_departition(recon, self.block_size, pshape, self.shape, img.shape[-1])

    def _prox_nonoverlapping(self, img, lam):
        if self.randshift:
            shifts, axes = self.shifts(), self._axes()
            out = self._svt_blocks(torch.roll(img, shifts, axes), lam)
            return torch.roll(out, tuple(-s for s in shifts), axes)
        return self._svt_blocks(img, lam)

    def _prox_overlapping(self, img, lam):
        """Average of all block-shifted non-overlapping passes
        (reference proxLLROverlapping!, ProxLLR.jl:160-195)."""
        axes = self._axes()
        total = torch.zeros_like(img)
        for shift in itertools.product(*(range(b) for b in self.block_size)):
            ys = self._svt_blocks(torch.roll(img, shift, axes), lam)
            total = total + torch.roll(ys, tuple(-s for s in shift), axes)
        return total / math.prod(self.block_size)

    def _image(self, x):
        """x (..., n) as (B, *shape, K)."""
        return x.reshape(-1, *self.shape, x.shape[-1] // math.prod(self.shape))

    def prox(self, x, lam=None):
        lam = self.lam if lam is None else lam
        img = self._image(x)
        lam = _lam(lam, x).reshape(-1) if _lam(lam, x).ndim else lam
        if self.fully_overlapping:
            out = self._prox_overlapping(img, lam)
        else:
            out = self._prox_nonoverlapping(img, lam)
        return out.reshape(x.shape)

    def value(self, x, lam=None):
        """Σλ‖block‖_* over *full* blocks only (reference blockNuclearNorm,
        ProxLLR.jl:115-152): each of the L chunks is rolled by the shift of
        ``prox``, and the trailing partial blocks of a non-dividing shape,
        zero-padded for the batched SVD, are masked out of the sum."""
        lam = self.lam if lam is None else lam
        nvox = math.prod(self.shape)
        K = x.shape[-1] // (nvox * self.L)
        nd = len(self.shape)
        nblk = [-(-self.shape[d] // self.block_size[d]) for d in range(nd)]
        full = torch.zeros(nblk, dtype=_real_dtype(x.dtype), device=x.device)
        full[tuple(slice(0, self.shape[d] // self.block_size[d]) for d in range(nd))] = 1.0
        full = full.reshape(-1)
        xb = x.reshape(-1, x.shape[-1])
        total = 0.0
        for i in range(self.L):
            chunk = xb[:, i * nvox * K:(i + 1) * nvox * K].reshape(-1, *self.shape, K)
            if self.randshift:
                chunk = torch.roll(chunk, self.shifts(), self._axes())
            blocks, _ = _block_partition(chunk, self.block_size)
            s = _svd(blocks, compute_uv=False)
            total = total + (full[:, None] * s).sum(dim=(-2, -1))
        return _lam(lam, x) * total.reshape(x.shape[:-1])


@dataclasses.dataclass(frozen=True)
class PositiveRegularization(ProjectionRegularization):
    def prox(self, x, lam=None):
        return enf_pos(enf_real(x))

    def value(self, x, lam=None):
        ok = (self.prox(x) == x).all(dim=-1)
        return torch.where(ok, 0.0, torch.inf)


@dataclasses.dataclass(frozen=True)
class RealRegularization(ProjectionRegularization):
    def prox(self, x, lam=None):
        return enf_real(x)

    def value(self, x, lam=None):
        ok = (self.prox(x) == x).all(dim=-1)
        return torch.where(ok, 0.0, torch.inf)


@dataclasses.dataclass(frozen=True)
class ProjectionRegularizationTerm(ProjectionRegularization):
    """Arbitrary user projection (reference ProxProj.jl): `proj_func` is a
    torch callable on x of shape (..., n)."""

    proj_func: Callable = None

    def prox(self, x, lam=None):
        return self.proj_func(x)

    def value(self, x, lam=None):
        ok = (self.prox(x) == x).all(dim=-1)
        return torch.where(ok, 0.0, torch.inf)
