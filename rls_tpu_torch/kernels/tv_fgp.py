"""Batched 2-D anisotropic TV prox by FGP: the hand-written CUDA kernel
``csrc/tv_fgp.cu`` and its plain PyTorch version.

Counterpart of ``rls_tpu/kernels/tv_pallas.py`` (``prox_tv2d_fgp_pallas``
:69, kernel body ``_kernel`` :39): the fori FGP of
``rls_tpu/kernels/_fgp_common.py:939-964`` with one λ per problem. The
wrapper takes the plain version only for a tensor on the CPU; a CUDA
tensor launches the kernel or raises.

The kernel runs on one of two routes that :func:`plan_tv_fgp` picks by
shape (``csrc/tv_fgp.cu``):

* resident: each problem on a thread-block cluster of c ≤ 16 CTAs, one
  band of image rows per CTA, with xtmp and the dual momentum (rv, rh) in
  shared memory, other bands' rows read through distributed shared
  memory; x, pv and ph, read at their own pixel only, in shared memory
  too where the band fits all six planes, else in global memory. The
  planner prices a wave of clusters by its band's pixels and a fixed
  cost, both measured (64 × 256²: 8 bands of 32 rows, all six planes on
  chip; 16 × 256²: 6 bands of 43 rows, three, in one wave; 16 × 512²: 16
  bands of 32 rows, three);
* global: one CTA per problem with its planes in global scratch, where no
  band fits (a row wider than ~19,300 pixels, or 1024²).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .._build import SMEM_MAX, SMS
from . import _fgp_common
from ._bands import HALO, BandPlan, band_sizes, cdiv, fewest_waves

__all__ = ["prox_tv2d_fgp", "prox_tv2d_fgp_torch", "plan_tv_fgp", "TvFgpPlan"]

# the kernel's threads per CTA and its largest cluster (the non-portable
# size); the resident route's planes in shared memory: xtmp, rv, rh, and
# x, pv, ph too where they fit (csrc/tv_fgp.cu)
THREADS, MAX_CLUSTER = 1024, 16
SHARED_PLANES, ALL_PLANES = 3, 6
# global scratch planes of (B, H, W): the resident route's pv and ph where
# they are not in shared memory; the global route's xtmp, pv, ph, rv, rh
OWN_SCRATCH, GLOBAL_SCRATCH = 2, 5
# the planes by name, and the shared-memory plane that holds each on the
# resident route (S0-S2 always; S3-S5 the own-pixel planes where they fit)
PLANES = ("xtmp", "rv", "rh", "pv", "ph", "x")
# the planner's cost of a wave of clusters, in the time of a band pixel
# with all six planes on chip: a fixed WAVE_PIXELS (its barriers and
# set-up), and GLOBAL_PIXEL for a band pixel whose x, pv and ph are in
# global memory. Fitted to every cluster size and placement at 64 × 256²,
# 16 × 256² and 16 × 512² on an H100 (chip_smoke.py --time-tv-fgp, PERF.md
# §6): 2.0 µs a wave and 0.45 / 0.69 ns a pixel, per dual iteration
WAVE_PIXELS, GLOBAL_PIXEL = 4400, 1.5


def cluster_smem_bytes(rows, W, own_shared):
    """Shared memory of a resident CTA whose band has `rows` rows of width
    W, as ``cluster_smem_bytes`` in csrc/tv_fgp.cu counts it: three planes
    (six where x, pv and ph are in shared memory too), each rounded up to
    4 floats, and the DSMEM row table (rows + 2·HALO pointers)."""
    planes = ALL_PLANES if own_shared else SHARED_PLANES
    return 4 * planes * cdiv(rows * W, 4) * 4 + 8 * (rows + 2 * HALO)


@dataclasses.dataclass(frozen=True)
class TvFgpPlan(BandPlan):
    """How a TV prox launch runs: a ``BandPlan`` (route, cluster size, rows
    per band, CTAs and shared memory per CTA), `scratch` planes of (B, H,
    W) in global memory, and `own` where x, pv and ph live on the resident
    route ("shared" or "global")."""

    scratch: int
    own: str = "global"

    def places(self):
        """{plane: "shared" | "global"} for each plane of ``PLANES``."""
        if self.route == "global":
            return dict.fromkeys(PLANES, "global")
        return {p: "shared" if k < SHARED_PLANES else self.own for k, p in enumerate(PLANES)}


def _sizes(H, W, own_shared, sms, smem_max):
    return band_sizes(H, W, range(1, MAX_CLUSTER + 1),
                      lambda rows, w: cluster_smem_bytes(rows, w, own_shared), sms, smem_max)


def fitting_sizes(H, W, sms=SMS, smem_max=SMEM_MAX):
    """The cluster sizes c ≤ 16 (and ≤ sms) whose bands of ⌈H/c⌉ rows fit
    one CTA's shared memory with no band empty, with the three shared
    planes: the sizes of the resident route."""
    return _sizes(H, W, False, sms, smem_max)


def own_shared_sizes(H, W, sms=SMS, smem_max=SMEM_MAX):
    """The sizes of :func:`fitting_sizes` whose bands fit all six planes."""
    return _sizes(H, W, True, sms, smem_max)


def _resident_plan(B, H, W, c, own_shared):
    rows = cdiv(H, c)
    return TvFgpPlan("resident", c, rows, H, B * c, cluster_smem_bytes(rows, W, own_shared),
                     0 if own_shared else OWN_SCRATCH, "shared" if own_shared else "global")


@functools.lru_cache(maxsize=256)
def plan_tv_fgp(B, H, W, resident, sms=SMS, smem_max=SMEM_MAX, clusters=None) -> TvFgpPlan:
    """The route of a TV prox launch of B problems of H × W on a card of
    `sms` SMs and `smem_max` bytes of shared memory per block that holds n
    clusters of c CTAs of the resident kernel at once for each pair (c, n)
    of `resident` (``cudaOccupancyMaxActiveClusters`` of the kernel with
    the planes that c's band holds; a size not named is held 0 times).

    The rule: each fitting size keeps x, pv and ph in shared memory where
    its band fits all six planes, else in global memory; among the sizes,
    ``fewest_waves`` takes the least waves × cost of a wave
    (``MIN_CTA_PIXELS``, ties to the smaller c), a wave costing
    WAVE_PIXELS plus its band's pixels, each GLOBAL_PIXEL where x, pv and
    ph are in global memory. `clusters` forces a size of
    :func:`fitting_sizes` instead (the timing mode and the tests compare
    sizes with it). An image whose bands fit at no c takes the global
    route. Raises ValueError naming the shape where it is empty, a forced
    size unfit, or no route exists (2³¹ pixels or more per problem), and
    naming the plan where the card holds no cluster of it (no fallback)."""
    if min(B, H, W) < 1:
        raise ValueError(f"prox_tv2d_fgp: empty shape {B} x {H}x{W}")
    fit = fitting_sizes(H, W, sms, smem_max)
    on_chip = own_shared_sizes(H, W, sms, smem_max)
    if clusters is not None and clusters not in fit:
        raise ValueError(f"prox_tv2d_fgp: a cluster of {clusters} CTAs does not fit "
                         f"{B} x {H}x{W} (the fitting sizes: {fit})")
    if fit:
        c = clusters or fewest_waves(
            B, H, W, fit, resident,
            lambda c: WAVE_PIXELS + cdiv(H, c) * W * (1 if c in on_chip else GLOBAL_PIXEL))
        plan = _resident_plan(B, H, W, c, c in on_chip)
        if dict(resident).get(c, 0) < 1:
            raise ValueError(f"prox_tv2d_fgp: the card holds no cluster of {plan} "
                             f"({B} x {H}x{W})")
        return plan
    if H * W >= 2**31:
        raise ValueError(
            f"prox_tv2d_fgp: no route for {B} x {H}x{W}: bands fit no cluster of at most "
            f"{MAX_CLUSTER} CTAs with {smem_max} bytes of shared memory each, and one CTA "
            "per problem indexes fewer than 2**31 pixels"
        )
    return TvFgpPlan("global", 1, H, H, B, 0, GLOBAL_SCRATCH)


@functools.lru_cache(maxsize=None)
def resident_limits(index, clusters, rows, W, own_shared):
    """(shared memory per CTA as the kernel counts it, clusters of the
    resident kernel with its own-pixel planes in shared memory or not that
    device `index` holds at once: ``cudaOccupancyMaxActiveClusters``)."""
    from .. import _build

    out = (ctypes.c_longlong * 2)()
    with torch.cuda.device(index):
        _build.check(_build.load_library().tv_fgp_cluster_occupancy(
            clusters, rows, W, int(own_shared), out), "tv_fgp_cluster_occupancy")
    return out[0], out[1]


@functools.lru_cache(maxsize=256)
def _card_plan(index, B, H, W, clusters=None, own=None):
    """(plan, clusters resident at once) of a launch of B × H × W on device
    `index`, with ``plan_tv_fgp``'s forced `clusters`; `own` = "global"
    keeps x, pv and ph in global memory where they would fit in shared
    memory (the timing mode's and the card tests' placement A/B)."""
    from .. import _build

    limits = _build.device_limits(index)
    on_chip = () if own == "global" else own_shared_sizes(H, W, *limits)
    held = {c: resident_limits(index, c, cdiv(H, c), W, c in on_chip)
            for c in fitting_sizes(H, W, *limits)}
    plan = plan_tv_fgp(B, H, W, tuple((c, n) for c, (_, n) in held.items()), *limits,
                       clusters=clusters)
    if own == "global" and plan.route == "resident":
        plan = _resident_plan(B, H, W, plan.clusters, False)
    if plan.route == "global":
        return plan, None
    smem, active = held[plan.clusters]
    if smem != plan.smem:
        raise RuntimeError(f"prox_tv2d_fgp: the kernel counts {smem} bytes of shared memory "
                           f"for {plan}")
    return plan, active


def plan_on_card(xb):
    """(plan, clusters resident at once) of a launch on xb's card, (B, H, W);
    the count is None on the global route. Raises RuntimeError where the
    kernel counts other shared memory than the planner, ValueError where
    the resident plan has no cluster the card can hold."""
    return _card_plan(xb.device.index or 0, *xb.shape)


def _batch_lam(lam, x, B):
    """λ as (B,) float32 on x's device: a scalar, or an array
    broadcastable to x's leading (batch) axes."""
    lam = torch.as_tensor(lam, dtype=x.dtype, device=x.device)
    if lam.ndim == 0:
        return lam.expand(B)
    if x.ndim == 1:  # unbatched x with a (1,)-shaped λ
        return lam.reshape(B)
    return torch.broadcast_to(lam, x.shape[:-1]).reshape(B)


def prox_tv2d_fgp_torch(xb, lamb, iterations: int):
    """Plain version: `xb` (B, H, W), `lamb` (B,)."""
    return _fgp_common.fgp_loop(xb, lamb.view(-1, 1, 1), iterations)


def _launch(xb, lamb, iterations: int, clusters=None, own=None):
    """One launch on `xb` (B, H, W) float32 and `lamb` (B,), both contiguous
    on a CUDA device, on the card's plan, or with ``_card_plan``'s forced
    `clusters` and `own` (the timing mode and the card tests)."""
    from .. import _build

    B, H, W = xb.shape
    plan, _ = _card_plan(xb.device.index or 0, B, H, W, clusters, own)
    lib = _build.load_library()
    out = torch.empty_like(xb)
    # the kernel zeroes the duals itself; a plan with every plane in shared
    # memory needs no scratch
    scratch = (torch.empty((plan.scratch, B, H, W), dtype=xb.dtype, device=xb.device)
               if plan.scratch else None)
    args = (xb.data_ptr(), lamb.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, H, W, iterations)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "resident":
            code = lib.tv_fgp_cluster_launch(*args, plan.clusters, plan.rows,
                                             int(plan.own == "shared"), plan.smem, stream)
        else:
            code = lib.tv_fgp_launch(*args, stream)
    _build.check(code, f"prox_tv2d_fgp ({B} x {H}x{W}, {plan})")
    prox_tv2d_fgp.launches += 1
    prox_tv2d_fgp.route_launches[plan.route] += 1
    return out


def prox_tv2d_fgp(x, lam, im_shape, iterations: int):
    """Batched fused 2-D TV prox, on the route of :func:`plan_tv_fgp`.

    x: (..., H*W) real array (leading axes = batch); lam: scalar or an
    array broadcastable to the leading axes (per-problem λ). Returns x's
    shape. ``prox_tv2d_fgp.launches`` counts the CUDA kernel's launches,
    and ``prox_tv2d_fgp.route_launches`` the launches by route.
    """
    H, W = im_shape
    xb = x.reshape(-1, H, W)
    B = xb.shape[0]
    lamb = _batch_lam(lam, x, B)
    if x.device.type == "cpu":
        return prox_tv2d_fgp_torch(xb, lamb, iterations).reshape(x.shape)
    if x.device.type != "cuda":
        raise ValueError(f"prox_tv2d_fgp: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"prox_tv2d_fgp: the CUDA kernel takes float32, got {x.dtype}")
    out = _launch(xb.contiguous(), lamb.contiguous(), iterations)
    return out.reshape(x.shape)


prox_tv2d_fgp.launches = 0
prox_tv2d_fgp.route_launches = {"resident": 0, "global": 0}
