"""Batched 2-D anisotropic TV prox by FGP: the hand-written CUDA kernel
``csrc/tv_fgp.cu`` and its plain PyTorch version.

Counterpart of ``rls_tpu/kernels/tv_pallas.py`` (``prox_tv2d_fgp_pallas``
:69, kernel body ``_kernel`` :39): the fori FGP of
``rls_tpu/kernels/_fgp_common.py:939-964`` with one λ per problem. The
wrapper takes the plain version only for a tensor on the CPU; a CUDA
tensor launches the kernel or raises.

The kernel runs on one of three routes that :func:`plan_tv_fgp` picks by
shape and dual iterations (``csrc/tv_fgp.cu``):

* resident: each problem on a thread-block cluster of c ≤ 16 CTAs, one
  band of image rows per CTA, with xtmp and the dual momentum (rv, rh) in
  shared memory, other bands' rows read through distributed shared
  memory; x, pv and ph, read at their own pixel only, in shared memory
  too where the band fits all six planes, else in global memory. The
  planner prices a wave of clusters by its band's pixels and a fixed
  cost, both measured (64 × 256²: 8 bands of 32 rows, all six planes on
  chip; 16 × 256²: 6 bands of 43 rows, three, in one wave; 16 × 512²: 16
  bands of 32 rows, three);
* windows: where a problem's bands fit no cluster (1024²), the resident
  route's kernel on windows of rows, a cluster each: a window of
  `interior` rows widened by a halo of as many rows as dual iterations on
  each side, so that its interior is bit for bit the whole image's (an
  edge's error moves one row a dual iteration), and only the interior
  written. The planner takes the cluster size, placement and windows by
  the same waves × cost of a wave, halo rows counted as band pixels;
* global: one CTA per problem with its planes in global scratch, where no
  window fits: a row wider than ~19,300 pixels (no band of one row), or
  than ~9,660 at 10 dual iterations (16 CTAs hold fewer than 2·halo + 1
  rows).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .._build import SMEM_MAX, SMS
from . import _fgp_common
from ._bands import HALO, MIN_CTA_PIXELS, BandPlan, band_sizes, cdiv, fewest_waves

__all__ = ["prox_tv2d_fgp", "prox_tv2d_fgp_torch", "prox_tv2d_fgp_windows_torch",
           "plan_tv_fgp", "TvFgpPlan"]

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
    per band, the rows the bands cover, CTAs and shared memory per CTA),
    `scratch` planes of (B·windows, H, W) in global memory, `own` where x,
    pv and ph live on a cluster route ("shared" or "global"), and a
    problem's `windows` of `interior` rows, each computed on `H` = min(image
    rows, interior + 2·halo) rows (the windowed route; one window of the
    whole image, no halo, on the others)."""

    scratch: int
    own: str = "global"
    halo: int = 0
    interior: int = 0
    windows: int = 1

    def places(self):
        """{plane: "shared" | "global"} for each plane of ``PLANES``."""
        if self.route == "global":
            return dict.fromkeys(PLANES, "global")
        return {p: "shared" if k < SHARED_PLANES else self.own for k, p in enumerate(PLANES)}

    def spans(self, H):
        """(lo, top, end) of each window of an image of H rows: the window
        is image rows [lo, lo + self.H), its interior [top, end). A window
        is shifted inside the image at its top and bottom (every window has
        self.H rows), so that each interior row lies at least `halo` rows
        from any window edge inside the image (the kernel's map)."""
        out = []
        for t in range(self.windows):
            top = t * self.interior
            out.append((min(max(top - self.halo, 0), H - self.H), top,
                        min(H, top + self.interior)))
        return out


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
    plan = TvFgpPlan("resident", c, cdiv(H, c), H, B * c, 0, 0, interior=H)
    return _placed(plan, W, own_shared)


def _placed(plan, W, own_shared):
    """`plan` (a cluster route) with x, pv and ph in shared memory or not."""
    return dataclasses.replace(plan, smem=cluster_smem_bytes(plan.rows, W, own_shared),
                               scratch=0 if own_shared else OWN_SCRATCH,
                               own="shared" if own_shared else "global")


def window_rows(H, interior, halo):
    """The rows of each window: the interior and a halo on each side, at
    most the image."""
    return min(H, interior + 2 * halo)


def _window_plan(B, H, W, c, halo, interior, smem_max):
    """The windowed plan of `interior` rows a window on clusters of c, x, pv
    and ph in shared memory where the band fits all six planes."""
    T, Hw = cdiv(H, interior), window_rows(H, interior, halo)
    rows = cdiv(Hw, c)
    plan = TvFgpPlan("windows", c, rows, Hw, B * T * c, 0, 0, halo=halo, interior=interior,
                     windows=T)
    return _placed(plan, W, cluster_smem_bytes(rows, W, True) <= smem_max)


def widest_band(W, own_shared, smem_max=SMEM_MAX):
    """The most rows of width W whose band fits `smem_max` bytes (three
    planes, or six with `own_shared`); 0 where not one row fits."""
    planes = ALL_PLANES if own_shared else SHARED_PLANES
    rows = max(0, (smem_max - 8 * 2 * HALO) // (4 * planes * W + 8) + 1)
    while rows and cluster_smem_bytes(rows, W, own_shared) > smem_max:
        rows -= 1
    return rows


def window_candidates(B, H, W, iterations, sms=SMS, smem_max=SMEM_MAX):
    """The windowed plans the planner weighs: for each cluster size c ≤ 16
    (and ≤ sms) and each placement, the fewest windows T whose bands fit
    (c times the widest band, less 2·halo interior rows), with that
    interior or with their interior spread evenly (⌈H/T⌉ rows: smaller
    bands, but a band may be left empty, and such a plan is dropped).
    Within one c and placement more windows cost more: each adds its halo
    rows and no wave gets cheaper than its band."""
    halo, out = iterations, []
    for c in range(1, min(MAX_CLUSTER, sms) + 1):
        for own_shared in (True, False):
            widest = min(H, c * widest_band(W, own_shared, smem_max) - 2 * halo)
            if widest < 1:
                continue
            for interior in (widest, cdiv(H, cdiv(H, widest))):
                plan = _window_plan(B, H, W, c, halo, interior, smem_max)
                if (c - 1) * plan.rows < plan.H and plan not in out:
                    out.append(plan)
    return out


def _wave_cost(plan, W):
    """A wave of `plan`'s clusters, in the time of a band pixel on chip."""
    return WAVE_PIXELS + plan.rows * W * (1 if plan.own == "shared" else GLOBAL_PIXEL)


@functools.lru_cache(maxsize=256)
def plan_tv_fgp(B, H, W, resident, sms=SMS, smem_max=SMEM_MAX, clusters=None, iterations=0,
                interior=None) -> TvFgpPlan:
    """The route of a TV prox launch of B problems of H × W at `iterations`
    dual iterations on a card of `sms` SMs and `smem_max` bytes of shared
    memory per block that holds n clusters of c CTAs of the resident kernel
    at once for each pair (c, n) of `resident` (``cudaOccupancyMaxActiveClusters``
    of the kernel with the planes that c's band holds; a size not named is
    held 0 times).

    The rule: each fitting size keeps x, pv and ph in shared memory where
    its band fits all six planes, else in global memory; among the sizes,
    ``fewest_waves`` takes the least waves × cost of a wave
    (``MIN_CTA_PIXELS``, ties to the smaller c), a wave costing
    WAVE_PIXELS plus its band's pixels, each GLOBAL_PIXEL where x, pv and
    ph are in global memory. `clusters` forces a size of
    :func:`fitting_sizes` instead (the timing mode and the tests compare
    sizes with it). An image whose bands fit at no c takes the windowed
    route: of :func:`window_candidates` the least ⌈B·windows / held(c)⌉ ×
    cost of a wave (halo rows counted as band pixels; ties to the smaller
    c, then the fewer windows), among those that leave every CTA
    ``MIN_CTA_PIXELS`` where any does. `interior` forces the windowed route
    with that many interior rows a window (then `clusters` a size that fits
    its window). Where no window fits either (a row wider than ~19,300
    pixels, or than ~9,660 at 10 dual iterations), the global route.
    Raises ValueError naming the shape where it is empty, a forced size or
    window unfit, or no route exists (2³¹ pixels or more per problem), and
    naming the plan where the card holds no cluster of it (no fallback)."""
    if min(B, H, W) < 1:
        raise ValueError(f"prox_tv2d_fgp: empty shape {B} x {H}x{W}")
    if interior is not None:
        if not 1 <= interior <= H:
            raise ValueError(f"prox_tv2d_fgp: windows of {interior} rows do not fit "
                             f"{B} x {H}x{W}")
        T, Hw = cdiv(H, interior), window_rows(H, interior, iterations)
        plan = plan_tv_fgp(B * T, Hw, W, resident, sms, smem_max, clusters)
        if plan.route != "resident":
            raise ValueError(f"prox_tv2d_fgp: windows of {Hw} rows fit no cluster "
                             f"({B} x {H}x{W})")
        return dataclasses.replace(plan, route="windows", halo=iterations, interior=interior,
                                   windows=T)
    fit = fitting_sizes(H, W, sms, smem_max)
    on_chip = own_shared_sizes(H, W, sms, smem_max)
    if clusters is not None and clusters not in fit:
        raise ValueError(f"prox_tv2d_fgp: a cluster of {clusters} CTAs does not fit "
                         f"{B} x {H}x{W} (the fitting sizes: {fit})")
    held = dict(resident)
    if fit:
        c = clusters or fewest_waves(
            B, H, W, fit, resident,
            lambda c: _wave_cost(_resident_plan(B, H, W, c, c in on_chip), W))
        plan = _resident_plan(B, H, W, c, c in on_chip)
        if held.get(c, 0) < 1:
            raise ValueError(f"prox_tv2d_fgp: the card holds no cluster of {plan} "
                             f"({B} x {H}x{W})")
        return plan
    if H * W >= 2**31:
        raise ValueError(
            f"prox_tv2d_fgp: no route for {B} x {H}x{W}: bands fit no cluster of at most "
            f"{MAX_CLUSTER} CTAs with {smem_max} bytes of shared memory each, and one CTA "
            "per problem indexes fewer than 2**31 pixels"
        )
    candidates = window_candidates(B, H, W, iterations, sms, smem_max)
    if not candidates:
        return TvFgpPlan("global", 1, H, H, B, 0, GLOBAL_SCRATCH, interior=H)
    wide = [p for p in candidates if p.rows * W >= MIN_CTA_PIXELS] or candidates
    ranked = sorted(
        ((cdiv(B * p.windows, held[p.clusters]) * _wave_cost(p, W), p.clusters, p.windows), k)
        for k, p in enumerate(wide) if held.get(p.clusters, 0) >= 1)
    if not ranked:
        raise ValueError(f"prox_tv2d_fgp: the card holds no cluster of {wide[0]} "
                         f"({B} x {H}x{W})")
    return wide[ranked[0][1]]


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
def _card_plan(index, B, H, W, clusters=None, own=None, iterations=0, interior=None):
    """(plan, clusters resident at once) of a launch of B × H × W at
    `iterations` dual iterations on device `index`, with ``plan_tv_fgp``'s
    forced `clusters` and `interior`; `own` = "global" keeps x, pv and ph
    in global memory where they would fit in shared memory (the timing
    mode's and the card tests' placement A/B). The windowed route's
    clusters held at once are read at each c's widest band of three
    planes (the most shared memory a window's CTA takes)."""
    from .. import _build

    limits = _build.device_limits(index)
    Hb = H if interior is None else window_rows(H, interior, iterations)
    fit = fitting_sizes(Hb, W, *limits)
    if fit:
        on_chip = own_shared_sizes(Hb, W, *limits)
        held = {c: resident_limits(index, c, cdiv(Hb, c), W, c in on_chip)[1] for c in fit}
    else:
        widest = widest_band(W, False, limits[1])
        held = {c: resident_limits(index, c, widest, W, False)[1]
                for c in range(1, min(MAX_CLUSTER, limits[0]) + 1)} if widest else {}
    plan = plan_tv_fgp(B, H, W, tuple(held.items()), *limits, clusters=clusters,
                       iterations=iterations, interior=interior)
    if plan.route == "global":
        return plan, None
    if own == "global":
        plan = _placed(plan, W, False)
    smem, active = resident_limits(index, plan.clusters, plan.rows, W, plan.own == "shared")
    if smem != plan.smem:
        raise RuntimeError(f"prox_tv2d_fgp: the kernel counts {smem} bytes of shared memory "
                           f"for {plan}")
    if active < 1:
        raise ValueError(f"prox_tv2d_fgp: the card holds no cluster of {plan} ({B} x {H}x{W})")
    return plan, active


def plan_on_card(xb, iterations):
    """(plan, clusters resident at once) of a launch on xb's card, (B, H, W),
    at `iterations` dual iterations; the count is None on the global route.
    Raises RuntimeError where the kernel counts other shared memory than
    the planner, ValueError where the plan has no cluster the card can
    hold."""
    return _card_plan(xb.device.index or 0, *xb.shape, iterations=iterations)


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


def prox_tv2d_fgp_windows_torch(xb, lamb, iterations: int, plan):
    """Plain version of the windowed route of `plan`: the fori FGP on each
    window of `plan.spans` (B·windows problems of plan.H rows, each window
    taken for the image), their interiors stitched. Equal to
    :func:`prox_tv2d_fgp_torch` bit for bit where the halo is at least the
    dual iterations (the tests and chip_smoke.py hold it so)."""
    spans = plan.spans(xb.shape[1])
    windows = torch.stack([xb[:, lo:lo + plan.H] for lo, _, _ in spans], dim=1)
    got = _fgp_common.fgp_loop(windows.flatten(0, 1),
                               lamb.repeat_interleave(len(spans)).view(-1, 1, 1), iterations)
    got = got.view(xb.shape[0], len(spans), plan.H, xb.shape[2])
    return torch.cat([got[:, t, top - lo:end - lo] for t, (lo, top, end) in enumerate(spans)],
                     dim=1)


def _launch(xb, lamb, iterations: int, clusters=None, own=None, interior=None):
    """One launch on `xb` (B, H, W) float32 and `lamb` (B,), both contiguous
    on a CUDA device, on the card's plan, or with ``_card_plan``'s forced
    `clusters`, `own` and `interior` (the timing mode and the card tests)."""
    from .. import _build

    B, H, W = xb.shape
    plan, _ = _card_plan(xb.device.index or 0, B, H, W, clusters, own, iterations, interior)
    lib = _build.load_library()
    out = torch.empty_like(xb)
    # the kernel zeroes the duals itself; a plan with every plane in shared
    # memory needs no scratch; each window has scratch of its own
    scratch = (torch.empty((plan.scratch, B * plan.windows, plan.H, W), dtype=xb.dtype,
                           device=xb.device) if plan.scratch else None)
    args = (xb.data_ptr(), lamb.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, H, W, iterations)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        cluster = (plan.clusters, plan.rows, int(plan.own == "shared"), plan.smem)
        if plan.route == "resident":
            code = lib.tv_fgp_cluster_launch(*args, *cluster, stream)
        elif plan.route == "windows":
            code = lib.tv_fgp_windows_launch(*args, *cluster, plan.interior, plan.halo, stream)
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
prox_tv2d_fgp.route_launches = {"resident": 0, "windows": 0, "global": 0}
