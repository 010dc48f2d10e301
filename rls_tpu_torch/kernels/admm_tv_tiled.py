"""The ADMM-TV solve for images too large for the fused kernel's five
planes (row 5): two hand-written CUDA routes and their plain PyTorch
version.

Counterpart of ``rls_tpu/kernels/admm_tv_tiled.py``: ``_kernel``
(:50-160), ``admm_tv_tiled`` (:183-251), ``check_admm_tv_tiled``
(:254-313) and ``solve_admm_tv_tiled`` (:316-363). The routes, picked by
:func:`plan_admm_tv_tiled`:

* cluster: the whole solve in one launch on the resident route of the
  ADMM-TV kernels (``csrc/admm_tv_cluster.cuh``, its entry points in
  ``csrc/admm_tv_tiled.cu``): each problem on a thread-block cluster of
  c ≤ 16 CTAs, one band of image rows per CTA, with the three planes
  that another band reads in shared memory and the planes read in the
  CTA's own rows in global memory (all five in shared memory where they
  fit, as the fused kernel keeps them). The JAX kernel has the same
  shape: it keeps each problem's CG untiled and its carries resident for
  the whole solve in one ``pallas_call``, and tiles only the z-update.
* tiles: ``csrc/admm_tv_tiled.cu``, where no band fits even three planes
  (1024²) or the caller passes `tile_rows`: one CTA per (row tile,
  problem), `tile_rows` from ``fista_tv_tiled.pick_tile_rows`` (about one
  wave of CTAs on the card). The CG needs two sums over the whole image
  per step, so the solve is a sequence of launches, 2·cg_iterations + 2
  per outer iteration (the schedule is in the CUDA source). Each launch
  reads windows of whole planes that earlier launches finished and writes
  only its tile's rows: the stencil Gram on a window of ``matvec_halo``
  extra rows a side, the TV z-update on a window of ``fgp_halo``. Tiling
  adds halo recompute, not approximation.

The plain version is the fused kernel's plain version (the monolithic
solve). The CG's sums are taken in double in a fixed order (on the
cluster route over the ranks in order; on the tiles route per tile, then
over the tiles), with no atomics, so a result does not change from run to
run. Not carried over: the TPU's tile picker ``pick_tile_rows_admm`` and
its VMEM budget. The seed is the fused path's exact ``rmv_stencil`` (the
JAX tiled wrapper takes ``A.rmv``).
"""

from __future__ import annotations

import functools

import torch

from .._build import SMEM_MAX, SMS
from ._bands import band_sizes, cdiv, fewest_waves
from .admm_tv_fused import (
    MAX_CLUSTER,
    PHASES,
    RESIDENT_SCRATCH,
    THREE_PLANE_SCRATCH,
    admm_tv_fused_torch,
    check_admm_tv,
    check_prox,
    cluster_smem_bytes,
    kernel_args,
    launch_plan,
    resident_limits,
    solver_args,
)
from .admm_tv_fused import fitting_sizes as own_shared_sizes
from .fista_tv_fused import GLOBAL_SMEM, MAX_TAPS, check_cuda_input
from .fista_tv_tiled import TiledPlan, pick_tile_rows
from .tv_fgp import GLOBAL_PIXEL

__all__ = [
    "admm_tv_tiled",
    "admm_tv_tiled_torch",
    "plan_admm_tv_tiled",
    "AdmmTiledPlan",
    "phase_clocks",
    "check_admm_tv_tiled",
    "solve_admm_tv_tiled",
    "matvec_halo",
    "fgp_halo",
    "launches_per_solve",
]

# the tiles route's global planes of (B, H, W): x (ping-pong), z, u
# (ping-pong), r, p (ping-pong), q, besides each CTA's window planes
TILE_SCRATCH = 9


def matvec_halo(kh: int) -> int:
    """Halo rows of the CG matvec's window: the column pass and its adjoint
    reach kh//2 rows each."""
    return 2 * (kh // 2)


def fgp_halo(tv_iterations: int) -> int:
    """Halo rows of the z-update's window: the FGP's dependence cone
    (one row per dual iteration and the final adjoint) and one row to
    spare; the JAX kernel rounds the same count up to 8 rows."""
    return tv_iterations + 2


def launches_per_solve(iterations: int, cg_iterations: int) -> int:
    """Kernel launches of one solve on the tiles route: per outer iteration
    one to start the CG, two per CG step, one for the z/u update."""
    return iterations * (2 * cg_iterations + 2)


class AdmmTiledPlan(TiledPlan):
    """How a row-5 launch runs: route "cluster" (a cluster of `clusters`
    CTAs per problem, bands of `rows` rows, `smem` bytes of shared memory
    per CTA; `own` "shared" where all five planes of a band are in shared
    memory, "global" where three are) or "tiles" (`clusters` tiles of
    `rows` rows per problem, one CTA each, `smem` the tiled kernel's static
    shared memory); `scratch` planes of (B, H, W) in global memory."""


def fitting_sizes(H, W, sms=SMS, smem_max=SMEM_MAX):
    """The cluster sizes c ≤ 16 (and ≤ sms) whose bands of ⌈H/c⌉ rows fit
    three planes in one CTA's shared memory with no band empty: the sizes
    of the cluster route."""
    return band_sizes(H, W, range(1, MAX_CLUSTER + 1),
                      lambda rows, w: cluster_smem_bytes(rows, w, False), sms, smem_max)


def _cluster_plan(B, H, W, c, own_shared):
    rows = cdiv(H, c)
    return AdmmTiledPlan("cluster", c, rows, H, B * c, cluster_smem_bytes(rows, W, own_shared),
                         RESIDENT_SCRATCH if own_shared else THREE_PLANE_SCRATCH,
                         "shared" if own_shared else "global")


def _tiles_plan(B, H, tile_rows):
    tiles = cdiv(H, tile_rows)
    return AdmmTiledPlan("tiles", tiles, tile_rows, H, B * tiles, GLOBAL_SMEM, TILE_SCRATCH)


@functools.lru_cache(maxsize=256)
def plan_admm_tv_tiled(B, H, W, kh, kw, resident, sms=SMS, smem_max=SMEM_MAX, tile_rows=None,
                       clusters=None) -> AdmmTiledPlan:
    """The route of a row-5 launch of B problems of H × W with kh × kw taps,
    on a card of `sms` SMs and `smem_max` bytes of shared memory per block
    that holds n clusters of c CTAs of the cluster kernel at once for each
    pair (c, n) of `resident` (``cudaOccupancyMaxActiveClusters`` of the
    kernel with the planes that c's band holds; a size not named is held 0
    times).

    The rule: where three planes of a band fit at some c ≤ 16
    (:func:`fitting_sizes`), the cluster route; each fitting size keeps
    all five planes in shared memory where they fit, else three, and
    ``fewest_waves`` takes the least waves × rows per band, a band's rows
    priced ``tv_fgp.GLOBAL_PIXEL`` each where its own-row planes are in
    global memory (ties to the smaller c). `clusters` forces a fitting
    size instead (the timing mode and the tests). Elsewhere, and wherever
    the caller passes `tile_rows`, the tiles route, with `tile_rows` or
    ``pick_tile_rows``. Raises ValueError naming the shape where it is
    empty, its taps too many, a forced size unfit, and naming the plan
    where the card holds no cluster of it (no fallback)."""
    if min(B, H, W) < 1:
        raise ValueError(f"admm_tv_tiled: empty shape {B} x {H}x{W}")
    if not (1 <= kh <= MAX_TAPS and 1 <= kw <= MAX_TAPS):
        raise ValueError(f"admm_tv_tiled: {kh} x {kw} taps; at most {MAX_TAPS} per axis")
    if tile_rows is not None:
        if tile_rows < 1:
            raise ValueError(f"tile_rows must be positive, got {tile_rows}")
        return _tiles_plan(B, H, tile_rows)
    fit = fitting_sizes(H, W, sms, smem_max)
    if clusters is not None and clusters not in fit:
        raise ValueError(f"admm_tv_tiled: a cluster of {clusters} CTAs does not fit "
                         f"{B} x {H}x{W} (the fitting sizes: {fit})")
    if not fit:
        return _tiles_plan(B, H, pick_tile_rows(H, B, sms))
    on_chip = own_shared_sizes(H, W, sms, smem_max)
    c = clusters or fewest_waves(
        B, H, W, fit, resident, lambda c: cdiv(H, c) * (1 if c in on_chip else GLOBAL_PIXEL))
    plan = _cluster_plan(B, H, W, c, c in on_chip)
    if dict(resident).get(c, 0) < 1:
        raise ValueError(f"admm_tv_tiled: the card holds no cluster of {plan} "
                         f"({B} x {H}x{W})")
    return plan


@functools.lru_cache(maxsize=256)
def _card_plan(index, B, H, W, kh, kw, tile_rows=None, clusters=None, own=None):
    """(plan, clusters resident at once) of a launch of B × H × W on device
    `index`, with ``plan_admm_tv_tiled``'s forced `tile_rows` or `clusters`;
    `own` = "global" keeps three planes of a band in shared memory where
    five would fit (the timing mode's and the card tests' placement A/B).
    The count is None on the tiles route. Raises RuntimeError where the
    kernel counts other shared memory than the planner."""
    from .. import _build

    limits = _build.device_limits(index)
    on_chip = () if own == "global" else own_shared_sizes(H, W, *limits)
    held = {c: resident_limits(index, c, cdiv(H, c), W, c in on_chip)
            for c in fitting_sizes(H, W, *limits)} if tile_rows is None else {}
    plan = plan_admm_tv_tiled(B, H, W, kh, kw, tuple((c, n) for c, (_, n) in held.items()),
                              *limits, tile_rows=tile_rows, clusters=clusters)
    if plan.route == "tiles":
        return plan, None
    if own == "global" and plan.own == "shared":
        plan = _cluster_plan(B, H, W, plan.clusters, False)
    smem, active = held[plan.clusters]
    if smem != plan.smem:
        raise RuntimeError(f"admm_tv_tiled: the kernel counts {smem} bytes of shared memory "
                           f"for {plan}")
    return plan, active


def plan_on_card(x0hat, taps, tile_rows=None):
    """(plan, clusters resident at once) of a launch on x0hat's card, (B, H,
    W); the count is None on the tiles route. Raises RuntimeError where the
    kernel counts other shared memory than the planner, ValueError where
    the cluster plan has no cluster the card can hold."""
    return _card_plan(x0hat.device.index or 0, *x0hat.shape, *(len(t) for t in taps), tile_rows)


def admm_tv_tiled_torch(x0hat, scal, t2tab, taps, iterations, cg_iterations, tol_inner,
                        prox="none"):
    """Plain version: the monolithic solve (the fused kernel's plain
    version). Returns ``(x, counts)``."""
    return admm_tv_fused_torch(x0hat, scal, t2tab, taps, iterations, cg_iterations,
                               tol_inner, prox)


def _launch_tiles(x0hat, scal, t2tab, taps, tile_rows, iterations, cg_iterations, tol_inner,
                  prox):
    from .. import _build

    B, H, W = x0hat.shape
    taps_h, taps_w = taps
    tv_iterations = t2tab.shape[0]
    T = -(-H // tile_rows)
    halo = max(matvec_halo(len(taps_h)), fgp_halo(tv_iterations))
    win_rows = min(H, tile_rows + 2 * halo)
    lib = _build.load_library()
    dev = x0hat.device
    f32 = torch.float32
    taps_t = torch.tensor(list(taps_h) + list(taps_w), dtype=f32, device=dev)
    # whole planes: x (ping-pong), z, u (ping-pong), r, p (ping-pong), q;
    # x, z and u start at zero
    planes = torch.empty((TILE_SCRATCH, B, H, W), dtype=f32, device=dev)
    planes[:4].zero_()
    # each CTA's window planes, per-tile partial sums (two slots) and the
    # per-problem CG scalars (two slots)
    window = torch.empty((B, T, 6, win_rows, W), dtype=f32, device=dev)
    partial = torch.empty((2, B, T, 3), dtype=torch.float64, device=dev)
    state = torch.empty((2, B, 8), dtype=f32, device=dev)
    counts = torch.zeros((B,), dtype=torch.int32, device=dev)  # set by each z-update
    with torch.cuda.device(dev):
        code = lib.admm_tv_tiled_launch(
            x0hat.data_ptr(), scal.data_ptr(), t2tab.data_ptr(), taps_t.data_ptr(),
            len(taps_h), len(taps_w), planes.data_ptr(), window.data_ptr(),
            partial.data_ptr(), state.data_ptr(), counts.data_ptr(),
            B, H, W, tile_rows, iterations, cg_iterations, tv_iterations, float(tol_inner),
            int(prox == "positive"), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "admm_tv_tiled_launch")
    n = launches_per_solve(iterations, cg_iterations)
    admm_tv_tiled.launches += n
    admm_tv_tiled.route_launches["tiles"] += n
    return planes[iterations % 2].clone(), counts


def _run(x0hat_b, taps, rho, lam, iterations, cg_iterations, tv_iterations, tol_inner,
         prox="none", tile_rows=None, clusters=None, own=None, prof=None):
    """(x, counts) of a solve on the CPU (the plain version) or on the card
    on its plan, with ``_card_plan``'s forced `tile_rows`, `clusters` and
    `own` (the last two for the timing mode and the card tests), and the
    cluster route's phase timer `prof`."""
    check_prox(prox)
    if tile_rows is not None and int(tile_rows) < 1:
        raise ValueError(f"tile_rows must be positive, got {tile_rows}")
    scal, t2tab = kernel_args(x0hat_b, rho, lam, tv_iterations)
    args = (iterations, cg_iterations, float(tol_inner), prox)
    if x0hat_b.device.type == "cpu":
        return admm_tv_tiled_torch(x0hat_b, scal, t2tab, taps, *args)
    check_cuda_input("admm_tv_tiled", x0hat_b, taps)
    x0hat_b = x0hat_b.contiguous()
    plan, _ = _card_plan(x0hat_b.device.index or 0, *x0hat_b.shape, *(len(t) for t in taps),
                         None if tile_rows is None else int(tile_rows), clusters, own)
    if prof is not None and plan.route != "cluster":
        raise ValueError(f"admm_tv_tiled: the phase timer is on the cluster route, not {plan}")
    if plan.route == "tiles":
        return _launch_tiles(x0hat_b, scal, t2tab, taps, plan.rows, *args)
    out = launch_plan(plan, x0hat_b, scal, t2tab, taps, *args, prof)
    admm_tv_tiled.launches += 1
    admm_tv_tiled.route_launches["cluster"] += 1
    return out


def admm_tv_tiled(
    x0hat_b, taps, rho, lam, iterations: int, cg_iterations: int, tv_iterations: int,
    tol_inner: float, prox="none", tile_rows=None, with_counts=False,
):
    """Batched ADMM-TV on a separable conv on the route of
    :func:`plan_admm_tv_tiled`: each problem on a thread-block cluster for
    the whole solve (one launch), or in row tiles of `tile_rows` rows
    (default: `pick_tile_rows` for the card; passing it forces the tiles
    route), `launches_per_solve` launches; arguments as for
    `admm_tv_fused`. The plain version runs for a CPU tensor, the CUDA
    kernels for a CUDA tensor (a refused launch raises).
    ``admm_tv_tiled.launches`` counts the kernels' launches, and
    ``admm_tv_tiled.route_launches`` the launches by route."""
    out = _run(x0hat_b, taps, rho, lam, iterations, cg_iterations, tv_iterations, tol_inner,
               prox, tile_rows)
    return out if with_counts else out[0]


admm_tv_tiled.launches = 0
admm_tv_tiled.route_launches = {"cluster": 0, "tiles": 0}


def phase_clocks(x0hat_b, taps, rho, lam, iterations: int, cg_iterations: int,
                 tv_iterations: int, tol_inner: float, prox="none", clusters=None, own=None):
    """One launch of the cluster route with its phase timer on: {phase: SM
    clocks that CTA 0 spent in it over the whole solve} (the fused kernel's
    ``PHASES``: the traffic of the planes in global memory falls in the
    sweeps that read and write them), at the plan's or a forced cluster
    size and placement. Raises on the tiles route and for a CPU tensor."""
    if x0hat_b.device.type == "cpu":
        raise ValueError("admm_tv_tiled: the phase timer runs on the card")
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=x0hat_b.device)
    _run(x0hat_b, taps, rho, lam, iterations, cg_iterations, tv_iterations, tol_inner, prox,
         None, clusters, own, prof)
    return dict(zip(PHASES, prof.tolist()))


def check_admm_tv_tiled(solver):
    """Validate `solver` for the tiled path (raises ValueError naming the
    first unsupported piece); the same solver requirements as the fused
    path, at any image size."""
    check_admm_tv(solver, "tiled")


def solve_admm_tv_tiled(solver, B_mat, tile_rows=None):
    """Drop-in fast path for `solve_batched_unrolled(solver, B)` at image
    sizes past the fused kernel's dispatch rule (512², 1024²). Returns the
    n×K solution matrix like the composed driver; `tile_rows` forces the
    tiles route."""
    check_admm_tv_tiled(solver)
    H, W = solver.AHA.A.im_shape
    *args, prox = solver_args(solver, B_mat)
    out = admm_tv_tiled(*args, prox=prox, tile_rows=tile_rows)
    return out.reshape(out.shape[0], H * W).T
