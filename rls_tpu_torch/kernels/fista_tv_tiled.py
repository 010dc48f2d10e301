"""The PGM-TV solve for images too large for the fused kernel's six planes
(row 3): two hand-written CUDA routes and their plain PyTorch version.

Counterpart of ``rls_tpu/kernels/fista_tv_tiled.py``: ``fista_tv_tiled``
(:704) in both its modes, ``check_fista_tv_tiled`` (:917-1014) and
``solve_fista_tv_tiled`` (:1017-1082). The routes, picked by
:func:`plan_fista_tv_tiled`:

* cluster: the whole solve in one launch on the resident route of the
  PGM-TV kernels (``csrc/pgm_tv_cluster.cuh``, its entry points in
  ``csrc/fista_tv_tiled.cu``): each problem on a thread-block cluster of
  c ≤ 16 CTAs, one band of image rows per CTA, with the three planes
  that another band reads in shared memory and the planes read in the
  CTA's own rows in global memory (all six in shared memory where they
  fit, as the fused kernel keeps them). The JAX function makes the same
  choice at 512²: ``mode="auto"`` takes its VMEM-carry variant, which
  keeps a problem's carries on chip for the whole solve (:757-790).
* tiles: ``csrc/fista_tv_tiled.cu``, the JAX halo-streamed variant's
  counterpart, where no band fits even three planes (1024²) or the caller
  passes `tile_rows`: each problem cut into row tiles of `tile_rows`
  rows, one CTA per (tile, problem), one launch per iteration. Each CTA
  reads a window of ``tile_rows + 2·halo`` rows of the previous iterate
  (``_fgp_common.tile_windows``, halo ``_fgp_common.tiled_halo``) and
  writes only its interior rows, into the other buffer of a ping-pong
  pair: tiling adds halo recompute, not approximation. The tile size
  adapts to the batch and the card's SM count (`pick_tile_rows`).

The plain version is the fused kernel's plain version (the monolithic
solve). FISTA, OptISTA and POGM; restart, early exit and ``sigma_fac``
as the JAX function takes them. The per-problem sums of the dynamic
schedules are summed in double in a fixed order (on the cluster route
over the ranks in order; on the tiles route per tile, then over the
tiles), with no atomics, so a result does not change from run to run.
The seed x0hat is the fused kernel's exact ``rmv_stencil`` (the JAX
tiled wrapper takes ``A.rmv``). Not ported: the TPU's tile-size pickers
and VMEM models, and the ``mode`` / ``iter_loop`` arguments.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .._build import SMEM_MAX, SMS
from . import _fgp_common
from ._bands import BandPlan, band_sizes, cdiv, fewest_waves
from .fista_tv_fused import (
    GLOBAL_SMEM,
    MAX_CLUSTER,
    MAX_TAPS,
    PHASES,
    RESIDENT_SCRATCH,
    THREE_PLANE_SCRATCH,
    check_cuda_input,
    check_pgm_tv,
    check_schedule,
    cluster_smem_bytes,
    fista_tv_fused_torch,
    kernel_args,
    launch_plan,
    prepare,
    resident_limits,
    solver_schedule,
    _codes,
)
from .tv_fgp import GLOBAL_PIXEL

__all__ = [
    "fista_tv_tiled",
    "fista_tv_tiled_torch",
    "plan_fista_tv_tiled",
    "TiledPlan",
    "pick_tile_rows",
    "phase_clocks",
    "check_fista_tv_tiled",
    "solve_fista_tv_tiled",
]

# the fewest rows a tile gets from `pick_tile_rows`: at 10 dual
# iterations and 9 taps (a 20-row halo) a 32-row tile recomputes its
# rows ~2.3×
MIN_TILE_ROWS = 32
# the tiles route's global planes of (B, H, W): the ping-pong carries (x,
# x_prev | y, z, w), besides each CTA's window planes
TILE_SCRATCH = 8


def pick_tile_rows(H: int, B: int, sms: int) -> int:
    """Rows per tile such that the (tile, problem) CTAs make about one wave
    on a card with `sms` SMs: ``sms // B`` tiles per problem, and no
    fewer than `MIN_TILE_ROWS` rows. On an H100 (132 SMs) that is 128 rows
    at 256² × 64, 64 rows at 512² × 16 and 1024² × 8, the fastest of 32,
    64 and 128 rows at each (NVIDIA H100 80GB HBM3, 700 W)."""
    tiles = max(1, sms // B)
    return max(MIN_TILE_ROWS, -(-H // tiles))


@dataclasses.dataclass(frozen=True)
class TiledPlan(BandPlan):
    """How a row-3 launch runs: route "cluster" (a ``BandPlan`` of
    `clusters` CTAs per problem, bands of `rows` rows, `smem` bytes of
    shared memory per CTA; `own` "shared" where all six planes of a band
    are in shared memory, "global" where three are) or "tiles"
    (`clusters` tiles of `rows` rows per problem, one CTA each, `smem` the
    tiled kernel's static shared memory); `scratch` planes of (B, H, W)
    in global memory."""

    scratch: int
    own: str = "global"


def fitting_sizes(H, W, sms=SMS, smem_max=SMEM_MAX):
    """The cluster sizes c ≤ 16 (and ≤ sms) whose bands of ⌈H/c⌉ rows fit
    three planes in one CTA's shared memory with no band empty: the sizes
    of the cluster route."""
    return band_sizes(H, W, range(1, MAX_CLUSTER + 1),
                      lambda rows, w: cluster_smem_bytes(rows, w, False), sms, smem_max)


def own_shared_sizes(H, W, sms=SMS, smem_max=SMEM_MAX):
    """The sizes of :func:`fitting_sizes` whose bands fit all six planes."""
    return band_sizes(H, W, range(1, MAX_CLUSTER + 1), cluster_smem_bytes, sms, smem_max)


def _cluster_plan(B, H, W, c, own_shared):
    rows = cdiv(H, c)
    return TiledPlan("cluster", c, rows, H, B * c, cluster_smem_bytes(rows, W, own_shared),
                     RESIDENT_SCRATCH if own_shared else THREE_PLANE_SCRATCH,
                     "shared" if own_shared else "global")


def _tiles_plan(B, H, tile_rows):
    tiles = cdiv(H, tile_rows)
    return TiledPlan("tiles", tiles, tile_rows, H, B * tiles, GLOBAL_SMEM, TILE_SCRATCH)


@functools.lru_cache(maxsize=256)
def plan_fista_tv_tiled(B, H, W, kh, kw, schedule, resident, sms=SMS, smem_max=SMEM_MAX,
                        tile_rows=None, clusters=None) -> TiledPlan:
    """The route of a row-3 launch of B problems of H × W with kh × kw taps
    and `schedule` = (method, restart, early exit), on a card of `sms` SMs
    and `smem_max` bytes of shared memory per block that holds n clusters
    of c CTAs of the cluster kernel at once for each pair (c, n) of
    `resident` (``cudaOccupancyMaxActiveClusters`` of the kernel with the
    planes that c's band holds; a size not named is held 0 times).

    The rule: where three planes of a band fit at some c ≤ 16
    (:func:`fitting_sizes`), the cluster route; each fitting size keeps
    all six planes in shared memory where they fit, else three, and
    ``fewest_waves`` takes the least waves × rows per band, a band's rows
    priced ``tv_fgp.GLOBAL_PIXEL`` each where its own-row planes are in
    global memory (ties to the smaller c). `clusters` forces a fitting
    size instead (the timing mode and the tests). Elsewhere, and wherever
    the caller passes `tile_rows`, the tiles route, with `tile_rows` or
    ``pick_tile_rows``. Raises ValueError naming the shape where it is
    empty, its taps too many, a forced size unfit, and naming the plan
    where the card holds no cluster of it (no fallback)."""
    method, restart, early = schedule
    check_schedule(method, restart, 0.0 if early else None, False)
    if min(B, H, W) < 1:
        raise ValueError(f"fista_tv_tiled: empty shape {B} x {H}x{W}")
    if not (1 <= kh <= MAX_TAPS and 1 <= kw <= MAX_TAPS):
        raise ValueError(f"fista_tv_tiled: {kh} x {kw} taps; at most {MAX_TAPS} per axis")
    if tile_rows is not None:
        if tile_rows < 1:
            raise ValueError(f"tile_rows must be positive, got {tile_rows}")
        return _tiles_plan(B, H, tile_rows)
    fit = fitting_sizes(H, W, sms, smem_max)
    if clusters is not None and clusters not in fit:
        raise ValueError(f"fista_tv_tiled: a cluster of {clusters} CTAs does not fit "
                         f"{B} x {H}x{W} (the fitting sizes: {fit})")
    if not fit:
        return _tiles_plan(B, H, pick_tile_rows(H, B, sms))
    on_chip = own_shared_sizes(H, W, sms, smem_max)
    c = clusters or fewest_waves(
        B, H, W, fit, resident, lambda c: cdiv(H, c) * (1 if c in on_chip else GLOBAL_PIXEL))
    plan = _cluster_plan(B, H, W, c, c in on_chip)
    if dict(resident).get(c, 0) < 1:
        raise ValueError(f"fista_tv_tiled: the card holds no cluster of {plan} "
                         f"({B} x {H}x{W})")
    return plan


@functools.lru_cache(maxsize=256)
def _card_plan(index, B, H, W, kh, kw, schedule, tile_rows=None, clusters=None, own=None):
    """(plan, clusters resident at once) of a launch of B × H × W on device
    `index`, with ``plan_fista_tv_tiled``'s forced `tile_rows` or
    `clusters`; `own` = "global" keeps three planes of a band in shared
    memory where six would fit (the timing mode's and the card tests'
    placement A/B). The count is None on the tiles route. Raises
    RuntimeError where the kernel counts other shared memory than the
    planner."""
    from .. import _build

    limits = _build.device_limits(index)
    method, restart, early = schedule
    dynamic = restart != "none" or early
    on_chip = () if own == "global" else own_shared_sizes(H, W, *limits)
    held = {c: resident_limits(index, c, cdiv(H, c), W, method, dynamic, c in on_chip)
            for c in fitting_sizes(H, W, *limits)} if tile_rows is None else {}
    plan = plan_fista_tv_tiled(B, H, W, kh, kw, schedule,
                               tuple((c, n) for c, (_, n) in held.items()), *limits,
                               tile_rows=tile_rows, clusters=clusters)
    if plan.route == "tiles":
        return plan, None
    if own == "global" and plan.own == "shared":
        plan = _cluster_plan(B, H, W, plan.clusters, False)
    smem, active = held[plan.clusters]
    if smem != plan.smem:
        raise RuntimeError(f"fista_tv_tiled: the kernel counts {smem} bytes of shared memory "
                           f"for {plan}")
    return plan, active


def plan_on_card(x0hat, taps, method="fista", restart="none", rel_tol=None, tile_rows=None):
    """(plan, clusters resident at once) of a launch on x0hat's card, (B, H,
    W); the count is None on the tiles route. Raises RuntimeError where the
    kernel counts other shared memory than the planner, ValueError where
    the cluster plan has no cluster the card can hold."""
    return _card_plan(x0hat.device.index or 0, *x0hat.shape, *(len(t) for t in taps),
                      (method, restart, rel_tol is not None), tile_rows)


def fista_tv_tiled_torch(x0hat, scal, tab, t2tab, taps, method="fista", restart="none",
                         rel_tol=None, sigma_fac=1.0):
    """Plain version: the monolithic solve (the fused kernel's plain
    version; a window loop would compute the same, only slower).
    Returns ``(x, counts)``."""
    return fista_tv_fused_torch(x0hat, scal, tab, t2tab, taps, method, restart,
                                rel_tol, sigma_fac)


def _launch_tiles(x0hat, scal, tab, t2tab, taps, tile_rows, method, restart, rel_tol,
                  sigma_fac):
    from .. import _build

    B, H, W = x0hat.shape
    taps_h, taps_w = taps
    iterations, tv_iterations = tab.shape[0], t2tab.shape[0]
    halo = _fgp_common.tiled_halo(tv_iterations, len(taps_h))
    T = -(-H // tile_rows)
    win_rows = min(H, tile_rows + 2 * halo)
    lib = _build.load_library()
    dev = x0hat.device
    f32 = torch.float32
    taps_t = torch.tensor(list(taps_h) + list(taps_w), dtype=f32, device=dev)
    # ping-pong carries (x, x_prev | y, z, w), each CTA's window planes,
    # per-tile partial sums (two slots), the per-tile Σx0hat², and the
    # per-problem scalar state (two slots)
    carries = (x0hat * 0.0).expand(2, 4, B, H, W).contiguous()
    window = torch.empty((B, T, 9, win_rows, W), dtype=f32, device=dev)
    partial = torch.zeros((2, B, T, 3), dtype=torch.float64, device=dev)
    norm_part = torch.zeros((B, T), dtype=torch.float64, device=dev)
    state = torch.zeros((2, B, 8), dtype=f32, device=dev)
    counts = torch.empty((B, 2), dtype=torch.int32, device=dev)
    dynamic = restart != "none" or rel_tol is not None
    stream = torch.cuda.current_stream().cuda_stream
    # the last launch only settles the last iteration's counts
    with torch.cuda.device(dev):
        for it in range(iterations + int(dynamic)):
            code = lib.fista_tv_tiled_launch(
                x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), t2tab.data_ptr(),
                taps_t.data_ptr(), len(taps_h), len(taps_w),
                carries.data_ptr(), window.data_ptr(), partial.data_ptr(),
                norm_part.data_ptr(), state.data_ptr(), counts.data_ptr(),
                B, H, W, tile_rows, halo, iterations, tv_iterations, it,
                *_codes(method, restart, rel_tol, False)[:3],
                float(rel_tol or 0.0), float(sigma_fac), stream,
            )
            _build.check(code, "fista_tv_tiled_launch")
            fista_tv_tiled.launches += 1
            fista_tv_tiled.route_launches["tiles"] += 1
    if not dynamic:
        counts = torch.tensor([[0, iterations]], dtype=torch.int32, device=dev).expand(B, 2)
    return carries[iterations % 2, 0].clone(), counts


def _run(x0hat_b, taps, rho, lam, iterations, tv_iterations, tile_rows=None, method="fista",
         restart="none", rel_tol=None, sigma_fac=1.0, clusters=None, own=None, prof=None):
    """(x, counts) of a solve on the CPU (the plain version) or on the
    card on its plan, with ``_card_plan``'s forced `tile_rows`, `clusters`
    and `own` (the last two for the timing mode and the card tests), and
    the cluster route's phase timer `prof`."""
    check_schedule(method, restart, rel_tol, False)
    if tile_rows is not None and int(tile_rows) < 1:
        raise ValueError(f"tile_rows must be positive, got {tile_rows}")
    scal, tab, t2tab = kernel_args(x0hat_b, rho, lam, method, iterations, tv_iterations)
    sched = (method, restart, rel_tol, sigma_fac)
    if x0hat_b.device.type == "cpu":
        return fista_tv_tiled_torch(x0hat_b, scal, tab, t2tab, taps, *sched)
    check_cuda_input("fista_tv_tiled", x0hat_b, taps)
    x0hat_b = x0hat_b.contiguous()
    plan, _ = _card_plan(x0hat_b.device.index or 0, *x0hat_b.shape, *(len(t) for t in taps),
                         (method, restart, rel_tol is not None), tile_rows, clusters, own)
    if prof is not None and plan.route != "cluster":
        raise ValueError(f"fista_tv_tiled: the phase timer is on the cluster route, not {plan}")
    if plan.route == "tiles":
        return _launch_tiles(x0hat_b, scal, tab, t2tab, taps, plan.rows, *sched)
    out = launch_plan(plan, x0hat_b, scal, tab, t2tab, taps, *sched, False, prof)
    fista_tv_tiled.launches += 1
    fista_tv_tiled.route_launches["cluster"] += 1
    return out


def fista_tv_tiled(
    x0hat_b, taps, rho, lam, iterations: int, tv_iterations: int, tile_rows=None,
    method="fista", restart="none", rel_tol=None, sigma_fac=1.0, with_counts=False,
):
    """Batched PGM-TV on a separable conv on the route of
    :func:`plan_fista_tv_tiled`: each problem on a thread-block cluster
    for the whole solve (one launch), or in row tiles of `tile_rows` rows
    (default: `pick_tile_rows` for the card; passing it forces the tiles
    route), one launch per iteration; arguments as for `fista_tv_fused`
    (no warm_tv). The plain version runs for a CPU tensor, the CUDA
    kernels for a CUDA tensor (a refused launch raises).
    ``fista_tv_tiled.launches`` counts the kernels' launches, and
    ``fista_tv_tiled.route_launches`` the launches by route: one per solve
    on the cluster route; one per iteration on the tiles route, and one
    more that settles the counts of a dynamic schedule."""
    out = _run(x0hat_b, taps, rho, lam, iterations, tv_iterations, tile_rows, method, restart,
               rel_tol, sigma_fac)
    return out if with_counts else out[0]


fista_tv_tiled.launches = 0
fista_tv_tiled.route_launches = {"cluster": 0, "tiles": 0}


def phase_clocks(x0hat_b, taps, rho, lam, iterations: int, tv_iterations: int,
                 method="fista", restart="none", rel_tol=None, sigma_fac=1.0, clusters=None,
                 own=None):
    """One launch of the cluster route with its phase timer on: {phase: SM
    clocks that CTA 0 spent in it over the whole solve} (the fused
    kernel's ``PHASES``: the traffic of the planes in global memory falls
    in the sweeps that read and write them), at the plan's or a forced
    cluster size and placement. Raises on the tiles route."""
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=x0hat_b.device)
    _run(x0hat_b, taps, rho, lam, iterations, tv_iterations, None, method, restart, rel_tol,
         sigma_fac, clusters, own, prof)
    return dict(zip(PHASES, prof.tolist()))


def check_fista_tv_tiled(solver, early_exit: bool = False):
    """Validate `solver` for the tiled path (FISTA/OptISTA/POGM +
    SeparableConv + 2-D TV); returns the method. Raises ValueError naming
    the first unsupported piece."""
    method = check_pgm_tv(solver, "tiled")
    solver_schedule(solver, method, early_exit, path="tiled")
    return method


def solve_fista_tv_tiled(solver, B_mat, tile_rows=None, early_exit=False):
    """Drop-in fast path for `solve_batched_unrolled(solver, B)` at image
    sizes whose bands fit no cluster with six planes (512², 1024²).
    Returns the n×K solution matrix like the composed driver.
    ``solver.restart`` and ``early_exit`` as for `solve_pgm_tv_fused`;
    `tile_rows` forces the tiles route."""
    method = check_fista_tv_tiled(solver, early_exit)
    restart, rel_tol, sigma_fac = solver_schedule(solver, method, early_exit, path="tiled")
    H, W = solver.AHA.A.im_shape
    x0hat_b, lam_eff = prepare(solver, B_mat)
    out = fista_tv_tiled(
        x0hat_b, solver.AHA.A.taps_hw(), solver.rho, lam_eff, solver.iterations,
        solver.reg.iterations_tv, tile_rows=tile_rows, method=method, restart=restart,
        rel_tol=rel_tol, sigma_fac=sigma_fac,
    )
    return out.reshape(out.shape[0], H * W).T
