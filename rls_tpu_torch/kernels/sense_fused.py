"""The whole batched FISTA-L21 multi-coil SENSE solve as ONE launch: the
hand-written CUDA kernel ``csrc/sense_fused.cu`` and its plain PyTorch
version.

Counterpart of ``rls_tpu/kernels/sense_fused.py``: ``_kernel`` (:33-82),
``fista_l21_sense_fused`` (:85-133), ``check_fista_l21_sense_fused``
(:136-179) and ``solve_fista_l21_sense_fused`` (:198-235). The complex
image x = (xr, xi) of each slice, complex L1 as ``L21Regularization(λ,
slices=2)`` (the group soft threshold over (re, im) pairs), fixed
iterations, per problem

    a      = momentum table, column 0
    m      = x + a (x − x_prev)                       (both planes)
    g      = m − ρ (Σ_c C̄_c Fᴴ M F C_c m − x0hat)
    |g|    = √(gr² + gi²)
    x      = g · max((|g| − ρλ) / (|g| or 1 where 0), 0)

from x = x_prev = 0. The SENSE normal op multiplies by each coil's map,
runs the masked normal op of the in-kernel FFT, and accumulates the
conjugate maps in coil order (``_dft_common.sense_normal``).

The kernel has three routes, picked by :func:`plan_sense`: **resident**,
a thread-block cluster of c ≤ min(C, 16) CTAs per slice, CTA k
transforming coils k, k + c, … with the coil's whole padded spectrum in
its shared memory and the FFT's stages in registers, each CTA owning a
band of rows for the coil fold and the pixel update; **split**, for
shapes whose padded spectrum fits no CTA (192², 256 × 128, 256²), the
same cluster kernel with each coil's spectrum split over a team of k CTAs
(each a band of its rows and a block of its columns, the transposes
through distributed shared memory: ``csrc/sense_split.cuh``), ⌊16/k⌋
coils a round at most; and **grid**, for shapes whose spectrum fits no
team of 16 (512², 1024²), one cooperative launch whose CTAs are all
resident: each slice on a team of CTAs (66 a slice at 2 × 512² on an
H100) that meet at a barrier of their own on a counter in global memory,
`slots` slices at once, each coil's spectrum in global scratch (L2),
`per_round` coils a round, the band's rows and the block's columns
transformed in shared memory a chunk of lines at a time, two team
barriers a round (``csrc/sense_grid.cuh``). The planner's pieces
(:func:`cluster_size`, :func:`coil_plan`, :class:`SensePlan`,
:func:`plan_coils`, :func:`plan_grid`, :func:`card_plan`) also plan the
SplitBregman kernel, whose routes run the same SENSE normal op
(``csrc/sense_cluster.cuh``, ``csrc/sense_split.cuh``,
``csrc/sense_grid.cuh``).

Not carried over: the TPU's bf16 hi/lo DFT factors, its VMEM gate
``_check_vmem_sense`` and ``interpret=``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .. import _build
from .._build import SMEM_MAX, SMS
from ._bands import cdiv
from ..models.prox import L21Regularization
from ..models.solvers.fista import FISTA
from ..ops.dft_real import SenseDFT2RealOperator
from . import _dft_common
from ._dft_common import (
    check_dft_cuda_input,
    check_fft_normal,
    check_fft_shape,
    check_fista_schedule,
    seed_and_lam,
    split_part,
    twiddle_tensor,
)
from .fista_l1_dft_fused import grid_chunk, grid_pitch
from .fista_tv_fused import momentum_tensor, problem_scalars

__all__ = [
    "fista_l21_sense_fused",
    "fista_l21_sense_fused_torch",
    "plan_sense",
    "plan_grid",
    "plan_on_card",
    "phase_clocks",
    "check_fista_l21_sense_fused",
    "solve_fista_l21_sense_fused",
]


def group_threshold(gr, gi, t):
    """The L21 prox over (re, im) pairs at strength t, as the kernels form
    it (``prox.py`` ``_group_scale``, the ``gn == 0`` guard included)."""
    gn = torch.sqrt(gr * gr + gi * gi)
    scale = torch.clamp((gn - t) / torch.where(gn == 0, torch.ones_like(gn), gn), min=0.0)
    return gr * scale, gi * scale


def fista_l21_sense_fused_torch(x0hat, scal, tab, coils, tables):
    """Plain version: `x0hat` (B, 2, H, W) the split [re; im] Aᴴb, `scal`
    (B, 2) = [ρ, λ_eff], `tab` the momentum table, `coils` the maps
    (coils_r, coils_i), (C, H, W) each, `tables` the ``dft_tables`` of the
    mask. Returns x (B, 2, H, W) in x0hat's dtype."""

    def col(v):
        return v.view(-1, 1, 1)

    rho, lam = col(scal[:, 0]), col(scal[:, 1])
    t = rho * lam
    x0r, x0i = x0hat[:, 0], x0hat[:, 1]
    xr = xi = pr = pi = x0r * 0.0
    for i in range(tab.shape[0]):
        a = tab[i, 0]
        mr = xr + a * (xr - pr)
        mi = xi + a * (xi - pi)
        nr, ni = _dft_common.sense_normal(mr, mi, *coils, tables)
        gr = mr - rho * (nr - x0r)
        gi = mi - rho * (ni - x0i)
        (xr, xi), pr, pi = group_threshold(gr, gi, t), xr, xi
    return torch.stack([xr, xi], dim=1)


def sense_args(x0hat_b, coils, mask):
    """(coils, tables) of a SENSE kernel call in x0hat's dtype."""
    coils = tuple(c.to(x0hat_b.dtype).contiguous() for c in coils)
    return coils, _dft_common.dft_tables(mask, x0hat_b.dtype)


# the kernels' threads per CTA and the largest cluster (csrc/sense_fused.cu,
# csrc/splitbregman_fused.cu)
THREADS, MAX_CLUSTER = 1024, 16
# the phases of the cluster routes' timer (csrc/sense_fused.cu kPhases)
PHASES = ("coil loads", "row ffts", "column ffts", "coil fold", "pixel update",
          "cluster barriers")
# the phases of the grid route's timer (csrc/sense_grid.cuh, kSetup ..
# kPhases)
GRID_PHASES = ("set-up", "row loads", "rows back", "coil fold", "rows forward and store",
               "column loads", "column transforms", "column stores", "barrier T1",
               "barrier T2")
# global scratch planes of (B, H, W) on the cluster routes: (re, im) of m,
# x_prev and the coil sum between rounds; the grid route's planes of (H,
# W) a slot: the same six (csrc/sense_fused.cu kGridPlanes)
RESIDENT_SCRATCH, GRID_SCRATCH = 6, 6
# the bytes of L2 that a grid plan's spectra, with the planes each slot's
# normal op streams beside them (GRID_OP_PLANES f32 planes: the input and
# the coil sum, re and im), may take: about 40 of the H100's 50 MB, so that
# the coil maps and the rest keep some room
GRID_L2, GRID_OP_PLANES = 40 * 2**20, 4


def _ceil4(n):
    return -(-n // 4) * 4


def resident_smem_bytes(H, W):
    """Shared memory of a resident CTA at H × W, as ``resident_smem_bytes``
    in csrc/sense_fused.cu counts it: the phase timer (one int64 per
    phase), the twiddles (``twiddle_floats(H, W)`` f32: H + W at powers of
    two) and one coil's padded spectrum (H·(W + 1) f32 for re, as many for
    im), each f32 array rounded up to 4 floats."""
    return 8 * len(PHASES) + 4 * (_ceil4(_dft_common.twiddle_floats(H, W))
                                  + 2 * _ceil4(H * (W + 1)))


def split_smem_bytes(H, W, team):
    """Shared memory of a split CTA at H × W on teams of `team` CTAs, as
    ``split_smem_bytes`` in csrc/sense_fused.cu counts it: the phase timer
    and the twiddles as on the resident route, the band (⌈H/team⌉·W f32 for
    re, as many for im) and the column block (H·(⌈W/team⌉ + 1) f32 for re,
    as many for im), each f32 array rounded up to 4 floats."""
    return 8 * len(PHASES) + 4 * (_ceil4(_dft_common.twiddle_floats(H, W))
                                  + 2 * split_floats(H, W, team))


def split_floats(H, W, team):
    """f32 of a split CTA's band and block, one plane each, each rounded up
    to 4 floats (csrc/split.cuh split_band_floats,
    split_block_floats)."""
    return _ceil4(-(-H // team) * W) + _ceil4(H * (-(-W // team) + 1))


def cluster_smem_bytes(H, W, team):
    """A cluster CTA's shared memory: :func:`resident_smem_bytes` on team 1,
    :func:`split_smem_bytes` on larger teams."""
    return resident_smem_bytes(H, W) if team == 1 else split_smem_bytes(H, W, team)


def cluster_size(C, sms=SMS, team=1):
    """(c, rounds) for C coils on teams of `team` CTAs a coil: the fewest
    rounds of at most ⌊min(16, sms) / team⌋ coils, then the smallest
    cluster that gives them (17 coils: 2 rounds on 9 CTAs; 6 coils on
    teams of 3: 2 rounds on 9)."""
    rounds = -(-C // (min(MAX_CLUSTER, sms) // team))
    return team * -(-C // rounds), rounds


def coil_plan(name, H, W, C, sms, smem_max, cluster_bytes, split=None):
    """(team, c, rounds) of a cluster plan for C coils of H × W, or None
    where no team of 16 fits (the grid route). Team 1 (resident) where a CTA holds a coil's padded
    spectrum (``cluster_bytes(H, W, 1)`` ≤ `smem_max`), else the smallest
    team of 2 … min(16, sms, H, W) CTAs whose split CTA fits, each on the
    cluster of :func:`cluster_size`. `split`: a forced (team, coils a
    round); raises ValueError naming it where it is no plan (a team past
    a side or 16, a cluster past min(16, sms), more coils a round than C,
    or shared memory past `smem_max`)."""
    if split is None:
        team = next((k for k in range(1, min(MAX_CLUSTER, sms, H, W) + 1)
                     if cluster_bytes(H, W, k) <= smem_max), None)
        return None if team is None else (team, *cluster_size(C, sms, team))
    team, per = split
    if not (1 <= team <= min(H, W) and 1 <= per <= C and team * per <= min(MAX_CLUSTER, sms)
            and cluster_bytes(H, W, team) <= smem_max):
        raise ValueError(f"{name}: no plan of teams of {team} CTAs, {per} coils a round at "
                         f"{H}x{W} with {C} coils ({cluster_bytes(H, W, team)} B of shared "
                         f"memory a CTA, {smem_max} on the card)")
    return team, team * per, -(-C // per)


@dataclasses.dataclass(frozen=True)
class SensePlan:
    """How a launch of a SENSE kernel (rows 9 and 10) on B slices runs:
    `route` "resident" (a cluster of `clusters` CTAs per slice, a coil a
    CTA, coils in `rounds` rounds), "split" (the same with each coil's
    spectrum split over a team of `team` CTAs) or "grid" (a team of `team`
    = `clusters` CTAs a slice that meet in L2, `slots` slices at once,
    `per_round` coils a round in `rounds` rounds, the band's rows
    `row_lines` at a time and the block's columns `col_lines` at a time);
    `ctas` CTAs in all, `smem` bytes of shared memory per CTA, `scratch`
    planes of (B, H, W) in global memory on the cluster routes (of (H, W)
    a slot on the grid route), and `resident_clusters`, the clusters the
    card holds at once (on the grid route its grid CTAs)."""

    route: str
    clusters: int
    rounds: int
    H: int
    C: int
    ctas: int
    smem: int
    scratch: int
    resident_clusters: int | None
    team: int = 1
    W: int = 0
    slots: int = 0
    per_round: int = 0
    row_lines: int = 0
    col_lines: int = 0

    def band(self, rank):
        """[r0, r1): the image rows CTA `rank` owns for the fold and the
        pixel updates: H // c rows, one more for the first H % c ranks
        (empty where H < c)."""
        return split_part(self.H, self.clusters, rank)

    def block(self, rank):
        """[c0, c1): the spectrum columns CTA `rank` of a grid team
        transforms."""
        return split_part(self.W, self.team, rank)


def grid_smem_bytes(H, W, plane, head=0, phases=len(GRID_PHASES)):
    """Shared memory of a CTA of the grid route at H × W whose two planes
    (re, im) hold `plane` f32 each, as ``smem_bytes`` in
    csrc/sense_grid.cuh counts it: `head` bytes of the kernel's own (row
    10's sums), the twiddles rounded up to 4 floats, the two planes, and
    the phase timer (`phases` int64)."""
    return head + 4 * (_ceil4(_dft_common.twiddle_floats(H, W)) + 2 * plane) + 8 * phases


def grid_plane_cap(H, W, smem_max, head=0, phases=len(GRID_PHASES)):
    """The most f32 of a grid CTA's plane (a multiple of 4) that `smem_max`
    bytes of shared memory hold."""
    return max(0, (smem_max - grid_smem_bytes(H, W, 0, head, phases)) // 8 // 4 * 4)


def coils_per_round(H, W, C, slots):
    """Coils a round of the grid route with `slots` slots: the fewest
    rounds whose spectra (per_round × H·W complex f32 a slot), with the
    GRID_OP_PLANES planes of each slot's normal op, fit GRID_L2 bytes, as
    even as possible; at least one coil a round (2 × 512², 6 coils: all 6
    in one round, 32 MiB; 1 × 1024²: two rounds of 3, 40 MiB)."""
    fit = (GRID_L2 // slots - GRID_OP_PLANES * 4 * H * W) // (8 * H * W)
    rounds = cdiv(C, max(1, min(C, fit)))
    return cdiv(C, rounds)


def grid_cost(B, H, W, C, team, slots):
    """The grid route's cost of a team and slots: the rounds of slices ×
    the points a CTA transforms a slice, ⌈B / slots⌉ · C · (⌈H/team⌉ · W +
    ⌈W/team⌉ · H)."""
    return cdiv(B, slots) * C * (cdiv(H, team) * W + cdiv(W, team) * H)


def plan_grid(name, B, H, W, C, held, smem_max=SMEM_MAX, head=0, phases=len(GRID_PHASES),
              scratch=GRID_SCRATCH, grid=None) -> SensePlan:
    """The grid route's plan of kernel `name` for B slices of H × W with C
    coils on a card that holds `held` grid CTAs at once: for each number of
    slots s ≤ min(B, held), a team of min(⌊held / s⌋, H, W) CTAs a slice
    and the coils a round of :func:`coils_per_round`; the least
    :func:`grid_cost`, then the fewest rounds of coils one after the other
    (⌈B / s⌉ · ⌈C / per_round⌉: two team barriers each), then more slots
    (2 × 512² at 6 coils on 132 CTAs: 2 slots of 66, every coil in one
    round). Each CTA's band and block pass through its shared memory in the
    fewest chunks that fit (``fista_l1_dft_fused.grid_chunk``), and the CTA
    takes the shared memory those chunks need (`head` bytes of the
    kernel's own and `phases` clocks besides). `grid` forces (team, slots,
    coils a round). Raises ValueError where a line fits no CTA, naming a
    forced plan past the shape, and naming the plan where the card holds
    fewer CTAs than it launches (no fallback)."""
    cap = grid_plane_cap(H, W, smem_max, head, phases)
    if cap < max(grid_pitch(H), grid_pitch(W)):
        raise ValueError(f"{name}: a line of {B} x {H}x{W} fits no grid CTA of {smem_max} bytes "
                         f"of shared memory")
    if grid is not None:
        team, slots, per = grid
        if not (1 <= team <= min(H, W) and 1 <= slots <= B and 1 <= per <= C):
            raise ValueError(f"{name}: a grid of {team} CTAs a slice in {slots} slots, {per} "
                             f"coils a round does not fit {B} x {H}x{W} with {C} coils")
    else:
        team, slots, per, best = 1, 1, C, None
        for s in range(1, min(B, held) + 1):
            t, p = min(held // s, H, W), coils_per_round(H, W, C, s)
            key = (grid_cost(B, H, W, C, t, s), cdiv(B, s) * cdiv(C, p), -s)
            if best is None or key < best:
                team, slots, per, best = t, s, p, key
    row_lines = grid_chunk(cdiv(H, team), grid_pitch(W), cap)
    col_lines = grid_chunk(cdiv(W, team), grid_pitch(H), cap)
    plane = _ceil4(max(row_lines * grid_pitch(W), col_lines * grid_pitch(H)))
    plan = SensePlan("grid", team, cdiv(C, per), H, C, team * slots,
                     grid_smem_bytes(H, W, plane, head, phases), scratch, held, team, W, slots,
                     per, row_lines, col_lines)
    if plan.ctas > held:
        raise ValueError(f"{name}: the card holds {held} CTAs, not the team of {plan} "
                         f"({B} x {H}x{W}, {C} coils)")
    return plan


def plan_coils(name, B, H, W, C, resident, sms, smem_max, cluster_bytes, scratch, split=None,
               grid_ctas=None, grid=None, head=0, phases=len(GRID_PHASES)) -> SensePlan:
    """The route of kernel `name`'s launch of B slices of H × W with C
    coils, on a card of `sms` SMs and `smem_max` bytes of shared memory per
    block that holds n clusters of c cluster CTAs at once for each pair
    (c, n) of `resident` (a size not named is held 0 times) and
    `grid_ctas` grid CTAs (None: one a SM); `cluster_bytes(H, W, team)` is
    a cluster CTA's shared memory, `scratch` the (cluster, grid) planes,
    and `head`, `phases` the grid CTA's own bytes and clocks. Resident or
    split on the plan of :func:`coil_plan` (`split` forces one); else, or
    where `grid` forces it, grid (:func:`plan_grid`). Raises ValueError
    naming the shape where it is empty or not the FFT's, and naming the
    plan where the card holds no cluster or team of it (no fallback)."""
    if min(B, C) < 1:
        raise ValueError(f"{name}: empty shape {B} x {H}x{W}, {C} coils")
    check_fft_shape(H, W)
    if split is not None and grid is not None:
        raise ValueError(f"{name}: a forced split plan and a forced grid plan at once")
    shape = None if grid is not None else coil_plan(name, H, W, C, sms, smem_max, cluster_bytes,
                                                    split)
    if shape is None:
        return plan_grid(name, B, H, W, C, sms if grid_ctas is None else grid_ctas, smem_max,
                         head, phases, scratch[1], grid)
    team, c, rounds = shape
    held = dict(resident).get(c, 0)
    plan = SensePlan("resident" if team == 1 else "split", c, rounds, H, C, B * c,
                     cluster_bytes(H, W, team), scratch[0], held, team, W)
    if held < 1:
        raise ValueError(f"{name}: the card holds no cluster of {plan} ({B} x {H}x{W}, {C} coils)")
    return plan


@functools.lru_cache(maxsize=256)
def plan_sense(B, H, W, C, resident, sms=SMS, smem_max=SMEM_MAX, split=None, grid_ctas=None,
               grid=None) -> SensePlan:
    """The route of a fused FISTA-L21-SENSE launch (:func:`plan_coils`):
    resident where the timer, the twiddles and a coil's padded spectrum
    (:func:`resident_smem_bytes`) fit one CTA, else split where a team's
    CTA (:func:`split_smem_bytes`) fits, else grid."""
    return plan_coils("fista_l21_sense_fused", B, H, W, C, resident, sms, smem_max,
                      cluster_smem_bytes, (RESIDENT_SCRATCH, GRID_SCRATCH), split, grid_ctas, grid)


@functools.lru_cache(maxsize=None)
def cluster_limits(entry, index, clusters, team, H, W):
    """(shared memory per CTA as the kernel counts it, clusters of its
    cluster kernel on teams of `team` that device `index` holds at once:
    ``cudaOccupancyMaxActiveClusters``), by the C entry point `entry`."""
    out = (ctypes.c_longlong * 2)()
    with torch.cuda.device(index):
        _build.check(getattr(_build.load_library(), entry)(clusters, team, H, W, out), entry)
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def grid_limits(entry, index, H, W, smem):
    """(grid CTAs of `smem` bytes of shared memory that device `index`
    holds a SM, and on all of its SMs), by the C entry point `entry`
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    out = (ctypes.c_longlong * 2)()
    with torch.cuda.device(index):
        _build.check(getattr(_build.load_library(), entry)(H, W, smem, out), entry)
    return out[0], out[1]


def plan_limits(index, clusters, team, H, W):
    """:func:`cluster_limits` of the FISTA-L21-SENSE cluster kernel."""
    return cluster_limits("sense_cluster_occupancy", index, clusters, team, H, W)


def resident_limits(index, clusters, H, W):
    """:func:`cluster_limits` of the resident FISTA-L21-SENSE kernel."""
    return plan_limits(index, clusters, 1, H, W)


def card_plan(name, x0hat, C, plan, cluster_bytes, limits, grid_entry, head=0,
              phases=len(GRID_PHASES), split=None, grid=None):
    """``plan(B, H, W, C, held, sms, smem_max, split, grid_ctas, grid)`` for
    a launch on x0hat's card ((B, 2, H, W), C coils), with the card's
    residency of the cluster plan's size (``limits(index, c, team, H,
    W)``, which also returns the kernel's count of ``cluster_bytes(H, W,
    team)``: a count that differs raises RuntimeError), or, where no
    cluster plan fits or `grid` forces the grid route, the grid CTAs the
    card holds at the grid route's largest shared memory (C entry point
    `grid_entry`)."""
    B, _, H, W = x0hat.shape
    index = x0hat.device.index or 0
    sms, smem_max = _build.device_limits(index)
    check_fft_shape(H, W)
    shape = None
    if grid is None:
        shape = coil_plan(name, H, W, max(C, 1), sms, smem_max, cluster_bytes, split)
    if shape is None:
        cap = grid_plane_cap(H, W, smem_max, head, phases)
        held = (grid_limits(grid_entry, index, H, W, grid_smem_bytes(H, W, cap, head, phases))[1]
                if cap else 0)
        return plan(B, H, W, C, (), sms, smem_max, split, held, grid)
    team, c, _ = shape
    smem, active = limits(index, c, team, H, W)
    if smem != cluster_bytes(H, W, team):
        raise RuntimeError(f"{name}: the kernel counts {smem} bytes of shared memory at "
                           f"{H}x{W} on teams of {team}, the planner "
                           f"{cluster_bytes(H, W, team)}")
    return plan(B, H, W, C, ((c, active),), sms, smem_max, split, None, grid)


def plan_on_card(x0hat, C, split=None, grid=None):
    """The plan of a launch on x0hat's card ((B, 2, H, W), C coils; `split`
    a forced (team, coils a round) of the cluster routes, `grid` a forced
    (team, slots, coils a round) of the grid route). Raises ValueError
    where the plan has no cluster or team the card can hold."""
    return card_plan("fista_l21_sense_fused", x0hat, C, plan_sense, cluster_smem_bytes,
                     plan_limits, "sense_grid_occupancy", split=split, grid=grid)


def grid_scratch(plan, H, W, planes, extra=0):
    """The grid route's scratch as one f32 tensor's length: each slot's
    per_round spectra (H × W complex f32) and its `planes` planes of H × W,
    then `extra` floats."""
    return plan.slots * (2 * plan.per_round + planes) * H * W + extra


def _launch(x0hat, scal, tab, coils, tables, prof=None, split=None, grid=None):
    B, _, H, W = x0hat.shape
    C = coils[0].shape[0]
    plan = plan_on_card(x0hat, C, split, grid)
    lib = _build.load_library()
    dev = x0hat.device
    tw = twiddle_tensor(tables)
    wt = tables[2].T.contiguous()  # read along a spectrum column
    out = torch.empty_like(x0hat)
    prof_ptr = None if prof is None else prof.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route != "grid":
            scratch = torch.empty((plan.scratch, B, H, W), dtype=torch.float32, device=dev)
            code = lib.sense_cluster_launch(
                x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), tw.data_ptr(),
                wt.data_ptr(), coils[0].data_ptr(), coils[1].data_ptr(), out.data_ptr(),
                scratch.data_ptr(), prof_ptr, B, H, W, C, tab.shape[0], plan.clusters, plan.team,
                plan.smem, stream)
        else:
            # each slot's spectra (complex, interleaved), then its planes;
            # the teams' barrier counters
            scratch = torch.empty(grid_scratch(plan, H, W, GRID_SCRATCH), dtype=torch.float32,
                                  device=dev)
            bar = torch.zeros(plan.slots, dtype=torch.int32, device=dev)
            code = lib.sense_grid_launch(
                x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), tw.data_ptr(),
                wt.data_ptr(), coils[0].data_ptr(), coils[1].data_ptr(), out.data_ptr(),
                scratch.data_ptr(), bar.data_ptr(), prof_ptr, B, H, W, C, tab.shape[0],
                plan.team, plan.slots, plan.per_round, plan.row_lines, plan.col_lines,
                plan.smem, stream)
    _build.check(code, f"fista_l21_sense_fused ({B} x {H}x{W}, {C} coils, {plan})")
    fista_l21_sense_fused.launches += 1
    fista_l21_sense_fused.route_launches[plan.route] += 1
    return out


def _kernel_args(x0hat_b, mask, coils_r, coils_i, rho, lam, iterations):
    """(scal, tab, coils, tables) of a call in x0hat's dtype."""
    np_dt = torch.empty((), dtype=x0hat_b.dtype).numpy().dtype
    scal = problem_scalars(x0hat_b, rho, lam, np_dt)
    tab = momentum_tensor("fista", iterations, np_dt, x0hat_b.device)
    return (scal, tab, *sense_args(x0hat_b, (coils_r, coils_i), mask))


def phase_clocks(x0hat_b, mask, coils_r, coils_i, rho, lam, iterations: int, split=None,
                 grid=None):
    """One launch of the kernel with its phase timer on: {phase: SM clocks
    that CTA 0 spent in it over the whole solve} (``PHASES`` on the cluster
    routes, ``GRID_PHASES`` on the grid route; the launch counts in
    ``fista_l21_sense_fused.launches``), on the plan's route or the forced
    `split` / `grid`."""
    scal, tab, coils, tables = _kernel_args(x0hat_b, mask, coils_r, coils_i, rho, lam,
                                            iterations)
    check_dft_cuda_input("fista_l21_sense_fused", x0hat_b, mask, *coils)
    x0hat_b = x0hat_b.contiguous()
    plan = plan_on_card(x0hat_b, coils[0].shape[0], split, grid)
    phases = GRID_PHASES if plan.route == "grid" else PHASES
    prof = torch.zeros(len(phases), dtype=torch.int64, device=x0hat_b.device)
    _launch(x0hat_b, scal, tab, coils, tables, prof, split, grid)
    return dict(zip(phases, prof.tolist()))


def fista_l21_sense_fused(x0hat_b, mask, coils_r, coils_i, rho, lam, iterations: int,
                          split=None, grid=None):
    """Batched FISTA-L21 on C-coil SENSE in one launch, on the route of
    :func:`plan_sense` (a cluster of CTAs per slice, one coil's spectrum in
    each CTA's shared memory or split over a team of CTAs, or a team of
    CTAs per slice that meet in L2).

    x0hat_b: (B, 2, H, W) split [re; im] Aᴴb; mask (H, W); coils_r,
    coils_i (C, H, W); rho, lam: scalars or (B,) (λ already
    normalization-scaled); `split`: a forced cluster plan (team, coils a
    round), `grid`: a forced grid plan (team, slots, coils a round), for
    measuring. The plain version runs for a CPU tensor, the CUDA kernel
    (float32) for a CUDA tensor. ``fista_l21_sense_fused.launches`` counts
    the kernel's launches, and ``fista_l21_sense_fused.route_launches`` the
    launches by route."""
    scal, tab, coils, tables = _kernel_args(x0hat_b, mask, coils_r, coils_i, rho, lam,
                                            iterations)
    if x0hat_b.device.type == "cpu":
        return fista_l21_sense_fused_torch(x0hat_b, scal, tab, coils, tables)
    check_dft_cuda_input("fista_l21_sense_fused", x0hat_b, mask, *coils)
    return _launch(x0hat_b.contiguous(), scal, tab, coils, tables, split=split, grid=grid)


fista_l21_sense_fused.launches = 0
fista_l21_sense_fused.route_launches = {"resident": 0, "split": 0, "grid": 0}


def check_fista_l21_sense_fused(solver):
    """Validate `solver` for the fused SENSE FISTA-L21 path (raises
    ValueError naming the first unsupported piece)."""
    if not isinstance(solver, FISTA):
        raise ValueError("fused path requires a FISTA solver")
    check_fft_normal(solver, SenseDFT2RealOperator)
    reg = solver.reg
    if not isinstance(reg, L21Regularization) or reg.slices != 2:
        raise ValueError(
            "fused path requires L21Regularization(slices=2) — the split-real form of complex L1"
        )
    check_fista_schedule(solver)


def solve_fista_l21_sense_fused(solver, B_mat):
    """Drop-in fast path for `solve_batched_unrolled(solver, B)` when the
    solver is FISTA + SenseDFT2RealOperator + L21(slices=2) (complex-L1
    SENSE MRI). Returns the n×K solution matrix ([re; im] rows)."""
    check_fista_l21_sense_fused(solver)
    op = solver.A
    H, W = op.im_shape
    x0, lam_eff = seed_and_lam(solver, B_mat, solver.reg)
    out = fista_l21_sense_fused(x0.reshape(-1, 2, H, W), op.mask, op.coils_r, op.coils_i,
                                solver.rho, lam_eff, solver.iterations)
    return out.reshape(out.shape[0], 2 * H * W).T
