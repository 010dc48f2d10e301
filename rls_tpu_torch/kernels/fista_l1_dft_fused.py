"""The whole batched FISTA-L1 compressed-sensing solve on a subsampled 2-D
DFT as ONE launch: the hand-written CUDA kernel
``csrc/fista_l1_dft_fused.cu`` and its plain PyTorch version.

Counterpart of ``rls_tpu/kernels/fista_l1_dft_fused.py``: ``_kernel``
(:32-107), ``fista_l1_dft_fused`` (:110-147), ``check_fista_l1_dft_fused``
(:150-190) and ``solve_fista_l1_dft_fused`` (:205-247). BASELINE
configuration #2: FISTA with the real soft threshold on
``SubsampledDFT2RealOperator``, fixed iterations, per problem

    a     = momentum table, column 0 (f64 on the host, rounded once)
    x_mom = x + a (x − x_prev)
    xg    = x_mom − ρ (Re(Fᴴ M F x_mom) − x0hat)
    x     = max(|xg| − ρλ, 0) · (xg + ε) / (|xg| + ε)

from x = x_prev = 0. The normal op runs on the in-kernel FFT of
``_dft_common`` (the plain version repeats it stage by stage); x0hat is
the operator's own adjoint of b (cuFFT on the card).

The kernel runs on one of two routes that :func:`plan_fista_l1_dft` picks
by shape:

* resident: each problem on a thread-block cluster of c ≤ 16 CTAs, the
  image's rows and the spectrum's columns split over it as evenly as
  possible (``_dft_common.split_part``: bands of ⌊H/c⌋ or ⌈H/c⌉ rows,
  blocks of ⌊W/c⌋ or ⌈W/c⌉ columns), CTA r owning its band of x, x_prev
  and the spectrum and its block of columns in shared memory for the
  whole solve; the transposes between the row and the column passes go
  through distributed shared memory (the CS cell at 256²: 16 bands of 16
  rows; 320²: 16 bands of 20; 97 × 128 at batch 2: bands of 33, 32 and
  32 rows on 3 CTAs);
* grid: where no cluster of 16 holds a band and a block (448², 512², 640²,
  1024² and 1024 × 256: every square side from 385 on, all past the JAX
  kernel's VMEM check), one cooperative launch whose CTAs are all
  resident: each problem on a team of CTAs (33 a problem at 4 × 512² on an
  H100) that meet at a barrier of their own on a counter in global
  memory, `slots` problems at once and the rest in rounds; the team's
  bands and blocks split as the resident route's, the spectrum in global
  scratch (L2), each CTA transforming whole lines of its band and block in
  shared memory, two team barriers an iteration (the table is in the
  kernel's header).

Both routes agree with the plain version bit for bit.

Not carried over: the TPU's bf16 hi/lo DFT factors (``op.cat``), its VMEM
gate ``_check_vmem_fista_l1_dft`` and ``interpret=``. The size gate is the
FFT's own: H and W from 2 to 1024, whatever their prime factors
(``_dft_common.check_fft_shape``), which covers every side the JAX kernel
takes on its chip (multiples of 64 up to 320², 64 × 704).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from .._build import SMEM_MAX, SMS
from ..models.prox import L1Regularization
from ..models.solvers.fista import FISTA
from ..ops.dft_real import SubsampledDFT2RealOperator
from . import _dft_common
from ._bands import cdiv, fewest_waves
from .fista_tv_fused import momentum_tensor, problem_scalars

__all__ = [
    "fista_l1_dft_fused",
    "fista_l1_dft_fused_torch",
    "check_fista_l1_dft_fused",
    "solve_fista_l1_dft_fused",
    "plan_fista_l1_dft",
    "DftPlan",
    "phase_clocks",
    "GRID_PHASES",
]

# the cluster sizes of the resident route at a power-of-two shape, and the
# largest at any shape (the non-portable 16)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_CLUSTER = 16
# the phases of the resident route's timer (csrc/fista_l1_dft_fused.cu kPhases)
PHASES = ("set-up and write-out", "loads", "rows forward", "push to the column blocks",
          "barrier A", "column transforms", "write-back", "barrier B", "rows back and store")
# the phases of the grid route's timer (csrc/fista_l1_dft_fused.cu kGridPhases)
GRID_PHASES = ("set-up", "row loads", "rows back", "pixel update", "rows forward and store",
               "column loads", "column transforms", "column stores", "barrier T1", "barrier T2")


def _ceil4(n):
    return -(-n // 4) * 4


def resident_smem_bytes(H, W, clusters):
    """Shared memory of a resident CTA at H × W on clusters of `clusters`
    CTAs, as ``resident_smem_bytes`` in csrc/fista_l1_dft_fused.cu counts
    it: the twiddles (``twiddle_floats(H, W)`` f32: H + W at powers of
    two), x, x_prev and the band's spectrum (re, im) of ⌈H/c⌉·W f32 each
    (the largest band), the column block (re, im) of H·(⌈W/c⌉ + 1) f32
    each (the largest block and its pitch), every f32 array rounded up to 4
    floats (csrc/split.cuh), and the phase timer (one int64 per phase)."""
    band = _ceil4(cdiv(H, clusters) * W)
    block = _ceil4(H * (cdiv(W, clusters) + 1))
    return (4 * (_ceil4(_dft_common.twiddle_floats(H, W)) + 4 * band + 2 * block)
            + 8 * len(PHASES))


def grid_pitch(n):
    """The pitch of an n-point line in a grid CTA's shared memory: odd
    (csrc/fista_l1_dft_fused.cu grid_pitch)."""
    return n | 1


def grid_smem_bytes(H, W, plane):
    """Shared memory of a CTA of the grid route at H × W whose two planes
    (re, im) hold `plane` f32 each, as ``grid_smem_bytes`` in
    csrc/fista_l1_dft_fused.cu counts it: the twiddles rounded up to 4
    floats, the two planes, and the phase timer (one int64 per phase)."""
    return 4 * (_ceil4(_dft_common.twiddle_floats(H, W)) + 2 * plane) + 8 * len(GRID_PHASES)


def grid_plane_cap(H, W, smem_max=SMEM_MAX):
    """The most f32 of a grid CTA's plane (a multiple of 4) that `smem_max`
    bytes of shared memory hold."""
    return max(0, (smem_max - grid_smem_bytes(H, W, 0)) // 8 // 4 * 4)


def grid_chunk(lines, pitch, cap):
    """Lines of a chunk when a CTA's `lines` lines of `pitch` floats pass
    through a plane of `cap` floats: as few chunks as fit, as even as
    possible (0 where not one line fits)."""
    fit = cap // pitch
    return 0 if fit < 1 else cdiv(lines, cdiv(lines, fit))


@dataclasses.dataclass(frozen=True)
class DftPlan:
    """How a fused FISTA-L1-DFT launch runs: `route` "resident" (a cluster
    of `clusters` CTAs per problem) or "grid" (a team of `clusters` CTAs per
    problem, `slots` problems at once and `rounds` = ⌈B / slots⌉ of them a
    slot, one cooperative launch); either way H and W split over the
    problem's CTAs by ``_dft_common.split_part`` (:meth:`band`,
    :meth:`block`): bands of at most `rows` image rows, blocks of at most
    `cols` spectrum columns, `smem` bytes of shared memory per CTA, `ctas`
    CTAs in all. A grid CTA transforms its band `row_lines` rows at a time
    and its block `col_lines` columns at a time (0 on the resident
    route)."""

    route: str
    clusters: int
    rows: int
    cols: int
    H: int
    W: int
    ctas: int
    smem: int
    slots: int = 0
    rounds: int = 0
    row_lines: int = 0
    col_lines: int = 0

    @property
    def team(self):
        """The CTAs of one problem (the cluster's, or the grid's team)."""
        return self.clusters

    def band(self, rank):
        """[r0, r1): the image rows CTA `rank` owns."""
        return _dft_common.split_part(self.H, self.clusters, rank)

    def block(self, rank):
        """[c0, c1): the spectrum columns CTA `rank` transforms."""
        return _dft_common.split_part(self.W, self.clusters, rank)


def cluster_sizes(H, W, sms=SMS, smem_max=SMEM_MAX):
    """The cluster sizes c the resident kernel takes at H × W whose CTAs
    fit one block's shared memory, c ≤ sms: at a power-of-two shape the
    powers of two up to 16 that divide H and W (the kernel's shifts), at
    any other every c from 1 to min(16, H, W) (uneven parts where c does
    not divide a side)."""
    sizes = (CLUSTER_SIZES if _dft_common._is_pow2(H) and _dft_common._is_pow2(W)
             else range(1, MAX_CLUSTER + 1))
    return tuple(c for c in sizes
                 if c <= min(sms, H, W) and resident_smem_bytes(H, W, c) <= smem_max)


def fitting_sizes(H, W, sms=SMS, smem_max=SMEM_MAX):
    """The cluster sizes the planner chooses among: those of
    :func:`cluster_sizes` that are powers of two dividing H and W (even
    bands and blocks) where there are any, else all of them (uneven ones:
    97 × 128 takes 2 to 16, 300² 10 to 16). Empty where no cluster of 16
    holds a band (512², and every square side from 385): the grid route's
    shapes."""
    fit = cluster_sizes(H, W, sms, smem_max)
    even = tuple(c for c in fit if c in CLUSTER_SIZES and H % c == 0 and W % c == 0)
    return even or fit


@functools.lru_cache(maxsize=256)
def plan_fista_l1_dft(B, H, W, resident, sms=SMS, smem_max=SMEM_MAX, clusters=None,
                      grid_ctas=None, grid=None) -> DftPlan:
    """The route of a fused FISTA-L1-DFT launch of B problems of H × W, on
    a card of `sms` SMs and `smem_max` bytes of shared memory per block
    that holds n clusters of c CTAs of the resident kernel at once for each
    pair (c, n) of `resident` (``cudaOccupancyMaxActiveClusters``; a size
    not named is held 0 times) and `grid_ctas` CTAs of the grid kernel
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` × SMs at the
    largest shared memory the grid route takes; None: one a SM, as a CTA
    of 1024 threads leaves no room for a second).

    The rule, as ``plan_pdhg``'s: among the sizes of :func:`fitting_sizes`
    that the card holds, the smallest and each larger one that leaves every
    CTA at least ``MIN_CTA_PIXELS`` pixels, the one with the fewest waves ×
    rows per band, ⌈B / held(c)⌉ · ⌈H/c⌉ (a CTA transforms ⌈H/c⌉ rows and
    as many columns' worth of points); ties go to the smaller c. A spectrum
    whose bands fit at no c (448², 512², 640², 1024²) takes the grid route:
    :func:`plan_grid`. `clusters` forces a size of :func:`cluster_sizes`,
    `grid` a (team, slots) of the grid route at any shape (for measuring
    and tests).
    Raises ValueError naming the shape where it is empty or not the FFT's,
    naming a forced size that does not fit, and naming the plan where the
    card holds no cluster or team of it (no fallback)."""
    if B < 1:
        raise ValueError(f"fista_l1_dft_fused: empty batch of {B} x {H}x{W}")
    _dft_common.check_fft_shape(H, W)
    fit = fitting_sizes(H, W, sms, smem_max)
    if clusters is not None and clusters not in cluster_sizes(H, W, sms, smem_max):
        raise ValueError(f"fista_l1_dft_fused: a cluster of {clusters} CTAs does not fit "
                         f"{B} x {H}x{W} (the sizes that do: {cluster_sizes(H, W, sms, smem_max)})")
    if grid is not None or not fit:
        return plan_grid(B, H, W, sms if grid_ctas is None else grid_ctas, smem_max, grid)
    c = clusters or fewest_waves(B, H, W, fit, resident)
    plan = DftPlan("resident", c, cdiv(H, c), cdiv(W, c), H, W, B * c,
                   resident_smem_bytes(H, W, c))
    if dict(resident).get(c, 0) < 1:
        raise ValueError(f"fista_l1_dft_fused: the card holds no cluster of {plan} "
                         f"({B} x {H}x{W})")
    return plan


def grid_cost(B, H, W, team, slots):
    """The grid route's cost of a team and slots: rounds × the points a CTA
    transforms a round, ⌈B / slots⌉ · (⌈H/team⌉ · W + ⌈W/team⌉ · H)."""
    return cdiv(B, slots) * (cdiv(H, team) * W + cdiv(W, team) * H)


def plan_grid(B, H, W, held, smem_max=SMEM_MAX, grid=None) -> DftPlan:
    """The grid route's plan of B problems of H × W on a card that holds
    `held` grid CTAs at once: for each number of slots s ≤ min(B, held), a
    team of min(⌊held / s⌋, H, W) CTAs a problem; the least
    :func:`grid_cost`, ties to more slots (fewer rounds, so fewer team
    barriers one after the other: 4 × 512² on 132 CTAs takes 4 slots of
    33). Each CTA's band and block pass through its shared memory in the
    fewest chunks that fit (:func:`grid_chunk`), and the CTA takes the
    shared memory those chunks need. `grid` forces (team, slots). Raises
    ValueError where a line fits no CTA, naming a forced plan past the
    shape, and naming the plan where the card holds fewer CTAs than it
    launches (no fallback)."""
    cap = grid_plane_cap(H, W, smem_max)
    if cap < max(grid_pitch(H), grid_pitch(W)):
        raise ValueError(f"fista_l1_dft_fused: a line of {B} x {H}x{W} fits no grid CTA of "
                         f"{smem_max} bytes of shared memory")
    if grid is not None:
        team, slots = grid
        if not (1 <= team <= min(H, W) and 1 <= slots <= B):
            raise ValueError(f"fista_l1_dft_fused: a grid of {team} CTAs a problem in {slots} "
                             f"slots does not fit {B} x {H}x{W}")
    else:
        team, slots, best = 1, 1, None
        for s in range(1, min(B, held) + 1):
            t = min(held // s, H, W)
            cost = grid_cost(B, H, W, t, s)
            if best is None or cost <= best:
                team, slots, best = t, s, cost
    rows, cols = cdiv(H, team), cdiv(W, team)
    row_lines, col_lines = grid_chunk(rows, grid_pitch(W), cap), grid_chunk(cols, grid_pitch(H), cap)
    plane = _ceil4(max(row_lines * grid_pitch(W), col_lines * grid_pitch(H)))
    plan = DftPlan("grid", team, rows, cols, H, W, team * slots, grid_smem_bytes(H, W, plane),
                   slots, cdiv(B, slots), row_lines, col_lines)
    if plan.ctas > held:
        raise ValueError(f"fista_l1_dft_fused: the card holds {held} CTAs, not the team of "
                         f"{plan} ({B} x {H}x{W})")
    return plan


@functools.lru_cache(maxsize=None)
def resident_limits(index, clusters, H, W):
    """(shared memory per CTA as the kernel counts it, clusters of the
    resident kernel that device `index` holds at once:
    ``cudaOccupancyMaxActiveClusters``)."""
    from .. import _build

    out = (ctypes.c_longlong * 2)()
    with torch.cuda.device(index):
        _build.check(_build.load_library().fista_l1_dft_cluster_occupancy(clusters, H, W, out),
                     "fista_l1_dft_cluster_occupancy")
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def grid_limits(index, H, W, smem):
    """(grid CTAs of `smem` bytes of shared memory that device `index`
    holds a SM, and on all of its SMs:
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    from .. import _build

    out = (ctypes.c_longlong * 2)()
    with torch.cuda.device(index):
        _build.check(_build.load_library().fista_l1_dft_grid_occupancy(H, W, smem, out),
                     "fista_l1_dft_grid_occupancy")
    return out[0], out[1]


def plan_on_card(x0hat, clusters=None, grid=None):
    """(plan, clusters or grid CTAs resident at once) of a launch on x0hat's
    card ((B, H, W)), with `clusters` or `grid` (team, slots) forced where
    given. Raises RuntimeError where the kernel counts other shared memory
    than the planner, ValueError where the plan has no cluster or team the
    card can hold."""
    from .. import _build

    B, H, W = x0hat.shape
    _dft_common.check_fft_shape(H, W)
    index = x0hat.device.index or 0
    limits = _build.device_limits(index)
    sizes = set(fitting_sizes(H, W, *limits))
    if grid is not None or not sizes:
        # the card's count at the grid route's largest shared memory, which
        # no plan exceeds
        cap = grid_plane_cap(H, W, limits[1])
        held = grid_limits(index, H, W, grid_smem_bytes(H, W, cap))[1] if cap else 0
        plan = plan_fista_l1_dft(B, H, W, (), *limits, clusters, held, grid)
        return plan, grid_limits(index, H, W, plan.smem)[1]
    if clusters in cluster_sizes(H, W, *limits):
        sizes.add(clusters)
    held = {c: resident_limits(index, c, H, W) for c in sorted(sizes)}
    plan = plan_fista_l1_dft(B, H, W, tuple((c, n) for c, (_, n) in held.items()), *limits,
                             clusters, None, grid)
    smem, active = held[plan.clusters]
    if smem != plan.smem:
        raise RuntimeError(f"fista_l1_dft_fused: the kernel counts {smem} bytes of shared "
                           f"memory for {plan}")
    return plan, active


def fista_l1_dft_fused_torch(x0hat, scal, tab, tables):
    """Plain version: `x0hat` (B, H, W), `scal` (B, 2) = [ρ, λ_eff], `tab`
    the momentum table (one row per iteration), `tables` the
    ``_dft_common.dft_tables`` of the mask. Returns x in x0hat's dtype."""

    def col(v):
        return v.view(-1, 1, 1)

    rho, lam = col(scal[:, 0]), col(scal[:, 1])
    t = rho * lam
    eps = torch.finfo(x0hat.dtype).eps
    x = x_prev = x0hat * 0.0
    for i in range(tab.shape[0]):
        x_mom = x + tab[i, 0] * (x - x_prev)
        res = _dft_common.real_normal(x_mom, tables) - x0hat
        xg = x_mom - rho * res
        mag = xg.abs()
        x, x_prev = torch.clamp(mag - t, min=0.0) * (xg + eps) / (mag + eps), x
    return x


def _launch(x0hat, scal, tab, tables, plan, prof=None):
    from .. import _build

    B, H, W = x0hat.shape
    lib = _build.load_library()
    dev = x0hat.device
    tw = _dft_common.twiddle_tensor(tables)
    wt = tables[2].T.contiguous()  # read along a spectrum column
    out = torch.empty_like(x0hat)
    prof_ptr = None if prof is None else prof.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "resident":
            code = lib.fista_l1_dft_cluster_launch(
                x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), tw.data_ptr(), wt.data_ptr(),
                out.data_ptr(), prof_ptr, B, H, W, tab.shape[0], plan.clusters, plan.smem, stream)
        else:
            # each slot's spectrum (complex, interleaved), then its x_prev;
            # the teams' barrier counters
            scratch = torch.empty((3 * plan.slots, H, W), dtype=torch.float32, device=dev)
            bar = torch.zeros(plan.slots, dtype=torch.int32, device=dev)
            code = lib.fista_l1_dft_grid_launch(
                x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), tw.data_ptr(), wt.data_ptr(),
                out.data_ptr(), scratch.data_ptr(), bar.data_ptr(), prof_ptr, B, H, W,
                tab.shape[0], plan.clusters, plan.slots, plan.row_lines, plan.col_lines,
                plan.smem, stream)
    _build.check(code, f"fista_l1_dft_fused ({B} x {H}x{W}, {plan})")
    fista_l1_dft_fused.launches += 1
    fista_l1_dft_fused.route_launches[plan.route] += 1
    return out


def _kernel_args(x0hat_b, mask, rho, lam, iterations):
    """(scal, tab, tables) for the kernel and its plain version, in x0hat's
    dtype on its device."""
    H, W = x0hat_b.shape[-2:]
    if tuple(mask.shape) != (H, W):
        raise ValueError(f"fista_l1_dft_fused: a mask of {tuple(mask.shape)} for images of "
                         f"{H}x{W}")
    np_dt = torch.empty((), dtype=x0hat_b.dtype).numpy().dtype
    return (problem_scalars(x0hat_b, rho, lam, np_dt),
            momentum_tensor("fista", iterations, np_dt, x0hat_b.device),
            _dft_common.dft_tables(mask, x0hat_b.dtype))


def fista_l1_dft_fused(x0hat_b, mask, rho, lam, iterations: int, clusters=None, grid=None):
    """Batched FISTA-L1 on the subsampled DFT of `mask` (H, W) in one
    launch, on the route of :func:`plan_fista_l1_dft` (a cluster of CTAs
    per problem with its state in shared memory, or a team of CTAs per
    problem that meet in L2).

    x0hat_b: (B, H, W), Aᴴb per problem; rho, lam: scalars or (B,) (λ
    already normalization-scaled). The plain version runs for a CPU
    tensor, the CUDA kernel (float32) for a CUDA tensor; `clusters` forces
    the resident route's cluster size and `grid` the grid route's (team,
    slots) (for measuring and tests; the plain version has no plan).
    ``fista_l1_dft_fused.launches`` counts the kernel's launches, and
    ``fista_l1_dft_fused.route_launches`` the launches by route."""
    if x0hat_b.device.type == "cpu":
        return fista_l1_dft_fused_torch(x0hat_b, *_kernel_args(x0hat_b, mask, rho, lam,
                                                                iterations))
    _dft_common.check_dft_cuda_input("fista_l1_dft_fused", x0hat_b, mask)
    x0hat_b = x0hat_b.contiguous()
    return _launch(x0hat_b, *_kernel_args(x0hat_b, mask, rho, lam, iterations),
                   plan_on_card(x0hat_b, clusters, grid)[0])


fista_l1_dft_fused.launches = 0
fista_l1_dft_fused.route_launches = {"resident": 0, "grid": 0}


def phase_clocks(x0hat_b, mask, rho, lam, iterations: int, clusters=None, grid=None):
    """One launch of the kernel with its phase timer on: {phase: SM clocks
    that CTA 0 spent in it over the whole solve} (``PHASES`` on the
    resident route, ``GRID_PHASES`` on the grid route; the launch counts in
    ``fista_l1_dft_fused.launches``), on the plan's route or the forced
    `clusters` / `grid`. Raises for a CPU tensor."""
    if x0hat_b.device.type == "cpu":
        raise ValueError("fista_l1_dft_fused: the phase timer runs on the card")
    _dft_common.check_dft_cuda_input("fista_l1_dft_fused", x0hat_b, mask)
    x0hat_b = x0hat_b.contiguous()
    plan, _ = plan_on_card(x0hat_b, clusters, grid)
    phases = PHASES if plan.route == "resident" else GRID_PHASES
    prof = torch.zeros(len(phases), dtype=torch.int64, device=x0hat_b.device)
    _launch(x0hat_b, *_kernel_args(x0hat_b, mask, rho, lam, iterations), plan, prof)
    return dict(zip(phases, prof.tolist()))


def check_fista_l1_dft_fused(solver):
    """Validate `solver` for the fused FISTA-L1-DFT path (raises ValueError
    naming the first unsupported piece)."""
    if not isinstance(solver, FISTA):
        raise ValueError("fused path requires a FISTA solver")
    _dft_common.check_fft_normal(solver, SubsampledDFT2RealOperator)
    if not isinstance(solver.reg, L1Regularization):
        raise ValueError("fused path requires L1Regularization")
    _dft_common.check_fista_schedule(solver)


def solve_fista_l1_dft_fused(solver, B_mat):
    """Drop-in fast path for `solve_batched_unrolled(solver, B)` when the
    solver is FISTA + SubsampledDFT2RealOperator + L1 (BASELINE
    configuration #2's shape). Returns the n×K solution matrix."""
    check_fista_l1_dft_fused(solver)
    op = solver.A
    H, W = op.im_shape
    x0, lam_eff = _dft_common.seed_and_lam(solver, B_mat, solver.reg)
    out = fista_l1_dft_fused(x0.reshape(-1, H, W), op.mask, solver.rho, lam_eff,
                             solver.iterations)
    return out.reshape(out.shape[0], H * W).T
