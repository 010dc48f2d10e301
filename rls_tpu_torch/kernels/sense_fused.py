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
coils a round at most; and **global**, one CTA per slice staging the
spectrum through shared memory chunk by chunk, for shapes whose spectrum
fits no team (512² and larger). The planner's pieces
(:func:`cluster_size`, :func:`coil_plan`, :class:`SensePlan`,
:func:`plan_coils`, :func:`card_plan`) also plan the SplitBregman kernel,
whose cluster routes run the same SENSE normal op
(``csrc/sense_cluster.cuh``, ``csrc/sense_split.cuh``).

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
from .fista_tv_fused import momentum_tensor, problem_scalars

__all__ = [
    "fista_l21_sense_fused",
    "fista_l21_sense_fused_torch",
    "plan_sense",
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
# global scratch planes of (B, H, W). Resident and split: (re, im) of m,
# x_prev and the coil sum between rounds. Global: (re, im) of m, x_prev,
# the spectrum and the coil sum
RESIDENT_SCRATCH, GLOBAL_SCRATCH = 6, 8
# the global route's static shared memory (csrc/dft_common.cuh FftShared,
# 2 × 4352 + 2 × 1024 floats)
GLOBAL_SMEM = 4 * (2 * 4352 + 2 * 1024)


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
    """(team, c, rounds) of a cluster plan for C coils of H × W, or None for
    the global route. Team 1 (resident) where a CTA holds a coil's padded
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
    spectrum split over a team of `team` CTAs) or "global" (one CTA per
    slice, every coil in turn); `ctas` CTAs in all, `smem` bytes of shared
    memory per CTA, `scratch` planes of (B, H, W) in global memory, and on
    the cluster routes `resident_clusters`, the clusters the card holds at
    once."""

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

    def band(self, rank):
        """[r0, r1): the image rows CTA `rank` owns for the fold and the
        pixel updates: H // c rows, one more for the first H % c ranks
        (empty where H < c)."""
        return split_part(self.H, self.clusters, rank)


def plan_coils(name, B, H, W, C, resident, sms, smem_max, cluster_bytes, global_smem, scratch,
               split=None) -> SensePlan:
    """The route of kernel `name`'s launch of B slices of H × W with C
    coils, on a card of `sms` SMs and `smem_max` bytes of shared memory per
    block that holds n clusters of c cluster CTAs at once for each pair
    (c, n) of `resident` (a size not named is held 0 times);
    `cluster_bytes(H, W, team)` is a cluster CTA's shared memory,
    `global_smem` the global route's, and `scratch` (cluster, global)
    global planes. Resident or split on the plan of :func:`coil_plan`
    (`split` forces one); else global. Raises ValueError naming the shape
    where it is empty or not the FFT's, and naming the plan where the card
    holds no cluster of it (no fallback)."""
    if min(B, C) < 1:
        raise ValueError(f"{name}: empty shape {B} x {H}x{W}, {C} coils")
    check_fft_shape(H, W)
    shape = coil_plan(name, H, W, C, sms, smem_max, cluster_bytes, split)
    if shape is None:
        return SensePlan("global", 1, C, H, C, B, global_smem, scratch[1], None)
    team, c, rounds = shape
    held = dict(resident).get(c, 0)
    plan = SensePlan("resident" if team == 1 else "split", c, rounds, H, C, B * c,
                     cluster_bytes(H, W, team), scratch[0], held, team)
    if held < 1:
        raise ValueError(f"{name}: the card holds no cluster of {plan} ({B} x {H}x{W}, {C} coils)")
    return plan


@functools.lru_cache(maxsize=256)
def plan_sense(B, H, W, C, resident, sms=SMS, smem_max=SMEM_MAX, split=None) -> SensePlan:
    """The route of a fused FISTA-L21-SENSE launch (:func:`plan_coils`):
    resident where the timer, the twiddles and a coil's padded spectrum
    (:func:`resident_smem_bytes`) fit one CTA, else split where a team's
    CTA (:func:`split_smem_bytes`) fits, else global."""
    return plan_coils("fista_l21_sense_fused", B, H, W, C, resident, sms, smem_max,
                      cluster_smem_bytes, GLOBAL_SMEM, (RESIDENT_SCRATCH, GLOBAL_SCRATCH), split)


@functools.lru_cache(maxsize=None)
def cluster_limits(entry, index, clusters, team, H, W):
    """(shared memory per CTA as the kernel counts it, clusters of its
    cluster kernel on teams of `team` that device `index` holds at once:
    ``cudaOccupancyMaxActiveClusters``), by the C entry point `entry`."""
    out = (ctypes.c_longlong * 2)()
    with torch.cuda.device(index):
        _build.check(getattr(_build.load_library(), entry)(clusters, team, H, W, out), entry)
    return out[0], out[1]


def plan_limits(index, clusters, team, H, W):
    """:func:`cluster_limits` of the FISTA-L21-SENSE cluster kernel."""
    return cluster_limits("sense_cluster_occupancy", index, clusters, team, H, W)


def resident_limits(index, clusters, H, W):
    """:func:`cluster_limits` of the resident FISTA-L21-SENSE kernel."""
    return plan_limits(index, clusters, 1, H, W)


def card_plan(name, x0hat, C, plan, cluster_bytes, limits, split=None):
    """``plan(B, H, W, C, held, sms, smem_max, split)`` for a launch on
    x0hat's card ((B, 2, H, W), C coils), with the card's residency of the
    cluster plan's size (``limits(index, c, team, H, W)``, which also
    returns the kernel's count of ``cluster_bytes(H, W, team)``: a count
    that differs raises RuntimeError)."""
    B, _, H, W = x0hat.shape
    index = x0hat.device.index or 0
    sms, smem_max = _build.device_limits(index)
    check_fft_shape(H, W)
    held = ()
    shape = coil_plan(name, H, W, max(C, 1), sms, smem_max, cluster_bytes, split)
    if shape is not None:
        team, c, _ = shape
        smem, active = limits(index, c, team, H, W)
        if smem != cluster_bytes(H, W, team):
            raise RuntimeError(f"{name}: the kernel counts {smem} bytes of shared memory at "
                               f"{H}x{W} on teams of {team}, the planner "
                               f"{cluster_bytes(H, W, team)}")
        held = ((c, active),)
    return plan(B, H, W, C, held, sms, smem_max, split)


def plan_on_card(x0hat, C, split=None):
    """The plan of a launch on x0hat's card ((B, 2, H, W), C coils; `split`
    a forced (team, coils a round)). Raises ValueError where the cluster
    plan has no cluster the card can hold."""
    return card_plan("fista_l21_sense_fused", x0hat, C, plan_sense, cluster_smem_bytes,
                     plan_limits, split)


def _launch(x0hat, scal, tab, coils, tables, prof=None, split=None):
    B, _, H, W = x0hat.shape
    C = coils[0].shape[0]
    plan = plan_on_card(x0hat, C, split)
    if prof is not None and plan.route == "global":
        raise ValueError(f"fista_l21_sense_fused: the phase timer is on the resident route and "
                         f"the split route, not {plan}")
    lib = _build.load_library()
    dev = x0hat.device
    tw = twiddle_tensor(tables)
    out = torch.empty_like(x0hat)
    scratch = torch.empty((plan.scratch, B, H, W), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route != "global":
            wt = tables[2].T.contiguous()  # read along a spectrum column
            code = lib.sense_cluster_launch(
                x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), tw.data_ptr(),
                wt.data_ptr(), coils[0].data_ptr(), coils[1].data_ptr(), out.data_ptr(),
                scratch.data_ptr(), None if prof is None else prof.data_ptr(), B, H, W, C,
                tab.shape[0], plan.clusters, plan.team, plan.smem, stream)
        else:
            weights = tables[2].contiguous()
            code = lib.sense_fused_launch(
                x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), tw.data_ptr(),
                weights.data_ptr(), coils[0].data_ptr(), coils[1].data_ptr(), out.data_ptr(),
                scratch.data_ptr(), B, H, W, C, tab.shape[0], stream)
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


def phase_clocks(x0hat_b, mask, coils_r, coils_i, rho, lam, iterations: int, split=None):
    """One launch of the cluster kernel (resident or split) with its phase
    timer on: {phase: SM clocks that CTA 0 spent in it over the whole
    solve} (``PHASES``; the launch counts in
    ``fista_l21_sense_fused.launches``). Raises on the global route."""
    scal, tab, coils, tables = _kernel_args(x0hat_b, mask, coils_r, coils_i, rho, lam,
                                            iterations)
    check_dft_cuda_input("fista_l21_sense_fused", x0hat_b, mask, *coils)
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=x0hat_b.device)
    _launch(x0hat_b.contiguous(), scal, tab, coils, tables, prof, split)
    return dict(zip(PHASES, prof.tolist()))


def fista_l21_sense_fused(x0hat_b, mask, coils_r, coils_i, rho, lam, iterations: int,
                          split=None):
    """Batched FISTA-L21 on C-coil SENSE in one launch, on the route of
    :func:`plan_sense` (a cluster of CTAs per slice, one coil's spectrum in
    each CTA's shared memory or split over a team of CTAs, or one CTA per
    slice).

    x0hat_b: (B, 2, H, W) split [re; im] Aᴴb; mask (H, W); coils_r,
    coils_i (C, H, W); rho, lam: scalars or (B,) (λ already
    normalization-scaled); `split`: a forced cluster plan (team, coils a
    round), for measuring. The plain version runs for a CPU tensor, the
    CUDA kernel (float32) for a CUDA tensor.
    ``fista_l21_sense_fused.launches`` counts the kernel's launches, and
    ``fista_l21_sense_fused.route_launches`` the launches by route."""
    scal, tab, coils, tables = _kernel_args(x0hat_b, mask, coils_r, coils_i, rho, lam,
                                            iterations)
    if x0hat_b.device.type == "cpu":
        return fista_l21_sense_fused_torch(x0hat_b, scal, tab, coils, tables)
    check_dft_cuda_input("fista_l21_sense_fused", x0hat_b, mask, *coils)
    return _launch(x0hat_b.contiguous(), scal, tab, coils, tables, split=split)


fista_l21_sense_fused.launches = 0
fista_l21_sense_fused.route_launches = {"resident": 0, "split": 0, "global": 0}


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
