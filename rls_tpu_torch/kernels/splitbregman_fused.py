"""The whole batched SplitBregman (L21 + TV) multi-coil SENSE solve as ONE
launch: the hand-written CUDA kernel ``csrc/splitbregman_fused.cu`` and
its plain PyTorch version.

Counterpart of ``rls_tpu/kernels/splitbregman_fused.py``: ``_kernel``
(:48-185), ``splitbregman_l1_tv_sense_fused`` (:217-279), ``_term_order``
(:298-314), ``check_splitbregman_l1_tv_fused`` (:317-373) and
``solve_splitbregman_l1_tv_fused`` (:376-437). BASELINE configuration #4:
SplitBregman on ``SenseDFT2RealOperator`` with two identity-trafo terms,
complex L1 as ``L21Regularization(slices=2)`` and 2-D TV on each split
plane, per problem

    per inner iteration (× iterations_inner):
      β  = β_y + ρ₁(z₁ − u₁) + ρ₂(z₂ − u₂)
      x  = CG(AᴴA + (ρ₁+ρ₂)I, β, x₀ = x, cg_iterations, ‖r‖ ≤ tol_inner·‖β‖)
      z₁ = prox_L21(x + u₁, λ₁/ρ₁)             (x + u₁ where ρ₁ = 0)
      z₂ = FGP-TV per plane (x + u₂, λ₂/ρ₂)     (x + u₂ where ρ₂ = 0)
      uᵢ = uᵢ + x − zᵢ
    per outer iteration (× iterations), after the inner ones:
      β_y = β_y + Aᴴb − AᴴA x,  zᵢ = x,  uᵢ = 0

from x = 0, β_y = Aᴴb. The CG is ``pcg``'s masked form: a step of a
problem whose ‖r‖ is at or below its target takes α = 0 and keeps p (the
``pq == 0`` and ``rz == 0`` guards). Its sums (‖β‖², r·r, p·q, over both
planes) are taken in float64 and rounded once, in both versions. The TV
prox is the fold FGP (``_fgp_common.fgp_fold``), valid because λ₂/ρ₂ is
the same at every call; the JAX kernel runs it with ``fgp_unroll=True``.
Both versions return per-problem counts, (B,) int32: the CG steps that
were live, summed over the whole solve.

The kernel has three routes, picked by :func:`plan_splitbregman`:
**resident**, a thread-block cluster of c ≤ min(C, 16) CTAs per slice, CTA
k transforming coils k, k + c, … with the coil's whole padded spectrum in
its shared memory and the FFT's stages in registers (``csrc/fft_resident.cuh``),
each CTA owning a band of rows for the coil fold and the vector phases;
**split**, for shapes whose padded spectrum fits no CTA (192², 256 × 128,
256²), the same cluster kernel with each coil's spectrum split over a
team of CTAs (``csrc/sense_split.cuh``; the plan of
``sense_fused.coil_plan``); and **grid**, for shapes whose spectrum fits
no team of 16 (512², 1024²), a team of CTAs per slice that meet in L2
(``csrc/sense_grid.cuh``, the plan of ``sense_fused.plan_grid``): the
CG's sums taken over the team (each CTA's block sum to global memory, a
team barrier, the team's entries added in rank order and rounded once),
the vector phases on each CTA's band, and the fold FGP of both planes
swept band by band over the team with a team barrier between sweeps.

Not carried over: the TPU's 3-way bf16 DFT factors (``_dft_cat3``) and
the compensated seed built from them (:394-411): the seed here is the
operator's own adjoint (cuFFT); the VMEM gate ``_check_vmem_splitbregman``
and ``interpret=``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .._build import SMEM_MAX, SMS
from ..models.prox import L21Regularization, TVRegularization
from ..models.solvers.splitbregman import SplitBregman
from ..ops.base import IdentityOperator
from ..ops.dft_real import SenseDFT2RealOperator
from . import _dft_common, _fgp_common
from ._dft_common import (
    check_dft_cuda_input, check_fft_normal, seed_and_lam, twiddle_tensor,
)
from .sense_fused import (
    GRID_PHASES as SENSE_GRID_PHASES, THREADS, SensePlan, card_plan, cluster_limits,
    grid_scratch, group_threshold, plan_coils, sense_args, split_floats,
)
# the cluster size rule and the largest cluster, the same for both SENSE kernels
from .sense_fused import MAX_CLUSTER, cluster_size  # noqa: F401

__all__ = [
    "splitbregman_l1_tv_fused",
    "splitbregman_l1_tv_fused_torch",
    "plan_splitbregman",
    "plan_on_card",
    "phase_clocks",
    "check_splitbregman_l1_tv_fused",
    "solve_splitbregman_l1_tv_fused",
]


def splitbregman_l1_tv_fused_torch(x0hat, scal, t2tab, coils, tables, iterations,
                                   iterations_inner, cg_iterations, tol_inner):
    """Plain version: `x0hat` (B, 2, H, W) the split [re; im] Aᴴb, `scal`
    (B, 4) = [ρ₁, ρ₂, λ₁_eff, λ₂_eff], `t2tab` the fold-FGP constants (one
    row per dual iteration), `coils` (coils_r, coils_i), `tables` the
    ``dft_tables`` of the mask, `tol_inner` a Python float. Returns ``(x
    (B, 2, H, W), live CG steps (B,))`` in x0hat's dtype."""

    def col(v):
        return v.view(-1, 1, 1)

    rho1, rho2, lam1, lam2 = scal.unbind(1)
    rho_sum = col(rho1 + rho2)
    one = torch.ones_like(rho1)
    t1 = col(lam1 / torch.where(rho1 != 0, rho1, one))
    t2 = col(lam2 / torch.where(rho2 != 0, rho2, one)).unsqueeze(1)
    on1, on2 = col(rho1 != 0), col(rho2 != 0).unsqueeze(1)
    rho1, rho2 = col(rho1), col(rho2)
    x0r, x0i = x0hat[:, 0], x0hat[:, 1]

    def normal(vr, vi):
        return _dft_common.sense_normal(vr, vi, *coils, tables)

    def matvec(vr, vi):  # AᴴA + (ρ₁ + ρ₂)I
        nr, ni = normal(vr, vi)
        return nr + rho_sum * vr, ni + rho_sum * vi

    xr = xi = x0r * 0.0
    byr, byi = x0r, x0i
    live = torch.zeros(x0hat.shape[0], dtype=torch.int32, device=x0hat.device)
    for _ in range(iterations):
        zero = xr * 0.0
        z1r, z1i, u1r, u1i, z2r, z2i, u2r, u2i = xr, xi, zero, zero, xr, xi, zero, zero
        for _ in range(iterations_inner):
            br = byr + rho1 * (z1r - u1r) + rho2 * (z2r - u2r)
            bi = byi + rho1 * (z1i - u1i) + rho2 * (z2i - u2i)
            target = tol_inner * torch.sqrt(_dft_common.dsum_sq(br, bi))
            mr, mi = matvec(xr, xi)
            rr, ri = br - mr, bi - mi
            pr, pi = rr, ri
            rz = _dft_common.dsum_sq(rr, ri)
            for _ in range(cg_iterations):
                qr, qi = matvec(pr, pi)
                pq = _dft_common.dsum_dot(((pr, qr), (pi, qi)))
                active = torch.sqrt(rz) > target
                live += active.to(torch.int32)
                denom = torch.where(pq == 0, torch.ones_like(pq), pq)
                alpha = col(torch.where(active, rz / denom, torch.zeros_like(rz)))
                xr, xi = xr + alpha * pr, xi + alpha * pi
                rr, ri = rr - alpha * qr, ri - alpha * qi
                rz_new = _dft_common.dsum_sq(rr, ri)
                safe = torch.where(rz == 0, torch.ones_like(rz), rz)
                beta_c = col(torch.where(rz == 0, torch.zeros_like(rz), rz_new / safe))
                keep = col(active)
                pr = torch.where(keep, rr + beta_c * pr, pr)
                pi = torch.where(keep, ri + beta_c * pi, pi)
                rz = rz_new
            # z₁: the group threshold over (re, im); z₂: the fold FGP per plane
            ar, ai = xr + u1r, xi + u1i
            sr, si = group_threshold(ar, ai, t1)
            z1r, z1i = torch.where(on1, sr, ar), torch.where(on1, si, ai)
            u1r, u1i = u1r + xr - z1r, u1i + xi - z1i
            v = torch.stack([xr + u2r, xi + u2i], dim=1)
            z2 = torch.where(on2, _fgp_common.fgp_fold(v, t2, t2tab), v)
            z2r, z2i = z2.unbind(1)
            u2r, u2i = u2r + xr - z2r, u2i + xi - z2i
        nr, ni = normal(xr, xi)
        byr, byi = byr + x0r - nr, byi + x0i - ni
    return torch.stack([xr, xi], dim=1), live


def kernel_args(x0hat_b, rho1, rho2, lam1, lam2, tv_iterations, dtype=np.float32):
    """(scal (B, 4), t2tab) for the kernel and its plain version in `dtype`
    on x0hat's device; the four scalars are numbers or (B,)."""
    B = x0hat_b.shape[0]
    dev = x0hat_b.device
    tdt = torch.from_numpy(np.zeros((), dtype)).dtype
    scal = torch.stack([
        torch.broadcast_to(torch.as_tensor(v, dtype=tdt, device=dev).reshape(-1), (B,))
        for v in (rho1, rho2, lam1, lam2)
    ], dim=1)
    t2tab = torch.as_tensor(_fgp_common.fgp_t2_table(tv_iterations, dtype), device=dev)
    return scal, t2tab


# the phases of the cluster routes' timer (csrc/splitbregman_fused.cu kPhases)
PHASES = ("coil loads", "row ffts", "column ffts", "coil fold", "vector phases",
          "cluster sums", "fgp", "cluster barriers")
# the phases of the grid route's timer (csrc/splitbregman_fused.cu
# kGridPhases): csrc/sense_grid.cuh's, then its own
GRID_PHASES = SENSE_GRID_PHASES + ("vector phases", "team sums", "fgp")
# global scratch planes of (B, H, W) on the cluster routes: (re, im) of
# β_y, z₁, u₁, z₂, u₂, β | v, r, p, q and the coil sum between rounds, and
# the FGP's pv, ph, rv, rh, y for each plane. The grid route's planes of
# (H, W) a slot: the same with v apart from β (csrc/splitbregman_fused.cu
# kGridPlanes)
RESIDENT_SCRATCH, GRID_SCRATCH = 30, 32
# the grid CTA's own shared memory before the twiddles: the block sums (3 ×
# 32 float64) and the team's (4 float64) (csrc/splitbregman_fused.cu
# kGridHead)
GRID_HEAD = 8 * (3 * (THREADS // 32) + 4)


def _ceil4(n):
    return -(-n // 4) * 4


def resident_smem_bytes(H, W):
    """Shared memory of a resident CTA at H × W, as ``resident_smem_bytes``
    in csrc/splitbregman_fused.cu counts it: the block sums (3 × 32
    float64), the CTA's sums for the cluster (two slots) and the cluster's
    (4 float64 each), the phase timer (one int64 per phase), the twiddles
    (``twiddle_floats(H, W)`` f32: H + W at powers of two) and one coil's
    padded spectrum (H·(W + 1) f32 for re, as many for im), each f32 array
    rounded up to 4 floats."""
    return (8 * (3 * (THREADS // 32) + 12) + 8 * len(PHASES)
            + 4 * (_ceil4(_dft_common.twiddle_floats(H, W)) + 2 * _ceil4(H * (W + 1))))


def split_smem_bytes(H, W, team):
    """Shared memory of a split CTA at H × W on teams of `team` CTAs, as
    ``split_smem_bytes`` in csrc/splitbregman_fused.cu counts it: the sums,
    the phase timer and the twiddles as on the resident route, the band
    (⌈H/team⌉·W f32 for re, as many for im) and the column block
    (H·(⌈W/team⌉ + 1) f32 for re, as many for im), each f32 array rounded up
    to 4 floats."""
    return (8 * (3 * (THREADS // 32) + 12) + 8 * len(PHASES)
            + 4 * (_ceil4(_dft_common.twiddle_floats(H, W)) + 2 * split_floats(H, W, team)))


def cluster_smem_bytes(H, W, team):
    """A cluster CTA's shared memory: :func:`resident_smem_bytes` on team 1,
    :func:`split_smem_bytes` on larger teams."""
    return resident_smem_bytes(H, W) if team == 1 else split_smem_bytes(H, W, team)


@functools.lru_cache(maxsize=256)
def plan_splitbregman(B, H, W, C, resident, sms=SMS, smem_max=SMEM_MAX, split=None,
                      grid_ctas=None, grid=None) -> SensePlan:
    """The route of a fused SplitBregman launch of B slices of H × W with C
    coils (``sense_fused.plan_coils``, shared with the FISTA-L21-SENSE
    kernel): resident where a coil's padded spectrum and the rest of
    :func:`resident_smem_bytes` fit one CTA, on the cluster size of
    ``sense_fused.cluster_size``; else split on the smallest team whose CTA
    (:func:`split_smem_bytes`) fits; else grid (``sense_fused.plan_grid``
    with the CTA's sums, GRID_HEAD, and GRID_PHASES clocks); `split` forces
    a (team, coils a round), `grid` a (team, slots, coils a round). Raises
    ValueError naming the shape where it is empty or not the FFT's, and
    naming the plan where the card holds no cluster or team of it (no
    fallback)."""
    return plan_coils("splitbregman_l1_tv_fused", B, H, W, C, resident, sms, smem_max,
                      cluster_smem_bytes, (RESIDENT_SCRATCH, GRID_SCRATCH), split, grid_ctas,
                      grid, GRID_HEAD, len(GRID_PHASES))


def plan_limits(index, clusters, team, H, W):
    """``sense_fused.cluster_limits`` of the SplitBregman cluster kernel on
    teams of `team`: (shared memory per CTA as the kernel counts it,
    clusters that device `index` holds at once)."""
    return cluster_limits("splitbregman_cluster_occupancy", index, clusters, team, H, W)


def resident_limits(index, clusters, H, W):
    """:func:`plan_limits` of the resident SplitBregman kernel."""
    return plan_limits(index, clusters, 1, H, W)


def plan_on_card(x0hat, C, split=None, grid=None):
    """The plan of a launch on x0hat's card ((B, 2, H, W), C coils; `split`
    a forced (team, coils a round), `grid` a forced (team, slots, coils a
    round)), with the card's residency of its cluster size or grid CTAs.
    Raises ValueError where the plan has no cluster or team the card can
    hold."""
    return card_plan("splitbregman_l1_tv_fused", x0hat, C, plan_splitbregman,
                     cluster_smem_bytes, plan_limits, "splitbregman_grid_occupancy", GRID_HEAD,
                     len(GRID_PHASES), split, grid)


def _launch(x0hat, scal, t2tab, coils, tables, iterations, iterations_inner, cg_iterations,
            tol_inner, prof=None, split=None, grid=None):
    B, _, H, W = x0hat.shape
    C = coils[0].shape[0]
    plan = plan_on_card(x0hat, C, split, grid)
    lib = _build.load_library()
    dev = x0hat.device
    tw = twiddle_tensor(tables)
    wt = tables[2].T.contiguous()  # read along a spectrum column
    out = torch.empty_like(x0hat)
    counts = torch.empty((B,), dtype=torch.int32, device=dev)
    sched = (B, H, W, C, iterations, iterations_inner, cg_iterations, t2tab.shape[0],
             float(tol_inner))
    prof_ptr = None if prof is None else prof.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route != "grid":
            scratch = torch.empty((plan.scratch, B, H, W), dtype=torch.float32, device=dev)
            code = lib.splitbregman_cluster_launch(
                x0hat.data_ptr(), scal.data_ptr(), t2tab.data_ptr(), tw.data_ptr(),
                wt.data_ptr(), coils[0].data_ptr(), coils[1].data_ptr(), out.data_ptr(),
                scratch.data_ptr(), counts.data_ptr(), prof_ptr, *sched, plan.clusters,
                plan.team, plan.smem, stream)
        else:
            # each slot's spectra (complex, interleaved), then its planes,
            # then the team's sums (slots × 2 × team × 4 float64); the teams'
            # barrier counters
            sums = plan.slots * 2 * plan.team * 4 * 2
            scratch = torch.empty(grid_scratch(plan, H, W, GRID_SCRATCH, sums),
                                  dtype=torch.float32, device=dev)
            bar = torch.zeros(plan.slots, dtype=torch.int32, device=dev)
            code = lib.splitbregman_grid_launch(
                x0hat.data_ptr(), scal.data_ptr(), t2tab.data_ptr(), tw.data_ptr(),
                wt.data_ptr(), coils[0].data_ptr(), coils[1].data_ptr(), out.data_ptr(),
                scratch.data_ptr(), bar.data_ptr(), counts.data_ptr(), prof_ptr, *sched,
                plan.team, plan.slots, plan.per_round, plan.row_lines, plan.col_lines,
                plan.smem, stream)
    _build.check(code, f"splitbregman_l1_tv_fused ({B} x {H}x{W}, {C} coils, {plan})")
    splitbregman_l1_tv_fused.launches += 1
    splitbregman_l1_tv_fused.route_launches[plan.route] += 1
    return out, counts


def phase_clocks(x0hat_b, mask, coils_r, coils_i, rho1, rho2, lam1, lam2, iterations: int,
                 iterations_inner: int, cg_iterations: int, tv_iterations: int,
                 tol_inner: float, split=None, grid=None):
    """One launch of the kernel with its phase timer on: {phase: SM clocks
    that CTA 0 spent in it over the whole solve} (``PHASES`` on the cluster
    routes, ``GRID_PHASES`` on the grid route; the launch counts in
    ``splitbregman_l1_tv_fused.launches``), on the plan's route or the
    forced `split` / `grid`."""
    scal, t2tab = kernel_args(x0hat_b, rho1, rho2, lam1, lam2, tv_iterations)
    coils, tables = sense_args(x0hat_b, (coils_r, coils_i), mask)
    check_dft_cuda_input("splitbregman_l1_tv_fused", x0hat_b, mask, *coils)
    x0hat_b = x0hat_b.contiguous()
    plan = plan_on_card(x0hat_b, coils[0].shape[0], split, grid)
    phases = GRID_PHASES if plan.route == "grid" else PHASES
    prof = torch.zeros(len(phases), dtype=torch.int64, device=x0hat_b.device)
    _launch(x0hat_b, scal, t2tab, coils, tables, iterations, iterations_inner, cg_iterations,
            tol_inner, prof, split, grid)
    return dict(zip(phases, prof.tolist()))


def splitbregman_l1_tv_fused(
    x0hat_b, mask, coils_r, coils_i, rho1, rho2, lam1, lam2, iterations: int,
    iterations_inner: int, cg_iterations: int, tv_iterations: int, tol_inner: float,
    with_counts=False, split=None, grid=None,
):
    """Batched SplitBregman L21 + TV on C-coil SENSE in one launch, on the
    route of :func:`plan_splitbregman` (a cluster of CTAs per slice, one
    coil's spectrum in each CTA's shared memory or split over a team of
    CTAs, or a team of CTAs per slice that meet in L2).

    x0hat_b: (B, 2, H, W) split [re; im] Aᴴb; mask (H, W); coils_r,
    coils_i (C, H, W); rho1, rho2 the L21 and TV terms' ρ, lam1, lam2
    their λ (scalars or (B,), already normalization-scaled); `split`: a
    forced cluster plan (team, coils a round), `grid`: a forced grid plan
    (team, slots, coils a round), for measuring. The plain version runs
    for a CPU tensor, the CUDA kernel (float32) for a CUDA tensor.
    ``splitbregman_l1_tv_fused.launches`` counts the kernel's launches, and
    ``splitbregman_l1_tv_fused.route_launches`` the launches by route.
    Returns x, or ``(x, counts)`` with `with_counts`: the live CG steps per
    problem."""
    np_dt = torch.empty((), dtype=x0hat_b.dtype).numpy().dtype
    scal, t2tab = kernel_args(x0hat_b, rho1, rho2, lam1, lam2, tv_iterations, np_dt)
    coils, tables = sense_args(x0hat_b, (coils_r, coils_i), mask)
    args = (iterations, iterations_inner, cg_iterations, float(tol_inner))
    if x0hat_b.device.type == "cpu":
        out = splitbregman_l1_tv_fused_torch(x0hat_b, scal, t2tab, coils, tables, *args)
    else:
        check_dft_cuda_input("splitbregman_l1_tv_fused", x0hat_b, mask, *coils)
        out = _launch(x0hat_b.contiguous(), scal, t2tab, coils, tables, *args, split=split,
                      grid=grid)
    return out if with_counts else out[0]


splitbregman_l1_tv_fused.launches = 0
splitbregman_l1_tv_fused.route_launches = {"resident": 0, "split": 0, "grid": 0}


def _term_order(solver):
    """Return (i_l21, i_tv) indices of the L21 and TV terms."""
    if len(solver.reg) != 2:
        raise ValueError("fused path requires exactly two reg terms (L21 + TV)")
    first, second = solver.reg
    if isinstance(first, L21Regularization) and isinstance(second, TVRegularization):
        return 0, 1
    if isinstance(first, TVRegularization) and isinstance(second, L21Regularization):
        return 1, 0
    raise ValueError("fused path requires one L21Regularization and one TVRegularization")


def check_splitbregman_l1_tv_fused(solver):
    """Validate `solver` for the fused SplitBregman path (raises ValueError
    naming the first unsupported piece)."""
    if not isinstance(solver, SplitBregman):
        raise ValueError("fused path requires a SplitBregman solver")
    op = check_fft_normal(solver, SenseDFT2RealOperator)
    i_l21, i_tv = _term_order(solver)
    if solver.reg[i_l21].slices != 2:
        raise ValueError(
            "fused path requires L21Regularization(slices=2) — the split-real form of complex L1"
        )
    tv = solver.reg[i_tv]
    H, W = op.im_shape
    dims = (tv.dims,) if isinstance(tv.dims, int) else tuple(tv.dims)
    if tv.shape != (2, H, W) or tuple(sorted(dims)) != (1, 2):
        raise ValueError(
            "fused path requires TV over shape (2, H, W) with dims (1, 2) — per-plane 2-D TV "
            "on the split representation"
        )
    if not all(isinstance(t, IdentityOperator) for t in solver.reg_trafo):
        raise ValueError("fused path requires identity reg_trafos")
    if solver.proj:
        raise ValueError("fused path does not support projection terms")
    if solver.precon is not None:
        raise ValueError("fused path does not support a preconditioner")
    if solver.abs_tol is not None or solver.rel_tol is not None:
        raise ValueError(
            "fused path runs the fixed inner/outer schedule; abs_tol/rel_tol early outer "
            "updates are not supported"
        )


def solve_splitbregman_l1_tv_fused(solver, B_mat):
    """Drop-in fast path for `solve_batched_unrolled(solver, B)` when the
    solver is SplitBregman + SenseDFT2RealOperator + (L21(slices=2) + TV)
    with identity trafos (BASELINE configuration #4's shape). Returns the
    n×K solution matrix ([re; im] rows)."""
    check_splitbregman_l1_tv_fused(solver)
    op = solver.A
    i_l21, i_tv = _term_order(solver)
    H, W = op.im_shape
    x0, lam1, lam2 = seed_and_lam(solver, B_mat, solver.reg[i_l21], solver.reg[i_tv])
    out = splitbregman_l1_tv_fused(
        x0.reshape(-1, 2, H, W), op.mask, op.coils_r, op.coils_i, solver.rho0[i_l21],
        solver.rho0[i_tv], lam1, lam2, solver.iterations, solver.iterations_inner,
        solver.iterations_cg, solver.reg[i_tv].iterations_tv, solver.tol_inner,
    )
    return out.reshape(out.shape[0], 2 * H * W).T
