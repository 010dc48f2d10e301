"""The whole batched PGM-TV solve as ONE launch: the hand-written CUDA
kernel ``csrc/fista_tv_fused.cu`` and its plain PyTorch version.

Counterpart of ``rls_tpu/kernels/fista_tv_fused.py``: ``_momentum_table``
(:43-103), ``fista_tv_fused`` (:676) with its loops ``_pgm_loop``
(:375-416), ``_fista_loop_dynamic`` (:247-291, scalars :187),
``_pogm_loop_dynamic`` (:294-372, coefficients :215, restart decision
:238) and ``_fista_loop_warm`` (:419-457), ``check_pgm_tv_fused``
(:893-976) and ``solve_pgm_tv_fused`` (:1069-1212).

Methods and schedules, all in one launch, on one of two routes that
:func:`plan_pgm_tv` picks by shape (``csrc/fista_tv_fused.cu``):

* resident: each problem on a thread-block cluster of c CTAs (c in 1, 2,
  4, 8, 16), one band of image rows per CTA, the six planes read at
  neighbouring pixels in shared memory for the whole solve, rows of
  another band read through distributed shared memory;
* global: one CTA per problem with its planes in global scratch, for
  images whose single row is too wide for a band (about W > 9,600).

The resident kernel's body (``csrc/pgm_tv_cluster.cuh``) also runs with
three planes of a band in shared memory and the rest in global memory:
the "cluster" route of the row-tiled solve
(``fista_tv_tiled.plan_fista_tv_tiled``), for images whose bands fit no
cluster with six (512²). ``solve_batched_fast`` sends an image here where
six planes fit (:func:`check_six_planes`: up to 384² on an H100), else to
the row-tiled solve.

The schedules:

* fixed (``restart="none"``, no early exit): FISTA, OptISTA and POGM
  driven by the f64 momentum table, one row per iteration;
* dynamic: FISTA with ``restart="gradient"`` / ``"gradient_mapping"``
  and POGM with ``restart="gradient"`` (σ ← σ·sigma_fac), with their f32
  θ/σ/γ recurrences in the kernel, and the early-exit freeze mask
  (``rel_tol``) of FISTA and POGM;
* warm (FISTA, fixed schedule): the TV duals carried across iterations.

Every schedule runs the fold FGP (``_fgp_common.fgp_fold``); the JAX
dynamic and warm loops default to its fori form, the same f32 math up to
≤ 1 ulp. The Gram is the exact stencil route (four zero-padded passes,
``make_sepconv_stencil_ops``). The JAX kernel's ``_kernel_grouped`` and
``_kernel_interleaved`` compute the same function as ``_kernel`` and have
no counterpart: ``interleave`` is accepted where the JAX function accepts
it and runs this kernel.

Both versions also return per-problem counts, (B, 2) int32: the
iterations in which the restart test fired (while live), and the
iterations that were live (not frozen by early exit).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .._build import SMEM_MAX, SMS
from ..models.prox import TVRegularization
from ..models.regularization import normalization_factor
from ..models.solvers.base import theta_next
from ..models.solvers.fista import FISTA
from ..models.solvers.optista import OptISTA
from ..models.solvers.pogm import POGM
from ..ops.base import NormalOperator
from ..ops.conv_direct import SeparableConvOperator
from . import _fgp_common
from ._bands import HALO, MIN_CTA_PIXELS, BandPlan, band_sizes, cdiv
from ._tables import shared_table

__all__ = [
    "fista_tv_fused",
    "fista_tv_fused_torch",
    "plan_pgm_tv",
    "PgmTvPlan",
    "phase_clocks",
    "check_pgm_tv_fused",
    "solve_pgm_tv_fused",
    "solve_fista_tv_fused",
]

# tap counts the kernels' shared-memory tap buffer holds per axis
MAX_TAPS = 63
METHODS = ("fista", "optista", "pogm")
RESTARTS = ("none", "gradient", "gradient_mapping")
# solver class → momentum-table method
_METHOD_OF = ((FISTA, "fista"), (OptISTA, "optista"), (POGM, "pogm"))


def _momentum_table(method: str, iterations: int, theta0: float = 1.0, dtype=np.float32):
    """Per-iteration momentum scalars, computed in f64 on the host and
    rounded to `dtype` (``rls_tpu/kernels/fista_tv_fused.py:43-103``):
    col 0 α (inertia), col 1 β, col 2 γ (prox/gradient scale on ρ, 1 for
    FISTA), col 3 extra (OptISTA 1/γ; POGM α/γ_old, the z coupling)."""
    tab = np.zeros((iterations, 4), np.float64)
    if method == "fista":
        th_old = th = float(theta0)
        for i in range(iterations):
            tab[i, 0] = (th_old - 1.0) / th
            tab[i, 2] = 1.0
            th_old, th = th, (1.0 + np.sqrt(1.0 + 4.0 * th * th)) / 2.0
    elif method == "optista":
        # θ_N: N−1 standard steps, then the 8θ² variant (OptISTA.jl:145-149)
        tn = float(theta0)
        for _ in range(iterations - 1):
            tn = (1.0 + np.sqrt(1.0 + 4.0 * tn * tn)) / 2.0
        tn = (1.0 + np.sqrt(1.0 + 8.0 * tn * tn)) / 2.0
        th = float(theta0)
        for i in range(iterations):
            gamma = 2.0 * th / tn**2 * (tn**2 - 2.0 * th**2 + th)
            th_old = th
            c = 8.0 if i == iterations - 1 else 4.0
            th = (1.0 + np.sqrt(1.0 + c * th_old**2)) / 2.0
            tab[i] = ((th_old - 1.0) / th, th_old / th, gamma, 1.0 / gamma)
    elif method == "pogm":
        th = float(theta0)
        gamma_over_rho_old = None  # γ₋₁ = 1 is ρ-dependent, but α₀ = 0
        for i in range(iterations):
            th_old = th
            th = (1.0 + np.sqrt(1.0 + 4.0 * th_old**2)) / 2.0
            alpha = (th_old - 1.0) / th
            gamma_over_rho = (2.0 * th_old + th - 1.0) / th
            tab[i] = (
                alpha,
                th_old / th,  # β with σ = 1 (no restart)
                gamma_over_rho,
                0.0 if gamma_over_rho_old is None else alpha / gamma_over_rho_old,
            )
            gamma_over_rho_old = gamma_over_rho
    else:
        raise ValueError(f"unknown method {method!r}")
    return tab.astype(dtype)


def fista_tv_fused_torch(
    x0hat, scal, tab, t2tab, taps, method="fista", restart="none",
    rel_tol=None, sigma_fac=1.0, warm_tv=False,
):
    """Plain version: `x0hat` (B, H, W), `scal` (B, 2) = [ρ, λ_eff], `tab`
    the momentum table (one row per iteration, read by the fixed
    schedules), `t2tab` the fold-FGP constants (one row per dual
    iteration). Returns ``(x, counts)``; the dtype is x0hat's."""
    taps_h, taps_w = taps
    B = x0hat.shape[0]
    iterations = tab.shape[0]
    early = rel_tol is not None
    dynamic = restart != "none" or early
    rho, lam = scal[:, 0], scal[:, 1]

    def col(v):
        return v.view(-1, 1, 1)

    def normal(u):
        return _fgp_common.sepconv_stencil_normal(u, taps_h, taps_w)

    duals = None
    if warm_tv:
        duals = (x0hat * 0.0, x0hat * 0.0)

    def prox(xg, lam_tv):
        nonlocal duals
        if warm_tv:
            out, duals = _fgp_common.fgp_fold_warm(xg, col(lam_tv), t2tab, duals)
            return out
        return _fgp_common.fgp_fold(xg, col(lam_tv), t2tab)

    def vsum(u):
        return u.sum(dim=(1, 2))

    x = m1 = m2 = w = x0hat * 0.0  # (x, x_prev) or (x, y, z) and POGM's w
    one = torch.ones_like(rho)
    th_in = th_old = sig = gam_old = one
    done = torch.zeros_like(rho)
    fires = torch.zeros(B, dtype=torch.int32, device=x0hat.device)
    live_iters = torch.zeros_like(fires)
    if early:
        norm_x0 = torch.sqrt(vsum(x0hat * x0hat))
    for i in range(iterations):
        live = 1.0 - done
        live_iters += (live > 0).to(torch.int32)
        if method == "fista":
            a = (th_old - 1.0) / th_in if dynamic else tab[i, 0]
            x_mom = x + col(a) * (x - m1)
            res = normal(x_mom) - x0hat
            x_new = prox(x_mom - col(rho) * res, rho * lam)
            if not dynamic:
                x, m1 = x_new, x
                continue
            th = th_in
            if restart != "none":
                if restart == "gradient_mapping":
                    dot = vsum((x_mom - x_new) * (x_new - x))
                else:
                    dot = vsum(res * (x_new - x))
                fire = dot > 0.0
                fires += (fire & (live > 0)).to(torch.int32)
                th = torch.where(fire, one, th)
            th_old_new, th_new = th, theta_next(th)
            if early:
                rel = torch.sqrt(vsum(res * res)) / norm_x0
                done = torch.maximum(done, (rel < rel_tol).to(done.dtype))
                th_old_new = th_old + live * (th_old_new - th_old)
                th_new = th_in + live * (th_new - th_in)
                x, m1 = x + col(live) * (x_new - x), m1 + col(live) * (x - m1)
            else:
                x, m1 = x_new, x
            th_in, th_old = th_new, th_old_new
            continue

        res = normal(x) - x0hat
        if method == "optista":
            a, bcoef, g, e = tab[i]
            c = rho * g
            y_new = prox(m1 - col(c) * res, c * lam)
            z_new = x + (y_new - m1) * e
            x, m1, m2 = (1.0 + a + bcoef) * z_new - a * m2 - bcoef * x, y_new, z_new
            continue

        # POGM; m1, m2 = y, z
        y_new = x - col(rho) * res
        if dynamic:
            th = theta_next(th_in, 8.0 if restart != "none" and i == iterations - 1 else 4.0)
            a = (th_in - 1.0) / th
            bcoef = sig * th_in / th
            if restart != "none":
                gam = rho * (1.0 + a + bcoef)
            else:
                gam = rho * (2.0 * th_in + th - 1.0) / th
            e = rho * a / gam_old
            lam_tv = gam * lam
        else:
            a, bcoef, g, e = tab[i]
            lam_tv = rho * g * lam
        x_mid = (
            col(1.0 + a + bcoef) * y_new - col(a) * m1 - col(bcoef + e) * x + col(e) * m2
        )
        x_new = prox(x_mid, lam_tv)
        if not dynamic:
            x, m1, m2 = x_new, y_new, x_mid
            continue
        w_new, sig_new = w, sig
        if restart != "none":
            r = rho / gam
            w_mid = w + y_new + col(r) * (x_new - x_mid)
            c1 = vsum(w_mid * (x_new - x_mid))
            c2 = vsum(w_mid * res)
            fire = (c1 / gam - c2) < 0.0
            fires += (fire & (live > 0)).to(torch.int32)
            sig_new = torch.where(fire, one, sig * sigma_fac)
            th = torch.where(fire, one, th)
            w_new = col(r) * (x_mid - x_new) - y_new
        if early:
            rel = torch.sqrt(vsum(res * res)) / norm_x0
            done = torch.maximum(done, (rel < rel_tol).to(done.dtype))
            lv = col(live)
            x_new = x + lv * (x_new - x)
            y_new = m1 + lv * (y_new - m1)
            x_mid = m2 + lv * (x_mid - m2)
            w_new = w + lv * (w_new - w)
            th = th_in + live * (th - th_in)
            sig_new = sig + live * (sig_new - sig)
            gam = gam_old + live * (gam - gam_old)
        x, m1, m2, w = x_new, y_new, x_mid, w_new
        th_in, sig, gam_old = th, sig_new, gam
    return x, torch.stack([fires, live_iters], dim=1)


def _codes(method, restart, rel_tol, warm_tv):
    """The kernels' integer schedule codes."""
    return (
        METHODS.index(method), RESTARTS.index(restart), int(rel_tol is not None),
        int(warm_tv),
    )


# the kernels' threads per CTA, the resident route's largest cluster and
# its planes of a band in shared memory: all six, or three (the row-tiled
# solve's cluster route) (csrc/pgm_tv_cluster.cuh); the farthest row a
# stencil tap reads is the band code's HALO
THREADS, MAX_CLUSTER = 1024, 16
ALL_PLANES, SHARED_PLANES = 6, 3
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# the phases of the resident route's timer (csrc/pgm_tv_cluster.cuh kPhases)
PHASES = ("set-up", "momentum", "gram", "fgp sweeps", "cluster barriers",
          "prox and carries", "sums")
# global scratch planes of (B, H, W): the resident route's carries and
# own-pixel temporaries (x_prev | y, z, w, res, y_new, x_mom), and with
# three planes in shared memory also t3, xg, pv and ph; the global route's
# carries and window planes
RESIDENT_SCRATCH, THREE_PLANE_SCRATCH, GLOBAL_SCRATCH = 6, 10, 12
# the global route's static shared memory: the taps and the block sums
GLOBAL_SMEM = 4 * 2 * MAX_TAPS + 8 * 3 * (THREADS // 32)


def cluster_smem_bytes(rows, W, own_shared=True):
    """Shared memory of a resident CTA whose band has `rows` rows of width
    W, as ``cluster_smem_bytes`` in csrc/pgm_tv_cluster.cuh counts it: six
    planes (three where not `own_shared`; each rounded up to 4 floats),
    the block sums (3 × 32 float64), the CTA's and the cluster's sums (4
    float64 each), the phase timer, the DSMEM row table (rows + 2·HALO
    pointers) and the taps (2 × MAX_TAPS f32)."""
    planes = ALL_PLANES if own_shared else SHARED_PLANES
    return (4 * planes * cdiv(rows * W, 4) * 4 + 8 * (3 * (THREADS // 32) + 8)
            + 8 * len(PHASES) + 8 * (rows + 2 * HALO) + 4 * 2 * MAX_TAPS)


@dataclasses.dataclass(frozen=True)
class PgmTvPlan(BandPlan):
    """How a fused PGM-TV launch runs: a ``BandPlan`` (route, cluster size,
    rows per band, CTAs and shared memory per CTA) and `scratch` planes of
    (B, H, W) in global memory."""

    scratch: int


def fitting_sizes(H, W, sms=SMS, smem_max=SMEM_MAX):
    """The cluster sizes of ``CLUSTER_SIZES`` whose bands of ⌈H/c⌉ rows fit
    one CTA's shared memory with no band empty and c ≤ sms."""
    return band_sizes(H, W, CLUSTER_SIZES, cluster_smem_bytes, sms, smem_max)


@functools.lru_cache(maxsize=256)
def plan_pgm_tv(B, H, W, kh, kw, schedule, resident, sms=SMS,
                smem_max=SMEM_MAX) -> PgmTvPlan:
    """The route of a fused PGM-TV launch of B problems of H × W with kh ×
    kw taps and `schedule` = (method, restart, early exit, warm duals), on
    a card of `sms` SMs and `smem_max` bytes of shared memory per block
    that holds n clusters of c CTAs of this shape at once for each pair
    (c, n) of `resident` (``cudaOccupancyMaxActiveClusters``; a size not
    named is held 0 times).

    The rule: the smallest cluster size c of :func:`fitting_sizes` is
    resident; c is then raised to a larger fitting size while the card
    holds all B clusters of it at once and each CTA keeps at least
    ``MIN_CTA_PIXELS`` pixels, so that a small batch lights more SMs in one
    wave. An image whose bands fit at no c (a row wider than ~9,600
    pixels) takes the global route. A shape with neither (empty, or a
    problem of 2³¹ pixels or more) raises ValueError naming it."""
    method, restart, early, warm = schedule
    check_schedule(method, restart, 0.0 if early else None, warm)
    if min(B, H, W) < 1:
        raise ValueError(f"fista_tv_fused: empty shape {B} x {H}x{W}")
    if not (1 <= kh <= MAX_TAPS and 1 <= kw <= MAX_TAPS):
        raise ValueError(f"fista_tv_fused: {kh} x {kw} taps; at most {MAX_TAPS} per axis")
    fit = fitting_sizes(H, W, sms, smem_max)
    if fit:
        held = dict(resident)
        c = fit[0]
        for bigger in fit[1:]:
            if B > held.get(bigger, 0) or cdiv(H, bigger) * W < MIN_CTA_PIXELS:
                break
            c = bigger
        rows = cdiv(H, c)
        return PgmTvPlan("resident", c, rows, H, B * c, cluster_smem_bytes(rows, W),
                         RESIDENT_SCRATCH)
    if H * W >= 2**31:
        raise ValueError(
            f"fista_tv_fused: no route for {B} x {H}x{W}: bands fit no cluster of "
            f"{CLUSTER_SIZES} CTAs with {smem_max} bytes of shared memory each, and one "
            "CTA per problem indexes fewer than 2**31 pixels"
        )
    return PgmTvPlan("global", 1, H, H, B, GLOBAL_SMEM, GLOBAL_SCRATCH)


@functools.lru_cache(maxsize=None)
def resident_limits(index, clusters, rows, W, method, dynamic, own_shared=True):
    """(shared memory per CTA as the kernel counts it, clusters of the
    resident kernel for (method, dynamic) with six planes of a band in
    shared memory, or three, that device `index` holds at once:
    ``cudaOccupancyMaxActiveClusters``)."""
    from .. import _build

    name = "fista_tv_cluster_occupancy" if own_shared else "fista_tv_tiled_cluster_occupancy"
    out = (ctypes.c_longlong * 2)()
    with torch.cuda.device(index):
        _build.check(getattr(_build.load_library(), name)(
            clusters, rows, W, METHODS.index(method), int(dynamic), out), name)
    return out[0], out[1]


def plan_on_card(x0hat, taps, method="fista", restart="none", rel_tol=None, warm_tv=False):
    """(plan, clusters resident at once) of a launch on x0hat's card; the
    count is None on the global route. Raises ValueError where the resident
    plan has no cluster the card can hold (no fallback)."""
    from .. import _build

    B, H, W = x0hat.shape
    index = x0hat.device.index or 0
    schedule = (method, restart, rel_tol is not None, warm_tv)
    dynamic = restart != "none" or rel_tol is not None
    limits = _build.device_limits(index)
    held = {c: resident_limits(index, c, cdiv(H, c), W, method, dynamic)
            for c in fitting_sizes(H, W, *limits)}
    plan = plan_pgm_tv(B, H, W, *(len(t) for t in taps), schedule,
                       tuple((c, n) for c, (_, n) in held.items()), *limits)
    if plan.route == "global":
        return plan, None
    smem, active = held[plan.clusters]
    if smem != plan.smem:
        raise RuntimeError(f"fista_tv_fused: the kernel counts {smem} bytes of shared "
                           f"memory for {plan}")
    if active < 1:
        raise ValueError(f"fista_tv_fused: the card holds no cluster of {plan}")
    return plan, active


def launch_plan(plan, x0hat, scal, tab, t2tab, taps, method, restart, rel_tol, sigma_fac,
                warm_tv, prof=None):
    """One launch of the kernel on `plan`: the resident route with
    ``plan.clusters`` CTAs per problem, bands of ``plan.rows`` rows, six
    planes of a band in shared memory where ``plan.own`` is "shared" (or
    the plan has no `own`), else three, and ``plan.scratch`` global planes;
    else the global route. `x0hat` (B, H, W) float32 contiguous on a CUDA
    device. Returns ``(x, counts)``; raises on a refused launch."""
    from .. import _build

    B, H, W = x0hat.shape
    taps_h, taps_w = taps
    lib = _build.load_library()
    dev = x0hat.device
    taps_t = torch.tensor(list(taps_h) + list(taps_w), dtype=torch.float32, device=dev)
    out = torch.empty_like(x0hat)
    counts = torch.empty((B, 2), dtype=torch.int32, device=dev)
    scratch = torch.empty((plan.scratch, B, H, W), dtype=torch.float32, device=dev)
    args = (x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), t2tab.data_ptr(),
            taps_t.data_ptr(), len(taps_h), len(taps_w), out.data_ptr(), scratch.data_ptr(),
            counts.data_ptr())
    sched = (B, H, W, tab.shape[0], t2tab.shape[0], *_codes(method, restart, rel_tol, warm_tv),
             float(rel_tol or 0.0), float(sigma_fac))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "global":
            code = lib.fista_tv_fused_launch(*args, *sched, stream)
        else:
            # six planes: row 2's entry (fista_tv_fused.cu); three: row 3's
            # (fista_tv_tiled.cu); one kernel body (pgm_tv_cluster.cuh)
            launch = (lib.fista_tv_cluster_launch if getattr(plan, "own", "shared") == "shared"
                      else lib.fista_tv_tiled_cluster_launch)
            code = launch(*args, None if prof is None else prof.data_ptr(), *sched,
                          plan.clusters, plan.rows, plan.smem, stream)
    _build.check(code, f"PGM-TV kernel ({B} x {H}x{W}, {plan})")
    return out, counts


def _launch(x0hat, scal, tab, t2tab, taps, method, restart, rel_tol, sigma_fac, warm_tv,
            prof=None):
    plan, _ = plan_on_card(x0hat, taps, method, restart, rel_tol, warm_tv)
    if prof is not None and plan.route != "resident":
        raise ValueError(f"fista_tv_fused: the phase timer is on the resident route, not {plan}")
    out = launch_plan(plan, x0hat, scal, tab, t2tab, taps, method, restart, rel_tol, sigma_fac,
                      warm_tv, prof)
    fista_tv_fused.launches += 1
    fista_tv_fused.route_launches[plan.route] += 1
    return out


def phase_clocks(x0hat_b, taps, rho, lam, iterations: int, tv_iterations: int,
                 method="fista", restart="none", rel_tol=None, sigma_fac=1.0, warm_tv=False):
    """One launch of the resident kernel with its phase timer on: {phase:
    SM clocks that CTA 0 spent in it over the whole solve} (``PHASES``; the
    launch counts in ``fista_tv_fused.launches``). Raises on the global
    route."""
    check_schedule(method, restart, rel_tol, warm_tv)
    check_cuda_input("fista_tv_fused", x0hat_b, taps)
    scal, tab, t2tab = kernel_args(x0hat_b, rho, lam, method, iterations, tv_iterations)
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=x0hat_b.device)
    _launch(x0hat_b.contiguous(), scal, tab, t2tab, taps, method, restart, rel_tol, sigma_fac,
            warm_tv, prof)
    return dict(zip(PHASES, prof.tolist()))


def check_schedule(method, restart, rel_tol, warm_tv):
    """The method/schedule combinations the PGM-TV kernels take, with the
    JAX function's rejections (``fista_tv_fused.py:760-777``)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if restart not in RESTARTS:
        raise ValueError(f"unknown restart mode {restart!r}")
    dynamic = restart != "none" or rel_tol is not None
    if dynamic and method not in ("fista", "pogm"):
        raise ValueError("restart/early-exit are FISTA/POGM-only in the fused path")
    if restart == "gradient_mapping" and method != "fista":
        raise ValueError("gradient_mapping restart is a FISTA mode; use the composed path")
    if warm_tv and method != "fista":
        raise ValueError(
            "warm_tv carries λ-scaled duals across iterations, which needs "
            "a constant prox scale — FISTA only (OptISTA/POGM scale by γ_i)"
        )
    if warm_tv and dynamic:
        raise ValueError(
            "warm_tv is not implemented for the dynamic (restart/early-exit) schedules"
        )


def problem_scalars(x0hat_b, rho, lam, dtype=np.float32):
    """(B, 2) [ρ, λ] per problem in `dtype` on x0hat's device; `rho` and
    `lam` are scalars or (B,)."""
    B = x0hat_b.shape[0]
    dev = x0hat_b.device
    tdt = torch.from_numpy(np.zeros((), dtype)).dtype

    def per_problem(v):
        if isinstance(v, (int, float)):  # filled on the device: no host-to-device copy
            return torch.full((B,), v, dtype=tdt, device=dev)
        return torch.broadcast_to(torch.as_tensor(v, dtype=tdt, device=dev).reshape(-1), (B,))

    return torch.stack([per_problem(rho), per_problem(lam)], dim=1)


def momentum_tensor(method, iterations, dtype, device):
    """``_momentum_table(method, iterations)`` in `dtype` on `device`,
    shared by every call (``shared_table``: read only)."""
    return shared_table(_momentum_table, method, iterations, 1.0, dtype, device=device)


def kernel_args(x0hat_b, rho, lam, method, iterations, tv_iterations, dtype=np.float32):
    """(scal, tab, t2tab) for the kernels and their plain versions: ρ and λ
    per problem, the momentum table and the fold-FGP constants, in
    `dtype` on x0hat's device (the two tables shared, read only)."""
    dev = x0hat_b.device
    scal = problem_scalars(x0hat_b, rho, lam, dtype)
    tab = momentum_tensor(method, iterations, dtype, dev)
    t2tab = shared_table(_fgp_common.fgp_t2_table, tv_iterations, dtype, device=dev)
    return scal, tab, t2tab


def check_cuda_input(name, x0hat_b, taps):
    """What a CUDA kernel of this family takes; raises otherwise."""
    if x0hat_b.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x0hat_b.device}")
    if x0hat_b.dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA kernel takes float32, got {x0hat_b.dtype}")
    if max(len(t) for t in taps) > MAX_TAPS:
        raise ValueError(f"{name}: at most {MAX_TAPS} taps per axis")


def fista_tv_fused(
    x0hat_b, taps, rho, lam, iterations: int, tv_iterations: int, method="fista",
    restart="none", rel_tol=None, sigma_fac=1.0, warm_tv=False, with_counts=False,
):
    """Batched PGM-TV on a separable conv in one launch, on the route of
    :func:`plan_pgm_tv` (a cluster of CTAs per problem with its planes in
    shared memory, or one CTA per problem on global scratch).

    x0hat_b: (B, H, W) float32, Aᴴb per problem; taps: (taps_h, taps_w);
    rho, lam: scalars or (B,) (λ already normalization-scaled); method
    "fista" | "optista" | "pogm"; restart "none" | "gradient" |
    "gradient_mapping"; rel_tol: the early-exit tolerance (None: off);
    warm_tv: carry the TV duals (FISTA, fixed schedule). The plain version
    runs for a CPU tensor, the CUDA kernel for a CUDA tensor.
    ``fista_tv_fused.launches`` counts the kernel's launches, and
    ``fista_tv_fused.route_launches`` the launches by route. Returns x, or
    ``(x, counts)`` with `with_counts`.
    """
    check_schedule(method, restart, rel_tol, warm_tv)
    scal, tab, t2tab = kernel_args(x0hat_b, rho, lam, method, iterations, tv_iterations)
    sched = (method, restart, rel_tol, sigma_fac, warm_tv)
    if x0hat_b.device.type == "cpu":
        out = fista_tv_fused_torch(x0hat_b, scal, tab, t2tab, taps, *sched)
    else:
        check_cuda_input("fista_tv_fused", x0hat_b, taps)
        out = _launch(x0hat_b.contiguous(), scal, tab, t2tab, taps, *sched)
    return out if with_counts else out[0]


fista_tv_fused.launches = 0
fista_tv_fused.route_launches = {"resident": 0, "global": 0}


def check_pgm_tv(solver, path="fused"):
    """Validate `solver` for a PGM-TV kernel; returns its method.

    Raises ValueError naming the first unsupported piece. Shared by the
    fused and the tiled path (``check_pgm_tv_fused``, :893-976, and
    ``check_fista_tv_tiled``, ``fista_tv_tiled.py:917-1014``). The
    TPU-only requirements of ``rls_tpu`` (compensated factors,
    concrete-tracer tests, VMEM gates and tile sizes) have no counterpart;
    a float32 operator takes the place of the compensated-factor
    requirement.
    """
    method = next((m for cls, m in _METHOD_OF if isinstance(solver, cls)), None)
    if method is None:
        raise ValueError(f"{path} path requires FISTA, OptISTA, or POGM")
    # the kernel applies the GRAM of A, so AHA must actually be A's
    # NormalOperator — a bare operator passed as AHA means "this IS AᴴA
    # already", which the kernel cannot honor (it would square it)
    if not isinstance(solver.AHA, NormalOperator):
        raise ValueError(
            f"{path} path requires AHA to be the NormalOperator of a "
            "SeparableConvOperator (construct the solver from A, not AHA)"
        )
    if solver.AHA.weights is not None:
        raise ValueError(f"{path} path does not support weighted normal ops")
    op = solver.AHA.A
    if not isinstance(op, SeparableConvOperator):
        raise ValueError(f"{path} path requires SeparableConvOperator")
    if solver.A is None:
        raise ValueError(f"{path} path requires solver.A (for x0hat = Aᴴb)")
    if op.dtype != torch.float32:
        raise ValueError(f"{path} path requires a float32 operator, got {op.dtype}")
    if op.taps is None:
        raise ValueError(f"{path} path requires an operator built with tap metadata")
    reg = solver.reg
    if not isinstance(reg, TVRegularization):
        raise ValueError(f"{path} path requires TVRegularization")
    H, W = op.im_shape
    dims = (reg.dims,) if isinstance(reg.dims, int) else tuple(reg.dims)
    if reg.shape != (H, W) or tuple(sorted(dims)) != (0, 1):
        raise ValueError(f"{path} path requires 2-D TV over both axes")
    if solver.proj:
        raise ValueError(f"{path} path does not support projection terms")
    restart = getattr(solver, "restart", "none")
    if restart not in RESTARTS:
        raise ValueError(f"{path} path does not support restart={restart!r}")
    if restart == "gradient" and method not in ("fista", "pogm"):
        raise ValueError(
            f"{path} gradient restart is implemented for FISTA "
            "(reference FISTA.jl:171-176) and POGM (POGM.jl:222-232) "
            "only; use the composed path"
        )
    if restart == "gradient_mapping" and method != "fista":
        raise ValueError("gradient_mapping restart is a FISTA mode; use the composed path")
    if float(solver.theta) != 1.0:
        raise ValueError(f"{path} path requires the default theta=1 schedule")
    return method


def check_pgm_tv_fused(solver):
    """`check_pgm_tv` for the fused kernel; returns the method."""
    return check_pgm_tv(solver, "fused")


def check_six_planes(H: int, W: int) -> None:
    """The dispatch's rule between this kernel (row 2) and the row-tiled
    solve (row 3), from the planners' routes: an image comes here where the
    resident route's six planes of a band fit a cluster on an H100
    (:func:`fitting_sizes`: up to 384² for a square image), else it goes to
    row 3, whose planner keeps three planes of a band in shared memory
    (512²) or walks row tiles (1024²). The check sees the solver, not the
    batch or the card."""
    if not fitting_sizes(H, W):
        raise ValueError(
            f"a {H}x{W} image goes to the row-tiled kernel (six planes of its bands fit no "
            f"cluster of at most {MAX_CLUSTER} CTAs)"
        )


def solver_schedule(solver, method, early_exit=False, warm_tv=False, path="fused"):
    """(restart, rel_tol, sigma_fac) of a checked solver, with the rules of
    ``solve_pgm_tv_fused`` (:1100-1111): ``early_exit`` (FISTA and POGM)
    freezes a problem once ‖res‖/‖x0hat‖ < solver.rel_tol; ``warm_tv``
    needs FISTA with restart="none"."""
    restart = getattr(solver, "restart", "none")
    if warm_tv and (method != "fista" or restart != "none"):
        raise ValueError("warm_tv requires FISTA with restart='none'")
    rel_tol = None
    if early_exit:
        if method not in ("fista", "pogm"):
            raise ValueError(f"early_exit is FISTA/POGM-only in the {path} path")
        if solver.rel_tol is None:
            raise ValueError("early_exit needs a concrete solver.rel_tol")
        rel_tol = float(solver.rel_tol)
    return restart, rel_tol, float(getattr(solver, "sigma_fac", 1.0))


def prepare(solver, B_mat, reg=None):
    """(x0hat_b (K, H, W), λ_eff (K,)) of the problems in B_mat's columns,
    λ_eff of `reg` (default: solver.reg); the seed is the exact-f32
    stencil adjoint (``rmv_stencil``) when solver.A is the operator, as
    the JAX fused wrappers seed it."""
    op = solver.AHA.A
    op.check_device(B_mat)
    H, W = op.im_shape
    bt = B_mat.T  # (K, n)
    if solver.A is op:
        x0hat_b = op.rmv_stencil(bt).reshape(-1, H, W)
    else:
        x0hat_b = solver.A.rmv(bt).reshape(-1, H, W)
    scale = normalization_factor(solver.normalize_reg, solver.A, bt)
    return x0hat_b, (solver.reg if reg is None else reg).get_lam() * scale


def solve_pgm_tv_fused(solver, B_mat, early_exit=False, warm_tv=False, interleave=1):
    """Drop-in fast path for `solve_batched_unrolled(solver, B)` when the
    solver is FISTA / OptISTA / POGM + SeparableConvOperator + 2-D TV.
    Returns the n×K solution matrix like the composed driver.
    ``solver.restart`` other than "none" rides the in-kernel dynamic
    schedule; see `solver_schedule` for ``early_exit`` and ``warm_tv``.
    ``interleave`` > 1 is accepted where the JAX function accepts it (the
    fixed schedule, H and W multiples of 64, a batch it divides) and runs
    the same kernel: the JAX interleaved kernel is a rescheduling with the
    same result."""
    method = check_pgm_tv_fused(solver)
    restart, rel_tol, sigma_fac = solver_schedule(solver, method, early_exit, warm_tv)
    H, W = solver.AHA.A.im_shape
    if interleave > 1:
        if restart != "none" or rel_tol is not None or warm_tv:
            raise ValueError(
                "interleave > 1 is the fixed-schedule fold path: no "
                "restart/early-exit/warm_tv"
            )
        if H % 64 or W % 64:
            raise ValueError("interleave > 1 needs H, W % 64 == 0, as the JAX function does")
        if B_mat.shape[1] % interleave:
            raise ValueError(
                f"batch {B_mat.shape[1]} not divisible by interleave {interleave}"
            )
    x0hat_b, lam_eff = prepare(solver, B_mat)
    out = fista_tv_fused(
        x0hat_b, solver.AHA.A.taps_hw(), solver.rho, lam_eff, solver.iterations,
        solver.reg.iterations_tv, method=method, restart=restart, rel_tol=rel_tol,
        sigma_fac=sigma_fac, warm_tv=warm_tv,
    )
    return out.reshape(out.shape[0], H * W).T


def solve_fista_tv_fused(solver, B_mat):
    """Alias of `solve_pgm_tv_fused` for FISTA."""
    return solve_pgm_tv_fused(solver, B_mat)
