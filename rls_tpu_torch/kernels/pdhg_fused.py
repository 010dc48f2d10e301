"""The whole fixed-iteration PDHG solve on a separable convolution as ONE
launch: the hand-written CUDA kernel ``csrc/pdhg_fused.cu`` and its plain
PyTorch version.

Counterpart of ``rls_tpu/kernels/pdhg_fused.py``: ``_grad8_ops`` (:56-94),
``_kernel`` (:97-182), ``pdhg_fused`` (:185-219), ``check_pdhg_fused``
(:232-265) and ``solve_pdhg_fused`` (:268-308). Per problem, from
x = y₁ = y₂ = 0, `iterations` times

    y₁ ← (y₁ + σ(Ax − u)) · (1 / (1 + σ))
    y₂ ← conj-prox(y₂ + σΦx)
    x  ← x − τ(Aᴴy₁ + Φᴴy₂), then max(x, 0) with Positive

with A and Aᴴ the zero-padded stencil passes (rows, then columns) and the
dual kind ``"tv8"`` (the 8 planes of ``Grad8Operator`` and the sequential
weighted projection), ``"tviso"`` (the 2 masked forward differences of
``GradientOperator`` on full planes and the elementwise λ-clip) or
``"l1"`` (Φ = I and the clip). No gap is computed: the kernel matches the
fixed-iteration ``solve_batched_unrolled``, which ignores it.

The kernel runs on one of two routes that :func:`plan_pdhg` picks by
shape:

* resident: each problem on a thread-block cluster of c ≤ 16 CTAs, one
  band of image rows per CTA, x, y₁, the stencil temporary and the dual
  planes in shared memory for the whole solve, rows of another band read
  through distributed shared memory (the tv8 cell at 256²: 16 bands of 16
  rows);
* global: one CTA per problem with its planes in global scratch, for a row
  so wide that no band fits (about W > 5,200 for tv8).

Numerics, the same in both versions and on both routes: every product and
sum is rounded on its own in the order written here (the kernel forbids
FMA contraction), so the kernel agrees with the plain version bit for bit.
The composed solver multiplies by banded matrices and divides by 1 + σ, so
it differs from both by f32 rounding.

Not carried over: the TPU's VMEM gate (``_check_vmem_pdhg``, :222-229);
the planner's shared-memory count takes its place.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .._build import SMEM_MAX, SMS
from ..models.prox import PositiveRegularization, RealRegularization
from ..models.regularization import normalization_factor
from ..models.solvers.pdhg import PDHG, W8, clip_conj
from ..ops.conv_direct import SeparableConvOperator, stencil_pass
from ..ops.grad import Grad8Operator
from ._bands import (HALO, MIN_CTA_PIXELS, BandPlan, band_sizes, cdiv,  # noqa: F401
                     fewest_waves)
from .fista_tv_fused import MAX_TAPS, check_cuda_input

__all__ = [
    "pdhg_fused",
    "pdhg_fused_torch",
    "check_pdhg_fused",
    "solve_pdhg_fused",
    "kernel_scalars",
    "plan_pdhg",
    "PdhgPlan",
    "phase_clocks",
    "KINDS",
]

KINDS = ("tv8", "tviso", "l1")
PROXES = ("none", "positive")
_PLANES = {"tv8": 8, "tviso": 2, "l1": 1}
# the largest cluster (the non-portable size); the kernel's tap buffer per
# axis (MAX_TAPS), row reach (HALO) and the least pixels a CTA keeps when
# the planner spreads a problem over more CTAs than its bands need
# (MIN_CTA_PIXELS: a guess, not measured for this kernel) are the PGM-TV
# kernel's
MAX_CLUSTER = 16
# the phases of the resident route's timer (csrc/pdhg_fused.cu kPhases)
PHASES = ("set-up", "A x pass", "dual update", "Aᴴ y₁ pass", "primal update",
          "cluster barriers")


def cluster_smem_bytes(kind, rows, W):
    """Shared memory of a resident CTA whose band has `rows` rows of width
    W, as ``cluster_smem_bytes`` in csrc/pdhg_fused.cu counts it: x, y₁, t1
    and the dual planes (8, 2, 1), each rounded up to 4 floats, the phase
    timer (int64 each), the DSMEM row table (rows + 2·HALO pointers), the
    taps (2 × MAX_TAPS f32) and the 8 plane weights."""
    return (4 * (3 + _PLANES[kind]) * cdiv(rows * W, 4) * 4 + 8 * len(PHASES)
            + 8 * (rows + 2 * HALO) + 4 * (2 * MAX_TAPS + 8))


class PdhgPlan(BandPlan):
    """How a fused PDHG launch runs: `route` "resident" (a cluster of
    `clusters` CTAs per problem, bands of `rows` image rows, the last one
    possibly shorter, `smem` bytes of shared memory per CTA) or "global"
    (one CTA per problem, `rows` = H, its planes in global scratch, `smem`
    0 of dynamic shared memory); `ctas` CTAs in all."""


def fitting_sizes(kind, H, W, sms=SMS, smem_max=SMEM_MAX):
    """The cluster sizes c ≤ 16 (and ≤ sms) whose bands of ⌈H/c⌉ rows fit
    one CTA's shared memory with no band empty."""
    return band_sizes(H, W, range(1, MAX_CLUSTER + 1),
                      functools.partial(cluster_smem_bytes, kind), sms, smem_max)


def _check_shape(B, H, W, kh, kw, kind):
    if kind not in KINDS:
        raise ValueError(f"unknown PDHG kind {kind!r}; the kernel takes {KINDS}")
    if min(B, H, W) < 1:
        raise ValueError(f"pdhg_fused: empty shape {B} x {H}x{W}")
    if not (1 <= kh <= MAX_TAPS and 1 <= kw <= MAX_TAPS):
        raise ValueError(f"pdhg_fused: {kh} x {kw} taps; at most {MAX_TAPS} per axis")


@functools.lru_cache(maxsize=256)
def plan_pdhg(B, H, W, kh, kw, kind, resident, sms=SMS, smem_max=SMEM_MAX) -> PdhgPlan:
    """The route of a fused PDHG launch of B problems of H × W with kh × kw
    taps and dual `kind`, on a card of `sms` SMs and `smem_max` bytes of
    shared memory per block that holds n clusters of c CTAs of the resident
    kernel at once for each pair (c, n) of `resident`
    (``cudaOccupancyMaxActiveClusters``; a size not named is held 0 times).

    The rule: among the sizes of :func:`fitting_sizes` that the card
    holds, the smallest and each larger one that leaves every CTA at least
    ``MIN_CTA_PIXELS`` pixels, the one with the fewest waves × rows per
    band, ⌈B / held(c)⌉ · ⌈H/c⌉ (a wave's time goes with the pixels of its
    CTAs); ties go to the smaller c. An image whose bands fit at no c (a
    row wider than ~5,200 pixels for tv8) takes the global route. A shape
    with neither (empty, or a problem of 2³¹ pixels or more) raises
    ValueError naming it, as does a resident plan the card holds no
    cluster of (no fallback)."""
    _check_shape(B, H, W, kh, kw, kind)
    fit = fitting_sizes(kind, H, W, sms, smem_max)
    if fit:
        c = fewest_waves(B, H, W, fit, resident)
        rows = cdiv(H, c)
        plan = PdhgPlan("resident", c, rows, H, B * c, cluster_smem_bytes(kind, rows, W))
        if dict(resident).get(c, 0) < 1:
            raise ValueError(f"pdhg_fused: the card holds no cluster of {plan} "
                             f"({B} x {H}x{W}, {kind})")
        return plan
    if H * W >= 2**31:
        raise ValueError(
            f"pdhg_fused: no route for {B} x {H}x{W} ({kind}): bands fit no cluster of at "
            f"most {MAX_CLUSTER} CTAs with {smem_max} bytes of shared memory each, and one "
            "CTA per problem indexes fewer than 2**31 pixels"
        )
    return PdhgPlan("global", 1, H, H, B, 0)


@functools.lru_cache(maxsize=None)
def resident_limits(index, kind, clusters, rows, W):
    """(shared memory per CTA as the kernel counts it, clusters of the
    resident kernel of `kind` that device `index` holds at once:
    ``cudaOccupancyMaxActiveClusters``)."""
    from .. import _build

    out = (ctypes.c_longlong * 2)()
    with torch.cuda.device(index):
        _build.check(
            _build.load_library().pdhg_cluster_occupancy(
                KINDS.index(kind), clusters, rows, W, out),
            "pdhg_cluster_occupancy")
    return out[0], out[1]


def plan_on_card(u_b, taps, kind="tv8"):
    """(plan, clusters resident at once) of a launch on u_b's card; the
    count is None on the global route. Raises RuntimeError where the kernel
    counts other shared memory than the planner, ValueError where the
    resident plan has no cluster the card can hold."""
    from .. import _build

    B, H, W = u_b.shape
    kh, kw = (len(t) for t in taps)
    _check_shape(B, H, W, kh, kw, kind)
    index = u_b.device.index or 0
    limits = _build.device_limits(index)
    held = {c: resident_limits(index, kind, c, cdiv(H, c), W)
            for c in fitting_sizes(kind, H, W, *limits)}
    plan = plan_pdhg(B, H, W, kh, kw, kind, tuple((c, n) for c, (_, n) in held.items()),
                     *limits)
    if plan.route == "global":
        return plan, None
    smem, active = held[plan.clusters]
    if smem != plan.smem:
        raise RuntimeError(f"pdhg_fused: the kernel counts {smem} bytes of shared memory "
                           f"for {plan}")
    return plan, active


def _grad_div(kind, H, W, like):
    """(grad, div) of the dual kind on (B, H, W) planes, in the kernel's
    op order."""
    if kind == "tv8":
        g8 = Grad8Operator((H, W), like.dtype, device=like.device)

        def grad(x):
            return list(g8.mv(x.reshape(-1, H * W)).reshape(-1, 8, H, W).unbind(dim=1))

        def div(planes):
            return g8.rmv(torch.stack(planes, dim=1).reshape(-1, 8 * H * W)).reshape(-1, H, W)

        return grad, div
    if kind == "tviso":
        not_last_row = (torch.arange(H, device=like.device) < H - 1).to(like.dtype)[:, None]
        not_last_col = (torch.arange(W, device=like.device) < W - 1).to(like.dtype)[None, :]

        def grad(x):
            return [(torch.roll(x, -1, -2) - x) * not_last_row,
                    (torch.roll(x, -1, -1) - x) * not_last_col]

        def div(planes):
            pv, ph = planes
            return (torch.roll(pv, 1, -2) - pv + torch.roll(ph, 1, -1)) - ph

        return grad, div
    return (lambda x: [x]), (lambda planes: planes[0])


def pdhg_fused_torch(u, scal, taps, iterations: int, kind="tv8", prox="none"):
    """Plain version: `u` (B, H, W), `scal` (B, 3) = [σ, τ, λ_eff], `taps`
    (taps_h, taps_w). Returns x (B, H, W) in u's dtype."""
    taps_h, taps_w = taps
    H, W = u.shape[-2:]
    sigma, tau, lam = (scal[:, k].view(-1, 1, 1) for k in range(3))
    inv1s = 1.0 / (1.0 + sigma)
    grad, div = _grad_div(kind, H, W, u)

    def fwd(v):
        return stencil_pass(stencil_pass(v, taps_h, -2, False), taps_w, -1, False)

    def adj(v):
        return stencil_pass(stencil_pass(v, taps_h, -2, True), taps_w, -1, True)

    def conj_prox(planes):
        if kind != "tv8":
            return [clip_conj(p, lam) for p in planes]
        planes = list(planes)
        for k in range(8):
            gnorm = torch.sqrt(sum(p * p for p in planes))
            planes[k] = W8[k] * torch.sign(planes[k]) * torch.minimum(gnorm, lam)
        return planes

    zero = u * 0.0
    x, y1, y2 = zero, zero, [zero] * _PLANES[kind]
    for _ in range(iterations):
        y1 = (y1 + sigma * (fwd(x) - u)) * inv1s
        g = grad(x)
        y2 = conj_prox([y2[k] + sigma * g[k] for k in range(len(y2))])
        x = x - tau * (adj(y1) + div(y2))
        if prox == "positive":
            x = torch.clamp(x, min=0.0)
    return x


def _launch(u, scal, taps, iterations, kind, prox, prof=None):
    from .. import _build

    B, H, W = u.shape
    taps_h, taps_w = taps
    plan, _ = plan_on_card(u, taps, kind)
    if prof is not None and plan.route != "resident":
        raise ValueError(f"pdhg_fused: the phase timer is on the resident route, not {plan}")
    lib = _build.load_library()
    dev = u.device
    taps_t = torch.tensor(list(taps_h) + list(taps_w), dtype=torch.float32, device=dev)
    weights = torch.tensor(W8, dtype=torch.float32, device=dev)
    out = torch.empty_like(u)
    args = (u.data_ptr(), scal.data_ptr(), taps_t.data_ptr(), weights.data_ptr(),
            len(taps_h), len(taps_w), out.data_ptr())
    sched = (B, H, W, iterations, KINDS.index(kind), int(prox == "positive"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "resident":
            code = lib.pdhg_cluster_launch(
                *args, None if prof is None else prof.data_ptr(), *sched, plan.clusters,
                plan.rows, plan.smem, stream)
        else:
            # y1, the stencil temporary and the dual planes
            scratch = torch.empty((2 + _PLANES[kind], B, H, W), dtype=torch.float32, device=dev)
            code = lib.pdhg_fused_launch(*args, scratch.data_ptr(), *sched, stream)
    _build.check(code, f"pdhg_fused ({B} x {H}x{W}, {kind}, {plan})")
    pdhg_fused.launches += 1
    pdhg_fused.route_launches[plan.route] += 1
    return out


def kernel_scalars(u_b, sigma, tau, lam, dtype=np.float32):
    """(B, 3) [σ, τ, λ_eff] per problem in `dtype` on u's device; each a
    scalar or (B,)."""
    B = u_b.shape[0]
    tdt = torch.from_numpy(np.zeros((), dtype)).dtype

    def per_problem(v):
        return torch.broadcast_to(
            torch.as_tensor(v, dtype=tdt, device=u_b.device).reshape(-1), (B,))

    return torch.stack([per_problem(v) for v in (sigma, tau, lam)], dim=1)


def _checked(u_b, taps, kind, prox):
    if kind not in KINDS:
        raise ValueError(f"unknown PDHG kind {kind!r}; the kernel takes {KINDS}")
    if prox not in PROXES:
        raise ValueError(f"unknown prox {prox!r}; the PDHG kernel takes {PROXES}")
    if u_b.device.type != "cpu":
        check_cuda_input("pdhg_fused", u_b, taps)


def pdhg_fused(u_b, taps, sigma, tau, lam, iterations: int, kind="tv8", prox="none"):
    """Batched fixed-iteration PDHG on a separable conv in one launch, on
    the route of :func:`plan_pdhg` (a cluster of CTAs per problem with its
    planes in shared memory, or one CTA per problem on global scratch).

    u_b: (B, H, W) float32, the data images; taps: (taps_h, taps_w);
    sigma, tau, lam: scalars or (B,) (λ already normalization-scaled);
    kind "tv8" | "tviso" | "l1"; prox "none" | "positive". The plain
    version runs for a CPU tensor, the CUDA kernel for a CUDA tensor.
    ``pdhg_fused.launches`` counts the kernel's launches, and
    ``pdhg_fused.route_launches`` the launches by route. Returns x
    (B, H, W).
    """
    _checked(u_b, taps, kind, prox)
    scal = kernel_scalars(u_b, sigma, tau, lam)
    if u_b.device.type == "cpu":
        return pdhg_fused_torch(u_b, scal, taps, iterations, kind, prox)
    return _launch(u_b.contiguous(), scal, taps, iterations, kind, prox)


pdhg_fused.launches = 0
pdhg_fused.route_launches = {"resident": 0, "global": 0}


def phase_clocks(u_b, taps, sigma, tau, lam, iterations: int, kind="tv8", prox="none"):
    """One launch of the resident kernel with its phase timer on: {phase:
    SM clocks that CTA 0 spent in it over the whole solve} (``PHASES``; the
    launch counts in ``pdhg_fused.launches``). Raises on the global route
    and for a CPU tensor."""
    _checked(u_b, taps, kind, prox)
    if u_b.device.type == "cpu":
        raise ValueError("pdhg_fused: the phase timer runs on the card")
    scal = kernel_scalars(u_b, sigma, tau, lam)
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=u_b.device)
    _launch(u_b.contiguous(), scal, taps, iterations, kind, prox, prof)
    return dict(zip(PHASES, prof.tolist()))


def check_pdhg_fused(solver):
    """Validate `solver` for the fused PDHG kernel (raises ValueError naming
    the unsupported piece); returns (kind, prox)."""
    if not isinstance(solver, PDHG):
        raise ValueError("fused PDHG path requires a PDHG solver")
    op = solver.A
    if not isinstance(op, SeparableConvOperator):
        raise ValueError("fused PDHG path requires a SeparableConvOperator")
    if op.taps is None:
        raise ValueError("fused PDHG path requires tap metadata (from_taps)")
    if op.dtype != torch.float32:
        raise ValueError(f"fused PDHG path covers real float32 systems only, got {op.dtype}")
    if solver.reg_kind == "tv":
        if tuple(solver.shape) != tuple(op.im_shape):
            raise ValueError("TV shape must equal the operator image shape")
        kind = "tv8" if solver.tv_scheme == "8dir" else "tviso"
    elif solver.reg_kind == "l1":
        kind = "l1"
    else:
        raise ValueError(f"unsupported reg kind {solver.reg_kind}")
    for p in solver.proj:
        if not isinstance(p, (PositiveRegularization, RealRegularization)):
            raise ValueError(
                "fused PDHG path supports only Positive/Real projections, "
                f"got {type(p).__name__}"
            )
    if any(isinstance(p, PositiveRegularization) for p in solver.proj):
        return kind, "positive"
    return kind, "none"  # Real is the identity on real systems


def solve_pdhg_fused(solver, B_mat):
    """Drop-in fast path for ``solve_batched_unrolled(solver, B)`` on a
    PDHG solver over a separable-conv operator with 8-direction or
    isotropic TV or L1 (columns of ``B_mat`` are problems; returns n × K).
    λ_eff = f32(λ)·normalization per problem, as ``rls_tpu`` forms it."""
    kind, prox = check_pdhg_fused(solver)
    op = solver.A
    H, W = op.im_shape
    if B_mat.is_complex():
        raise ValueError(
            "fused PDHG path covers real data only (complex b: the composed "
            "real-only solver rejects it too)"
        )
    if B_mat.shape[0] != H * W:
        raise ValueError(f"B has {B_mat.shape[0]} rows, operator expects {H * W}")
    op.check_device(B_mat)
    bt = B_mat.to(torch.float32).T
    scale = normalization_factor(solver.normalize_reg, solver.A, bt)
    lam = solver.reg.get_lam()
    lam = torch.as_tensor(lam.real if torch.is_tensor(lam) else lam, dtype=torch.float32,
                          device=bt.device)
    lam_eff = lam * scale.to(torch.float32)
    out = pdhg_fused(bt.reshape(-1, H, W).contiguous(), op.taps_hw(), solver.sigma, solver.tau,
                     lam_eff, solver.iterations, kind, prox)
    return out.reshape(out.shape[0], H * W).T
