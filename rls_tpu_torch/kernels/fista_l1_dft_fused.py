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
* global: one CTA per problem, the spectrum staged through global scratch,
  for spectra whose bands fit no cluster of 16 (512², 640² and larger:
  every square side from 385 on, all past the JAX kernel's VMEM check).

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
]

# the cluster sizes of the resident route at a power-of-two shape, and the
# largest at any shape (the non-portable 16)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_CLUSTER = 16
# the phases of the resident route's timer (csrc/fista_l1_dft_fused.cu kPhases)
PHASES = ("set-up and write-out", "loads", "rows forward", "push to the column blocks",
          "barrier A", "column transforms", "write-back", "barrier B", "rows back and store")


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


@dataclasses.dataclass(frozen=True)
class DftPlan:
    """How a fused FISTA-L1-DFT launch runs: `route` "resident" (a cluster
    of `clusters` CTAs per problem, H and W split over it by
    ``_dft_common.split_part``: bands of at most `rows` image rows, blocks
    of at most `cols` spectrum columns, `smem` bytes of shared memory per
    CTA) or "global" (one CTA per problem, `rows` = H, `cols` = W, its
    spectrum in global scratch, `smem` 0 of dynamic shared memory); `ctas`
    CTAs in all."""

    route: str
    clusters: int
    rows: int
    cols: int
    H: int
    W: int
    ctas: int
    smem: int

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
    holds a band (512², and every square side from 385)."""
    fit = cluster_sizes(H, W, sms, smem_max)
    even = tuple(c for c in fit if c in CLUSTER_SIZES and H % c == 0 and W % c == 0)
    return even or fit


@functools.lru_cache(maxsize=256)
def plan_fista_l1_dft(B, H, W, resident, sms=SMS, smem_max=SMEM_MAX, clusters=None) -> DftPlan:
    """The route of a fused FISTA-L1-DFT launch of B problems of H × W, on
    a card of `sms` SMs and `smem_max` bytes of shared memory per block
    that holds n clusters of c CTAs of the resident kernel at once for each
    pair (c, n) of `resident` (``cudaOccupancyMaxActiveClusters``; a size
    not named is held 0 times).

    The rule, as ``plan_pdhg``'s: among the sizes of :func:`fitting_sizes`
    that the card holds, the smallest and each larger one that leaves every
    CTA at least ``MIN_CTA_PIXELS`` pixels, the one with the fewest waves ×
    rows per band, ⌈B / held(c)⌉ · ⌈H/c⌉ (a CTA transforms ⌈H/c⌉ rows and
    as many columns' worth of points); ties go to the smaller c. A spectrum
    whose bands fit at no c (512², 640², 1024²) takes the global route.
    `clusters` forces a size of :func:`cluster_sizes` (for measuring and
    tests). Raises ValueError naming the shape where it is empty or not the
    FFT's, naming a forced size that does not fit, and naming the plan where
    the card holds no cluster of it (no fallback)."""
    if B < 1:
        raise ValueError(f"fista_l1_dft_fused: empty batch of {B} x {H}x{W}")
    _dft_common.check_fft_shape(H, W)
    fit = fitting_sizes(H, W, sms, smem_max)
    if clusters is not None and clusters not in cluster_sizes(H, W, sms, smem_max):
        raise ValueError(f"fista_l1_dft_fused: a cluster of {clusters} CTAs does not fit "
                         f"{B} x {H}x{W} (the sizes that do: {cluster_sizes(H, W, sms, smem_max)})")
    if not fit:
        return DftPlan("global", 1, H, W, H, W, B, 0)
    c = clusters or fewest_waves(B, H, W, fit, resident)
    plan = DftPlan("resident", c, cdiv(H, c), cdiv(W, c), H, W, B * c,
                   resident_smem_bytes(H, W, c))
    if dict(resident).get(c, 0) < 1:
        raise ValueError(f"fista_l1_dft_fused: the card holds no cluster of {plan} "
                         f"({B} x {H}x{W})")
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


def plan_on_card(x0hat, clusters=None):
    """(plan, clusters resident at once) of a launch on x0hat's card ((B,
    H, W)), with `clusters` forced where given; the count is None on the
    global route. Raises RuntimeError where the kernel counts other shared
    memory than the planner, ValueError where the resident plan has no
    cluster the card can hold."""
    from .. import _build

    B, H, W = x0hat.shape
    _dft_common.check_fft_shape(H, W)
    index = x0hat.device.index or 0
    limits = _build.device_limits(index)
    sizes = set(fitting_sizes(H, W, *limits))
    if clusters in cluster_sizes(H, W, *limits):
        sizes.add(clusters)
    held = {c: resident_limits(index, c, H, W) for c in sorted(sizes)}
    plan = plan_fista_l1_dft(B, H, W, tuple((c, n) for c, (_, n) in held.items()), *limits,
                             clusters)
    if plan.route == "global":
        return plan, None
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


def _launch(x0hat, scal, tab, tables, prof=None, clusters=None):
    from .. import _build

    B, H, W = x0hat.shape
    plan, _ = plan_on_card(x0hat, clusters)
    if prof is not None and plan.route != "resident":
        raise ValueError(f"fista_l1_dft_fused: the phase timer is on the resident route, "
                         f"not {plan}")
    lib = _build.load_library()
    dev = x0hat.device
    tw = _dft_common.twiddle_tensor(tables)
    out = torch.empty_like(x0hat)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "resident":
            wt = tables[2].T.contiguous()  # read along a spectrum column
            code = lib.fista_l1_dft_cluster_launch(
                x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), tw.data_ptr(), wt.data_ptr(),
                out.data_ptr(), None if prof is None else prof.data_ptr(), B, H, W,
                tab.shape[0], plan.clusters, plan.smem, stream)
        else:
            weights = tables[2].contiguous()
            # x_prev, x_mom and the spectrum's (re, im)
            scratch = torch.empty((4, B, H, W), dtype=torch.float32, device=dev)
            code = lib.fista_l1_dft_fused_launch(
                x0hat.data_ptr(), scal.data_ptr(), tab.data_ptr(), tw.data_ptr(),
                weights.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, H, W, tab.shape[0],
                stream)
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


def fista_l1_dft_fused(x0hat_b, mask, rho, lam, iterations: int, clusters=None):
    """Batched FISTA-L1 on the subsampled DFT of `mask` (H, W) in one
    launch, on the route of :func:`plan_fista_l1_dft` (a cluster of CTAs
    per problem with its state in shared memory, or one CTA per problem).

    x0hat_b: (B, H, W), Aᴴb per problem; rho, lam: scalars or (B,) (λ
    already normalization-scaled). The plain version runs for a CPU
    tensor, the CUDA kernel (float32) for a CUDA tensor; `clusters` forces
    the kernel's cluster size (for measuring and tests; the plain version
    has no plan). ``fista_l1_dft_fused.launches`` counts the kernel's
    launches, and ``fista_l1_dft_fused.route_launches`` the launches by
    route."""
    if x0hat_b.device.type == "cpu":
        return fista_l1_dft_fused_torch(x0hat_b, *_kernel_args(x0hat_b, mask, rho, lam,
                                                                iterations))
    _dft_common.check_dft_cuda_input("fista_l1_dft_fused", x0hat_b, mask)
    return _launch(x0hat_b.contiguous(), *_kernel_args(x0hat_b, mask, rho, lam, iterations),
                   clusters=clusters)


fista_l1_dft_fused.launches = 0
fista_l1_dft_fused.route_launches = {"resident": 0, "global": 0}


def phase_clocks(x0hat_b, mask, rho, lam, iterations: int, clusters=None):
    """One launch of the resident kernel with its phase timer on: {phase:
    SM clocks that CTA 0 spent in it over the whole solve} (``PHASES``; the
    launch counts in ``fista_l1_dft_fused.launches``), on the plan's
    cluster size or `clusters`. Raises on the global route and for a CPU
    tensor."""
    if x0hat_b.device.type == "cpu":
        raise ValueError("fista_l1_dft_fused: the phase timer runs on the card")
    _dft_common.check_dft_cuda_input("fista_l1_dft_fused", x0hat_b, mask)
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=x0hat_b.device)
    _launch(x0hat_b.contiguous(), *_kernel_args(x0hat_b, mask, rho, lam, iterations), prof,
            clusters)
    return dict(zip(PHASES, prof.tolist()))


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
