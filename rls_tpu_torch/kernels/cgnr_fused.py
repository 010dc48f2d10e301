"""The whole batched CGNR solve on a dense matrix as ONE launch: the
hand-written CUDA kernel ``csrc/cgnr_fused.cu`` and its plain PyTorch
version.

Counterpart of ``rls_tpu/kernels/cgnr_fused.py``: ``_kernel`` (:86-130),
``check_cgnr_fused`` (:133-171) and ``solve_cgnr_fused`` (:174-281). Per
problem, from x = 0 and r = p = Aᴴb, ``steps`` = min(iterations, n) times

    q = A p,  v = Aᴴ q,  ζ = r·r,  denom = p·v + λ p·p
    α = ζ / denom (0 where ζ = 0; denom = 0 read as 1)
    x += α p,  r −= α v + (λα) p,  β = r·r / ζ (ζ = 0 read as 1),  p = r + β p

then x = max(x, 0) with the Positive projection. The guards make a step
past convergence (r = p = 0) the identity, as ``CGNR.step`` does.

Numerics, the same in both versions: every matvec entry and every dot is
summed in double from the f32 entries and rounded to f32 (the plain
version multiplies in float64; the kernel accumulates in double); the
updates are separate f32 operations. The two then differ only where two
double sums taken in another order round to different f32 values, which
keeps the kernel next to the plain version even on systems whose f32 CG
amplifies a 1-ulp change of b to 1e-2.

The kernel runs a CG step of the whole batch over every SM: A's rows are
cut into slabs and the batch into groups, one CTA per (slab, group), each
keeping its slab of A in shared memory for the whole solve, so a load of
A serves every problem of the group, and multiplying on the FP64 tensor
cores. :func:`plan_cgnr` chooses the cut on the host; a shape that has no
plan whose CTAs are all resident at once raises.

Not carried over: the TPU's pre-split bf16 hi/lo factors and their VMEM
gate (:164), and ``chunked_batch_run`` (:67-83): the port launches one
grid over the whole batch.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..models.prox import PositiveRegularization
from ..models.regularization import normalization_factor
from ..models.solvers.cgnr import CGNR
from ..ops.base import DenseOperator, NormalOperator

__all__ = [
    "cgnr_fused",
    "cgnr_fused_torch",
    "check_cgnr_fused",
    "plan_cgnr",
    "CgnrPlan",
    "phase_clocks",
    "solve_cgnr_fused",
    "split_real_embedding",
    "dsum_mm",
    "dsum_dot",
]

PROXES = ("none", "positive")


def dsum_mm(x, M):
    """x @ M with every sum taken in float64, rounded to x's dtype."""
    return (x.double() @ M.double()).to(x.dtype)


def dsum_dot(a, b):
    """Σ a·b over the last axis in float64, rounded to a's dtype."""
    return (a.double() * b.double()).sum(dim=-1).to(a.dtype)


def cgnr_fused_torch(b, A, lam, steps: int, prox="none"):
    """Plain version: `b` (P, m) and `A` (m, n) real, `lam` (P,) the
    effective λ per problem. Returns x (P, n) in b's dtype."""
    A64 = A.double()

    def col(v):
        return v.unsqueeze(-1)

    r = dsum_mm(b, A64)  # Aᴴ b
    x = r * 0.0
    p = r
    for _ in range(steps):
        v = dsum_mm(dsum_mm(p, A64.T), A64)  # Aᴴ A p
        zeta = dsum_dot(r, r)
        denom = dsum_dot(p, v) + lam * dsum_dot(p, p)
        alpha = torch.where(
            zeta > 0, zeta / torch.where(denom == 0, torch.ones_like(denom), denom),
            torch.zeros_like(zeta),
        )
        x = x + col(alpha) * p
        r = r - col(alpha) * v - col(lam * alpha) * p
        beta = dsum_dot(r, r) / torch.where(zeta > 0, zeta, torch.ones_like(zeta))
        p = r + col(beta) * p
    if prox == "positive":
        x = torch.clamp(x, min=0.0)
    return x


# the kernel's warps per CTA and problems per tile (csrc/cgnr_fused.cu)
WARPS, TILE = 8, 8
# the phases that the kernel can time (csrc/cgnr_fused.cu kPhases)
PHASES = ("set-up", "q", "partial v", "barrier 1", "slab sums and dots", "barrier 2",
          "x and r", "barrier 3", "p", "x out")


# the planner's prices, in SM clocks: a barrier of a group's CTAs (an
# atomic and a poll of L2) and a round trip of loads through L2
SYNC_CLOCKS, TRIP_CLOCKS = 2000, 1000


@dataclasses.dataclass(frozen=True)
class CgnrPlan:
    """How the CGNR kernel cuts a solve: `slabs` slabs of `rows` rows of A,
    `groups` groups of `group_size` problems, one CTA per (slab, group);
    with `resident` each CTA keeps its slab of A and its group's p in
    shared memory; `smem` bytes of it per CTA."""

    slabs: int
    rows: int
    groups: int
    group_size: int
    resident: bool
    smem: int

    @property
    def ctas(self) -> int:
        return self.slabs * self.groups


def _cdiv(a, b):
    return -(-a // b)


def _align16(nbytes):
    return _cdiv(nbytes, 16) * 16


def slab_ld(n):
    """The row stride of A's slab in shared memory (csrc/cgnr_fused.cu
    ``slab_ld``): at least n rounded up to 16, 8 mod 32 floats."""
    n16 = _cdiv(n, 16) * 16
    return n16 + (40 - n16 % 32) % 32


def smem_bytes(n, slabs, rows, group_size, resident):
    """Shared memory of one CTA, as ``smem_bytes`` in csrc/cgnr_fused.cu
    counts it: q for a tile of 8 problems (float64, rows rounded up to
    16), five f32 scalars per problem, the block reductions, the phase
    timer and the warps' split sums (8 × 128 float64); with `resident` the
    slab of A (f32, zero rows and columns up to 16 rows and ``slab_ld``),
    the group's p (float64, tiles × n rounded up to 8 × 8), the owner's x,
    r, v (f32, tiles × its columns × 8) and, with several slabs, the
    group's whole r (f32, tiles × n × 8); with one slab the partial v of
    every tile (float64). Each piece starts 16-byte aligned."""
    chunk, tiles, rows16 = _cdiv(n, slabs), _cdiv(group_size, TILE), _cdiv(rows, 16) * 16
    nbytes = (8 * TILE * rows16 + _align16(20 * group_size) + 8 * 2 * WARPS * TILE
              + 8 * len(PHASES) + 8 * WARPS * 128)
    if resident:
        nbytes += (_align16(4 * rows16 * slab_ld(n)) + 8 * TILE * tiles * _cdiv(n, 8) * 8
                   + _align16(12 * TILE * tiles * chunk)
                   + (_align16(4 * TILE * tiles * n) if slabs > 1 else 0))
    if slabs == 1:
        nbytes += 8 * TILE * tiles * n
    return nbytes


def step_clocks(n, slabs, rows, group_size, resident):
    """A model of one CG step's SM clocks on a CTA of the plan: q and the
    partial v on the FP64 tensor cores (~100 double FMAs per SM and clock
    in 16 × 8 blocks, a quarter of that for a lone block), the vectors'
    work, and with several slabs the group's barriers and round trips
    through L2; A read from L2 twice per tile where it is not resident."""
    tiles = _cdiv(group_size, TILE)
    rows16, n16 = _cdiv(rows, 16) * 16, _cdiv(n, 16) * 16
    work = 8 * rows16 * n16 // 100
    q = tiles * max(work, 16 * 8 * n16 // 25)
    v = tiles * max(work, 16 * 8 * rows16 // 25)
    vec = tiles * n + group_size * n // 8
    group = 0 if slabs == 1 else (3 if resident else 4) * SYNC_CLOCKS + 3 * TRIP_CLOCKS
    stream = 0 if resident else tiles * rows * n // 4
    return q + v + vec + group + stream


@functools.lru_cache(maxsize=256)
def plan_cgnr(m, n, P, sms, smem_max) -> CgnrPlan:
    """The cut of a solve of P problems on an m × n A for a card of `sms`
    SMs and `smem_max` bytes of shared memory per block: the plan of least
    :func:`step_clocks` whose CTAs, at most one per SM, are all resident
    at once. Raises ValueError where no plan fits."""
    if min(m, n, P) < 1:
        raise ValueError(f"cgnr_fused: empty shape A {m}x{n}, {P} problems")
    best = None
    for s_try in range(1, min(m, sms) + 1):
        rows = _cdiv(m, s_try)
        slabs = _cdiv(m, rows)
        if slabs != s_try:
            continue  # the same cut as a smaller slab count
        for g_try in range(1, min(P, sms // slabs) + 1):
            group_size = _cdiv(P, g_try)
            groups = _cdiv(P, group_size)
            if groups != g_try:
                continue
            for resident in (True, False):
                smem = smem_bytes(n, slabs, rows, group_size, resident)
                if smem > smem_max:
                    continue
                key = (step_clocks(n, slabs, rows, group_size, resident), -groups, slabs)
                if best is None or key < best[0]:
                    best = (key, CgnrPlan(slabs, rows, groups, group_size, resident, smem))
                break
    if best is None:
        raise ValueError(
            f"cgnr_fused: no plan for A {m}x{n} with {P} problems whose CTAs fit at once "
            f"on {sms} SMs with {smem_max} bytes of shared memory each"
        )
    return best[1]


def _launch(b, A, lam, steps, prox, prof=None):
    from .. import _build

    P, m = b.shape
    n = A.shape[1]
    if P == 0:
        return torch.empty((0, n), dtype=torch.float32, device=b.device)
    lib = _build.load_library()
    plan = plan_cgnr(m, n, P, *_build.device_limits(b.device.index or 0))
    out = torch.empty((P, n), dtype=torch.float32, device=b.device)
    # one float64 workspace, each piece 256-byte aligned: the barrier
    # counters and, without `resident`, p of the group's tiles as (column,
    # problem), both zeroed; with several slabs the partial v and the dots
    # that meet in L2; r and, without `resident`, v (f32)
    tiles = _cdiv(plan.group_size, TILE)
    shared = plan.slabs > 1
    sizes = (plan.groups * 16,
             0 if plan.resident else plan.groups * tiles * _cdiv(n, 8) * 8 * TILE,
             plan.groups * plan.slabs * tiles * n * TILE if shared else 0,
             plan.groups * plan.slabs * plan.group_size * 2 if shared else 0,
             _cdiv(P * n, 2), 0 if plan.resident else _cdiv(P * n, 2))
    starts = [0]
    for size in sizes:
        starts.append(starts[-1] + _cdiv(size, 32) * 32)
    ws = torch.empty(starts[-1], dtype=torch.float64, device=b.device)
    ws[:starts[2]].zero_()
    bar, p, part, dots, r, v = (ws[starts[i]:starts[i + 1]] for i in range(6))
    bar, r, v = bar.view(torch.int32), r.view(torch.float32), v.view(torch.float32)
    with torch.cuda.device(b.device):
        code = lib.cgnr_fused_launch(
            b.data_ptr(), A.data_ptr(), lam.data_ptr(), out.data_ptr(), part.data_ptr(),
            dots.data_ptr(), r.data_ptr(), v.data_ptr(), p.data_ptr(), bar.data_ptr(),
            None if prof is None else prof.data_ptr(), P, m, n, steps, int(prox == "positive"),
            plan.slabs, plan.rows, plan.groups, plan.group_size, int(plan.resident), plan.smem,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, f"cgnr_fused_launch (A {m}x{n}, {P} problems, {plan})")
    cgnr_fused.launches += 1
    return out


def phase_clocks(b, A, lam, steps: int, prox="none"):
    """One launch of the CUDA kernel with its phase timer on: {phase: SM
    clocks that CTA 0 spent in it over the whole solve} (``PHASES``;
    ``cgnr_fused.launches`` counts the launch)."""
    check_cuda_operands("cgnr_fused", A, b, lam)
    prof = torch.zeros(len(PHASES), dtype=torch.int64, device=b.device)
    _launch(b.contiguous(), A.contiguous(), lam.contiguous(), steps, prox, prof)
    return dict(zip(PHASES, prof.tolist()))


def check_cuda_operands(name, A, *vectors):
    """What a dense CUDA kernel takes: float32 tensors on one card; raises
    otherwise."""
    for t in (A, *vectors):
        if t.device.type != "cuda" or t.device != A.device:
            raise ValueError(f"{name}: unsupported device {t.device} (A on {A.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")


def cgnr_fused(b, A, lam, steps: int, prox="none"):
    """Batched CGNR on a dense real A, one CG step of the whole batch over
    every SM (the cut of :func:`plan_cgnr`).

    b: (P, m) float32, one problem per row; A: (m, n) float32; lam: (P,)
    the effective λ per problem; steps: the CG steps (min(iterations,
    n)); prox "none" | "positive". The plain version runs for CPU tensors,
    the CUDA kernel for CUDA tensors; a shape without a plan raises.
    ``cgnr_fused.launches`` counts the kernel's launches. Returns x (P, n).
    """
    if prox not in PROXES:
        raise ValueError(f"unknown prox {prox!r}; the CGNR kernel takes {PROXES}")
    if b.shape[-1] != A.shape[0]:
        raise ValueError(f"b has {b.shape[-1]} entries per problem, A has {A.shape[0]} rows")
    if b.device.type == "cpu":
        return cgnr_fused_torch(b, A, lam, steps, prox)
    check_cuda_operands("cgnr_fused", A, b, lam)
    return _launch(b.contiguous(), A.contiguous(), lam.contiguous(), steps, prox)


cgnr_fused.launches = 0


def check_dense_normal(solver, path):
    """The operator rules the dense kernels share: a DenseOperator A whose
    AᴴA is the default, unweighted NormalOperator of A itself."""
    if solver.A is None or not isinstance(solver.A, DenseOperator):
        raise ValueError(f"{path} requires a dense operator A")
    if not (
        isinstance(solver.AHA, NormalOperator)
        and solver.AHA.A is solver.A
        and solver.AHA.weights is None
    ):
        raise ValueError(
            f"{path} requires the default AHA = AᴴA normal operator "
            "(custom/weighted AHA: use the composed path)"
        )


def is_scalar(lam) -> bool:
    return torch.as_tensor(lam).ndim == 0


def check_cgnr_fused(solver):
    """Validate `solver` for the fused CGNR kernel (raises ValueError
    naming the unsupported piece); returns the in-kernel projection."""
    if not isinstance(solver, CGNR):
        raise ValueError("fused CGNR path requires a CGNR solver")
    check_dense_normal(solver, "fused CGNR path")
    if not is_scalar(solver.l2.get_lam()):
        raise ValueError(
            "fused CGNR path requires a scalar L2 λ (vector-λ Tikhonov: use the composed path)"
        )
    if any(isinstance(r, PositiveRegularization) for r in solver.constr):
        return "positive"
    return "none"  # the Real projection is the identity on real systems


def lam_per_problem(solver, reg, bt):
    """λ·normalization per problem (P,) in float32, the scale taken from
    the original operator and the columns `bt` (P, m)."""
    scale = normalization_factor(solver.normalize_reg, solver.A, bt)
    lam = reg.get_lam()
    lam = torch.as_tensor(lam.real if torch.is_tensor(lam) else lam, dtype=torch.float32,
                          device=bt.device)
    return (lam * scale.real.to(torch.float32)).expand(bt.shape[0]).contiguous()


def split_real_embedding(mat, bt):
    """The float32 split-real embedding of a complex system: M = [[Re A,
    −Im A], [Im A, Re A]] (2m, 2n) and [Re b, Im b] (P, 2m) per problem;
    A or b may be real."""
    ar = mat.real.to(torch.float32)
    ai = mat.imag.to(torch.float32) if mat.is_complex() else torch.zeros_like(ar)
    bi = bt.imag if bt.is_complex() else torch.zeros_like(bt)
    return (torch.cat([torch.cat([ar, -ai], 1), torch.cat([ai, ar], 1)], 0),
            torch.cat([bt.real, bi], 1).to(torch.float32))


def solve_cgnr_fused(solver, B_mat):
    """Drop-in fast path for ``solve_batched_unrolled(solver, B)`` on a
    dense CGNR solver: the whole batch runs as one launch (columns of
    ``B_mat`` are problems; returns n × K).

    Complex systems (complex A or complex b) ride the exact split-real
    embedding M = [[Re A, −Im A], [Im A, Re A]], x̃ = [Re x; Im x]:
    complex CGNR's recurrences coincide step for step with real CG on the
    embedded normal equations, and the Real/Positive projections act on
    the reassembled complex iterate after the kernel.
    """
    prox = check_cgnr_fused(solver)
    mat0 = solver.A.mat
    if B_mat.shape[0] != mat0.shape[0]:
        raise ValueError(f"B has {B_mat.shape[0]} rows, operator expects {mat0.shape[0]}")
    bt0 = B_mat.T
    lam = lam_per_problem(solver, solver.l2, bt0)
    is_cplx = mat0.is_complex() or B_mat.is_complex()
    if is_cplx:
        n_c = mat0.shape[1]
        mat, bt = split_real_embedding(mat0, bt0)
        prox = "none"  # the projections act on the complex iterate
    else:
        mat = mat0.to(torch.float32)
        bt = bt0.to(torch.float32)
    x = cgnr_fused(bt, mat, lam, solver.total_steps, prox)
    if not is_cplx:
        return x.T
    dt_c = mat0.dtype if mat0.is_complex() else B_mat.dtype
    xc = torch.complex(x[:, :n_c], x[:, n_c:]).to(dt_c)
    for rg in solver.constr:  # the finalize projections, in the reference's order
        xc = rg.prox(xc)
    return xc.T
