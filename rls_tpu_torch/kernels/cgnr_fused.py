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

Not carried over: the TPU's pre-split bf16 hi/lo factors and their VMEM
gate (:164), and ``chunked_batch_run`` (:67-83): the port launches one
grid over the whole batch.
"""

from __future__ import annotations

import torch

from ..models.prox import PositiveRegularization
from ..models.regularization import normalization_factor
from ..models.solvers.cgnr import CGNR
from ..ops.base import DenseOperator, NormalOperator

__all__ = [
    "cgnr_fused",
    "cgnr_fused_torch",
    "check_cgnr_fused",
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


def _launch(b, A, lam, steps, prox):
    from .. import _build

    P, m = b.shape
    n = A.shape[1]
    lib = _build.load_library()
    out = torch.empty((P, n), dtype=torch.float32, device=b.device)
    # the planes r, p, v (n each) and q (m) of every problem
    scratch = torch.empty((P, 3 * n + m), dtype=torch.float32, device=b.device)
    with torch.cuda.device(b.device):
        code = lib.cgnr_fused_launch(
            b.data_ptr(), A.data_ptr(), lam.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            P, m, n, steps, int(prox == "positive"), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "cgnr_fused_launch")
    cgnr_fused.launches += 1
    return out


def check_cuda_operands(name, A, *vectors):
    """What a dense CUDA kernel takes: float32 tensors on one card; raises
    otherwise."""
    for t in (A, *vectors):
        if t.device.type != "cuda" or t.device != A.device:
            raise ValueError(f"{name}: unsupported device {t.device} (A on {A.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")


def cgnr_fused(b, A, lam, steps: int, prox="none"):
    """Batched CGNR on a dense real A, one CTA per problem.

    b: (P, m) float32, one problem per row; A: (m, n) float32; lam: (P,)
    the effective λ per problem; steps: the CG steps (min(iterations,
    n)); prox "none" | "positive". The plain version runs for CPU tensors,
    the CUDA kernel for CUDA tensors. ``cgnr_fused.launches`` counts the
    kernel's launches. Returns x (P, n).
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
