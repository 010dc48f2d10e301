"""The greedy-randomized Kaczmarz sweep as ONE launch: the hand-written CUDA
kernel ``csrc/kaczmarz_greedy.cu`` and its plain PyTorch version.

Counterpart of ``rls_tpu/kernels/kaczmarz_greedy.py``: ``_kernel``
(:53-161), ``kaczmarz_greedy_sweep_pallas`` (:164-265),
``check_kaczmarz_greedy`` (:268-300) and ``solve_kaczmarz_greedy``
(:303-367). One sweep is S steps of the reference's greedy mode
(Kaczmarz.jl:393-426) for every problem: score |r|², threshold it by
e_k, draw a row from the surviving weights by Gumbel-max (or take the
step's forced row), then x += α·a_row, vl_row += α·ε and
r −= r_row·Gt[row] with Gt = diag(denom)·(AAᵀ + λI). The solve runs T
sweeps, with the Positive projection and the residual refresh
r = u − ε·vl − A x between them.

The draws: ``rls_tpu`` draws with ``pltpu.prng_*`` (``jax.random`` in
interpret mode), which torch cannot repeat. Kernel and plain version share
a counter-based generator in integer arithmetic (`uniforms`): the uniform
of row k at step j of sweep t for problem p is a hash of (seed, t, p, j, k),
and the Gumbel noise −log(−log U) is taken in f32. On the card both
versions draw the same rows; ``forced_rows`` pins the sequence.

λ: ``rls_tpu`` recovers λ as ``norms[0] − rownorm²[0]`` in f32 (:333-334),
which for λ = 1e-6 beside row norms of order n is mostly rounding. The
port takes λ_eff from the solver's L2 term.

Real float32 dense systems only (the composed ``Kaczmarz`` covers the
rest), as in ``rls_tpu``; its VMEM gate has no counterpart.
"""

from __future__ import annotations

import torch

from ..models.prox import PositiveRegularization, RealRegularization
from ..models.solvers.kaczmarz import Kaczmarz, greedy_table_lam
from ..ops.base import DenseOperator
from .kaczmarz_streamed import check_indices, sweep_projection

__all__ = [
    "kaczmarz_greedy_sweep",
    "kaczmarz_greedy_sweep_torch",
    "check_kaczmarz_greedy",
    "greedy_operands",
    "greedy_solve",
    "solve_kaczmarz_greedy",
    "uniforms",
]

_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    """a·c mod 2³² for a < 2³² (an int or an int64 tensor), without
    leaving int64."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M32


def _lowbias32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniforms(seed: int, sweep: int, P: int, step: int, m: int, device):
    """(P, m) float32: the uniform of row k at this step for problem p,
    ((h >> 9) + 0.5)·2⁻²³ of the hash h of (seed, sweep, p, step, k) —
    bit for bit what the kernel draws."""
    pre = _lowbias32((_lowbias32(seed & _M32) + sweep) & _M32)
    pre = [_lowbias32((_lowbias32((pre + p) & _M32) + step) & _M32) for p in range(P)]
    pre = torch.tensor(pre, dtype=torch.int64, device=device)[:, None]
    h = _lowbias32((pre + torch.arange(m, dtype=torch.int64, device=device)) & _M32)
    return ((h >> 9).to(torch.float32) + 0.5) * 2.0**-23


def kaczmarz_greedy_sweep_torch(A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S: int,
                                seed: int, sweep: int, forced_rows=None):
    """Plain version of one S-step sweep, the problems batched inside each
    step; the arguments as for `kaczmarz_greedy_sweep`. Returns
    (x, vl, r, rows)."""
    P, m = r.shape
    dev, dt = r.device, r.dtype
    fnorm = torch.as_tensor(fnorm, dtype=dt, device=dev)
    theta_t = None if theta is None else torch.as_tensor(theta, dtype=dt, device=dev)
    x, vl, r = x.clone(), vl.clone(), r.clone()
    forced = None if forced_rows is None else forced_rows.tolist()
    ks = torch.arange(m, device=dev)
    pr = torch.arange(P, device=dev)
    rows = torch.empty((P, S), dtype=torch.int32, device=dev)
    for j in range(S):
        r2 = r * r
        dn = r2.double().sum(dim=-1).to(dt)
        mx = (r2 * denom).amax(dim=-1)
        safe = torch.where(dn > 0, dn, torch.ones_like(dn))
        q = mx / safe
        if theta_t is None:
            ek = 0.5 * (q + fnorm)
        else:
            ek = theta_t * q + (1.0 - theta_t) * fnorm
        lower = ek * safe
        if forced is not None and forced[j] >= 0:
            row = torch.full((P,), forced[j], dtype=torch.int64, device=dev)
        else:
            w = torch.where(r2 >= lower[:, None] * norms, r2, torch.zeros_like(r2))
            g = -torch.log(-torch.log(uniforms(seed, sweep, P, j, m, dev)))
            score = torch.where(w > 0, torch.log(torch.where(w > 0, w, torch.ones_like(w))) + g,
                                torch.full_like(w, -float("inf")))
            smax = score.amax(dim=-1, keepdim=True)
            row = torch.where(score >= smax, ks, m).amin(dim=-1)
        r_row = r[pr, row]
        alpha = denom[row] * r_row
        vl[pr, row] = vl[pr, row] + alpha * eps
        x = x + alpha[:, None] * A[row]
        r = r - r_row[:, None] * Gt[row]
        rows[:, j] = row
    return x, vl, r, rows


def _launch(A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S, seed, sweep, forced_rows):
    from .. import _build

    P, m = r.shape
    n = x.shape[1]
    lib = _build.load_library()
    x, vl, r = (t.contiguous().clone() for t in (x, vl, r))
    rows = torch.empty((P, S), dtype=torch.int32, device=r.device)
    forced = None if forced_rows is None else forced_rows.to(torch.int32).contiguous()
    with torch.cuda.device(r.device):
        code = lib.kaczmarz_greedy_launch(
            A.data_ptr(), Gt.data_ptr(), denom.data_ptr(), norms.data_ptr(), x.data_ptr(),
            vl.data_ptr(), r.data_ptr(), eps.data_ptr(),
            None if forced is None else forced.data_ptr(), rows.data_ptr(), P, m, n, S,
            float(fnorm), 0.0 if theta is None else float(theta), int(theta is not None),
            seed & _M32, sweep & _M32, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "kaczmarz_greedy_launch")
    if P > 0 and S > 0:  # the C entry point launched
        kaczmarz_greedy_sweep.launches += 1
    return x, vl, r, rows


def kaczmarz_greedy_sweep(A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S: int, seed: int,
                          sweep: int, forced_rows=None):
    """One S-step greedy sweep for P problems, one CTA per problem.

    A: (m, n) float32; Gt: (m, m), Gt[i] = denomᵢ·(AAᵀ + λI)[i]; denom,
    norms: (m,) (1/(rownorm² + λ), rownorm² + λ); x: (P, n); vl, r: (P, m);
    eps: (P,); fnorm: 1/(‖A‖_F² + λ); theta: the e_k mix, or None for ½;
    seed, sweep: the draw's counters; forced_rows: (S,) rows, −1 = draw
    (a row outside [−1, m) raises ValueError). The plain version runs for
    CPU tensors, the CUDA kernel for CUDA tensors.
    ``kaczmarz_greedy_sweep.launches`` counts the kernel's launches.
    Returns (x, vl, r, rows (P, S) int32)."""
    args = (A, Gt, denom, norms, x, vl, r, eps, fnorm, theta, S, seed, sweep, forced_rows)
    if forced_rows is not None:
        if forced_rows.shape != (S,):
            raise ValueError(f"kaczmarz_greedy_sweep: forced_rows of shape "
                             f"{tuple(forced_rows.shape)} for {S} steps")
        check_indices("kaczmarz_greedy_sweep (forced row, -1 = draw)", forced_rows, -1,
                     r.shape[1])
    if r.device.type == "cpu":
        return kaczmarz_greedy_sweep_torch(*args)
    for t in (A, Gt, denom, norms, x, vl, r, eps):
        if t.device != r.device or t.dtype != torch.float32:
            raise ValueError(f"kaczmarz_greedy_sweep: the CUDA kernel takes float32 on "
                             f"{r.device}, got {t.dtype} on {t.device}")
    if forced_rows is not None and forced_rows.device != r.device:
        raise ValueError(f"kaczmarz_greedy_sweep: forced_rows on {forced_rows.device}, "
                         f"r on {r.device}")
    return _launch(*(t.contiguous() for t in args[:8]), *args[8:])


kaczmarz_greedy_sweep.launches = 0


def check_kaczmarz_greedy(solver):
    """Validate `solver` for the greedy kernel (raises ValueError naming the
    unsupported piece); returns the projection between sweeps."""
    if not isinstance(solver, Kaczmarz):
        raise ValueError("greedy kernel requires a Kaczmarz solver")
    if not solver.greedy:
        raise ValueError("greedy kernel requires greedy_randomized=True")
    if not isinstance(solver.A, DenseOperator):
        raise ValueError("greedy kernel requires a dense operator")
    if solver.A.dtype != torch.float32:
        raise ValueError(f"greedy kernel is real float32 only, got {solver.A.dtype}; "
                         "use the composed path")
    if solver.tikhonov_inv_sqrt is not None:
        raise ValueError("greedy kernel does not support vector-λ Tikhonov")
    for r in solver.reg:
        if not isinstance(r, (PositiveRegularization, RealRegularization)):
            raise ValueError(
                "greedy kernel supports only Positive/Real projections, "
                f"got {type(r).__name__}"
            )
    return sweep_projection(solver)


def greedy_operands(solver, B_mat, dtype=torch.float32):
    """(A, Gt, denom, norms, eps, fnorm, bt) of the problems in B_mat's
    columns, in `dtype` (the kernel's float32, or float64 for a plain
    reference solve), all from the solver's greedy tables and the λ they
    were built with (greedy mode has no per-problem normalization):
    norms = rownorm² + λ, denom = 1/norms (0 on empty rows), εw = √λ,
    Gt = greedy_Bᵀ."""
    solver.A.check_device(B_mat)
    if B_mat.is_complex():
        raise ValueError("greedy kernel is real-only; use the composed path")
    bt = B_mat.T.to(dtype).contiguous()
    lam = greedy_table_lam(solver.l2, bt.device).to(dtype)
    eps = torch.sqrt(lam).expand(bt.shape[0]).contiguous()
    norms = solver.greedy_norms.to(dtype)
    rn2 = solver.A.row_norms_sq()
    denom = torch.where(rn2 > 0, 1.0 / norms, torch.zeros_like(norms))
    return (solver.A.mat.to(dtype).contiguous(), solver.greedy_B.T.to(dtype).contiguous(),
            denom, norms, eps, float(solver.greedy_fnorm), bt)


def greedy_solve(solver, B_mat, sweep=kaczmarz_greedy_sweep, forced_rows=None,
                 dtype=torch.float32):
    """The T-sweep greedy solve of the problems in B_mat's columns with the
    sweep function `sweep` (the kernel's wrapper, or its plain version in
    any `dtype`): x₀ = 0 and r = b; after each sweep the projection and
    r = b − ε·vl − A x. `forced_rows` (T, S) pins the rows. Returns
    (x (n, K), rows (T, K, S))."""
    prox = sweep_projection(solver)
    A, Gt, denom, norms, eps, fnorm, bt = greedy_operands(solver, B_mat, dtype)
    x = bt.new_zeros((bt.shape[0], A.shape[1]))
    vl = bt.new_zeros((bt.shape[0], A.shape[0]))
    r = bt.clone()
    rows = []
    for t in range(solver.iterations):
        fr = None if forced_rows is None else forced_rows[t]
        x, vl, r, rw = sweep(A, Gt, denom, norms, x, vl, r, eps, fnorm, solver.theta,
                             solver.sub_matrix_size, solver.seed, t, fr)
        rows.append(rw)
        if prox == "positive":
            x = torch.clamp(x, min=0.0)
        r = bt - eps[:, None] * vl - x @ A.T
    return x.T, torch.stack(rows)


def solve_kaczmarz_greedy(solver, B_mat, forced_rows=None):
    """Drop-in fast path for batched greedy-randomized Kaczmarz: each sweep
    is ONE launch of the greedy kernel; the between-sweep projection and
    residual refresh ride PyTorch. Returns the n × K solution matrix. The
    draws differ from the composed path's generator (the same per-step
    distribution); ``forced_rows`` (T, S) pins the row sequence."""
    check_kaczmarz_greedy(solver)
    return greedy_solve(solver, B_mat, forced_rows=forced_rows)[0]
