#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rls_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: CUDA must be present; TF32 is switched off for matmuls and
     cuDNN; the card's name and power limit are printed;
  2. build: the seven CUDA sources are compiled from rls_tpu_torch/csrc
     (one nvcc per source, all at once);
  3. each kernel against its plain PyTorch version on the card, with both
     times: the TV prox and the fused solve (FISTA, OptISTA, POGM) at the
     flagship shapes (64 problems of 256², 50 × 10 iterations); the fused
     solve's dynamic and warm schedules (gradient restart, sigma_fac < 1,
     early exit, warm TV duals) at batch 8, with the per-problem restart
     and freeze counts of kernel and plain version side by side; the tiled
     solve at 512² (batch 16, 50 × 10), once at 1024² (batch 8), and its
     dynamic schedules at 512² (batch 4); the fused ADMM-TV solve at
     BASELINE configuration #3's shapes (16 distinct problems of 256², 12
     outer × 6 CG × 8 dual iterations) and the tiled ADMM-TV solve at 512²
     (batch 16, 10 × 5 × 10), each with a Positive case at batch 4 and the
     live CG steps of kernel and plain version side by side;
  4. the flagship through the public API: batched FISTA-TV deblurring,
     256², 9×9 Gaussian, 50×10 iterations, ρ = 0.95, λ = 5e-4, batch 64,
     through solve_batched_fast (fused kernel, one launch) and
     solve_batched_unrolled (TV kernel, one launch per FISTA iteration),
     held against the f64 reference solutions of bench_ref_f64.npz; the
     OptISTA and POGM flagship through solve_batched_fast;
  5. the 512² cell of tools/bench_suite.py (fista_tv_512_tiled_b16: 9×9
     Gaussian σ = 2, ρ = 0.95, λ = 5e-4, 50 × 10, batch 16) through
     solve_batched_fast, which must run the tiled kernel, held on two
     columns against a float64 solve of the plain version on the card;
  6. the two ADMM-TV cells of tools/bench_suite.py: admm_tv_deblur256_b16
     (ρ = 0.1, λ = 2e-3, 12 × 6 × 8) through solve_batched_fast (one fused
     launch) and through solve_batched_unrolled (the composed ADMM, one TV
     kernel launch per outer iteration), and admm_tv_512_tiled_b16 (ρ =
     0.1, λ = 5e-4, 10 × 5 × 10) through solve_batched_fast (the tiled
     kernel), each held on two columns against a float64 solve of the
     plain version on the card, with a torch.profiler breakdown of the
     device time of one solve of each;
  3g. each dense kernel against its plain version, held to the plain
     version's own spread under b·(1 + 2⁻²³) in the same run and to the
     restart-count rule (DENSE_SPREAD): the fused CGNR on the 64×64 cell,
     the 1024×512 cell, with Positive at batch 4 and on a complex A
     through the split-real embedding; the dense FISTA / OptISTA / POGM on
     the LASSO cell (600 iterations, and 100 for the restart schedules,
     the table methods and FISTA-L2 with Positive); the plane kernel on a
     complex A (FISTA with gradient restart and Real, POGM) and on the real
     A with a complex b;
  8. the dense cells through solve_batched_fast, each running its kernel
     once by the launch counters, with problems/s:
     cgnr_l2_dense64_fused_b16 (printed against a float64 DirectSolver;
     the refined CGNR, 3 rounds on 4 columns, held to TOL_PARITY and
     TOL_RESIDUAL), cgnr_l2_dense_1024x512_b64 (held on 4 columns, with a
     torch.linalg.solve yardstick), fista_l1_dense_cs_b16_fused (held to
     TOL_RESIDUAL on 2 columns against a float64 solve of the plain
     version), its OptISTA and POGM at 100 iterations, and the complex
     FISTA case;
  7. the kernel table as one JSON line (launches on the main path, error
     against the plain version, kernel and plain times, and the least
     time the card could take, `bound_ms`), then the result line
     {"ok": true, "device": {...}}.

Phase 8 runs after phase 6; the table and the result line come last. The
flagship problem is rebuilt with numpy exactly as bench.py:36-68 builds
it, the other cells as tools/bench_suite.py:79-102, :127-151, :204-225
and :308-379 build them (replaying its seeded generator).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N, BATCH, ITERS, TV_ITERS, LAM, RHO = 256, 64, 50, 10, 5e-4, 0.95
BATCH_DYN = 8  # the dynamic and warm schedules of the fused kernel
# kernel vs plain version. FMA contraction in the kernels gives ~1 ulp
# per op. The TV prox (10 dual iterations) stays within 1e-5 of max|x|.
# The 50 × 10 solves amplify ulps: on an H100, a 1-ulp perturbation of
# x0hat moves the plain FISTA solve itself by 7.1e-6 in relative 2-norm
# and 5.8e-4 (1.7e-4 of max|x|) at its worst pixel, growing smoothly from
# 1e-7 after one iteration. Every solve kernel is held to twice that
# spread in norm and to 1e-3 of max|x| at any pixel; each schedule's own
# spread is measured again in every run and printed beside its error.
TOL_TV = 1e-5
TOL_FUSED_NORM = 2e-5
TOL_FUSED_MAX = 1e-3
# ADMM's scaled dual u integrates every CG difference over the outer
# iterations, so an ADMM kernel is held to the plain version's own spread
# under a 1-ulp change of x0hat, measured in the same run: within
# ADMM_SPREAD times that spread, in 2-norm and at the worst pixel
ADMM_SPREAD = 2.0
# BASELINE configuration #3 (tools/bench_suite.py:127-151) and its 512²
# sibling (:340-354): (n, batch, λ, outer, CG, dual iterations); ρ = 0.1
ADMM_RHO, ADMM_TOL = 0.1, 1e-5
ADMM256 = (256, 16, 2e-3, 12, 6, 8)
ADMM512 = (512, 16, 5e-4, 10, 5, 10)
# the dense cells: tools/bench_suite.py:79-102 (CGNR, 64×64, λ = 1e-6, 200
# iterations = 64 steps, batch 16) and :204-225 (FISTA-L1 on 256×512, λ =
# 1e-4, ρ = 0.95/‖A‖₂², 600 iterations, batch 16; its restart schedules,
# OptISTA, POGM and the complex cases run 100 iterations), and the 1024×512
# CGNR at the JAX kernels' largest size class (λ = 1e-3, 64 iterations,
# batch 64). On the 64×64 CGNR and the 600-iteration LASSO a 1-ulp change
# of b moves the f32 solve by ~1e-2, so each dense kernel is held to the
# plain version's own spread under b·(1 + 2⁻²³), measured in the same run:
# within max(DENSE_SPREAD × spread, DENSE_FLOOR) in relative 2-norm and
# 1e-3 of max|x| at any entry, and its restart counts to Σ|kernel − plain|
# ≤ 2·Σ|plain − plain(1 ulp)| + 1. The accuracy bars of these cells are
# the refined CGNR's and the well-conditioned 1024×512 CGNR's (TOL_PARITY
# and TOL_RESIDUAL against a float64 DirectSolver) and the LASSO's
# residual (TOL_RESIDUAL against a float64 solve of the plain version).
CGNR64_LAM, CGNR64_ITERS = 1e-6, 200
CGNR1K_LAM, CGNR1K_ITERS = 1e-3, 64
LASSO_LAM, LASSO_ITERS, SHORT_ITERS = 1e-4, 600, 100
DENSE_SPREAD, DENSE_FLOOR = 2.0, 1e-5
# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): f32
# outside the tensor cores, and HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# against the f64 reference (the bars the TPU flagship is held to)
TOL_PARITY = 1e-3
TOL_RESIDUAL = 1e-4


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gaussian_kernel(k=9, sigma=2.0):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    kern = np.outer(g, g)
    return kern / kern.sum()


def phantoms(n=N, batch=BATCH):
    """bench.py's seeded piecewise-constant phantoms, (batch, n²) f32."""
    rng = np.random.default_rng(0)
    imgs = np.zeros((batch, n, n), np.float32)
    for b in range(batch):
        for _ in range(6):
            x0, y0 = rng.integers(0, n - 32, size=2)
            w, h = rng.integers(16, 64, size=2)
            imgs[b, x0 : x0 + w, y0 : y0 + h] += rng.normal()
    return imgs.reshape(batch, n * n)


def bench_suite_draws():
    """The seeded draws of tools/bench_suite.py that this run rebuilds,
    from its generator default_rng(0) replayed through the other cells'
    draws (:81-294): the dense CGNR cell's A (64×64) and XT1 (64×16,
    :80-96), the ADMM-TV deblurring image (256², :132-135), the dense LASSO
    cell's A (256×512) and sparse X (512×16, 5% nonzero, :208-211), and the
    512² batch of 16 (:326-331) and 1024² batch of 8 (:367-372) of
    phantoms; all float32, the images flattened."""
    rng = np.random.default_rng(0)
    a64 = (rng.normal(size=(64, 64)).astype(np.float32) / np.float32(8.0)).astype(np.float32)
    rng.normal(size=(64,))
    xt1 = rng.normal(size=(64, 16)).astype(np.float32)
    for _ in range(8):
        rng.integers(0, 256 - 20, 2), rng.uniform(0.3, 1.0)
    rng.choice(256 * 256, size=int(0.35 * 256 * 256), replace=False)
    img3 = np.zeros((256, 256), np.float32)
    for _ in range(6):
        i0, j0 = rng.integers(0, 256 - 40, 2)
        img3[i0 : i0 + 30, j0 : j0 + 30] += rng.uniform(0.3, 1.0)
    a2b = (rng.normal(size=(256, 512)) / np.sqrt(256)).astype(np.float32)
    x2b = (rng.normal(size=(512, 16)) * (rng.uniform(size=(512, 16)) < 0.05)).astype(np.float32)
    rng.normal(size=(1024, 256)), rng.uniform(size=(1024, 256)), rng.normal(size=(256,))
    rng.normal(size=(8192, 2048)), rng.normal(size=(2048,))
    out = {"cgnr64": (a64, xt1), "admm": img3.reshape(-1), "lasso": (a2b, x2b)}
    for n, batch, margin, lo, hi in ((512, 16, 64, 16, 128), (1024, 8, 128, 32, 256)):
        imgs = np.zeros((batch, n, n), np.float32)
        for b in range(batch):
            for _ in range(6):
                i0, j0 = rng.integers(0, n - margin, size=2)
                w, h = rng.integers(lo, hi, size=2)
                imgs[b, i0 : i0 + w, j0 : j0 + h] += rng.normal()
        out[n] = imgs.reshape(batch, n * n)
    return out


def dense_systems(draws):
    """The dense systems of phases 3g and 8, as numpy (A, B with one
    problem per column): the two cells of tools/bench_suite.py
    (cgnr_l2_dense64_fused_b16, fista_l1_dense_cs_b16_fused), the 1024×512
    CGNR cell (A = N(0,1)/√1024, XT = N(0,1) 512×64, default_rng(1)), a
    complex A of 256×512 with entries (N + iN)/√(2·256) and the LASSO
    cell's X as its phantoms (default_rng(2)), and the LASSO cell's real A
    with a complex b (a second sparse X from the same generator as the
    imaginary part)."""
    a64, xt1 = draws["cgnr64"]
    a2b, x2b = draws["lasso"]
    rng = np.random.default_rng(1)
    a1k = (rng.normal(size=(1024, 512)) / np.sqrt(1024)).astype(np.float32)
    x1k = rng.normal(size=(512, 64)).astype(np.float32)
    rng = np.random.default_rng(2)
    ac = ((rng.normal(size=(256, 512)) + 1j * rng.normal(size=(256, 512)))
          / np.sqrt(2 * 256)).astype(np.complex64)
    xi = (rng.normal(size=(512, 16)) * (rng.uniform(size=(512, 16)) < 0.05)).astype(np.float32)
    return {
        # bench_suite multiplies the float64 quotient A / √64 (numpy ≥ 2)
        "cgnr64": (a64, (a64.astype(np.float64) @ xt1).astype(np.float32)),
        "cgnr1k": (a1k, (a1k.astype(np.float64) @ x1k).astype(np.float32)),
        "lasso": (a2b, a2b @ x2b),
        "cplx": (ac, (ac @ x2b.astype(np.complex64)).astype(np.complex64)),
        "real_a_cplx_b": (a2b, (a2b @ x2b + 1j * (a2b @ xi)).astype(np.complex64)),
    }


def build_solver(n, device, cls="FISTA", dtype=None):
    """The bench's deblurring solver at n² (9×9 Gaussian σ = 2, ρ = 0.95,
    λ = 5e-4, 50 × 10), TV on the CUDA kernel."""
    import torch

    import rls_tpu_torch as rtt

    op = rtt.SeparableConvOperator.from_kernel(
        gaussian_kernel(), im_shape=(n, n), dtype=dtype or torch.float32, device=device
    )
    kw = {"track_residual": False} if cls == "FISTA" else {}
    return getattr(rtt, cls).create(
        op,
        reg=rtt.TVRegularization(LAM, shape=(n, n), iterations_tv=TV_ITERS, backend="cuda"),
        iterations=ITERS,
        rho=RHO,
        rel_tol=0.0,
        **kw,
    )


def build_admm(cell, device, dtype=None):
    """The ADMM-TV deblurring solver of an ADMM cell (9×9 Gaussian σ = 2,
    ρ = 0.1, tol_inner 1e-5, masked CG), TV on the CUDA kernel."""
    import torch

    import rls_tpu_torch as rtt

    n, _, lam, iters, cg, tv = cell
    op = rtt.SeparableConvOperator.from_kernel(
        gaussian_kernel(), im_shape=(n, n), dtype=dtype or torch.float32, device=device
    )
    return rtt.ADMM.create(
        op,
        reg=rtt.TVRegularization(lam, shape=(n, n), iterations_tv=tv, backend="cuda"),
        iterations=iters, iterations_cg=cg, unroll_cg=True, rho=ADMM_RHO, tol_inner=ADMM_TOL,
    )


def build_flagship(device, batch=BATCH, cls="FISTA"):
    """(solver, B (n², batch), xs_true (batch, n²)) on `device`; the first
    columns of B are the reference's own measurements."""
    import torch

    solver = build_solver(N, device, cls)
    op = solver.A
    xs = torch.from_numpy(phantoms(batch=batch)).to(device)
    B = op.mv(xs).T.contiguous()
    ref = np.load(os.path.join(ROOT, "bench_ref_f64.npz"))
    b64 = torch.from_numpy(ref["b64"].astype(np.float32)).to(device)
    n_ref = int(ref["n_ref"])
    # the same phantoms as the reference's, blurred there with bf16 hi/lo
    # compensated products (~2⁻¹⁶ relative), here with plain f32 ones
    dev = float((B[:, :n_ref] - b64).abs().max() / b64.abs().max())
    require(dev <= 1e-4, f"rebuilt measurements differ from the reference's by {dev:.2e}")
    B[:, :n_ref] = b64
    return solver, B, xs


def parity(x, ref):
    """(max column rel. error vs x64, max |‖Ax − b‖ − r64| / ‖b‖) over
    the reference columns, with the residual taken by an f64 convolution
    as bench.py:184-200 does."""
    from scipy.signal import convolve2d

    n_ref = int(ref["n_ref"])
    x64, b64, r64 = ref["x64"].astype(np.float64), ref["b64"], ref["r64"]
    xc = x[:, :n_ref].astype(np.float64)
    rel = max(
        np.linalg.norm(xc[:, j] - x64[:, j]) / np.linalg.norm(x64[:, j])
        for j in range(n_ref)
    )
    kern = gaussian_kernel()
    res = max(
        abs(
            np.linalg.norm(
                convolve2d(xc[:, j].reshape(N, N), kern, mode="same", boundary="fill").ravel()
                - b64[:, j]
            )
            - r64[j]
        )
        / np.linalg.norm(b64[:, j])
        for j in range(n_ref)
    )
    return float(rel), float(res)


def cuda_ms(fn, reps):
    """Mean milliseconds of `fn()` over `reps` runs, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def alternate_ms(plain, kernel, reps):
    """Times of (plain, kernel) taken in turns: plain, kernel, kernel,
    plain, after one warm-up of each."""
    plain(), kernel()
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (p1 + p2) / 2, (k1 + k2) / 2


def bound(ops, nbytes):
    """(ms, "operations" | "bytes"): the least time the card could take for
    `ops` f32 operations and `nbytes` of device-memory traffic."""
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stencil_ops(kh, kw):
    """f32 operations per pixel of AᴴA as four stencil passes (K products
    and K − 1 sums each)."""
    return 2 * (2 * kh - 1) + 2 * (2 * kw - 1)


def fold_fgp_ops(tv):
    """Per pixel, the fold FGP with `tv` dual iterations from zero duals:
    the first a gradient of xg/8 and two clips (7), each later one the
    adjoint, the scaled step, two gradients, two clips and the momentum
    (19), then x = xg − gtᵀ(p) (4)."""
    return 0 if tv == 0 else 19 * tv - 8


def fgp_loop_ops(tv):
    """Per pixel, the fori FGP of the TV prox kernel: 23 per dual iteration
    (adjoint, λ scale, two gradients with 1/8λ, clip and mask, momentum),
    5 for the result."""
    return 23 * tv + 5


def pgm_ops(kh, kw, tv, method="fista", restart="none", early=False, warm=False):
    """Per pixel and live iteration of a PGM-TV schedule: AᴴA, the prox
    and the method's own steps (FISTA: momentum 3, residual and gradient
    step 3; OptISTA: residual 1, prox input 2, z 3, x 5; POGM: residual 1,
    y 2, x_mid 7); a restart's dots (FISTA 3, gradient mapping 4; POGM's
    w and its two dots 11); the early-exit ‖res‖² (2); a warm start's
    full first dual iteration (12 more than from zero duals)."""
    own = {"fista": 6, "optista": 11, "pogm": 10}[method]
    extra = {"none": 0, "gradient": 11 if method == "pogm" else 3, "gradient_mapping": 4}[restart]
    return stencil_ops(kh, kw) + own + fold_fgp_ops(tv) + extra + 2 * early + 12 * warm


def admm_ops(kh, kw, tv, iterations, live_steps, positive):
    """Per pixel of one problem's ADMM-TV solve, counting only the CG steps
    that were live: per outer iteration the CG start (β, AᴴA + ρI, r and
    two squared norms: stencil + 10) and the z-update (x + u, the prox,
    u: fold FGP + 3, and the projection); per live step the matvec, p·q,
    the x, r and p updates and r·r (stencil + 12)."""
    s = stencil_ops(kh, kw)
    return iterations * (s + 10 + fold_fgp_ops(tv) + 3 + int(positive)) + live_steps * (s + 12)


def hold_to_plain(name, kernel, plain, x0hat, show_counts=False, spread=None):
    """Run `kernel(x0hat)` and `plain(x0hat)` (each → (x, counts)), and
    the plain version once more with x0hat moved by 1 ulp; print the
    error and the plain version's own spread (with `show_counts`, also the
    per-problem counts of all three, which must agree between kernel and
    plain: restarts fired and live iterations, or, for a (B,) count, the
    live CG steps); hold the kernel to TOL_FUSED_NORM in 2-norm and
    TOL_FUSED_MAX of max|x| per pixel, or with `spread` to `spread` times
    the plain version's spread in both. Returns max|kernel − plain|."""
    import torch

    got, counts = kernel(x0hat)
    want, want_counts = plain(x0hat)
    ulp, ulp_counts = plain(torch.nextafter(x0hat, torch.full_like(x0hat, float("inf"))))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    norm = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    scale = float(want.abs().max())
    ulp_max = float((ulp - want).abs().max())
    ulp_norm = float(torch.linalg.norm(ulp - want) / torch.linalg.norm(want))
    print(
        f"{name}: max|kernel - plain| = {err:.3e} (max|x| {scale:.3f}), rel. 2-norm "
        f"{norm:.3e}; plain under a 1-ulp input change: max {ulp_max:.3e}, rel. 2-norm "
        f"{ulp_norm:.3e}"
    )
    if show_counts and counts.ndim == 1:
        print(f"{name}: live CG steps kernel {counts.tolist()} plain {want_counts.tolist()} "
              f"plain(1 ulp) {ulp_counts.tolist()}")
    elif show_counts:
        print(
            f"{name}: restarts kernel {counts[:, 0].tolist()} plain "
            f"{want_counts[:, 0].tolist()} plain(1 ulp) {ulp_counts[:, 0].tolist()}; "
            f"live iterations kernel {counts[:, 1].tolist()} plain "
            f"{want_counts[:, 1].tolist()} plain(1 ulp) {ulp_counts[:, 1].tolist()}"
        )
    require(torch.isfinite(got).all(), f"{name} kernel gave non-finite values")
    require(counts.tolist() == want_counts.tolist(),
            f"{name}: the kernel's counts differ from the plain version's")
    if spread is None:
        ok = norm <= TOL_FUSED_NORM and err <= TOL_FUSED_MAX * scale
    else:
        ok = norm <= spread * ulp_norm and err <= spread * ulp_max
    require(ok, f"{name} kernel disagrees: max {err:.3e}, rel. 2-norm {norm:.3e}")
    return err


def parity_f64(name, x, B, xs_true, op64, x64):
    """Hold the first columns of a solve `x` (n × K) to the float64
    solutions `x64` (k × n) of the same measurements: the worst column-wise
    relative error (≤ TOL_PARITY) and |‖A x − b‖ − ‖A x64 − b‖| / ‖b‖ with
    A in float64 (≤ TOL_RESIDUAL); and the reconstruction against the
    phantoms `xs_true` (K × n) must beat the blurred input."""
    import torch

    k = x64.shape[0]
    require(bool(torch.isfinite(x).all()), f"{name}: non-finite values")
    xc = x[:, :k].T.double()
    b64 = B[:, :k].T.double()
    rel = float(max(torch.linalg.norm(xc[j] - x64[j]) / torch.linalg.norm(x64[j])
                    for j in range(k)))
    def resid(v, j):
        return torch.linalg.norm(op64.mv(v) - b64[j])

    res = float(max(
        abs(resid(xc[j], j) - resid(x64[j], j)) / torch.linalg.norm(b64[j])
        for j in range(k)
    ))
    rec = float(torch.linalg.norm(x.T - xs_true) / torch.linalg.norm(xs_true))
    blur = float(torch.linalg.norm(B.T - xs_true) / torch.linalg.norm(xs_true))
    print(f"{name}: recon_rel_err {rec:.4f} (blurred {blur:.4f}), max_rel_err vs f64 {rel:.3e}, "
          f"residual_rel_diff vs f64 {res:.3e}")
    require(rec < blur, f"{name}: the reconstruction is no better than the blur")
    require(rel <= TOL_PARITY, f"{name}: max_rel_err vs f64 {rel:.3e}")
    require(res <= TOL_RESIDUAL, f"{name}: residual_rel_diff vs f64 {res:.3e}")


def admm_f64(cell, B, k, device):
    """(A in float64, the float64 plain ADMM-TV solve of B's first k
    columns, (k, n²))."""
    import torch

    from rls_tpu_torch.kernels import admm_tv_fused as admm_fused

    n, _, lam, iters, cg, tv = cell
    s64 = build_admm(cell, device, dtype=torch.float64)
    x0 = s64.A.rmv_stencil(B[:, :k].T.double()).reshape(k, n, n)
    scal, t2 = admm_fused.kernel_args(x0, ADMM_RHO, lam, tv, dtype=np.float64)
    x64 = admm_fused.admm_tv_fused_torch(x0, scal, t2, s64.A.taps_hw(), iters, cg, ADMM_TOL)[0]
    return s64.A, x64.reshape(k, -1)


def device_breakdown(name, fn):
    """torch.profiler over one call of `fn` after a warm-up: print the
    wall time of one call without the profiler, the device time by kernel
    (the five largest) and the device's busy share of that wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            rows.append((ms, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    top = "; ".join(f"{key[:60]} {ms:.3f} ms ({count}×)" for ms, count, key in rows[:5])
    print(f"profile[{name}]: wall {wall:.2f} ms without the profiler, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%); {top or 'the profiler saw no device time'}")


def launch_counts(reset=False):
    """The launch counters of the eight kernel wrappers, by name; with
    `reset`, set them to 0 first."""
    from rls_tpu_torch.kernels import admm_tv_fused, admm_tv_tiled, cgnr_fused, fista_tv_fused
    from rls_tpu_torch.kernels import fista_tv_tiled, pgm_dense_fused, tv_fgp

    fns = (tv_fgp.prox_tv2d_fgp, fista_tv_fused.fista_tv_fused, fista_tv_tiled.fista_tv_tiled,
           admm_tv_fused.admm_tv_fused, admm_tv_tiled.admm_tv_tiled, cgnr_fused.cgnr_fused,
           pgm_dense_fused.pgm_dense_fused, pgm_dense_fused.pgm_dense_fused_cplx)
    if reset:
        for fn in fns:
            fn.launches = 0
    return {fn.__name__: fn.launches for fn in fns}


def admm_kernel_phase(dev, cases):
    """Each ADMM-TV kernel against its plain version: `cases` holds
    (cell, kernel wrapper, phantoms (batch, n²)); x0hat is the exact
    adjoint of the blurred phantoms. Each is held to the plain version's
    1-ulp spread with equal live CG steps, at the cell's batch and with
    the Positive projection at batch 4, and timed in turns with its plain
    version; then the other kernel at the same size is timed alone.
    Returns {wrapper name: {"err", "ms": (plain, kernel), "live"}}."""
    import torch

    from rls_tpu_torch.kernels import admm_tv_fused as admm_fused

    def pair(cell, wrapper, taps, prox="none"):
        _, _, lam, iters, cg, tv = cell

        def kernel(x0):
            return wrapper(x0, taps, ADMM_RHO, lam, iters, cg, tv, ADMM_TOL, prox=prox,
                           with_counts=True)

        def plain(x0):
            scal, t2 = admm_fused.kernel_args(x0, ADMM_RHO, lam, tv)
            return admm_fused.admm_tv_fused_torch(x0, scal, t2, taps, iters, cg, ADMM_TOL, prox)

        return kernel, plain

    out, x0s = {}, []
    for cell, wrapper, imgs in cases:
        n, batch = cell[:2]
        op = build_admm(cell, dev).A
        taps = op.taps_hw()
        x0 = op.rmv_stencil(op.mv(torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)))
        x0 = x0.reshape(batch, n, n)
        x0s.append((cell, taps, x0))
        label = f"{wrapper.__name__}[{n}², batch {batch}]"
        kernel, plain = pair(cell, wrapper, taps)
        err = hold_to_plain(label, kernel, plain, x0, show_counts=True, spread=ADMM_SPREAD)
        err = max(err, hold_to_plain(
            f"{wrapper.__name__}[{n}², batch 4, positive]", *pair(cell, wrapper, taps, "positive"),
            x0[:4].contiguous(), show_counts=True, spread=ADMM_SPREAD))
        live = kernel(x0)[1].tolist()
        ms = alternate_ms(lambda: plain(x0), lambda: kernel(x0), reps=3)
        print(f"{label}: kernel {ms[1]:.3f} ms, plain {ms[0]:.3f} ms")
        out[wrapper.__name__] = {"err": err, "ms": ms, "live": live}
    # each size on the other kernel, timed only (the dispatch stays
    # ≤ 256² → fused)
    wrappers = [w for _, w, _ in cases]
    for (cell, taps, x0), wrapper in zip(x0s, wrappers[::-1]):
        kernel, _ = pair(cell, wrapper, taps)
        ms = cuda_ms(lambda: kernel(x0), reps=3)
        print(f"{wrapper.__name__} at {cell[0]}², batch {cell[1]}: {ms:.3f} ms "
              f"({cell[1] / (ms / 1e3):.1f} problems/s)")
    return out


def admm_cell_phase(name, cell, dev, imgs, launches, composed=False):
    """An ADMM-TV cell of tools/bench_suite.py through solve_batched_fast:
    the phantoms `imgs` (batch, n²) blurred by the cell's operator, the
    launch counters set to 0 just before the solve and read just after
    (they must equal `launches`, every other counter 0), two columns held
    to a float64 solve of the plain version on the card, problems/s, and
    the device breakdown of one solve. With `composed`, the same through
    solve_batched_unrolled (the composed ADMM: one TV kernel launch per
    outer iteration)."""
    import torch

    import rls_tpu_torch as rtt

    n, batch, _, iters = cell[:4]
    solver = build_admm(cell, dev)
    xs = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
    B = solver.A.mv(xs).T.contiguous()
    op64, x64 = admm_f64(cell, B, 2, dev)
    runs = [(name, rtt.solve_batched_fast, launches)]
    if composed:
        runs.append((f"{name} composed", rtt.solve_batched_unrolled, {"prox_tv2d_fgp": iters}))
    counts = []
    for label, solve, want in runs:
        launch_counts(reset=True)
        x = solve(solver, B)
        torch.cuda.synchronize()
        got = launch_counts()
        counts.append(got)
        print(f"launches ({label}): {got}")
        require(got == {**{k: 0 for k in got}, **want},
                f"{label}: expected the launches {want} and no others")
        require(tuple(x.shape) == (n * n, batch), f"{label}: shape {tuple(x.shape)}")
        parity_f64(label, x, B, xs, op64, x64)
        ms = cuda_ms(lambda: solve(solver, B), reps=3)
        print(f"{label}: {batch / (ms / 1e3):.1f} problems/s ({ms:.2f} ms per batch of {batch})")
    device_breakdown(name, lambda: rtt.solve_batched_fast(solver, B))
    return counts[0]


def dense_pgm_ops(m, n, iterations, cplx=False):
    """f32 operations of one dense PGM solve per problem: x0hat = Aᴴb
    (2mn, ×4 complex), and per iteration the matvec pair (4mn, ×4 complex)
    and the entry-wise work: FISTA's momentum (3), residual (1), gradient
    step (2), the L1 prox (6) and a restart dot (3), doubled on the two
    planes of complex data."""
    c = 4 if cplx else 1
    return c * 2 * m * n + iterations * (c * 4 * m * n + (2 if cplx else 1) * 15 * n)


def hold_dense(name, kernel, plain, b, counts=True):
    """Run `kernel(*b)` and `plain(*b)` (each → (x, counts)), and the plain
    version once more on b·(1 + 2⁻²³); print the error and the plain
    version's own spread, and the per-problem restart counts of all three
    with `counts`. The kernel must lie within max(DENSE_SPREAD × spread,
    DENSE_FLOOR) in relative 2-norm and within TOL_FUSED_MAX of max|x| at
    any entry, and its counts must obey Σ|kernel − plain| ≤ 2·Σ|plain −
    plain(1 ulp)| + 1. Returns max|kernel − plain|."""
    import torch

    got, kc = kernel(*b)
    want, pc = plain(*b)
    ulp, uc = plain(*(t * (1.0 + 2.0**-23) for t in b))
    torch.cuda.synchronize()
    norm = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    spread = float(torch.linalg.norm(ulp - want) / torch.linalg.norm(want))
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    bar = max(DENSE_SPREAD * spread, DENSE_FLOOR)
    print(f"{name}: max|kernel - plain| = {err:.3e} (max|x| {scale:.3f}), rel. 2-norm "
          f"{norm:.3e}; plain under b(1 + 2^-23): rel. 2-norm {spread:.3e} (bar {bar:.3e})")
    require(bool(torch.isfinite(got).all()), f"{name} kernel gave non-finite values")
    require(norm <= bar and err <= TOL_FUSED_MAX * scale,
            f"{name} kernel disagrees: max {err:.3e}, rel. 2-norm {norm:.3e}")
    if counts:
        d_kernel = int((kc - pc).abs().sum())
        d_plain = int((pc - uc).abs().sum())
        print(f"{name}: restarts kernel {kc.tolist()} plain {pc.tolist()} "
              f"plain(1 ulp) {uc.tolist()}")
        require(d_kernel <= 2 * d_plain + 1,
                f"{name}: the restart counts differ by {d_kernel} (plain's own: {d_plain})")
    return err


def dense_kernel_phase(dev, systems):
    """Phase 3g: each dense kernel against its plain version at the dense
    cells' shapes (`hold_dense`), and each kernel timed in turns with its
    plain version at its main-path shape (the 1024×512 CGNR cell, the
    600-iteration LASSO cell, the complex FISTA case). Returns {kernel:
    {"err", "ms": (plain, kernel)}}."""
    import torch

    from rls_tpu_torch.kernels import cgnr_fused as cg
    from rls_tpu_torch.kernels import pgm_dense_fused as pd

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = {k: {"err": 0.0} for k in ("cgnr_fused", "pgm_dense_fused", "pgm_dense_fused_cplx")}

    def note(kernel, err):
        out[kernel]["err"] = max(out[kernel]["err"], err)

    # CGNR: the two cells, Positive at batch 4, and the complex A through
    # the split-real embedding
    a_c, b_c = systems["cplx"]
    emb_a, emb_b = cg.split_real_embedding(t(a_c), t(b_c.T))
    cases = (
        ("cgnr_l2_dense64_fused_b16", *map(t, systems["cgnr64"]), CGNR64_LAM, CGNR64_ITERS,
         "none"),
        ("cgnr_l2_dense_1024x512_b64", *map(t, systems["cgnr1k"]), CGNR1K_LAM, CGNR1K_ITERS,
         "none"),
        ("1024x512, batch 4, positive", t(systems["cgnr1k"][0]), t(systems["cgnr1k"][1][:, :4]),
         CGNR1K_LAM, CGNR1K_ITERS, "positive"),
        ("complex 256x512 embedded, batch 16", emb_a, emb_b.T, CGNR1K_LAM, 64, "none"),
    )
    for label, A, B, lam, iters, prox in cases:
        bt = B.T.contiguous()
        lam_v = torch.full((bt.shape[0],), lam, device=dev)
        steps = min(iters, A.shape[1])

        def kernel(b, A=A, lam_v=lam_v, steps=steps, prox=prox):
            return cg.cgnr_fused(b, A, lam_v, steps, prox), None

        def plain(b, A=A, lam_v=lam_v, steps=steps, prox=prox):
            return cg.cgnr_fused_torch(b, A, lam_v, steps, prox), None

        note("cgnr_fused", hold_dense(f"cgnr_fused[{label}]", kernel, plain, (bt,),
                                      counts=False))
        if label.startswith("cgnr_l2_dense_1024"):
            out["cgnr_fused"]["ms"] = alternate_ms(lambda: plain(bt), lambda: kernel(bt), reps=3)

    # dense PGM on the LASSO cell's real A
    a2b, b2b = systems["lasso"]
    A, bt = t(a2b), t(b2b.T)
    rho = 0.95 / float(np.linalg.norm(a2b, 2)) ** 2
    for method, restart, kind, prox, iters in (
        ("fista", "none", "l1", "none", LASSO_ITERS),
        ("fista", "gradient", "l1", "none", SHORT_ITERS),
        ("fista", "gradient_mapping", "l1", "none", SHORT_ITERS),
        ("optista", "none", "l1", "none", SHORT_ITERS),
        ("pogm", "none", "l1", "none", SHORT_ITERS),
        ("fista", "none", "l2", "positive", SHORT_ITERS),
    ):
        sched = (iters, method, kind, restart, prox)

        def kernel(b, sched=sched):
            return pd.pgm_dense_fused(b, A, LASSO_LAM, rho, 1.0, *sched, with_counts=True)

        def plain(b, sched=sched):
            scal, tab = pd.kernel_args(b, LASSO_LAM, rho, 1.0, sched[1], sched[0])
            return pd.pgm_dense_fused_torch(b, A, scal, tab, *sched)

        label = f"pgm_dense_fused[{method}-{kind}, restart {restart}, {prox}, {iters} it.]"
        note("pgm_dense_fused", hold_dense(label, kernel, plain, (bt,)))
        if iters == LASSO_ITERS:
            out["pgm_dense_fused"]["ms"] = alternate_ms(lambda: plain(bt), lambda: kernel(bt),
                                                        reps=2)

    # complex data as planes: the complex A, and the real A with a complex b
    for label, key, method, restart, prox in (
        ("complex A, fista-l1, gradient restart, real", "cplx", "fista", "gradient", "real"),
        ("complex A, pogm-l1", "cplx", "pogm", "none", "none"),
        ("real A, complex b, fista-l1, gradient restart", "real_a_cplx_b", "fista", "gradient",
         "none"),
    ):
        a, b = systems[key]
        ar, ai = t(a.real.astype(np.float32)), t(a.imag.astype(np.float32))
        br, bi = t(b.real.T.astype(np.float32)), t(b.imag.T.astype(np.float32))
        rho_c = 0.95 / float(np.linalg.norm(a, 2)) ** 2
        sched = (SHORT_ITERS, method, "l1", restart, prox)

        def kernel(br, bi, ar=ar, ai=ai, rho_c=rho_c, sched=sched):
            xr, xi, n = pd.pgm_dense_fused_cplx(br, bi, ar, ai, LASSO_LAM, rho_c, 1.0, *sched,
                                                with_counts=True)
            return torch.stack([xr, xi]), n

        def plain(br, bi, ar=ar, ai=ai, rho_c=rho_c, sched=sched):
            scal, tab = pd.kernel_args(br, LASSO_LAM, rho_c, 1.0, sched[1], sched[0])
            xr, xi, n = pd.pgm_dense_fused_cplx_torch(br, bi, ar, ai, scal, tab, *sched)
            return torch.stack([xr, xi]), n

        note("pgm_dense_fused_cplx", hold_dense(f"pgm_dense_fused_cplx[{label}]", kernel, plain,
                                                (br, bi)))
        if key == "cplx" and method == "fista":
            out["pgm_dense_fused_cplx"]["ms"] = alternate_ms(
                lambda: plain(br, bi), lambda: kernel(br, bi), reps=2)
    for name, row in out.items():
        print(f"{name}: kernel {row['ms'][1]:.3f} ms, plain {row['ms'][0]:.3f} ms")
    return out


def dense_parity(name, x, B, A64, x64, hold=True):
    """The first k = len(x64) columns of a dense solve `x` (n × K) against
    the float64 solutions `x64` (n × k) of the same columns of B: the worst
    column's relative error and |‖A x − b‖ − ‖A x64 − b‖| / ‖b‖ with A in
    float64; held to TOL_PARITY and TOL_RESIDUAL with `hold`. Returns
    both."""
    import torch

    k = x64.shape[1]
    require(bool(torch.isfinite(x).all()), f"{name}: non-finite values")
    xc = x[:, :k].to(x64.dtype)
    b = B[:, :k].to(x64.dtype)
    rel = float(max(torch.linalg.norm(xc[:, j] - x64[:, j]) / torch.linalg.norm(x64[:, j])
                    for j in range(k)))
    res = float(max(
        abs(torch.linalg.norm(A64 @ xc[:, j] - b[:, j]) - torch.linalg.norm(A64 @ x64[:, j]
                                                                            - b[:, j]))
        / torch.linalg.norm(b[:, j])
        for j in range(k)
    ))
    print(f"{name}: parity_max_rel_err vs f64 {rel:.3e}, parity_residual_rel_diff vs f64 "
          f"{res:.3e}{'' if hold else ' (printed, not held)'}")
    if hold:
        require(rel <= TOL_PARITY, f"{name}: parity_max_rel_err vs f64 {rel:.3e}")
        require(res <= TOL_RESIDUAL, f"{name}: parity_residual_rel_diff vs f64 {res:.3e}")
    return rel, res


def dense_cell_phase(dev, systems):
    """Phase 8: the dense cells through solve_batched_fast, each with the
    launch counters set to 0 just before the solve and read just after
    (exactly one launch of its kernel, none of any other), problems/s, and
    the accuracy bars. Returns the launches of each dense kernel summed
    over these runs, and the torch.linalg.solve yardstick of the 1024×512
    cell in ms."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import pgm_dense_fused as pd

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    launched = {"cgnr_fused": 0, "pgm_dense_fused": 0, "pgm_dense_fused_cplx": 0}

    def run(name, solver, B, kernel):
        launch_counts(reset=True)
        x = rtt.solve_batched_fast(solver, B)
        torch.cuda.synchronize()
        got = launch_counts()
        print(f"launches ({name}): {got}")
        require(got == {**{k: 0 for k in got}, kernel: 1},
                f"{name}: expected one launch of {kernel} and no others")
        launched[kernel] += 1
        require(tuple(x.shape) == (solver.A.in_size, B.shape[1]),
                f"{name}: shape {tuple(x.shape)}")
        require(bool(torch.isfinite(x).all()), f"{name}: non-finite values")
        ms = cuda_ms(lambda: rtt.solve_batched_fast(solver, B), reps=3)
        print(f"{name}: {B.shape[1] / (ms / 1e3):.1f} problems/s ({ms:.3f} ms per batch of "
              f"{B.shape[1]})")
        return x

    def direct64(A, B, lam, k):
        ds = rtt.DirectSolver.create(rtt.DenseOperator(A.double(), device=dev),
                                     reg=rtt.L2Regularization(lam))
        return rtt.solve_batched_unrolled(ds, B[:, :k].double())

    # the two CGNR cells
    library_ms = None
    for name, key, lam, iters in (
        ("cgnr_l2_dense64_fused_b16", "cgnr64", CGNR64_LAM, CGNR64_ITERS),
        ("cgnr_l2_dense_1024x512_b64", "cgnr1k", CGNR1K_LAM, CGNR1K_ITERS),
    ):
        A, B = map(t, systems[key])
        solver = rtt.CGNR.create(rtt.DenseOperator(A, device=dev), reg=rtt.L2Regularization(lam),
                                 iterations=iters)
        x = run(name, solver, B, "cgnr_fused")
        x64 = direct64(A, B, lam, 4)
        if key == "cgnr64":
            # the fused f32 CG on cond(AᴴA) ≈ 4e4: printed, not held; the
            # refined solve carries this cell's accuracy bar
            dense_parity(name, x, B, A.double(), x64, hold=False)
            xr = rtt.solve_cgnr_refined(solver, B[:, :4].T.contiguous(), rounds=3).T
            dense_parity(f"{name} solve_cgnr_refined (3 rounds, 4 columns)", xr, B,
                         A.double(), x64)
        else:
            dense_parity(name, x, B, A.double(), x64)
            # the yardstick: one torch.linalg.solve on the regularized Gram,
            # built outside the timed call as the kernel's inputs are
            G = A.T @ A + lam * torch.eye(A.shape[1], device=dev)
            AtB = A.T @ B
            torch.linalg.solve(G, AtB)  # warm-up: the solver library's set-up
            library_ms = cuda_ms(lambda: torch.linalg.solve(G, AtB), reps=10)
            print(f"{name}: torch.linalg.solve(G, AᵀB) {library_ms:.3f} ms (yardstick)")

    # the LASSO cell, with the table methods and the complex case
    a2b, b2b = systems["lasso"]
    A, B = t(a2b), t(b2b)
    rho = 0.95 / float(np.linalg.norm(a2b, 2)) ** 2
    op = rtt.DenseOperator(A, device=dev)
    solver = rtt.FISTA.create(op, reg=rtt.L1Regularization(LASSO_LAM), iterations=LASSO_ITERS,
                              rho=rho, track_residual=False)
    name = "fista_l1_dense_cs_b16_fused"
    x = run(name, solver, B, "pgm_dense_fused")
    # two columns against a float64 solve of the plain version, and the
    # plain f32 version's own residual difference
    b2 = B[:, :2].T.contiguous()
    sched = (LASSO_ITERS, "fista", "l1", "none", "none")
    scal64, tab64 = pd.kernel_args(b2.double(), LASSO_LAM, rho, 1.0, "fista", LASSO_ITERS,
                                   dtype=np.float64)
    x64 = pd.pgm_dense_fused_torch(b2.double(), A.double(), scal64, tab64, *sched)[0].T
    scal, tab = pd.kernel_args(b2, LASSO_LAM, rho, 1.0, "fista", LASSO_ITERS)
    x_plain = pd.pgm_dense_fused_torch(b2, A, scal, tab, *sched)[0].T
    _, res_plain = dense_parity(f"{name} (plain f32 version)", x_plain, B, A.double(), x64,
                                hold=False)
    _, res = dense_parity(name, x, B, A.double(), x64, hold=False)
    bar = TOL_RESIDUAL
    if res_plain > TOL_RESIDUAL:
        bar = 2 * res_plain
        print(f"{name}: the plain f32 version itself misses {TOL_RESIDUAL:.0e} "
              f"({res_plain:.3e}); the kernel is held to twice that, {bar:.3e}")
    require(res <= bar, f"{name}: parity_residual_rel_diff vs f64 {res:.3e} > {bar:.3e}")
    for cls in ("OptISTA", "POGM"):
        s_cls = getattr(rtt, cls).create(op, reg=rtt.L1Regularization(LASSO_LAM),
                                         iterations=SHORT_ITERS, rho=rho)
        run(f"{name} [{cls}, {SHORT_ITERS} iterations]", s_cls, B, "pgm_dense_fused")
    a_c, b_c = systems["cplx"]
    s_c = rtt.FISTA.create(
        rtt.DenseOperator(t(a_c), device=dev),
        reg=[rtt.L1Regularization(LASSO_LAM), rtt.RealRegularization()],
        iterations=SHORT_ITERS, rho=0.95 / float(np.linalg.norm(a_c, 2)) ** 2,
        restart="gradient", track_residual=False,
    )
    run("complex A 256x512, fista-l1, gradient restart, real", s_c, t(b_c), "pgm_dense_fused_cplx")
    return launched, library_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import rls_tpu_torch as rtt
    from rls_tpu_torch import _build
    from rls_tpu_torch.kernels import admm_tv_fused as admm_fused
    from rls_tpu_torch.kernels import admm_tv_tiled as admm_tiled
    from rls_tpu_torch.kernels import fista_tv_fused as fused
    from rls_tpu_torch.kernels import fista_tv_tiled as tiled
    from rls_tpu_torch.kernels import tv_fgp
    from rls_tpu_torch.kernels.admm_tv_tiled import launches_per_solve

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    t_start = time.perf_counter()

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s")

    # 3a. the TV prox kernel against its plain version, flagship shapes
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(BATCH, N, N)).astype(np.float32)).to(dev)
    lam = torch.from_numpy(
        (RHO * LAM * rng.uniform(0.0, 400.0, size=BATCH)).astype(np.float32)
    ).to(dev)
    lam[0] = 0.0
    got = tv_fgp.prox_tv2d_fgp(x.reshape(BATCH, -1), lam, (N, N), TV_ITERS).reshape(x.shape)
    want = tv_fgp.prox_tv2d_fgp_torch(x, lam, TV_ITERS)
    torch.cuda.synchronize()
    err_tv = float((got - want).abs().max())
    scale = float(want.abs().max())
    print(f"tv_fgp: max|kernel - plain| = {err_tv:.3e} (max|x| {scale:.3f})")
    require(torch.isfinite(got).all(), "tv_fgp kernel gave non-finite values")
    require(err_tv <= TOL_TV * scale, f"tv_fgp kernel disagrees: {err_tv:.3e}")
    plain_tv, ms_tv = alternate_ms(
        lambda: tv_fgp.prox_tv2d_fgp_torch(x, lam, TV_ITERS),
        lambda: tv_fgp.prox_tv2d_fgp(x.reshape(BATCH, -1), lam, (N, N), TV_ITERS),
        reps=20,
    )
    print(f"tv_fgp: kernel {ms_tv:.3f} ms, plain {plain_tv:.3f} ms")

    # 3b. the fused kernel against its plain version: the fixed schedules
    # at the flagship shapes, with both times
    solver, B, xs_true = build_flagship(dev)
    op = solver.A
    taps = op.taps_hw()
    x0hat = op.rmv_stencil(B.T).reshape(BATCH, N, N)
    lam_b = torch.full((BATCH,), LAM, device=dev)

    def fused_pair(method, restart="none", rel_tol=None, sigma_fac=1.0, warm_tv=False):
        sched = dict(method=method, restart=restart, rel_tol=rel_tol, sigma_fac=sigma_fac,
                     warm_tv=warm_tv)

        def kernel(x0):
            return fused.fista_tv_fused(x0, taps, RHO, lam_b[: x0.shape[0]], ITERS, TV_ITERS,
                                        with_counts=True, **sched)

        def plain(x0):
            scal, tab, t2 = fused.kernel_args(x0, RHO, lam_b[: x0.shape[0]], method, ITERS,
                                              TV_ITERS)
            return fused.fista_tv_fused_torch(x0, scal, tab, t2, taps, **sched)

        return kernel, plain

    ntap_h, ntap_w = (len(t) for t in taps)

    def pgm_bound(x0, counts, method, restart="none", rel_tol=None, warm_tv=False, **_):
        """The bound of one fused PGM-TV solve: every live iteration
        (counts[:, 1]) of every problem, x0hat in and x out."""
        per_px = pgm_ops(ntap_h, ntap_w, TV_ITERS, method, restart, rel_tol is not None, warm_tv)
        live = int(counts[:, 1].sum())
        return bound(live * per_px * N * N, 4 * 2 * x0.numel())

    fused_err, fused_ms = {}, {}
    for method in ("fista", "optista", "pogm"):
        kernel, plain = fused_pair(method)
        fused_err[method] = hold_to_plain(f"fista_tv_fused[{method}]", kernel, plain, x0hat)
        fused_ms[method] = alternate_ms(lambda: plain(x0hat), lambda: kernel(x0hat), reps=3)
        print(
            f"fista_tv_fused[{method}]: kernel {fused_ms[method][1]:.3f} ms, "
            f"plain {fused_ms[method][0]:.3f} ms, bound %.4f ms (%s)"
            % pgm_bound(x0hat, kernel(x0hat)[1], method)
        )

    # 3c. the dynamic and warm schedules, batch 8, with both times
    x0_dyn = x0hat[:BATCH_DYN].contiguous()
    for name, kw in (
        ("fista gradient restart", dict(method="fista", restart="gradient")),
        ("pogm gradient restart, sigma_fac 0.9",
         dict(method="pogm", restart="gradient", sigma_fac=0.9)),
        ("fista early exit", dict(method="fista", rel_tol=1e-3)),
        ("pogm early exit", dict(method="pogm", rel_tol=1e-3)),
        ("fista warm_tv", dict(method="fista", warm_tv=True)),
    ):
        kernel, plain = fused_pair(**kw)
        hold_to_plain(f"fista_tv_fused[{name}]", kernel, plain, x0_dyn, show_counts=True)
        plain_ms, kernel_ms = alternate_ms(lambda: plain(x0_dyn), lambda: kernel(x0_dyn), reps=1)
        print(f"fista_tv_fused[{name}, batch {BATCH_DYN}]: kernel {kernel_ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound %.4f ms (%s)"
              % pgm_bound(x0_dyn, kernel(x0_dyn)[1], **kw))

    # 3d. the tiled kernel against its plain version: 512² and 1024²
    draws = bench_suite_draws()
    img_admm, imgs512, imgs1024 = draws["admm"], draws[512], draws[1024]
    tiled_err, tiled_ms = {}, None
    for n, imgs in ((512, imgs512), (1024, imgs1024)):
        s_n = build_solver(n, dev)
        taps_n = s_n.A.taps_hw()
        b_n = s_n.A.mv(torch.from_numpy(imgs).to(dev))
        x0_n = s_n.A.rmv_stencil(b_n).reshape(-1, n, n)
        lam_n = torch.full((x0_n.shape[0],), LAM, device=dev)

        def kernel(x0, lam_n=lam_n, taps_n=taps_n, **kw):
            return tiled.fista_tv_tiled(x0, taps_n, RHO, lam_n[: x0.shape[0]], ITERS,
                                        TV_ITERS, with_counts=True, **kw)

        def plain(x0, lam_n=lam_n, taps_n=taps_n, **kw):
            kw.setdefault("method", "fista")
            scal, tab, t2 = fused.kernel_args(x0, RHO, lam_n[: x0.shape[0]], kw["method"],
                                              ITERS, TV_ITERS)
            return tiled.fista_tv_tiled_torch(x0, scal, tab, t2, taps_n, **kw)

        tiled_err[n] = hold_to_plain(f"fista_tv_tiled[{n}², batch {x0_n.shape[0]}]",
                                     kernel, plain, x0_n)
        if n == 512:
            tiled_ms = alternate_ms(lambda: plain(x0_n), lambda: kernel(x0_n), reps=3)
            print(f"fista_tv_tiled[512²]: kernel {tiled_ms[1]:.3f} ms, "
                  f"plain {tiled_ms[0]:.3f} ms")
            forced = cuda_ms(lambda: fused.fista_tv_fused(x0_n, taps_n, RHO, lam_n, ITERS,
                                                          TV_ITERS), reps=2)
            print(f"fista_tv_fused forced to 512², batch 16: {forced:.3f} ms "
                  f"({16 / (forced / 1e3):.1f} problems/s)")
            for name, kw in (
                ("optista", dict(method="optista")),
                ("pogm gradient restart, sigma_fac 0.9",
                 dict(method="pogm", restart="gradient", sigma_fac=0.9)),
                ("fista gradient restart, early exit",
                 dict(method="fista", restart="gradient", rel_tol=1e-3)),
            ):
                hold_to_plain(
                    f"fista_tv_tiled[512², batch 4, {name}]",
                    lambda x0, kw=kw: kernel(x0, **kw), lambda x0, kw=kw: plain(x0, **kw),
                    x0_n[:4].contiguous(), show_counts=True,
                )
        del x0_n, b_n

    # 3e. the ADMM-TV kernels against their plain versions
    admm = admm_kernel_phase(dev, (
        (ADMM256, admm_fused.admm_tv_fused, phantoms(batch=ADMM256[1])),
        (ADMM512, admm_tiled.admm_tv_tiled, imgs512),
    ))

    # 3g. the dense kernels against their plain versions
    systems = dense_systems(draws)
    dense = dense_kernel_phase(dev, systems)

    # 4. the flagship through the public API; the counts start at 0 here
    ref = np.load(os.path.join(ROOT, "bench_ref_f64.npz"))
    fused.fista_tv_fused.launches = 0
    tv_fgp.prox_tv2d_fgp.launches = 0
    tiled.fista_tv_tiled.launches = 0
    x_fast = rtt.solve_batched_fast(solver, B)
    torch.cuda.synchronize()
    launches_fused = fused.fista_tv_fused.launches
    require(tiled.fista_tv_tiled.launches == 0, "the 256² flagship ran the tiled kernel")
    x_comp = rtt.solve_batched_unrolled(solver, B)
    torch.cuda.synchronize()
    launches_tv = tv_fgp.prox_tv2d_fgp.launches
    print(f"launches: fista_tv_fused {launches_fused}, tv_fgp {launches_tv}")
    require(launches_fused == 1, "solve_batched_fast did not run the fused kernel once")
    require(launches_tv == ITERS, f"solve_batched_unrolled ran the TV kernel {launches_tv}×")

    blur_err = float(torch.linalg.norm(B.T - xs_true) / torch.linalg.norm(xs_true))
    for name, out in (("solve_batched_fast", x_fast), ("solve_batched_unrolled", x_comp)):
        require(tuple(out.shape) == (N * N, BATCH), f"{name}: shape {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), f"{name}: non-finite values")
        rec = float(torch.linalg.norm(out.T - xs_true) / torch.linalg.norm(xs_true))
        rel, res = parity(out.cpu().numpy(), ref)
        print(
            f"{name}: recon_rel_err {rec:.4f} (blurred {blur_err:.4f}), "
            f"parity_max_rel_err {rel:.3e}, parity_residual_rel_diff {res:.3e}"
        )
        require(rec < blur_err, f"{name}: the reconstruction is no better than the blur")
        require(rel <= TOL_PARITY, f"{name}: parity_max_rel_err {rel:.3e}")
        require(res <= TOL_RESIDUAL, f"{name}: parity_residual_rel_diff {res:.3e}")
    for name, fn in (
        ("solve_batched_fast", lambda: rtt.solve_batched_fast(solver, B)),
        ("solve_batched_unrolled", lambda: rtt.solve_batched_unrolled(solver, B)),
    ):
        ms = cuda_ms(fn, reps=3)
        print(f"{name}: {BATCH / (ms / 1e3):.1f} problems/s ({ms:.2f} ms per batch of {BATCH})")
    # the OptISTA and POGM flagship through the same entry point
    for cls in ("OptISTA", "POGM"):
        s_cls = build_solver(N, dev, cls)
        fused.fista_tv_fused.launches = 0
        out = rtt.solve_batched_fast(s_cls, B)
        torch.cuda.synchronize()
        require(fused.fista_tv_fused.launches == 1, f"{cls}: the fused kernel did not run once")
        rec = float(torch.linalg.norm(out.T - xs_true) / torch.linalg.norm(xs_true))
        require(bool(torch.isfinite(out).all()) and rec < blur_err,
                f"{cls}: recon_rel_err {rec:.4f}, blurred {blur_err:.4f}")
        ms = cuda_ms(lambda: rtt.solve_batched_fast(s_cls, B), reps=3)
        print(f"solve_batched_fast[{cls}]: recon_rel_err {rec:.4f}, "
              f"{BATCH / (ms / 1e3):.1f} problems/s ({ms:.2f} ms per batch of {BATCH})")

    # 5. fista_tv_512_tiled_b16 through the public API; counts start at 0
    n5 = 512
    s5 = build_solver(n5, dev)
    xs5 = torch.from_numpy(imgs512).to(dev)
    B5 = s5.A.mv(xs5).T.contiguous()
    fused.fista_tv_fused.launches = 0
    tiled.fista_tv_tiled.launches = 0
    x5 = rtt.solve_batched_fast(s5, B5)
    torch.cuda.synchronize()
    launches_tiled = tiled.fista_tv_tiled.launches
    print(f"launches (512²): fista_tv_tiled {launches_tiled}, "
          f"fista_tv_fused {fused.fista_tv_fused.launches}")
    require(launches_tiled == ITERS, f"the 512² cell ran the tiled kernel {launches_tiled}×")
    require(fused.fista_tv_fused.launches == 0, "the 512² cell ran the fused kernel")
    require(tuple(x5.shape) == (n5 * n5, 16), f"512²: bad result {tuple(x5.shape)}")
    # two columns against a float64 solve of the plain version on the card
    s64 = build_solver(n5, dev, dtype=torch.float64)
    b64 = B5[:, :2].T.double()
    x0_64 = s64.A.rmv_stencil(b64).reshape(2, n5, n5)
    scal64, tab64, t2_64 = fused.kernel_args(x0_64, RHO, LAM, "fista", ITERS, TV_ITERS,
                                             dtype=np.float64)
    x64 = tiled.fista_tv_tiled_torch(x0_64, scal64, tab64, t2_64, taps)[0].reshape(2, -1)
    parity_f64("fista_tv_512_tiled_b16", x5, B5, xs5, s64.A, x64)
    ms5 = cuda_ms(lambda: rtt.solve_batched_fast(s5, B5), reps=3)
    print(f"fista_tv_512_tiled_b16: {16 / (ms5 / 1e3):.1f} problems/s "
          f"({ms5:.2f} ms per batch of 16)")

    # 6. the ADMM-TV cells through the public API
    for name, cell, imgs, want, composed in (
        ("admm_tv_deblur256_b16_fused", ADMM256,
         np.broadcast_to(img_admm, (ADMM256[1], img_admm.size)), {"admm_tv_fused": 1}, True),
        ("admm_tv_512_tiled_b16", ADMM512, imgs512,
         {"admm_tv_tiled": launches_per_solve(*ADMM512[3:5])}, False),
    ):
        kernel = next(iter(want))
        admm[kernel]["launches"] = admm_cell_phase(name, cell, dev, imgs, want, composed)[kernel]

    # 8. the dense cells through the public API
    dense_launched, library_ms = dense_cell_phase(dev, systems)
    print(f"phases 3-6, 8: {time.perf_counter() - t_start:.1f} s")

    # 7. the kernel table, then the result line
    # the least time for each kernel's timed call: every input read once,
    # every output written once, and the f32 operations this run's data
    # needs (for ADMM, the CG steps that were live)
    f32 = 4
    flag_px = BATCH * N * N
    n5px = 16 * n5 * n5
    fista_ops = ITERS * pgm_ops(ntap_h, ntap_w, TV_ITERS)
    bounds = {
        "tv_fgp": bound(fgp_loop_ops(TV_ITERS) * flag_px, f32 * (2 * flag_px + BATCH)),
        "fista_tv_fused": bound(fista_ops * flag_px, f32 * 2 * flag_px),
        "fista_tv_tiled": bound(fista_ops * n5px, f32 * 2 * n5px),
    }
    for name, cell in (("admm_tv_fused", ADMM256), ("admm_tv_tiled", ADMM512)):
        n, batch, _, iters, _, tv = cell
        ops = sum(admm_ops(ntap_h, ntap_w, tv, iters, v, False) for v in admm[name]["live"])
        bounds[name] = bound(ops * n * n, f32 * (2 * batch * n * n + batch))
    # the dense kernels at their timed shapes: A, b and λ or [λ, ρ, θ] read,
    # x written; CGNR 2mn for Aᴴb and 4mn + 10n per step, the dense PGM
    # solves as `dense_pgm_ops` counts them
    (m, n), p = systems["cgnr1k"][0].shape, systems["cgnr1k"][1].shape[1]
    steps = min(CGNR1K_ITERS, n)
    bounds["cgnr_fused"] = bound(p * (2 * m * n + steps * (4 * m * n + 10 * n)),
                                 f32 * (m * n + p * (m + n + 1)))
    (m, n), p = systems["lasso"][0].shape, systems["lasso"][1].shape[1]
    bounds["pgm_dense_fused"] = bound(p * dense_pgm_ops(m, n, LASSO_ITERS),
                                      f32 * (m * n + p * (m + n + 3)))
    (m, n), p = systems["cplx"][0].shape, systems["cplx"][1].shape[1]
    bounds["pgm_dense_fused_cplx"] = bound(p * dense_pgm_ops(m, n, SHORT_ITERS, cplx=True),
                                           f32 * (2 * m * n + p * (2 * m + 2 * n + 3)))
    rows = (
        ("tv_fgp", "tv_fgp.cu", "rls_tpu/kernels/tv_pallas.py:69", launches_tv, err_tv,
         (plain_tv, ms_tv)),
        ("fista_tv_fused", "fista_tv_fused.cu", "rls_tpu/kernels/fista_tv_fused.py:676",
         launches_fused, max(fused_err.values()), fused_ms["fista"]),
        ("fista_tv_tiled", "fista_tv_tiled.cu", "rls_tpu/kernels/fista_tv_tiled.py:704",
         launches_tiled, max(tiled_err.values()), tiled_ms),
        ("admm_tv_fused", "admm_tv_fused.cu", "rls_tpu/kernels/admm_tv_fused.py:156",
         admm["admm_tv_fused"]["launches"], admm["admm_tv_fused"]["err"],
         admm["admm_tv_fused"]["ms"]),
        ("admm_tv_tiled", "admm_tv_tiled.cu", "rls_tpu/kernels/admm_tv_tiled.py:183",
         admm["admm_tv_tiled"]["launches"], admm["admm_tv_tiled"]["err"],
         admm["admm_tv_tiled"]["ms"]),
        ("cgnr_fused", "cgnr_fused.cu", "rls_tpu/kernels/cgnr_fused.py:174",
         dense_launched["cgnr_fused"], dense["cgnr_fused"]["err"], dense["cgnr_fused"]["ms"]),
        ("pgm_dense_fused", "pgm_dense_fused.cu", "rls_tpu/kernels/pgm_dense_fused.py:355",
         dense_launched["pgm_dense_fused"], dense["pgm_dense_fused"]["err"],
         dense["pgm_dense_fused"]["ms"]),
        ("pgm_dense_fused_cplx", "pgm_dense_fused.cu", "rls_tpu/kernels/pgm_dense_fused.py:458",
         dense_launched["pgm_dense_fused_cplx"], dense["pgm_dense_fused_cplx"]["err"],
         dense["pgm_dense_fused_cplx"]["ms"]),
    )
    # one PyTorch call computes the same function only for CGNR's
    # regularized normal equations (torch.linalg.solve); none computes a
    # TV or a LASSO solve
    library = {"cgnr_fused": library_ms}
    kernels = []
    for name, src, replaces, launches, err, (plain_ms, ms) in rows:
        bound_ms, bound_by = bounds[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"rls_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library.get(name),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
