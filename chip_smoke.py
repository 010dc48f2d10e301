#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rls_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: CUDA must be present; TF32 is switched off for matmuls and
     cuDNN; the card's name and power limit are printed;
  2. build: the three CUDA kernels are compiled from rls_tpu_torch/csrc
     (one nvcc per source, all at once);
  3. each kernel against its plain PyTorch version on the card, with both
     times: the TV prox and the fused solve (FISTA, OptISTA, POGM) at the
     flagship shapes (64 problems of 256², 50 × 10 iterations); the fused
     solve's dynamic and warm schedules (gradient restart, sigma_fac < 1,
     early exit, warm TV duals) at batch 8, with the per-problem restart
     and freeze counts of kernel and plain version side by side; the tiled
     solve at 512² (batch 16, 50 × 10), once at 1024² (batch 8), and its
     dynamic schedules at 512² (batch 4);
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
  6. the kernel table as one JSON line, then the result line
     {"ok": true, "device": {...}}.

The flagship problem is rebuilt with numpy exactly as bench.py:36-68
builds it, the 512² and 1024² problems as tools/bench_suite.py:308-379
builds them (replaying its seeded generator).
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


def bench_suite_phantoms():
    """The 512² (batch 16) and 1024² (batch 8) phantoms of
    tools/bench_suite.py:326-331, :367-372: its generator default_rng(0)
    replayed through the draws of the cells before them (:81-294)."""
    rng = np.random.default_rng(0)
    rng.normal(size=(64, 64)), rng.normal(size=(64,)), rng.normal(size=(64, 16))
    for _ in range(8):
        rng.integers(0, 256 - 20, 2), rng.uniform(0.3, 1.0)
    rng.choice(256 * 256, size=int(0.35 * 256 * 256), replace=False)
    for _ in range(6):
        rng.integers(0, 256 - 40, 2), rng.uniform(0.3, 1.0)
    rng.normal(size=(256, 512)), rng.normal(size=(512, 16)), rng.uniform(size=(512, 16))
    rng.normal(size=(1024, 256)), rng.uniform(size=(1024, 256)), rng.normal(size=(256,))
    rng.normal(size=(8192, 2048)), rng.normal(size=(2048,))
    out = []
    for n, batch, margin, lo, hi in ((512, 16, 64, 16, 128), (1024, 8, 128, 32, 256)):
        imgs = np.zeros((batch, n, n), np.float32)
        for b in range(batch):
            for _ in range(6):
                i0, j0 = rng.integers(0, n - margin, size=2)
                w, h = rng.integers(lo, hi, size=2)
                imgs[b, i0 : i0 + w, j0 : j0 + h] += rng.normal()
        out.append(imgs.reshape(batch, n * n))
    return out


def build_solver(n, device, cls="FISTA", dtype=None):
    """The bench's deblurring solver at n² (9×9 Gaussian σ = 2, ρ = 0.95,
    λ = 5e-4, 50 × 10), TV on the CUDA kernel."""
    import torch

    import rls_tpu_torch as rtt

    op = rtt.SeparableConvOperator.from_kernel(
        gaussian_kernel(), im_shape=(n, n), dtype=dtype or torch.float32
    ).to(device)
    kw = {"track_residual": False} if cls == "FISTA" else {}
    return getattr(rtt, cls).create(
        op,
        reg=rtt.TVRegularization(LAM, shape=(n, n), iterations_tv=TV_ITERS, backend="cuda"),
        iterations=ITERS,
        rho=RHO,
        rel_tol=0.0,
        **kw,
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


def hold_to_plain(name, kernel, plain, x0hat, show_counts=False):
    """Run `kernel(x0hat)` and `plain(x0hat)` (each → (x, counts)), and
    the plain version once more with x0hat moved by 1 ulp; print the
    error and the plain version's own spread (with `show_counts`, also the
    per-problem counts of restarts fired and live iterations of all
    three, which must agree between kernel and plain); hold the kernel to
    TOL_FUSED_NORM in 2-norm and TOL_FUSED_MAX of max|x| per pixel.
    Returns max|kernel − plain|."""
    import torch

    got, counts = kernel(x0hat)
    want, want_counts = plain(x0hat)
    ulp, ulp_counts = plain(torch.nextafter(x0hat, torch.full_like(x0hat, float("inf"))))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    norm = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    scale = float(want.abs().max())
    print(
        f"{name}: max|kernel - plain| = {err:.3e} (max|x| {scale:.3f}), rel. 2-norm "
        f"{norm:.3e}; plain under a 1-ulp input change: max "
        f"{float((ulp - want).abs().max()):.3e}, rel. 2-norm "
        f"{float(torch.linalg.norm(ulp - want) / torch.linalg.norm(want)):.3e}"
    )
    if show_counts:
        print(
            f"{name}: restarts kernel {counts[:, 0].tolist()} plain "
            f"{want_counts[:, 0].tolist()} plain(1 ulp) {ulp_counts[:, 0].tolist()}; "
            f"live iterations kernel {counts[:, 1].tolist()} plain "
            f"{want_counts[:, 1].tolist()} plain(1 ulp) {ulp_counts[:, 1].tolist()}"
        )
    require(torch.isfinite(got).all(), f"{name} kernel gave non-finite values")
    require(counts.tolist() == want_counts.tolist(),
            f"{name}: the kernel's restart / freeze counts differ from the plain version's")
    require(
        norm <= TOL_FUSED_NORM and err <= TOL_FUSED_MAX * scale,
        f"{name} kernel disagrees: max {err:.3e}, rel. 2-norm {norm:.3e}",
    )
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import rls_tpu_torch as rtt
    from rls_tpu_torch import _build
    from rls_tpu_torch.kernels import fista_tv_fused as fused
    from rls_tpu_torch.kernels import fista_tv_tiled as tiled
    from rls_tpu_torch.kernels import tv_fgp

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

    fused_err, fused_ms = {}, {}
    for method in ("fista", "optista", "pogm"):
        kernel, plain = fused_pair(method)
        fused_err[method] = hold_to_plain(f"fista_tv_fused[{method}]", kernel, plain, x0hat)
        fused_ms[method] = alternate_ms(lambda: plain(x0hat), lambda: kernel(x0hat), reps=3)
        print(
            f"fista_tv_fused[{method}]: kernel {fused_ms[method][1]:.3f} ms, "
            f"plain {fused_ms[method][0]:.3f} ms"
        )

    # 3c. the dynamic and warm schedules, batch 8
    x0_dyn = x0hat[:BATCH_DYN].contiguous()
    for name, kw in (
        ("fista gradient restart", dict(method="fista", restart="gradient")),
        ("pogm gradient restart, sigma_fac 0.9",
         dict(method="pogm", restart="gradient", sigma_fac=0.9)),
        ("fista early exit", dict(method="fista", rel_tol=1e-3)),
        ("pogm early exit", dict(method="pogm", rel_tol=1e-3)),
        ("fista warm_tv", dict(method="fista", warm_tv=True)),
    ):
        hold_to_plain(f"fista_tv_fused[{name}]", *fused_pair(**kw), x0_dyn, show_counts=True)

    # 3d. the tiled kernel against its plain version: 512² and 1024²
    (imgs512, imgs1024) = bench_suite_phantoms()
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
    require(tuple(x5.shape) == (n5 * n5, 16) and bool(torch.isfinite(x5).all()),
            f"512²: bad result {tuple(x5.shape)}")
    # two columns against a float64 solve of the plain version on the card
    s64 = build_solver(n5, dev, dtype=torch.float64)
    b64 = B5[:, :2].T.double()
    x0_64 = s64.A.rmv_stencil(b64).reshape(2, n5, n5)
    scal64, tab64, t2_64 = fused.kernel_args(x0_64, RHO, LAM, "fista", ITERS, TV_ITERS,
                                             dtype=np.float64)
    x64 = tiled.fista_tv_tiled_torch(x0_64, scal64, tab64, t2_64, taps)[0].reshape(2, -1)
    xc = x5[:, :2].T.double()
    rel5 = float(max(torch.linalg.norm(xc[j] - x64[j]) / torch.linalg.norm(x64[j])
                     for j in range(2)))
    res5 = float(max(
        abs(torch.linalg.norm(s64.A.mv(xc[j]) - b64[j]) - torch.linalg.norm(s64.A.mv(x64[j])
                                                                            - b64[j]))
        / torch.linalg.norm(b64[j])
        for j in range(2)
    ))
    rec5 = float(torch.linalg.norm(x5.T - xs5) / torch.linalg.norm(xs5))
    blur5 = float(torch.linalg.norm(B5.T - xs5) / torch.linalg.norm(xs5))
    ms5 = cuda_ms(lambda: rtt.solve_batched_fast(s5, B5), reps=3)
    print(
        f"fista_tv_512_tiled_b16: recon_rel_err {rec5:.4f} (blurred {blur5:.4f}), "
        f"max_rel_err vs f64 {rel5:.3e}, residual_rel_diff vs f64 {res5:.3e}, "
        f"{16 / (ms5 / 1e3):.1f} problems/s ({ms5:.2f} ms per batch of 16)"
    )
    require(rec5 < blur5, "512²: the reconstruction is no better than the blur")
    require(rel5 <= TOL_PARITY, f"512²: max_rel_err vs f64 {rel5:.3e}")
    require(res5 <= TOL_RESIDUAL, f"512²: residual_rel_diff vs f64 {res5:.3e}")
    print(f"phases 3-5: {time.perf_counter() - t_start:.1f} s")

    # 6. the kernel table, then the result line
    kernels = [
        {
            "name": "tv_fgp",
            "route": "cuda",
            "source": "rls_tpu_torch/csrc/tv_fgp.cu",
            "replaces": "rls_tpu/kernels/tv_pallas.py:69",
            "launches": launches_tv,
            "max_abs_err": err_tv,
            "ms": ms_tv,
            "plain_ms": plain_tv,
        },
        {
            "name": "fista_tv_fused",
            "route": "cuda",
            "source": "rls_tpu_torch/csrc/fista_tv_fused.cu",
            "replaces": "rls_tpu/kernels/fista_tv_fused.py:676",
            "launches": launches_fused,
            "max_abs_err": max(fused_err.values()),
            "ms": fused_ms["fista"][1],
            "plain_ms": fused_ms["fista"][0],
        },
        {
            "name": "fista_tv_tiled",
            "route": "cuda",
            "source": "rls_tpu_torch/csrc/fista_tv_tiled.cu",
            "replaces": "rls_tpu/kernels/fista_tv_tiled.py:704",
            "launches": launches_tiled,
            "max_abs_err": max(tiled_err.values()),
            "ms": tiled_ms[1],
            "plain_ms": tiled_ms[0],
        },
    ]
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
