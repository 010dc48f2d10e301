#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rls_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: CUDA must be present; TF32 is switched off for matmuls and
     cuDNN; the card's name and power limit are printed;
  2. build: the thirteen CUDA sources are compiled from
     rls_tpu_torch/csrc (one nvcc per source, all at once);
  3. each kernel against its plain PyTorch version on the card, with both
     times: the TV prox at TV_CHECKS (each plan printed and required:
     every shape the main path gives it on its resident route, with x, pv
     and ph in shared and in global memory, by the route counter, and its
     global route at TV_WIDE, rows too wide for a band) and the fused
     solve (FISTA, OptISTA, POGM) at the
     flagship shapes (64 problems of 256², 50 × 10 iterations); the fused
     solve's dynamic and warm schedules (gradient restart, sigma_fac < 1,
     early exit, warm TV duals) at batch 8, with the per-problem restart
     and freeze counts of kernel and plain version side by side, each
     fused case's plan printed first (route, CTAs per problem, rows per
     band, shared memory, clusters resident at once); row 3 at 512²
     (batch 16, 50 × 10) on its cluster route in one launch and at 1024²
     (batch 8) on its row tiles in 50, each plan printed and its route
     read from the route counter, and its dynamic schedules at 512²
     (batch 4); the fused ADMM-TV solve at
     BASELINE configuration #3's shapes (16 distinct problems of 256², 12
     outer × 6 CG × 8 dual iterations; its plan printed first, on its
     resident route by the route counter) and on its global route (4
     problems of 4 × 12000, rows too wide for a band), and the tiled
     ADMM-TV solve at 512² (batch 16, 10 × 5 × 10), each with a Positive
     case at batch 4 and the live CG steps of kernel and plain version side
     by side;
  4. the flagship through the public API: batched FISTA-TV deblurring,
     256², 9×9 Gaussian, 50×10 iterations, ρ = 0.95, λ = 5e-4, batch 64,
     through solve_batched_fast (fused kernel, one launch, on the
     resident route by its route counter) and
     solve_batched_unrolled (TV kernel, one launch per FISTA iteration,
     each on its resident route by the route counter),
     held against the f64 reference solutions of bench_ref_f64.npz; the
     OptISTA and POGM flagship through solve_batched_fast, with the
     composed solve_batched_unrolled of each timed beside it;
  5. the 512² cell of tools/bench_suite.py (fista_tv_512_tiled_b16: 9×9
     Gaussian σ = 2, ρ = 0.95, λ = 5e-4, 50 × 10, batch 16) through
     solve_batched_fast, which must run row 3 once on its cluster route
     (the route counter), held on two columns against a float64 solve of
     the plain version on the card;
  6. the two ADMM-TV cells of tools/bench_suite.py: admm_tv_deblur256_b16
     (ρ = 0.1, λ = 2e-3, 12 × 6 × 8) through solve_batched_fast (one fused
     launch, on the resident route by the route counter) and through
     solve_batched_unrolled (the composed ADMM, one TV
     kernel launch per outer iteration), and admm_tv_512_tiled_b16 (ρ =
     0.1, λ = 5e-4, 10 × 5 × 10) through solve_batched_fast (the tiled
     kernel), each held on two columns against a float64 solve of the
     plain version on the card, with a torch.profiler breakdown of the
     device time of one solve of each;
  3g. each dense kernel against its plain version, held to the plain
     version's own spread under b·(1 + 2⁻²³) in the same run and to the
     restart-count rule (DENSE_SPREAD): the fused CGNR on the 64×64 cell,
     the 1024×512 cell, with Positive at batch 4, on a complex A through
     the split-real embedding, at 1000×300 × 61 (remainders in the slabs
     and the problem groups) and at batch 137 (more problems than SMs),
     each case's plan printed first (CTAs, slabs × groups of the
     cooperative grid, rows per slab, problems per group, shared memory);
     the dense FISTA / OptISTA / POGM on
     the LASSO cell (600 iterations, and 100 for the restart schedules,
     the table methods and FISTA-L2 with Positive; its plan printed first,
     each case one launch on the grid route by the route counter); the
     plane kernel on a
     complex A (FISTA with gradient restart and Real, POGM) and on the real
     A with a complex b;
  3h. each FFT kernel against its plain version, held to the plain
     version's own spread under b·(1 + 2⁻²³) (FFT_SPREAD), with both
     times: the fused FISTA-L1-DFT on 16 distinct 256² CS problems with λ
     per problem (60 iterations; its plan printed first, on the resident
     route by its route counter, and bit for bit the plain version), and
     its global route on 4 problems of 512² (bit for bit, the route
     counter set to 0 just before and required to read one global
     launch), the fused FISTA-L21-SENSE (bit for bit) and the fused
     SplitBregman L21 + TV (4 × 8 × 8, TV 5, with the live CG steps of
     kernel and plain version side by side), each with its plan printed
     first (route, CTAs per slice, row bands, rounds of coils, shared
     memory, clusters resident at once) and on its resident route by its
     route counter, on the 8 SENSE slices of 128² with 6 coils, and the
     global routes of both (one CTA per slice) on 2 slices of 256 × 128
     with 6 coils, held alike and each required to run once on that
     route;
  8. the dense cells through solve_batched_fast, each running its kernel
     once by the launch counters, with problems/s:
     cgnr_l2_dense64_fused_b16 (printed against a float64 DirectSolver;
     the refined CGNR, 3 rounds on 4 columns, held to TOL_PARITY and
     TOL_RESIDUAL), cgnr_l2_dense_1024x512_b64 (held on 4 columns, with a
     torch.linalg.solve yardstick), fista_l1_dense_cs_b16_fused (held to
     TOL_RESIDUAL on 2 columns against a float64 solve of the plain
     version), its OptISTA and POGM at 100 iterations (each of the three
     one launch on row 7a's grid route by the route counter, the plan
     printed first), and the complex FISTA case;
  9. the compressed-sensing and SENSE cells through solve_batched_fast,
     each running its kernel once by the launch counters, with problems/s
     (slices/s), two columns held to TOL_PARITY and TOL_RESIDUAL against
     a float64 solve of the plain version on the card, and the error
     against the true images beside the float64 solve's own:
     fista_l1_cs_dft256_b16 (BASELINE #2, also through
     solve_batched_unrolled, the composed torch.fft path; its one launch
     on the resident route by the route counter),
     fista_l21_sense128_6coil_b8 (FISTA with complex L1 on the SENSE
     problem) and splitbregman_sense128_6coil_b8 (BASELINE #4, also
     composed), each SENSE cell's one launch on the resident route by the
     route counter; each cell's composed solve is timed as its kernel's
     yardstick;
  3i. the PDHG, Kaczmarz and greedy Kaczmarz kernels against their plain
     versions: the fused PDHG on its resident route (tv8 on 16 distinct
     256² problems at the PDHG cell's 200 iterations, tviso and L1 with
     Positive at 50, each plan printed first, held bit for bit) and on its
     global route (a row too wide for any band, held to the plain
     version's 1-ulp spread, the route counter set to 0 just before and
     required to read one global launch); the Kaczmarz sweep through
     Kaczmarz(backend="cuda") (cyclic and shuffled, the tall 1024×256
     system, batch 16: the sweep kernel's main path, its launches
     counted); the streamed solve on the tall system (dense and padded
     CSR, 16 distinct b), the 64 MiB system (4 b), a complex system and a
     real A with a complex b; the greedy sweep with forced rows and with
     sampled draws, whose rows must equal the plain version's; each held
     by `hold_dense` and timed in turns with its plain version, beside the
     composed solve at its shapes;
 10. the PDHG and Kaczmarz cells through solve_batched_fast, each
     running its named dispatch row (pdhg, kaczmarz_streamed,
     kaczmarz_greedy) by the launch counters, with problems/s, two
     columns held to a float64 plain solve on the card (the PDHG cell to
     twice its plain f32 version's own departure where that exceeds
     TOL_PARITY) and the error against the true image beside the float64
     solve's own: pdhg_tv8_deblur256_b16_fused (also composed; its one
     launch on the resident route by the route counter),
     kaczmarz_rand_pos_tall_b16_streamed, kaczmarz_rand_pos_tall_b16_csr,
     kaczmarz_streamed_64MiB_b4 and this script's
     kaczmarz_greedy_tall_b16;
  7. the kernel table as one JSON line (launches on the main path, error
     against the plain version, kernel and plain times, the least time
     the card could take, `bound_ms`, and a library yardstick where one
     exists: the composed solve_batched_unrolled at the kernel's shapes,
     timed once in phases 5, 6 and 8 for the tiled FISTA, the two ADMM
     and the two dense PGM rows), then the result line {"ok": true,
     "device": {...}}.

Phases 3h and 3i run after 3g, phases 8–10 after phase 6; the table and
the result line come last. The flagship problem is rebuilt with numpy
exactly as bench.py:36-68 builds it, the other cells as
tools/bench_suite.py:79-102, :104-125, :127-151, :153-194, :204-306 and
:308-379 build them (replaying its seeded generators).

    python3 chip_smoke.py --time-cgnr [ROOT]

times only the CGNR kernel of the rls_tpu_torch under ROOT (default: this
tree) at the two CGNR cells, beside torch.linalg.solve, and prints one
JSON line: run it for a parent tree and this one in turns to compare the
two kernels on one card.

    python3 chip_smoke.py --time-pgm-tv [ROOT]

does the same for the fused PGM-TV kernel (row 2): FISTA, OptISTA and POGM
at the flagship, the batch-8 schedules, 256² × 16 beside the tiled kernel,
and the flagship cell through solve_batched_fast, with each plan and the
kernel's clocks per phase where ROOT's package has them.

    python3 chip_smoke.py --time-splitbregman [ROOT]

does the same for the fused SplitBregman kernel (row 10): BASELINE #4's
8 slices, 64 slices, 1 and 3 coils, rows 8 and 9 as controls, and the
cell through solve_batched_fast, with each plan and the kernel's clocks
per phase where ROOT's package has them.

    python3 chip_smoke.py --time-pdhg [ROOT]

does the same for the fused PDHG kernel (row 11): tv8 at the PDHG cell
(16 distinct 256² problems, 200 iterations), tviso and L1 + Positive at
256² × 16, tv8 at 4 and 64 problems, and the cell through
solve_batched_fast, with each plan and the kernel's clocks per phase where
ROOT's package has them; and row 8 (FISTA-L1-DFT on the CS cell) beside
its composed solve_batched_unrolled, in turns, three readings each.

    python3 chip_smoke.py --time-fista-l1-dft [ROOT]

does the same for the fused FISTA-L1-DFT kernel (row 8): the CS cell's 16
distinct 256² problems (60 iterations), 1 and 64 problems of 256², 16 of
128², 4 of 512² on the global route, the cell through solve_batched_fast,
and the kernel in turns with the cell's composed solve_batched_unrolled,
whose device time torch.profiler also reads; row 9 as a control; with
each plan and the kernel's clocks per phase where ROOT's package has
them.

    python3 chip_smoke.py --time-sense [ROOT]

does the same for the fused FISTA-L21-SENSE kernel (row 9): the SENSE
cell's 8 slices of 128² with 6 coils (80 iterations), 64 slices, 1 slice,
8 slices with 1, 3 and 17 coils, 4 slices of 256² on the global route;
the kernel in turns with the cell's composed solve_batched_unrolled, both
with their device time by torch.profiler; rows 8 and 10 as controls;
with each plan and the kernel's clocks per phase where ROOT's package has
them.

    python3 chip_smoke.py --time-admm [ROOT]

does the same for the fused ADMM-TV kernel (row 4): BASELINE #3's 16
distinct 256² problems (12 × 6 × 8), 1 and 64 problems, Positive at batch
4, the cell at forced cluster sizes 6, 8 and 16, 4 × 4 × 12000 on the
global route, the tiled kernel (row 5) on the cell; the kernel in turns
with the cell's composed solve_batched_unrolled, both with their device
time by torch.profiler; row 2 as a control; each plan, the kernel's clocks
per phase, and sha256 digests of rows 2 and 5 and of row 4's global route
(bit for bit between two trees where row 4's change leaves them).

    python3 chip_smoke.py --time-tv-fgp [ROOT]

does the same for the TV prox kernel (row 1): 64 × 256² (10 dual
iterations), 16 × 256² (8), 16 × 512², 8 × 1024², 4 × 4 × 12000, 4 × 4 ×
20000 on the global route and 1 × 256², 64 × 256² at forced cluster sizes
5 and 16 and 16 × 256² at 6, each with its device time by torch.profiler;
the composed flagship, ADMM cell and 512² solves that launch it, with
their device times; each plan, and sha256 digests of every case and of
rows 2 and 4 (bit for bit between two trees where row 1's change leaves
them).

    python3 chip_smoke.py --time-tiled [ROOT]

does the same for row 3 (the cluster route and the row tiles): the
fista_tv_512_tiled_b16 cell on its route, in turns with the row tiles
(the parent's kernel), c = 15 in turns with c = 16, CTA 0's clocks by
phase, the two placements at 16 × 256² in turns; the cell's composed
solve; 8 × 1024² on the row tiles beside its composed solve; the
dispatch's boundary at 16 × 384² (row 2, row 3 on its plan, on three
planes and on the row tiles); each case's device time by torch.profiler,
row 2 at the flagship as the control, and sha256 digests.

    python3 chip_smoke.py --time-pgm-dense [ROOT]

does the same for the dense PGM kernel (row 7a): the
fista_l1_dense_cs_b16_fused cell (600 iterations) on its grid route in
turns with the per-problem kernel forced (the parent's kernel), OptISTA
and POGM at 100 iterations, FISTA with its gradient restart, at P = 1 and
at P = 137, each on both routes and with its device time by
torch.profiler; the cell's composed solve_batched_unrolled and its device
time; each plan and the grid route's clocks of CTA 0 by phase; row 6 at
both CGNR cells and row 7b as controls, with sha256 digests.

    python3 chip_smoke.py --time-library [ROOT]

reads the library yardstick of rows 2, 3, 4, 5, 7a, 7b, 10, 11, 12a, 12b
and 13: the composed solve_batched_unrolled at each kernel's main-path
shapes, three wall readings and three device times by torch.profiler
each.
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
# the fused ADMM-TV kernel's global route: 4 problems of 4 × 12000, rows
# too wide for any band of its resident route (at most 11,524 pixels)
ADMM_WIDE = (4, 4, 12000)
# the TV prox kernel's global route: 4 problems of 4 × 20000, rows too wide
# for any band of its resident route (three planes: at most 19,328 pixels)
TV_WIDE = (4, 4, 20000)
# phase 3a's TV prox cases: (B, H, W, dual iterations) of the composed
# flagship, the ADMM cell's composed solve, the 512² composed solves (row
# 3's and row 5's yardsticks), one-row bands, and the global route; each
# with its route and where its plan keeps x, pv and ph
TV_CHECKS = ((64, 256, 256, 10, "resident", "shared"), (16, 256, 256, 8, "resident", "global"),
             (16, 512, 512, 10, "resident", "global"), (4, 4, 12000, 10, "resident", "global"),
             (*TV_WIDE, 10, "global", "global"))
# the TV prox kernel's shapes in --time-tv-fgp: (B, H, W, dual iterations)
# of the composed flagship (50 launches), the ADMM cell's composed solve
# (12), the 512² composed solve (50) and the 1024² one, beside 4 × 4 ×
# 12000 (one-row bands), the global route and one problem
TV_SHAPES = ((64, 256, 256, 10), (16, 256, 256, 8), (16, 512, 512, 10), (8, 1024, 1024, 10),
             (4, 4, 12000, 10), (*TV_WIDE, 10), (1, 256, 256, 10))
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
# BASELINE #2 (tools/bench_suite.py:104-125): a 256² image, 35 % of its
# spectrum sampled, L1 λ = 2e-3, ρ = 0.95, 60 iterations, 16 columns
CS_N, CS_BATCH, CS_LAM, CS_ITERS = 256, 16, 2e-3, 60
# the SENSE problem of tools/bench_suite.py:153-184 (128², 6 coils, 8
# slices), solved by FISTA with complex L1 as examples/mri_sense_split_real.py:53-55
# solves it (λ = 1e-4, ρ = 0.95, 80 iterations) and by BASELINE #4's
# SplitBregman (:185-194: L21 λ = 1e-4 and TV λ = 1e-4 over 5 dual
# iterations, ρ = 0.01 each, 4 outer × 8 inner × 8 CG steps, tol_inner 1e-5)
SENSE_N, SENSE_C, SENSE_SLICES = 128, 6, 8
SENSE_LAM, SENSE_ITERS = 1e-4, 80
SB_LAM, SB_TV, SB_RHO, SB_SCHED, SB_TOL = 1e-4, 5, 0.01, (4, 8, 8), 1e-5
# The FFT kernels are held to the plain version's own spread under
# b·(1 + 2⁻²³), measured in the same run: within max(FFT_SPREAD × spread,
# FFT_FLOOR) in relative 2-norm and TOL_FUSED_MAX of max|x| at any entry,
# and SplitBregman's live CG steps must equal the plain version's.
FFT_SPREAD, FFT_FLOOR = 2.0, 1e-6
# the PDHG cell of tools/bench_suite.py:227-252 (pdhg_tv8_deblur256_b16_fused):
# 256², the 9-tap Gaussian exp(−(i−4)²/8) normalized as both factors, TV
# λ = 5e-3, σ = 1/16, τ from the power iteration, 200 iterations, the ADMM
# image tiled 16 times; its kernel is held to PDHG_SPREAD times the plain
# version's own 1-ulp spread (tv8 at 200 iterations on 16 distinct
# problems, tviso and L1 at PDHG_SHORT iterations). Against float64 the
# cell's x is held to PDHG_X_BAR, not TOL_PARITY: the 8-direction
# projection's sign(p) jumps at p = 0, and f32 rounds the differences of
# flat regions to exactly 0 where float64 does not, so every sound f32
# solve departs by ~1e-2 (on an H100, 700 W: 1.045e-2 the plain version
# and the kernel, 1.079e-2 the composed solve; the isotropic scheme in its
# place reads 3.2e-2). The weighted TV objective (TOL_PARITY) and the
# residual (TOL_RESIDUAL) do not jump; the kernel run at λ·PDHG_WRONG_LAM
# must miss them.
PDHG_N, PDHG_BATCH, PDHG_LAM, PDHG_SIGMA, PDHG_ITERS, PDHG_SHORT = 256, 16, 5e-3, 0.0625, 200, 50
PDHG_SPREAD, PDHG_X_BAR, PDHG_WRONG_LAM = 2.0, 2e-2, 1.1
# the PDHG kernel's global route: 4 problems of 16 × 6000, rows too wide for
# any band of the resident route (tv8 fits at most 5,256 pixels a row)
PDHG_WIDE = (4, 16, 6000)
# the Kaczmarz cells of tools/bench_suite.py:254-306: L2 λ = 1e-6 + Positive,
# randomized with a precomputed order; the tall system (1024×256) 20 sweeps
# of 64 rows (fraction 0.0625), batch 16, dense and padded CSR; the 64 MiB
# system (8192×2048) 8 sweeps of 1024 rows (fraction 0.125), batch 4; and
# this script's greedy cell on the tall system, 20 sweeps of 64 steps,
# batch 16. The sweep kernel (row 12a) runs KZ_SWEEPS cyclic or shuffled
# sweeps of the tall system through Kaczmarz(backend="cuda"). Each kernel
# is held by `hold_dense` (DENSE_SPREAD × the plain version's spread under
# b·(1 + 2⁻²³), DENSE_FLOOR).
KZ_LAM, KZ_TALL, KZ_64MIB, KZ_GREEDY = 1e-6, (20, 0.0625, 16), (8, 0.125, 4), (20, 0.0625, 16)
KZ_SWEEPS = 4


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
    :80-96), the compressed-sensing image (256²) and its sorted sample
    indices (35 %, :107-111), the ADMM-TV deblurring image (256², :132-135), the dense LASSO
    cell's A (256×512) and sparse X (512×16, 5% nonzero, :208-211), the tall
    Kaczmarz system (1024×256 N(0,1), 70 % zeroed) and its |N(0,1)| x
    (:255-258), the 64 MiB one (8192×2048 N(0,1)/√2048) and its x
    (:292-294), and the 512² batch of 16 (:326-331) and 1024² batch of 8
    (:367-372) of phantoms; all float32, the images flattened."""
    rng = np.random.default_rng(0)
    a64 = (rng.normal(size=(64, 64)).astype(np.float32) / np.float32(8.0)).astype(np.float32)
    rng.normal(size=(64,))
    xt1 = rng.normal(size=(64, 16)).astype(np.float32)
    img2 = np.zeros((CS_N, CS_N), np.float32)
    for _ in range(8):
        i0, j0 = rng.integers(0, CS_N - 20, 2)
        img2[i0 : i0 + 12, j0 : j0 + 12] += rng.uniform(0.3, 1.0)
    idx2 = np.sort(rng.choice(CS_N * CS_N, size=int(0.35 * CS_N * CS_N), replace=False))
    img3 = np.zeros((256, 256), np.float32)
    for _ in range(6):
        i0, j0 = rng.integers(0, 256 - 40, 2)
        img3[i0 : i0 + 30, j0 : j0 + 30] += rng.uniform(0.3, 1.0)
    a2b = (rng.normal(size=(256, 512)) / np.sqrt(256)).astype(np.float32)
    x2b = (rng.normal(size=(512, 16)) * (rng.uniform(size=(512, 16)) < 0.05)).astype(np.float32)
    ak = rng.normal(size=(1024, 256)).astype(np.float32)
    ak[rng.uniform(size=ak.shape) < 0.7] = 0.0
    xtk = np.abs(rng.normal(size=(256,)).astype(np.float32))
    ak2 = (rng.normal(size=(8192, 2048)) / np.sqrt(2048)).astype(np.float32)
    xtk2 = np.abs(rng.normal(size=(2048,)).astype(np.float32))
    out = {"cgnr64": (a64, xt1), "admm": img3.reshape(-1), "lasso": (a2b, x2b),
           "cs": (img2.reshape(-1), idx2), "kz_tall": (ak, xtk), "kz_64mib": (ak2, xtk2)}
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
    cell's X as its phantoms (default_rng(2)), the LASSO cell's real A
    with a complex b (a second sparse X from the same generator as the
    imaginary part), and two more CGNR batches on the 1024×512 cell's A
    (X = N(0,1) from default_rng(4)): its first 1000 rows and 300 columns
    at batch 61, and the whole A at batch 137."""
    a64, xt1 = draws["cgnr64"]
    a2b, x2b = draws["lasso"]
    rng = np.random.default_rng(1)
    a1k = (rng.normal(size=(1024, 512)) / np.sqrt(1024)).astype(np.float32)
    x1k = rng.normal(size=(512, 64)).astype(np.float32)
    rng = np.random.default_rng(2)
    ac = ((rng.normal(size=(256, 512)) + 1j * rng.normal(size=(256, 512)))
          / np.sqrt(2 * 256)).astype(np.complex64)
    xi = (rng.normal(size=(512, 16)) * (rng.uniform(size=(512, 16)) < 0.05)).astype(np.float32)
    rng = np.random.default_rng(4)
    a_rem = np.ascontiguousarray(a1k[:1000, :300])
    x_rem = rng.normal(size=(300, 61)).astype(np.float32)
    x_137 = rng.normal(size=(512, 137)).astype(np.float32)
    return {
        # bench_suite multiplies the float64 quotient A / √64 (numpy ≥ 2)
        "cgnr64": (a64, (a64.astype(np.float64) @ xt1).astype(np.float32)),
        "cgnr1k": (a1k, (a1k.astype(np.float64) @ x1k).astype(np.float32)),
        # the CGNR kernel's cuts with remainders in the slabs and the
        # groups (1000 × 300, batch 61) and with more problems than SMs
        # (the 1024 × 512 A, batch 137)
        "cgnr_rem": (a_rem, (a_rem.astype(np.float64) @ x_rem).astype(np.float32)),
        "cgnr_p137": (a1k, (a1k.astype(np.float64) @ x_137).astype(np.float32)),
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
        f"{norm:.3e}, bitwise {bool(torch.equal(got, want))}; plain under a 1-ulp input "
        f"change: max {ulp_max:.3e}, rel. 2-norm {ulp_norm:.3e}"
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


def device_kernels(fn):
    """torch.profiler over one call of `fn` (warm it up first): [(device
    ms, count, kernel name)] of every device kernel it ran, the largest
    first. Their sum is the call's device time, which the host's launch
    delays do not move."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    return sorted(rows, reverse=True)


def device_breakdown(name, fn):
    """torch.profiler over one call of `fn` after a warm-up: print the
    wall time of one call without the profiler, the device time by kernel
    (the five largest) and the device's busy share of that wall time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    rows = device_kernels(fn)
    busy = sum(ms for ms, _, _ in rows)
    top = "; ".join(f"{key[:60]} {ms:.3f} ms ({count}×)" for ms, count, key in rows[:5])
    print(f"profile[{name}]: wall {wall:.2f} ms without the profiler, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%); {top or 'the profiler saw no device time'}")


def launch_counts(reset=False):
    """The launch counters of the fifteen kernel wrappers, by name; with
    `reset`, set them to 0 first (and the TV prox, PGM-TV (rows 2 and 3),
    ADMM-TV, SplitBregman, PDHG, FISTA-L1-DFT, FISTA-L21-SENSE and dense
    PGM (row 7a) kernels' counts by route)."""
    from rls_tpu_torch.kernels import admm_tv_fused, admm_tv_tiled, cgnr_fused, fista_l1_dft_fused
    from rls_tpu_torch.kernels import fista_tv_fused, fista_tv_tiled, pgm_dense_fused, sense_fused
    from rls_tpu_torch.kernels import kaczmarz_greedy, kaczmarz_streamed, pdhg_fused
    from rls_tpu_torch.kernels import splitbregman_fused, tv_fgp

    fns = (tv_fgp.prox_tv2d_fgp, fista_tv_fused.fista_tv_fused, fista_tv_tiled.fista_tv_tiled,
           admm_tv_fused.admm_tv_fused, admm_tv_tiled.admm_tv_tiled, cgnr_fused.cgnr_fused,
           pgm_dense_fused.pgm_dense_fused, pgm_dense_fused.pgm_dense_fused_cplx,
           fista_l1_dft_fused.fista_l1_dft_fused, sense_fused.fista_l21_sense_fused,
           splitbregman_fused.splitbregman_l1_tv_fused, pdhg_fused.pdhg_fused,
           kaczmarz_streamed.kaczmarz_sweep, kaczmarz_streamed.kaczmarz_solve,
           kaczmarz_greedy.kaczmarz_greedy_sweep)
    if reset:
        for fn in fns:
            fn.launches = 0
        for fn in (tv_fgp.prox_tv2d_fgp, fista_tv_fused.fista_tv_fused,
                   admm_tv_fused.admm_tv_fused, splitbregman_fused.splitbregman_l1_tv_fused,
                   pdhg_fused.pdhg_fused, fista_l1_dft_fused.fista_l1_dft_fused,
                   sense_fused.fista_l21_sense_fused):
            fn.route_launches = {"resident": 0, "global": 0}
        fista_tv_tiled.fista_tv_tiled.route_launches = {"cluster": 0, "tiles": 0}
        pgm_dense_fused.pgm_dense_fused.route_launches = {"grid": 0, "per_problem": 0}
    return {fn.__name__: fn.launches for fn in fns}


def admm_kernel_phase(dev, cases):
    """Each ADMM-TV kernel against its plain version: `cases` holds
    (cell, kernel wrapper, phantoms (batch, n²)); x0hat is the exact
    adjoint of the blurred phantoms. Each is held to the plain version's
    1-ulp spread with equal live CG steps, at the cell's batch and with
    the Positive projection at batch 4, and timed in turns with its plain
    version; then the other kernel at the same size is timed alone. The
    fused kernel prints each plan, must take its resident route at the cell
    (by its route counter, set to 0 just before) and is held alike on its
    global route at ADMM_WIDE. Returns {wrapper name: {"err", "ms":
    (plain, kernel), "live"}}."""
    import torch

    from rls_tpu_torch.kernels import _fgp_common
    from rls_tpu_torch.kernels import admm_tv_fused as admm_fused

    def hold_on_route(label, kernel, plain, x0, route):
        """hold_to_plain, the launch's plan printed first and its route
        counter required to read one launch on `route`."""
        plan, active = admm_fused.plan_on_card(x0, taps)
        print(f"{label}: plan route {plan.route}, {plan.clusters} CTAs per problem, "
              f"{plan.rows} rows per band, {plan.ctas} CTAs, {plan.smem} B of shared memory per "
              f"CTA, {active} clusters resident at once")
        admm_fused.admm_tv_fused.route_launches = {"resident": 0, "global": 0}
        err = hold_to_plain(label, kernel, plain, x0, show_counts=True, spread=ADMM_SPREAD)
        got = admm_fused.admm_tv_fused.route_launches
        require(got == {"resident": int(route == "resident"), "global": int(route == "global")},
                f"{label}: expected one launch on the {route} route, got {got}")
        return err

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
        label4 = f"{wrapper.__name__}[{n}², batch 4, positive]"
        pair4 = pair(cell, wrapper, taps, "positive")
        if wrapper is admm_fused.admm_tv_fused:
            err = hold_on_route(label, kernel, plain, x0, "resident")
            err = max(err, hold_on_route(label4, *pair4, x0[:4].contiguous(), "resident"))
            # the global route: rows too wide for a band, x0hat = AᴴA of noise
            B, H, W = ADMM_WIDE
            wide = torch.from_numpy(np.random.default_rng(11).normal(size=ADMM_WIDE)
                                    .astype(np.float32)).to(dev)
            wide = _fgp_common.sepconv_stencil_normal(wide, *taps).contiguous()
            err = max(err, hold_on_route(f"{wrapper.__name__}[{B} x {H}x{W}, global route]",
                                         kernel, plain, wide, "global"))
        else:
            err = hold_to_plain(label, kernel, plain, x0, show_counts=True, spread=ADMM_SPREAD)
            err = max(err, hold_to_plain(label4, *pair4, x0[:4].contiguous(), show_counts=True,
                                         spread=ADMM_SPREAD))
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
    (they must equal `launches`, every other counter 0, and the fused
    kernel's on its resident route), two columns held
    to a float64 solve of the plain version on the card, problems/s, and
    the device breakdown of one solve. With `composed`, the same through
    solve_batched_unrolled (the composed ADMM: one TV kernel launch per
    outer iteration); without, the composed solve is timed once, unheld.
    Returns (the launches of the solve_batched_fast run, the composed
    solve's ms: the kernel's library yardstick)."""
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
    counts, times = [], []
    for label, solve, want in runs:
        launch_counts(reset=True)
        x = solve(solver, B)
        torch.cuda.synchronize()
        got = launch_counts()
        counts.append(got)
        print(f"launches ({label}): {got}")
        require(got == {**{k: 0 for k in got}, **want},
                f"{label}: expected the launches {want} and no others")
        if "admm_tv_fused" in want:
            from rls_tpu_torch.kernels import admm_tv_fused as admm_fused

            routes = admm_fused.admm_tv_fused.route_launches
            require(routes == {"resident": want["admm_tv_fused"], "global": 0},
                    f"{label}: the fused kernel's routes {routes}, not the resident one")
        require(tuple(x.shape) == (n * n, batch), f"{label}: shape {tuple(x.shape)}")
        parity_f64(label, x, B, xs, op64, x64)
        ms = cuda_ms(lambda: solve(solver, B), reps=3)
        times.append(ms)
        print(f"{label}: {batch / (ms / 1e3):.1f} problems/s ({ms:.2f} ms per batch of {batch})")
    if not composed:
        rtt.solve_batched_unrolled(solver, B)
        times.append(cuda_ms(lambda: rtt.solve_batched_unrolled(solver, B), reps=1))
        print(f"{name}: solve_batched_unrolled (composed) {times[-1]:.3f} ms per batch of "
              f"{batch}")
    device_breakdown(name, lambda: rtt.solve_batched_fast(solver, B))
    return counts[0], times[-1]


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


def print_pgm_dense_plan(name, plan):
    """Print row 7a's plan: its route and, on the grid route, the cut of
    the cooperative grid."""
    if plan.route != "grid":
        print(f"{name}: plan {plan.route}, one CTA per problem")
        return
    print(f"{name}: plan grid, {plan.ctas} CTAs = {plan.slabs} slabs x {plan.groups} groups "
          f"(one cooperative grid), {plan.rows} rows per slab, {plan.group_size} problems per "
          f"group, A's slab in {'shared' if plan.resident else 'global'} memory, {plan.smem} B "
          "of shared memory per CTA")


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

    # CGNR: the two cells, Positive at batch 4, the complex A through the
    # split-real embedding, and the cuts with remainders and with more
    # problems than SMs
    a_c, b_c = systems["cplx"]
    emb_a, emb_b = cg.split_real_embedding(t(a_c), t(b_c.T))
    from rls_tpu_torch import _build

    limits = _build.device_limits(dev.index or 0)
    cases = (
        ("cgnr_l2_dense64_fused_b16", *map(t, systems["cgnr64"]), CGNR64_LAM, CGNR64_ITERS,
         "none"),
        ("cgnr_l2_dense_1024x512_b64", *map(t, systems["cgnr1k"]), CGNR1K_LAM, CGNR1K_ITERS,
         "none"),
        ("1024x512, batch 4, positive", t(systems["cgnr1k"][0]), t(systems["cgnr1k"][1][:, :4]),
         CGNR1K_LAM, CGNR1K_ITERS, "positive"),
        ("complex 256x512 embedded, batch 16", emb_a, emb_b.T, CGNR1K_LAM, 64, "none"),
        ("1000x300, batch 61", *map(t, systems["cgnr_rem"]), CGNR1K_LAM, CGNR1K_ITERS, "none"),
        ("1024x512, batch 137", *map(t, systems["cgnr_p137"]), CGNR1K_LAM, CGNR1K_ITERS,
         "none"),
    )
    for label, A, B, lam, iters, prox in cases:
        bt = B.T.contiguous()
        lam_v = torch.full((bt.shape[0],), lam, device=dev)
        steps = min(iters, A.shape[1])
        plan = cg.plan_cgnr(*A.shape, bt.shape[0], *limits)
        print(f"cgnr_fused[{label}]: plan {plan.ctas} CTAs = {plan.slabs} slabs x "
              f"{plan.groups} groups (one cooperative grid), {plan.rows} rows per slab, "
              f"{plan.group_size} problems per group, A's slab and p in "
              f"{'shared' if plan.resident else 'global'} memory, {plan.smem} B of shared "
              f"memory per CTA")

        def kernel(b, A=A, lam_v=lam_v, steps=steps, prox=prox):
            return cg.cgnr_fused(b, A, lam_v, steps, prox), None

        def plain(b, A=A, lam_v=lam_v, steps=steps, prox=prox):
            return cg.cgnr_fused_torch(b, A, lam_v, steps, prox), None

        note("cgnr_fused", hold_dense(f"cgnr_fused[{label}]", kernel, plain, (bt,),
                                      counts=False))
        if label.startswith("cgnr_l2_dense_1024"):
            out["cgnr_fused"]["ms"] = alternate_ms(lambda: plain(bt), lambda: kernel(bt), reps=3)

    # dense PGM on the LASSO cell's real A, each case one launch on the
    # grid route (the route counter)
    a2b, b2b = systems["lasso"]
    A, bt = t(a2b), t(b2b.T)
    rho = 0.95 / float(np.linalg.norm(a2b, 2)) ** 2
    print_pgm_dense_plan("pgm_dense_fused[LASSO cell]", pd.card_plan(bt, A))
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
        pd.pgm_dense_fused.route_launches = {"grid": 0, "per_problem": 0}
        note("pgm_dense_fused", hold_dense(label, kernel, plain, (bt,)))
        require(pd.pgm_dense_fused.route_launches == {"grid": 1, "per_problem": 0},
                f"{label}: routes {pd.pgm_dense_fused.route_launches}, not one grid launch")
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
    over these runs, and {kernel: its yardstick in ms}: torch.linalg.solve
    on the 1024×512 cell's regularized Gram (CGNR), the composed
    solve_batched_unrolled on the LASSO cell and on the complex case (the
    dense PGM rows), each composed solve timed once."""
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
        if kernel == "pgm_dense_fused":
            routes = pd.pgm_dense_fused.route_launches
            print(f"routes ({name}): {routes}")
            require(routes == {"grid": 1, "per_problem": 0},
                    f"{name}: routes {routes}, not one launch on the grid route")
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

    library = {}

    def composed(name, kernel, solver, B):
        rtt.solve_batched_unrolled(solver, B)
        library[kernel] = cuda_ms(lambda: rtt.solve_batched_unrolled(solver, B), reps=1)
        print(f"{name}: solve_batched_unrolled (composed) {library[kernel]:.3f} ms (yardstick)")

    # the two CGNR cells
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
            library["cgnr_fused"] = cuda_ms(lambda: torch.linalg.solve(G, AtB), reps=10)
            print(f"{name}: torch.linalg.solve(G, AᵀB) {library['cgnr_fused']:.3f} ms "
                  "(yardstick)")

    # the LASSO cell, with the table methods and the complex case
    a2b, b2b = systems["lasso"]
    A, B = t(a2b), t(b2b)
    rho = 0.95 / float(np.linalg.norm(a2b, 2)) ** 2
    op = rtt.DenseOperator(A, device=dev)
    solver = rtt.FISTA.create(op, reg=rtt.L1Regularization(LASSO_LAM), iterations=LASSO_ITERS,
                              rho=rho, track_residual=False)
    name = "fista_l1_dense_cs_b16_fused"
    print_pgm_dense_plan(name, pd.card_plan(B.T, A))
    x = run(name, solver, B, "pgm_dense_fused")
    composed(name, "pgm_dense_fused", solver, B)
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
    name = "complex A 256x512, fista-l1, gradient restart, real"
    run(name, s_c, t(b_c), "pgm_dense_fused_cplx")
    composed(name, "pgm_dense_fused_cplx", s_c, t(b_c))
    return launched, library


def cs_phantoms(img2):
    """BASELINE #2's image and CS_BATCH − 1 more drawn the same way (8
    squares of 12², amplitudes U(0.3, 1)) from default_rng(3): (CS_BATCH,
    n²) float32, distinct problems for the kernel phase."""
    rng = np.random.default_rng(3)
    imgs = np.zeros((CS_BATCH, CS_N, CS_N), np.float32)
    imgs[0] = img2.reshape(CS_N, CS_N)
    for b in range(1, CS_BATCH):
        for _ in range(8):
            i0, j0 = rng.integers(0, CS_N - 20, 2)
            imgs[b, i0 : i0 + 12, j0 : j0 + 12] += rng.uniform(0.3, 1.0)
    return imgs.reshape(CS_BATCH, -1)


def coil_maps(rng, C, n=SENSE_N):
    """tools/bench_suite.py:160-166's smooth complex coil maps, C of n²
    with centres drawn from `rng`, normalized to a unit sum of squares:
    (C, n, n) complex64."""
    yy, xx = np.mgrid[0:n, 0:n] / n
    maps = np.stack(
        [(np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) * 2.0) + 0.15)
         * np.exp(1j * (cx * yy - cy * xx) * 2)
         for cy, cx in rng.uniform(0, 1, size=(C, 2))]
    ).astype(np.complex64)
    maps /= np.sqrt((np.abs(maps) ** 2).sum(0))
    return maps


def sense_problem():
    """tools/bench_suite.py:153-184's SENSE problem, from its own
    default_rng(0): smooth complex coil maps normalized to a unit sum of
    squares, the 45 % k-space mask with its fully sampled 20×20 centre,
    and 8 complex phantoms. Returns numpy (maps (C, H, W) complex64, mask
    (H, W), X (8, 2·H·W) split [re; im] float32)."""
    H = W = SENSE_N
    rng4 = np.random.default_rng(0)
    maps = coil_maps(rng4, SENSE_C)
    mask = (rng4.uniform(size=(H, W)) < 0.45).astype(np.float32)
    mask[H // 2 - 10 : H // 2 + 10, W // 2 - 10 : W // 2 + 10] = 1.0

    def phantom(seed):
        im = np.zeros((H, W), np.complex64)
        r = np.random.default_rng(seed)
        for _ in range(5):
            i0, j0 = r.integers(4, H - 36, 2)
            im[i0 : i0 + 28, j0 : j0 + 28] += r.uniform(0.4, 1.0) * np.exp(1j * r.uniform(0, 1))
        return im

    xs = np.stack([phantom(s) for s in range(SENSE_SLICES)])
    X = np.concatenate([xs.real.reshape(SENSE_SLICES, -1), xs.imag.reshape(SENSE_SLICES, -1)],
                       axis=1).astype(np.float32)
    return maps, mask, X


def fft_ops(hw):
    """f32 operations of one complex 2-D FFT of hw points, counted at
    5·n·log₂n whatever the kernel implements."""
    return 5 * hw * int(np.log2(hw))


def rfft_ops(hw):
    """f32 operations of one 2-D FFT of hw points whose input or output is
    real: half a complex one."""
    return fft_ops(hw) // 2


def dft_ops(hw, iterations):
    """Per problem, the FISTA-L1 DFT solve: per iteration the normal op and
    the momentum (3), the residual and gradient step (3) and the soft
    threshold (7) per pixel. Re(Fᴴ M F x) of a real x is the real-output
    inverse of the real-input forward transform times the symmetrised mask
    (M + M reflected) / 2, so the normal op is two real 2-D FFTs and the
    weights on the half spectrum (1 per pixel)."""
    return iterations * (2 * rfft_ops(hw) + 14 * hw)


def sense_normal_ops(hw, coils):
    """One SENSE normal op: per coil two complex 2-D FFTs, the coil product
    (6), the mask (2) and the conjugate accumulation (8) per pixel."""
    return coils * (2 * fft_ops(hw) + 16 * hw)


def sense_ops(hw, coils, iterations):
    """Per slice, the FISTA-L21 SENSE solve: per iteration the normal op,
    the momentum (6), the gradient step (6) and the group threshold (9)
    per pixel."""
    return iterations * (sense_normal_ops(hw, coils) + 21 * hw)


def sb_ops(hw, coils, iterations, inner, tv, live_steps):
    """Per slice, the SplitBregman solve, counting only the CG steps that
    were live: per inner iteration β and ‖β‖² (14), the CG start (a normal
    op, r and r·r: 10), the L21 z-update and u (16), and one fold FGP per
    plane and its u (2 × (fold FGP + 3)); per outer iteration the reset (0)
    and the Bregman update (a normal op and 4); per live step the matvec
    (a normal op and 4), p·q (4), the x and r updates with r·r (12) and p
    (4)."""
    n = sense_normal_ops(hw, coils)
    per_inner = n + (14 + 10 + 16 + 2 * (fold_fgp_ops(tv) + 3)) * hw
    return iterations * (inner * per_inner + n + 4 * hw) + live_steps * (n + 24 * hw)


def hold_fft(name, kernel, plain, x0, x0_ulp, counts=False, bitwise=False):
    """Run `kernel(x0)` and `plain(x0)` (each → (x, counts)), and the plain
    version once more on x0_ulp, the seed of b·(1 + 2⁻²³); print the error,
    whether the two agree bit for bit, and the plain version's own spread
    (with `counts`, also the live CG steps of all three, which must agree
    between kernel and plain); hold the kernel to max(FFT_SPREAD × spread,
    FFT_FLOOR) in relative 2-norm and TOL_FUSED_MAX of max|x| per entry,
    and with `bitwise` to the plain version's bits. Returns (max|kernel −
    plain|, the kernel's counts)."""
    import torch

    got, kc = kernel(x0)
    want, pc = plain(x0)
    ulp, uc = plain(x0_ulp)
    torch.cuda.synchronize()
    norm = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    spread = float(torch.linalg.norm(ulp - want) / torch.linalg.norm(want))
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    bar = max(FFT_SPREAD * spread, FFT_FLOOR)
    print(f"{name}: max|kernel - plain| = {err:.3e} (max|x| {scale:.3f}), rel. 2-norm {norm:.3e}, "
          f"bitwise {bool(torch.equal(got, want))}; plain under b(1 + 2^-23): rel. 2-norm "
          f"{spread:.3e} (bar {bar:.3e})")
    require(bool(torch.isfinite(got).all()), f"{name} kernel gave non-finite values")
    if counts:
        print(f"{name}: live CG steps kernel {kc.tolist()} plain {pc.tolist()} "
              f"plain(1 ulp) {uc.tolist()}")
        require(kc.tolist() == pc.tolist(),
                f"{name}: the kernel's live CG steps differ from the plain version's")
    require(norm <= bar and err <= TOL_FUSED_MAX * scale,
            f"{name} kernel disagrees: max {err:.3e}, rel. 2-norm {norm:.3e}")
    require(not bitwise or bool(torch.equal(got, want)),
            f"{name}: the kernel differs from the plain version's bits")
    return err, kc


def fft_kernel_phase(dev, draws):
    """Phase 3h: each FFT kernel against its plain version at its main-path
    shape, held by `hold_fft` and timed in turns with it: FISTA-L1 on 16
    distinct 256² CS problems with λ per problem (and its global route at
    512²), FISTA-L21 and SplitBregman on the 8 SENSE slices, each on its
    resident route by the route counter; then the global routes of
    FISTA-L21 and SplitBregman at 256 × 128, held but not timed. Returns
    {kernel: {"err", "ms": (plain, kernel), "live"}}."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import _dft_common as dc
    from rls_tpu_torch.kernels import fista_l1_dft_fused as k8
    from rls_tpu_torch.kernels import sense_fused as k9
    from rls_tpu_torch.kernels import splitbregman_fused as k10
    from rls_tpu_torch.kernels.fista_tv_fused import _momentum_table, problem_scalars

    out = {}
    bump = 1.0 + 2.0**-23

    def record(name, kernel, plain, x0, x0u, counts=False, reps=2, bitwise=False):
        err, live = hold_fft(name, kernel, plain, x0, x0u, counts, bitwise)
        ms = alternate_ms(lambda: plain(x0), lambda: kernel(x0), reps=reps)
        print(f"{name}: kernel {ms[1]:.3f} ms, plain {ms[0]:.3f} ms")
        out[name.split("[")[0]] = {"err": err, "ms": ms, "live": live}

    # row 8: 16 distinct problems, one λ each
    img2, idx2 = draws["cs"]
    op = rtt.SubsampledDFT2RealOperator.from_sample_idx(idx2, (CS_N, CS_N), device=dev)
    b = op.mv(torch.from_numpy(cs_phantoms(img2)).to(dev))
    x0 = op.rmv(b).reshape(CS_BATCH, CS_N, CS_N)
    x0u = op.rmv(b * bump).reshape(x0.shape)
    lam = torch.linspace(0.5, 2.0, CS_BATCH, device=dev) * CS_LAM
    scal = problem_scalars(x0, RHO, lam)
    tab = torch.as_tensor(_momentum_table("fista", CS_ITERS), device=dev)
    tables = dc.dft_tables(op.mask)
    plan, active = k8.plan_on_card(x0)
    print(f"fista_l1_dft_fused[{CS_N}², batch {CS_BATCH}]: plan route {plan.route}, "
          f"{plan.clusters} CTAs per problem, {plan.rows}-row bands, {plan.cols}-column blocks, "
          f"{plan.ctas} CTAs, {plan.smem} B of shared memory per CTA, {active} clusters "
          f"resident at once")
    k8.fista_l1_dft_fused.route_launches = {"resident": 0, "global": 0}
    record(f"fista_l1_dft_fused[{CS_N}², batch {CS_BATCH}, {CS_ITERS} it.]",
           lambda x: (k8.fista_l1_dft_fused(x, op.mask, RHO, lam, CS_ITERS), None),
           lambda x: (k8.fista_l1_dft_fused_torch(x, scal, tab, tables), None), x0, x0u,
           bitwise=True)
    routes = k8.fista_l1_dft_fused.route_launches
    require(plan.route == "resident" and routes["global"] == 0 and routes["resident"] > 0,
            f"the FISTA-L1-DFT kernel at {CS_N}² took the resident route: {plan}, {routes}")
    # its global route (one CTA per problem, the spectrum through global
    # scratch), which a spectrum too large for a cluster's bands takes: 4
    # problems of 512² on a 35 % mask, held to the bit but not timed
    gn, gb = 512, 4
    rng = np.random.default_rng(11)
    gop = rtt.SubsampledDFT2RealOperator.from_mask(rng.uniform(size=(gn, gn)) < 0.35, (gn, gn),
                                                    device=dev)
    gbv = gop.mv(torch.from_numpy(rng.normal(size=(gb, gn * gn)).astype(np.float32)).to(dev))
    gx0, gx0u = (gop.rmv(v).reshape(gb, gn, gn) for v in (gbv, gbv * bump))
    glam = torch.linspace(0.5, 2.0, gb, device=dev) * CS_LAM
    gscal = problem_scalars(gx0, RHO, glam)
    gtables = dc.dft_tables(gop.mask)
    gplan, _ = k8.plan_on_card(gx0)
    print(f"fista_l1_dft_fused[{gn}², batch {gb}]: plan route {gplan.route}, {gplan.ctas} CTAs")
    k8.fista_l1_dft_fused.route_launches = {"resident": 0, "global": 0}
    hold_fft(f"fista_l1_dft_fused[global route, {gn}², batch {gb}, {CS_ITERS} it.]",
             lambda x: (k8.fista_l1_dft_fused(x, gop.mask, RHO, glam, CS_ITERS), None),
             lambda x: (k8.fista_l1_dft_fused_torch(x, gscal, tab, gtables), None), gx0, gx0u,
             bitwise=True)
    routes = k8.fista_l1_dft_fused.route_launches
    require(routes == {"resident": 0, "global": 1},
            f"the FISTA-L1-DFT kernel at {gn}² took the global route once: {routes}")

    # rows 9 and 10: the 8 SENSE slices
    maps, mask, X = sense_problem()
    op = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (SENSE_N, SENSE_N), device=dev)
    b = op.mv(torch.from_numpy(X).to(dev))
    shape = (SENSE_SLICES, 2, SENSE_N, SENSE_N)
    x0, x0u = op.rmv(b).reshape(shape), op.rmv(b * bump).reshape(shape)
    coils = (op.coils_r, op.coils_i)
    tables = dc.dft_tables(op.mask)
    scal = k9.problem_scalars(x0, RHO, SENSE_LAM)
    tab = torch.as_tensor(_momentum_table("fista", SENSE_ITERS), device=dev)
    plan = k9.plan_on_card(x0, SENSE_C)
    print(f"sense_fused[{SENSE_N}², {SENSE_C} coils, {SENSE_SLICES} slices]: plan route "
          f"{plan.route}, {plan.clusters} CTAs per slice, bands "
          f"{[plan.band(q) for q in range(plan.clusters)]}, {plan.rounds} round(s), "
          f"{plan.ctas} CTAs, {plan.smem} B of shared memory per CTA, "
          f"{plan.resident_clusters} clusters resident at once")
    k9.fista_l21_sense_fused.route_launches = {"resident": 0, "global": 0}
    record(f"sense_fused[{SENSE_N}², {SENSE_C} coils, {SENSE_SLICES} slices, {SENSE_ITERS} it.]",
           lambda x: (k9.fista_l21_sense_fused(x, op.mask, *coils, RHO, SENSE_LAM, SENSE_ITERS),
                      None),
           lambda x: (k9.fista_l21_sense_fused_torch(x, scal, tab, coils, tables), None), x0, x0u,
           bitwise=True)
    routes = k9.fista_l21_sense_fused.route_launches
    require(plan.route == "resident" and routes["global"] == 0 and routes["resident"] > 0,
            f"the FISTA-L21-SENSE kernel at {SENSE_N}² took the resident route: {plan}, "
            f"{routes}")
    scal, t2 = k10.kernel_args(x0, SB_RHO, SB_RHO, SB_LAM, SB_LAM, SB_TV)
    plan = k10.plan_on_card(x0, SENSE_C)
    print(f"splitbregman_fused[{SENSE_N}², {SENSE_C} coils, {SENSE_SLICES} slices]: plan route "
          f"{plan.route}, {plan.clusters} CTAs per slice, bands "
          f"{[plan.band(q) for q in range(plan.clusters)]}, {plan.rounds} coil(s) per CTA "
          f"(one per round), {plan.ctas} CTAs, {plan.smem} B of shared memory per CTA, "
          f"{plan.resident_clusters} clusters resident at once")
    record(f"splitbregman_fused[{SENSE_N}², {SENSE_C} coils, {SENSE_SLICES} slices, "
           f"{'×'.join(map(str, SB_SCHED))}, TV {SB_TV}]",
           lambda x: k10.splitbregman_l1_tv_fused(x, op.mask, *coils, SB_RHO, SB_RHO, SB_LAM,
                                                  SB_LAM, *SB_SCHED, SB_TV, SB_TOL,
                                                  with_counts=True),
           lambda x: k10.splitbregman_l1_tv_fused_torch(x, scal, t2, coils, tables, *SB_SCHED,
                                                        SB_TOL),
           x0, x0u, counts=True, reps=1)

    # the global routes of rows 9 and 10 (one CTA per slice, staging the
    # spectrum through global scratch), which a spectrum too large for one
    # CTA takes: 2 slices of 256 × 128 at 6 coils, row 9 at SENSE_ITERS
    # iterations, row 10 on BASELINE #4's schedule; held to the bit (row 9)
    # and to the spread (row 10), not timed
    gh, gw, gb = 256, 128, 2
    rng = np.random.default_rng(10)
    gmaps = rng.normal(size=(SENSE_C, gh, gw)) + 1j * rng.normal(size=(SENSE_C, gh, gw))
    gmaps /= np.sqrt((np.abs(gmaps) ** 2).sum(0))
    gmask = (rng.uniform(size=(gh, gw)) < 0.45).astype(np.float32)
    gop = rtt.SenseDFT2RealOperator.from_maps(gmaps, gmask, (gh, gw), device=dev)
    gbv = gop.mv(torch.from_numpy(rng.normal(size=(gb, 2 * gh * gw)).astype(np.float32)).to(dev))
    gshape = (gb, 2, gh, gw)
    gx0, gx0u = gop.rmv(gbv).reshape(gshape), gop.rmv(gbv * bump).reshape(gshape)
    gcoils, gtables = (gop.coils_r, gop.coils_i), dc.dft_tables(gop.mask)
    gplan = k9.plan_on_card(gx0, SENSE_C)
    print(f"sense_fused[{gh}×{gw}, {SENSE_C} coils, {gb} slices]: plan route {gplan.route}, "
          f"{gplan.ctas} CTAs")
    gscal = k9.problem_scalars(gx0, RHO, SENSE_LAM)
    k9.fista_l21_sense_fused.route_launches = {"resident": 0, "global": 0}
    hold_fft(f"sense_fused[global route, {gh}×{gw}, {SENSE_C} coils, {gb} slices, "
             f"{SENSE_ITERS} it.]",
             lambda x: (k9.fista_l21_sense_fused(x, gop.mask, *gcoils, RHO, SENSE_LAM,
                                                 SENSE_ITERS), None),
             lambda x: (k9.fista_l21_sense_fused_torch(x, gscal, tab, gcoils, gtables), None),
             gx0, gx0u, bitwise=True)
    routes = k9.fista_l21_sense_fused.route_launches
    require(routes == {"resident": 0, "global": 1},
            f"the FISTA-L21-SENSE kernel at {gh}×{gw} took the global route once: {routes}")
    gplan = k10.plan_on_card(gx0, SENSE_C)
    print(f"splitbregman_fused[{gh}×{gw}, {SENSE_C} coils, {gb} slices]: plan route "
          f"{gplan.route}, {gplan.ctas} CTAs")
    scal, t2 = k10.kernel_args(gx0, SB_RHO, SB_RHO, SB_LAM, SB_LAM, SB_TV)
    k10.splitbregman_l1_tv_fused.route_launches = {"resident": 0, "global": 0}
    hold_fft(f"splitbregman_fused[global route, {gh}×{gw}, {SENSE_C} coils, {gb} slices, "
             f"{'×'.join(map(str, SB_SCHED))}, TV {SB_TV}]",
             lambda x: k10.splitbregman_l1_tv_fused(x, gop.mask, *gcoils, SB_RHO, SB_RHO, SB_LAM,
                                                    SB_LAM, *SB_SCHED, SB_TV, SB_TOL,
                                                    with_counts=True),
             lambda x: k10.splitbregman_l1_tv_fused_torch(x, scal, t2, gcoils, gtables,
                                                          *SB_SCHED, SB_TOL),
             gx0, gx0u, counts=True)
    routes = k10.splitbregman_l1_tv_fused.route_launches
    require(routes == {"resident": 0, "global": 1},
            f"the SplitBregman kernel at {gh}×{gw} took the global route once: {routes}")
    return out


def parity_fft(name, x, B, xs_true, op64, x64):
    """Hold the first k = len(x64) columns of a solve `x` (n × K) to the
    float64 solutions `x64` (k × n): the worst column's relative error
    (≤ TOL_PARITY) and |‖A x − b‖ − ‖A x64 − b‖| / ‖b‖ with A in float64
    (≤ TOL_RESIDUAL); print the reconstruction error against the true
    images `xs_true` (K × n) beside the float64 solve's own and the
    zero-filled Aᴴb's, which the reconstruction must beat."""
    import torch

    k = x64.shape[0]
    require(bool(torch.isfinite(x).all()), f"{name}: non-finite values")
    xc = x[:, :k].T.double()
    b64 = B[:, :k].T.double()
    rel = float(max(torch.linalg.norm(xc[j] - x64[j]) / torch.linalg.norm(x64[j])
                    for j in range(k)))
    r_x = torch.linalg.norm(op64.mv(xc) - b64, dim=1)
    r_64 = torch.linalg.norm(op64.mv(x64) - b64, dim=1)
    res = float(((r_x - r_64).abs() / torch.linalg.norm(b64, dim=1)).max())

    def err(v, truth):
        return float(torch.linalg.norm(v - truth) / torch.linalg.norm(truth))

    truth = xs_true.double()
    rec = err(x.T.double(), truth)
    zf = err(op64.rmv(B.T.double()), truth)
    print(f"{name}: recon_rel_err {rec:.4e} (float64 solve {err(x64, truth[:k]):.4e}, zero-filled "
          f"{zf:.4f}), max_rel_err vs f64 {rel:.3e}, residual_rel_diff vs f64 {res:.3e}")
    require(rec < zf, f"{name}: the reconstruction is no better than the zero-filled Aᴴb")
    require(rel <= TOL_PARITY, f"{name}: max_rel_err vs f64 {rel:.3e}")
    require(res <= TOL_RESIDUAL, f"{name}: residual_rel_diff vs f64 {res:.3e}")


def splitbregman_solver(op, dev):
    """BASELINE #4's SplitBregman (tools/bench_suite.py:185-194) on the
    SENSE operator `op`: L21 + per-plane TV with identity trafos."""
    import torch

    import rls_tpu_torch as rtt

    n = SENSE_N * SENSE_N
    return rtt.SplitBregman.create(
        op,
        reg=[rtt.L21Regularization(SB_LAM, slices=2),
             rtt.TVRegularization(SB_LAM, shape=(2, SENSE_N, SENSE_N), dims=(1, 2),
                                  iterations_tv=SB_TV)],
        reg_trafo=[rtt.IdentityOperator(2 * n, torch.float32, device=dev),
                   rtt.IdentityOperator(2 * n, torch.float32, device=dev)],
        iterations=SB_SCHED[0], iterations_inner=SB_SCHED[1], iterations_cg=SB_SCHED[2],
        unroll_cg=True, rho=[SB_RHO, SB_RHO], tol_inner=SB_TOL,
    )


def fft_cell_phase(dev, draws):
    """Phase 9: the three CS / SENSE cells through solve_batched_fast, each
    with the launch counters set to 0 just before the solve and read just
    after (one launch of its kernel, none of any other), problems/s, and
    two columns held by `parity_fft` to a float64 solve of the plain
    version on the card; BASELINE #2 and #4 also through
    solve_batched_unrolled (the composed torch.fft path: no kernel). Every
    cell's composed solve is timed: the yardstick of its kernel. Returns
    ({kernel: launches}, {kernel: composed ms})."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import _dft_common as dc
    from rls_tpu_torch.kernels import fista_l1_dft_fused as k8
    from rls_tpu_torch.kernels import sense_fused as k9
    from rls_tpu_torch.kernels import splitbregman_fused as k10
    from rls_tpu_torch.kernels.fista_tv_fused import _momentum_table, problem_scalars

    launched, composed_ms = {}, {}
    routed = {fn.__name__: fn for fn in (k8.fista_l1_dft_fused, k9.fista_l21_sense_fused,
                                         k10.splitbregman_l1_tv_fused)}

    def run(name, solver, B, xs_true, kernel, ref, composed, unit="problems/s"):
        K = B.shape[1]
        launch_counts(reset=True)
        x = rtt.solve_batched_fast(solver, B)
        torch.cuda.synchronize()
        got = launch_counts()
        print(f"launches ({name}): {got}")
        require(got == {**{k: 0 for k in got}, kernel: 1},
                f"{name}: expected one launch of {kernel} and no others")
        if kernel in routed:
            routes = routed[kernel].route_launches
            print(f"launches ({name}) by route: {routes}")
            require(routes == {"resident": 1, "global": 0},
                    f"{name}: expected one launch on the resident route, got {routes}")
        launched[kernel] = 1
        require(tuple(x.shape) == (solver.A.in_size, K), f"{name}: shape {tuple(x.shape)}")
        parity_fft(name, x, B, xs_true, *ref)
        ms = cuda_ms(lambda: rtt.solve_batched_fast(solver, B), reps=3)
        print(f"{name}: {K / (ms / 1e3):.1f} {unit} ({ms:.3f} ms per batch of {K})")
        if composed:
            launch_counts(reset=True)
            xc = rtt.solve_batched_unrolled(solver, B)
            torch.cuda.synchronize()
            got = launch_counts()
            require(not any(got.values()), f"{name} composed: kernel launches {got}")
            parity_fft(f"{name} composed", xc, B, xs_true, *ref)
        rtt.solve_batched_unrolled(solver, B)  # warm-up: cuFFT's plans
        composed_ms[kernel] = cuda_ms(lambda: rtt.solve_batched_unrolled(solver, B), reps=2)
        print(f"{name}: solve_batched_unrolled (torch.fft) {K / (composed_ms[kernel] / 1e3):.1f} "
              f"{unit} ({composed_ms[kernel]:.3f} ms per batch of {K})")

    # fista_l1_cs_dft256_b16: the bench tiles its one column 16 times
    img2, idx2 = draws["cs"]
    op = rtt.SubsampledDFT2RealOperator.from_sample_idx(idx2, (CS_N, CS_N), device=dev)
    xt = torch.from_numpy(img2).to(dev)
    B = op.mv(xt)[:, None].repeat(1, CS_BATCH).contiguous()
    solver = rtt.FISTA.create(op, reg=rtt.L1Regularization(CS_LAM), iterations=CS_ITERS, rho=RHO,
                              rel_tol=0.0, track_residual=False)
    op64 = rtt.SubsampledDFT2RealOperator.from_sample_idx(idx2, (CS_N, CS_N),
                                                          dtype=torch.float64, device=dev)
    x0 = op64.rmv(B[:, :2].T.double()).reshape(2, CS_N, CS_N)
    scal = problem_scalars(x0, RHO, CS_LAM, np.float64)
    tab = torch.as_tensor(_momentum_table("fista", CS_ITERS, dtype=np.float64), device=dev)
    x64 = k8.fista_l1_dft_fused_torch(x0, scal, tab, dc.dft_tables(op64.mask, torch.float64))
    run("fista_l1_cs_dft256_b16", solver, B, xt[None].repeat(CS_BATCH, 1), "fista_l1_dft_fused",
        (op64, x64.reshape(2, -1)), composed=True)

    # the SENSE cells
    maps, mask, X = sense_problem()
    op = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (SENSE_N, SENSE_N), device=dev)
    op64 = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (SENSE_N, SENSE_N),
                                               dtype=torch.float64, device=dev)
    xs = torch.from_numpy(X).to(dev)
    B = op.mv(xs).T.contiguous()
    x0 = op64.rmv(B[:, :2].T.double()).reshape(2, 2, SENSE_N, SENSE_N)
    coils64, tables64 = (op64.coils_r, op64.coils_i), dc.dft_tables(op64.mask, torch.float64)
    solver = rtt.FISTA.create(op, reg=rtt.L21Regularization(SENSE_LAM, slices=2),
                              iterations=SENSE_ITERS, rho=RHO)
    scal = k9.problem_scalars(x0, RHO, SENSE_LAM, np.float64)
    tab = torch.as_tensor(_momentum_table("fista", SENSE_ITERS, dtype=np.float64), device=dev)
    x64 = k9.fista_l21_sense_fused_torch(x0, scal, tab, coils64, tables64).reshape(2, -1)
    run("fista_l21_sense128_6coil_b8", solver, B, xs, "fista_l21_sense_fused", (op64, x64),
        composed=False, unit="slices/s")
    solver = splitbregman_solver(op, dev)
    scal, t2 = k10.kernel_args(x0, SB_RHO, SB_RHO, SB_LAM, SB_LAM, SB_TV, np.float64)
    x64, live64 = k10.splitbregman_l1_tv_fused_torch(x0, scal, t2, coils64, tables64, *SB_SCHED,
                                                     SB_TOL)
    print(f"splitbregman_sense128_6coil_b8: float64 plain solve's live CG steps {live64.tolist()}"
          f" of {SB_SCHED[0] * SB_SCHED[1] * SB_SCHED[2]}")
    run("splitbregman_sense128_6coil_b8", solver, B, xs, "splitbregman_l1_tv_fused",
        (op64, x64.reshape(2, -1)), composed=True, unit="slices/s")
    return launched, composed_ms


def pdhg_cell_solver(dev, dtype=None, tau=None):
    """The PDHG cell's solver (PDHG_*): the 9-tap Gaussian on both axes,
    8-direction TV; τ from the port's power iteration unless given."""
    import torch

    import rls_tpu_torch as rtt

    g = np.exp(-((np.arange(9) - 4) ** 2) / 8.0)
    g = g / g.sum()
    op = rtt.SeparableConvOperator.from_taps(g, g, (PDHG_N, PDHG_N),
                                             dtype=dtype or torch.float32, device=dev)
    return rtt.PDHG.create(op, reg=rtt.TVRegularization(PDHG_LAM, shape=(PDHG_N, PDHG_N)),
                           iterations=PDHG_ITERS, sigma=PDHG_SIGMA, tau=tau)


def pdhg_ops(kh, kw, kind):
    """f32 operations per pixel and iteration of the fused PDHG: A and Aᴴ
    (two stencil passes each), the y₁ update (4), the x update (3); tv8: 8
    differences, the dual step (16), the sequential projection (per plane
    the group norm 15, sqrt, sign, min and 2 products: 20) and Φᴴ (15);
    tviso: 2 differences, the dual step (4), two clips (5 each) and Φᴴ
    (3); l1: the dual step (2) and the clip (5)."""
    own = {"tv8": 8 + 16 + 8 * 20 + 15, "tviso": 2 + 4 + 10 + 3, "l1": 2 + 5}[kind]
    return 2 * (2 * kh - 1) + 2 * (2 * kw - 1) + 4 + 3 + own


def pdhg_kernel_phase(dev, solver):
    """Phase 3i, row 11: the fused PDHG kernel against its plain version on
    16 distinct 256² problems (bench.py's phantoms blurred by the cell's
    operator), tv8 at the cell's 200 iterations, tviso and L1 (with
    Positive) at PDHG_SHORT, each plan printed first and each required to
    run once on the resident route and to agree bit for bit (the plain
    version's 1-ulp spread printed beside it); tv8 timed in turns with its
    plain version. Then the global route on PDHG_WIDE (tv8, PDHG_SHORT
    iterations), held by `hold_to_plain` to PDHG_SPREAD × the plain
    version's spread, with the route counter set to 0 just before and
    required to read one global launch. Returns {"err", "ms": (plain,
    kernel)}."""
    import torch

    from rls_tpu_torch.kernels import pdhg_fused as pd

    op = solver.A
    taps = op.taps_hw()
    xs = torch.from_numpy(phantoms(n=PDHG_N, batch=PDHG_BATCH)).to(dev)
    u = op.mv(xs).reshape(PDHG_BATCH, PDHG_N, PDHG_N).contiguous()
    none = torch.zeros(0)
    routes = pd.pdhg_fused.route_launches

    def pair(kind, prox, iters):
        def kernel(x):
            return pd.pdhg_fused(x, taps, solver.sigma, solver.tau, PDHG_LAM, iters, kind,
                                 prox), none

        def plain(x):
            scal = pd.kernel_scalars(x, solver.sigma, solver.tau, PDHG_LAM)
            return pd.pdhg_fused_torch(x, scal, taps, iters, kind, prox), none

        return kernel, plain

    out = {"err": 0.0}
    for kind, prox, iters in (("tv8", "none", PDHG_ITERS), ("tviso", "none", PDHG_SHORT),
                              ("l1", "positive", PDHG_SHORT)):
        kernel, plain = pair(kind, prox, iters)
        label = f"pdhg_fused[{kind}, {prox}, {PDHG_N}², batch {PDHG_BATCH}, {iters} it.]"
        plan, active = pd.plan_on_card(u, taps, kind)
        print(f"{label}: plan route {plan.route}, {plan.clusters} CTAs per problem, "
              f"{plan.rows} rows per band, {plan.ctas} CTAs, {plan.smem} B of shared memory "
              f"per CTA, {active} clusters resident at once")
        before = routes["resident"]
        err = hold_to_plain(label, kernel, plain, u, spread=PDHG_SPREAD)
        require(routes["resident"] == before + 1, f"{label}: not one launch on the resident route")
        require(err == 0.0, f"{label}: the resident route is not bitwise the plain version")
        out["err"] = max(out["err"], err)
        if kind == "tv8":
            out["ms"] = alternate_ms(lambda: plain(u), lambda: kernel(u), reps=1)
            print(f"{label}: kernel {out['ms'][1]:.3f} ms, plain {out['ms'][0]:.3f} ms")
    # the global route
    B, H, W = PDHG_WIDE
    uw = op.mv(xs[:B]).reshape(B, PDHG_N, PDHG_N)[:, :H, :].repeat(1, 1, -(-W // PDHG_N))
    uw = uw[..., :W].contiguous()
    kernel, plain = pair("tv8", "none", PDHG_SHORT)
    label = f"pdhg_fused[tv8, none, {B} x {H}x{W}, {PDHG_SHORT} it., global route]"
    require(pd.plan_on_card(uw, taps, "tv8")[0].route == "global", f"{label}: not planned global")
    pd.pdhg_fused.route_launches = {"resident": 0, "global": 0}
    out["err"] = max(out["err"], hold_to_plain(label, kernel, plain, uw, spread=PDHG_SPREAD))
    got = pd.pdhg_fused.route_launches
    print(f"{label}: launches by route {got}")
    require(got == {"resident": 0, "global": 1}, f"{label}: launches by route {got}")
    return out


def kaczmarz_systems(draws, dev):
    """The Kaczmarz systems on the card: the tall A (1024×256) with 16
    distinct x (|N(0,1)|, default_rng(3)) and the cell's x, the 64 MiB A
    with 4 distinct x (default_rng(4)) and the cell's x, a complex A
    (512×128, (N + iN)/16, default_rng(5)) with 4 complex x, and 4 complex
    b for the tall real A; each b = A x with A in float32. Values: (A, B of
    distinct b, B of the cell, the cell's x)."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ak, xtk = draws["kz_tall"]
    ak2, xtk2 = draws["kz_64mib"]
    x16 = np.abs(np.random.default_rng(3).normal(size=(256, 16))).astype(np.float32)
    x4 = np.abs(np.random.default_rng(4).normal(size=(2048, 4))).astype(np.float32)
    rng = np.random.default_rng(5)
    ac = ((rng.normal(size=(512, 128)) + 1j * rng.normal(size=(512, 128))) / 16).astype(
        np.complex64)
    xc = (rng.normal(size=(128, 4)) + 1j * rng.normal(size=(128, 4))).astype(np.complex64)
    xcb = (rng.normal(size=(256, 4)) + 1j * rng.normal(size=(256, 4))).astype(np.complex64)
    return {
        "tall": (t(ak), t(ak @ x16), t(np.tile((ak @ xtk)[:, None], (1, 16))), t(xtk)),
        "64mib": (t(ak2), t(ak2 @ x4), t(np.tile((ak2 @ xtk2)[:, None], (1, 4))), t(xtk2)),
        "complex": (t(ac), t(ac @ xc)),
        "complex_b": t(ak.astype(np.complex64) @ xcb),
    }


def kaczmarz_solver(op, cell, greedy=False, positive=True, **kw):
    """The Kaczmarz cells' solver on operator `op`: L2 λ = KZ_LAM (+ Positive),
    `cell` = (sweeps, sub-matrix fraction, batch); randomized with a
    precomputed order unless told otherwise, or greedy."""
    import rls_tpu_torch as rtt

    sweeps, fraction, _ = cell
    reg = [rtt.L2Regularization(KZ_LAM)] + ([rtt.PositiveRegularization()] if positive else [])
    if greedy:
        kw.update(greedy_randomized=True)
    else:
        kw.setdefault("randomized", True)
        kw.setdefault("precompute_order", kw["randomized"])
    return rtt.Kaczmarz.create(op, reg=reg, iterations=sweeps, sub_matrix_fraction=fraction,
                               **kw)


def as_float64(solver):
    """`solver` on its operator in float64 (dense), with the same row
    orders."""
    import dataclasses

    import torch

    import rls_tpu_torch as rtt

    mat = solver.A.to_dense()
    mat = mat.to(torch.complex128 if mat.is_complex() else torch.float64)
    s64 = type(solver).create(
        rtt.DenseOperator(mat, device=mat.device),
        reg=[solver.l2, *solver.reg], iterations=solver.iterations,
        randomized=solver.randomized, greedy_randomized=solver.greedy,
        sub_matrix_fraction=solver.sub_matrix_size / solver.A.out_size, theta=solver.theta,
        seed=solver.seed,
    )
    return dataclasses.replace(s64, perm=solver.perm, precomputed_order=solver.precomputed_order)


def streamed_plain(solver, B, dtype=None):
    """`solve_kaczmarz_streamed(solver, B)` with the kernel's plain version
    (in float32, or `dtype`): n × K."""
    import torch

    from rls_tpu_torch.kernels import kaczmarz_streamed as ks

    if not solver.A.dtype.is_complex and B.is_complex():
        re = streamed_plain(solver, torch.cat([B.real, B.imag], dim=1), dtype)
        K = B.shape[1]
        return torch.complex(re[:, :K], re[:, K:])
    rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse = ks.solver_operands(
        solver, B, dtype or torch.float32)
    x, _ = ks.kaczmarz_solve_torch(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse,
                                   ks.sweep_projection(solver), cols)
    sol = torch.complex(x[:, 0], x[:, 1]) if x.shape[1] == 2 else x[:, 0]
    if solver.tikhonov_inv_sqrt is not None:
        sol = sol * solver.tikhonov_inv_sqrt.to(sol.dtype)[None, :]
    return sol.T


def kaczmarz_ops(n, steps):
    """f32 operations of `steps` row steps of one problem on real rows of n
    entries: the dot (2n), α (5), the axpy (2n) and the dual bump (2)."""
    return steps * (4 * n + 7)


def greedy_ops(m, n, steps):
    """f32 operations of `steps` greedy steps of one problem: |r|², its sum
    and r²·denom and their max (4m), the threshold (2m), log w and the
    Gumbel noise (4 per row, counted on every row), the argmax (m), α, the
    axpy (2n), the dual bump (2) and r −= r_row·Gt[row] (2m); the hash is
    integer work and not counted."""
    return steps * (13 * m + 2 * n + 3)


def kaczmarz_kernel_phase(dev, kz):
    """Phase 3i, rows 12a, 12b and 13, each held by `hold_dense`:
    12a through Kaczmarz(backend="cuda") (cyclic and shuffled, KZ_SWEEPS
    sweeps of the tall system, batch 16: the main path of the sweep kernel,
    its launches counted), one sweep timed in turns with its plain version
    and the composed one-sweep solve; 12b through solve_kaczmarz_streamed
    on the tall system (dense and padded CSR, 16 distinct b), the 64 MiB
    system (4 b), a complex system and the tall real A with complex b, the
    tall dense solve timed in turns with its plain version; 13 through
    greedy_solve with forced rows and with sampled draws, whose rows must
    equal the plain version's, one sweep timed in turns and the composed
    one-sweep greedy solve. Returns {kernel: {"err", "ms", ...}}."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import kaczmarz_greedy as kg
    from rls_tpu_torch.kernels import kaczmarz_streamed as ks

    A, B16, _, _ = kz["tall"]
    out = {k: {"err": 0.0} for k in ("kaczmarz_sweep", "kaczmarz_solve", "kaczmarz_greedy_sweep")}

    def note(name, err):
        out[name]["err"] = max(out[name]["err"], err)

    # 12a: the sweep kernel through Kaczmarz(backend="cuda")
    dense = rtt.DenseOperator(A, device=dev)
    out["kaczmarz_sweep"]["launches"] = 0
    for order in ("cyclic", "shuffled"):
        s = kaczmarz_solver(dense, (KZ_SWEEPS, 1.0, 16), randomized=False,
                            shuffle_rows=order == "shuffled", backend="cuda")
        launch_counts(reset=True)
        x = rtt.solve_batched_unrolled(s, B16)
        torch.cuda.synchronize()
        got = launch_counts()
        print(f"launches (Kaczmarz backend=cuda, {order}, {KZ_SWEEPS} sweeps): {got}")
        require(got == {**{k: 0 for k in got}, "kaczmarz_sweep": KZ_SWEEPS},
                f"{order}: expected {KZ_SWEEPS} launches of kaczmarz_sweep and no others")
        require(tuple(x.shape) == (256, 16) and bool(torch.isfinite(x).all()),
                f"{order}: bad result {tuple(x.shape)}")
        out["kaczmarz_sweep"]["launches"] += KZ_SWEEPS
        note("kaczmarz_sweep", hold_dense(
            f"kaczmarz_sweep[{order}, 1024x256, batch 16, {KZ_SWEEPS} sweeps]",
            lambda b, s=s: (rtt.solve_batched_unrolled(s, b).T, None),
            lambda b, s=s: (streamed_plain(s, b).T, None), (B16,), counts=False))
    s1 = kaczmarz_solver(dense, (1, 1.0, 16), randomized=False, backend="cuda")
    rows, _, idx, x0, vl0, u, denom, eps, _, _ = ks.solver_operands(s1, B16)
    out["kaczmarz_sweep"]["ms"] = alternate_ms(
        lambda: ks.kaczmarz_solve_torch(rows, idx, x0, vl0, u, denom, eps, 1, True),
        lambda: ks.kaczmarz_sweep(rows[0], x0[:, 0], vl0[:, 0], u[:, 0], denom, eps, idx[0]),
        reps=2)
    s1 = kaczmarz_solver(dense, (1, 1.0, 16), randomized=False)
    rtt.solve_batched_unrolled(s1, B16)
    out["kaczmarz_sweep"]["library_ms"] = cuda_ms(lambda: rtt.solve_batched_unrolled(s1, B16), 1)

    # 12b: the streamed solve
    A2, B4 = kz["64mib"][:2]
    Ac, Bc = kz["complex"]
    cases = (
        ("1024x256 dense, batch 16", kaczmarz_solver(dense, KZ_TALL), B16),
        ("1024x256 padded CSR, batch 16",
         kaczmarz_solver(rtt.PaddedCSROperator.from_dense(A.cpu().numpy(), device=dev), KZ_TALL),
         B16),
        ("8192x2048 dense (64 MiB), batch 4",
         kaczmarz_solver(rtt.DenseOperator(A2, device=dev), KZ_64MIB), B4),
        ("complex 512x128 dense, cyclic, 3 sweeps, batch 4",
         kaczmarz_solver(rtt.DenseOperator(Ac, device=dev), (3, 1.0, 4), randomized=False,
                         positive=False), Bc),
        ("1024x256 real A, complex b, batch 4",
         kaczmarz_solver(dense, KZ_TALL, positive=False), kz["complex_b"]),
    )
    for label, s, B in cases:
        note("kaczmarz_solve", hold_dense(
            f"kaczmarz_solve[{label}]", lambda b, s=s: (rtt.solve_kaczmarz_streamed(s, b).T, None),
            lambda b, s=s: (streamed_plain(s, b).T, None), (B,), counts=False))
    rows, _, idx, x0, vl0, u, denom, eps, sweeps, reuse = ks.solver_operands(cases[0][1], B16)
    out["kaczmarz_solve"]["ms"] = alternate_ms(
        lambda: ks.kaczmarz_solve_torch(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse,
                                        "positive"),
        lambda: ks.kaczmarz_solve(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, "positive"),
        reps=2)
    # the rows the timed solve visits, and how many distinct ones it reads
    out["kaczmarz_solve"]["visited"] = (int((idx >= 0).sum()), int(torch.unique(idx).numel()))

    # 13: the greedy sweep, forced and sampled
    sg = kaczmarz_solver(dense, KZ_GREEDY, greedy=True)
    T, S = sg.iterations, sg.sub_matrix_size
    forced = torch.from_numpy(np.random.default_rng(6).integers(0, 1024, size=(T, S))
                              .astype(np.int32)).to(dev)
    for label, fr in (("forced rows", forced), ("sampled draws", None)):
        _, rk = kg.greedy_solve(sg, B16, forced_rows=fr)
        _, rp = kg.greedy_solve(sg, B16, sweep=kg.kaczmarz_greedy_sweep_torch, forced_rows=fr)
        differ = int((rk != rp).sum())
        print(f"kaczmarz_greedy_sweep[{label}]: {rk.numel()} rows drawn ({T} sweeps × {S} steps "
              f"× 16 problems), {differ} differ from the plain version's, "
              f"{int(torch.unique(rk).numel())} distinct")
        require(differ == 0, f"kaczmarz_greedy_sweep[{label}]: {differ} drawn rows differ")
        note("kaczmarz_greedy_sweep", hold_dense(
            f"kaczmarz_greedy_sweep[{label}, 1024x256, batch 16, {T}×{S}]",
            lambda b, fr=fr: (kg.greedy_solve(sg, b, forced_rows=fr)[0].T, None),
            lambda b, fr=fr: (kg.greedy_solve(sg, b, sweep=kg.kaczmarz_greedy_sweep_torch,
                                              forced_rows=fr)[0].T, None),
            (B16,), counts=False))
    Ag, Gt, dg, ng, eg, fn, bt = kg.greedy_operands(sg, B16)
    z = (torch.zeros(16, 256, device=dev), torch.zeros(16, 1024, device=dev), bt)
    # the rows the timed sweep draws, and how many distinct ones it reads
    drawn = kg.kaczmarz_greedy_sweep(Ag, Gt, dg, ng, *z, eg, fn, None, S, sg.seed, 0)[3]
    out["kaczmarz_greedy_sweep"]["visited"] = (S, int(torch.unique(drawn).numel()))
    print(f"kaczmarz_greedy_sweep (timed sweep): {drawn.numel()} rows drawn, "
          f"{out['kaczmarz_greedy_sweep']['visited'][1]} distinct")
    out["kaczmarz_greedy_sweep"]["ms"] = alternate_ms(
        lambda: kg.kaczmarz_greedy_sweep_torch(Ag, Gt, dg, ng, *z, eg, fn, None, S, sg.seed, 0),
        lambda: kg.kaczmarz_greedy_sweep(Ag, Gt, dg, ng, *z, eg, fn, None, S, sg.seed, 0),
        reps=2)
    g1 = kaczmarz_solver(dense, (1,) + KZ_GREEDY[1:], greedy=True)
    rtt.solve_batched_unrolled(g1, B16)
    out["kaczmarz_greedy_sweep"]["library_ms"] = cuda_ms(
        lambda: rtt.solve_batched_unrolled(g1, B16), 1)
    for name, row in out.items():
        print(f"{name}: kernel {row['ms'][1]:.3f} ms, plain {row['ms'][0]:.3f} ms"
              + (f", composed {row['library_ms']:.3f} ms" if "library_ms" in row else ""))
    return out


def parity_cols(name, x, B, mv64, x64, xs_true, bar=TOL_PARITY, res_bar=TOL_RESIDUAL):
    """The first k columns of a solve `x` (n × K) against the float64
    solutions `x64` (n × k): the worst column's relative error (≤ `bar`,
    TOL_PARITY unless a cell's own f32 arithmetic cannot meet it) and
    |‖A x − b‖ − ‖A x64 − b‖| / ‖b‖ with A in float64 (≤ `res_bar`);
    printed with the error against the true image `xs_true` (n, the same
    for every column) beside the float64 solve's own. Returns both."""
    import torch

    k = x64.shape[1]
    require(bool(torch.isfinite(x).all()), f"{name}: non-finite values")
    xc = x[:, :k].to(x64.dtype)
    b = B[:, :k].to(x64.dtype)
    rel = float(max(torch.linalg.norm(xc[:, j] - x64[:, j]) / torch.linalg.norm(x64[:, j])
                    for j in range(k)))
    r_x = torch.linalg.norm(mv64(xc.T) - b.T, dim=1)
    r_64 = torch.linalg.norm(mv64(x64.T) - b.T, dim=1)
    res = float(((r_x - r_64).abs() / torch.linalg.norm(b, dim=0)).max())
    truth = xs_true.to(x64.dtype)[:, None]
    rec = float(torch.linalg.norm(x.to(x64.dtype) - truth) / torch.linalg.norm(
        truth.expand(-1, x.shape[1])))
    rec64 = float(torch.linalg.norm(x64 - truth) / torch.linalg.norm(truth.expand(-1, k)))
    print(f"{name}: recon_rel_err {rec:.4e} (float64 solve {rec64:.4e}), parity_max_rel_err vs "
          f"f64 {rel:.3e}, parity_residual_rel_diff vs f64 {res:.3e}")
    require(rel <= bar, f"{name}: parity_max_rel_err vs f64 {rel:.3e} > {bar:.3e}")
    require(res <= res_bar, f"{name}: parity_residual_rel_diff vs f64 {res:.3e}")
    return rel, res


def pdhg_objective(op64, B, x):
    """½‖A x − b‖² + λ·Σₖ wₖ‖Dₖ x‖₁ in float64 for each column of x (n × k)
    and B: the PDHG cell's weighted 8-direction TV objective."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.models.solvers.pdhg import W8

    xt = x.T.double()
    grad = rtt.Grad8Operator((PDHG_N, PDHG_N), torch.float64, device=xt.device)
    w = torch.tensor(W8, dtype=torch.float64, device=xt.device).repeat_interleave(PDHG_N ** 2)
    r = op64.mv(xt) - B.T.double()
    return 0.5 * (r * r).sum(dim=-1) + PDHG_LAM * (w * grad.mv(xt).abs()).sum(dim=-1)


def kernel_cell_phase(dev, draws, pdhg_solver, kz):
    """Phase 10: the PDHG and Kaczmarz cells through solve_batched_fast,
    each with the launch counters set to 0 just before the solve and read
    just after (the named dispatch row, its launches and no others),
    problems/s, and two columns held by `parity_cols` against a float64
    solve of the plain version on the card. The PDHG cell's composed solve
    (solve_batched_unrolled) is timed as its kernel's yardstick, the tall
    cell's composed Kaczmarz solve as the streamed kernel's. Returns
    ({kernel: launches}, {kernel: composed ms})."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import auto
    from rls_tpu_torch.kernels import kaczmarz_greedy as kg
    from rls_tpu_torch.kernels import pdhg_fused as pd

    launched, composed = {}, {}

    def run(name, solver, B, row, want):
        require(auto.select_fast_path(solver)[0] == row, f"{name}: dispatch is not {row}")
        launch_counts(reset=True)
        x = rtt.solve_batched_fast(solver, B)
        torch.cuda.synchronize()
        got = launch_counts()
        print(f"launches ({name}): {got}")
        require(got == {**{k: 0 for k in got}, **want},
                f"{name}: expected the launches {want} and no others")
        if row == "pdhg":
            routes = pd.pdhg_fused.route_launches
            print(f"launches ({name}) by route: {routes}")
            require(routes == {"resident": 1, "global": 0},
                    f"{name}: expected one launch on the resident route, got {routes}")
        for k, v in want.items():
            launched[k] = launched.get(k, 0) + v
        require(tuple(x.shape) == (solver.A.in_size, B.shape[1]), f"{name}: shape {x.shape}")
        ms = cuda_ms(lambda: rtt.solve_batched_fast(solver, B), reps=2)
        print(f"{name}: {B.shape[1] / (ms / 1e3):.1f} problems/s ({ms:.3f} ms per batch of "
              f"{B.shape[1]})")
        return x

    # pdhg_tv8_deblur256_b16_fused: the ADMM image blurred, tiled 16 times
    op = pdhg_solver.A
    xt = torch.from_numpy(draws["admm"]).to(dev)
    B = op.mv(xt)[:, None].repeat(1, PDHG_BATCH).contiguous()
    x = run("pdhg_tv8_deblur256_b16_fused", pdhg_solver, B, "pdhg", {"pdhg_fused": 1})
    s64 = pdhg_cell_solver(dev, torch.float64, tau=pdhg_solver.tau)
    u64 = B[:, :2].T.double().reshape(2, PDHG_N, PDHG_N)
    scal64 = pd.kernel_scalars(u64, PDHG_SIGMA, pdhg_solver.tau, PDHG_LAM, np.float64)
    x64 = pd.pdhg_fused_torch(u64, scal64, s64.A.taps_hw(), PDHG_ITERS, "tv8").reshape(2, -1).T
    obj64 = pdhg_objective(s64.A, B[:, :2], x64)

    def objective(name, x):
        diff = float(((pdhg_objective(s64.A, B[:, :2], x[:, :2]) - obj64).abs() / obj64).max())
        print(f"{name}: objective vs f64 {diff:.3e}")
        return diff

    # x against float64 at PDHG_X_BAR (see there), the objective at
    # TOL_PARITY, the residual at TOL_RESIDUAL; the plain f32 version's own
    # readings printed beside them
    u32 = B[:, :2].T.reshape(2, PDHG_N, PDHG_N).contiguous()
    x32 = pd.pdhg_fused_torch(u32, pd.kernel_scalars(u32, PDHG_SIGMA, pdhg_solver.tau, PDHG_LAM),
                              op.taps_hw(), PDHG_ITERS, "tv8").reshape(2, -1).T
    parity_cols("pdhg_tv8_deblur256_b16 (plain f32 version)", x32, B, s64.A.mv, x64, xt,
                bar=float("inf"), res_bar=float("inf"))
    objective("pdhg_tv8_deblur256_b16 (plain f32 version)", x32)
    parity_cols("pdhg_tv8_deblur256_b16_fused", x, B, s64.A.mv, x64, xt, PDHG_X_BAR)
    require(objective("pdhg_tv8_deblur256_b16_fused", x) <= TOL_PARITY,
            f"pdhg_tv8_deblur256_b16_fused: objective vs f64 above {TOL_PARITY:.0e}")
    launch_counts(reset=True)
    xc = rtt.solve_batched_unrolled(pdhg_solver, B)
    torch.cuda.synchronize()
    require(not any(launch_counts().values()), "the composed PDHG launched a kernel")
    parity_cols("pdhg_tv8_deblur256_b16 composed", xc, B, s64.A.mv, x64, xt, PDHG_X_BAR)
    require(objective("pdhg_tv8_deblur256_b16 composed", xc) <= TOL_PARITY,
            f"pdhg_tv8_deblur256_b16 composed: objective vs f64 above {TOL_PARITY:.0e}")
    # a wrong kernel: λ off by PDHG_WRONG_LAM must miss the objective or the
    # residual bar
    xw = pd.pdhg_fused(u32, op.taps_hw(), PDHG_SIGMA, pdhg_solver.tau, PDHG_LAM * PDHG_WRONG_LAM,
                       PDHG_ITERS, "tv8").reshape(2, -1).T
    label = f"pdhg_tv8_deblur256_b16 (the kernel at λ·{PDHG_WRONG_LAM})"
    _, res_w = parity_cols(label, xw, B, s64.A.mv, x64, xt, bar=float("inf"),
                           res_bar=float("inf"))
    require(objective(label, xw) > TOL_PARITY or res_w > TOL_RESIDUAL,
            f"{label} passes the cell's bars: they cannot tell a wrong λ")
    composed["pdhg_fused"] = cuda_ms(lambda: rtt.solve_batched_unrolled(pdhg_solver, B), 1)
    print(f"pdhg_tv8_deblur256_b16: solve_batched_unrolled {composed['pdhg_fused']:.3f} ms per "
          f"batch of {PDHG_BATCH} ({PDHG_BATCH / (composed['pdhg_fused'] / 1e3):.1f} problems/s)")

    # the Kaczmarz cells
    A, _, Bt, xtk = kz["tall"]
    A2, _, B2, xtk2 = kz["64mib"]
    dense = rtt.DenseOperator(A, device=dev)
    csr = rtt.PaddedCSROperator.from_dense(A.cpu().numpy(), device=dev)
    for name, s, B, xs in (
        ("kaczmarz_rand_pos_tall_b16_streamed", kaczmarz_solver(dense, KZ_TALL), Bt, xtk),
        ("kaczmarz_rand_pos_tall_b16_csr", kaczmarz_solver(csr, KZ_TALL), Bt, xtk),
        ("kaczmarz_streamed_64MiB_b4",
         kaczmarz_solver(rtt.DenseOperator(A2, device=dev), KZ_64MIB), B2, xtk2),
    ):
        x = run(name, s, B, "kaczmarz_streamed", {"kaczmarz_solve": 1})
        s64 = as_float64(s)
        x64 = streamed_plain(s64, B[:, :2].double(), torch.float64)
        parity_cols(name, x, B, s64.A.mv, x64, xs)
        if name.endswith("tall_b16_streamed"):
            rtt.solve_batched_unrolled(s, B)
            composed["kaczmarz_solve"] = cuda_ms(lambda: rtt.solve_batched_unrolled(s, B), 1)
            print(f"{name}: solve_batched_unrolled (composed) {composed['kaczmarz_solve']:.3f} ms")
    # kaczmarz_greedy_tall_b16: this script's own greedy cell
    sg = kaczmarz_solver(dense, KZ_GREEDY, greedy=True)
    name = "kaczmarz_greedy_tall_b16"
    x = run(name, sg, Bt, "kaczmarz_greedy", {"kaczmarz_greedy_sweep": sg.iterations})
    _, rows = kg.greedy_solve(sg, Bt)  # the same draws as the run above
    s64 = as_float64(sg)
    x64 = torch.cat([kg.greedy_solve(s64, Bt[:, j:j + 1].double(),
                                     sweep=kg.kaczmarz_greedy_sweep_torch,
                                     forced_rows=rows[:, j, :], dtype=torch.float64)[0]
                     for j in range(2)], dim=1)
    parity_cols(name, x, Bt, s64.A.mv, x64, xtk)
    return launched, composed


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
    smi = card_line()
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

    # 3a. the TV prox kernel against its plain version at TV_CHECKS: the
    # shapes the main path gives it on its resident route and TV_WIDE on its
    # global route, each plan and route by the route counter
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(BATCH, N, N)).astype(np.float32)).to(dev)
    lam = torch.from_numpy(
        (RHO * LAM * rng.uniform(0.0, 400.0, size=BATCH)).astype(np.float32)
    ).to(dev)
    lam[0] = 0.0
    err_tv = 0.0
    for k, (B1, H1, W1, tv1, route, own) in enumerate(TV_CHECKS):
        name = f"{B1} x {H1}x{W1}, {tv1} dual"
        xt = x if (B1, H1, W1) == (BATCH, N, N) else torch.from_numpy(
            np.random.default_rng(12 + k).normal(size=(B1, H1, W1)).astype(np.float32)).to(dev)
        plan, held = tv_fgp.plan_on_card(xt)
        print(f"tv_fgp plan, {name}: {plan}; clusters resident at once: {held}")
        require((plan.route, plan.own) == (route, own),
                f"tv_fgp at {name}: {plan}, not the {route} route with x, pv and ph in {own} "
                "memory")
        tv_fgp.prox_tv2d_fgp.route_launches = {"resident": 0, "global": 0}
        got = tv_fgp.prox_tv2d_fgp(xt.reshape(B1, -1), lam[:B1], (H1, W1),
                                   tv1).reshape(xt.shape)
        want = tv_fgp.prox_tv2d_fgp_torch(xt, lam[:B1], tv1)
        torch.cuda.synchronize()
        require(tv_fgp.prox_tv2d_fgp.route_launches == {"resident": int(route == "resident"),
                                                        "global": int(route == "global")},
                f"tv_fgp at {name}: routes {tv_fgp.prox_tv2d_fgp.route_launches}, not {route}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"tv_fgp, {name} ({route} route): max|kernel - plain| = {err:.3e} "
              f"(max|x| {scale:.3f})")
        require(torch.isfinite(got).all(), f"tv_fgp kernel gave non-finite values at {name}")
        require(err <= TOL_TV * scale, f"tv_fgp kernel disagrees at {name}: {err:.3e}")
        if route == "resident":
            err_tv = max(err_tv, err)  # the main path's shapes, for the kernel table
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

    def show_plan(name, x0, method, restart="none", rel_tol=None, warm_tv=False, **_):
        """Print the launch's plan: route, cluster size, rows per band,
        shared memory per CTA and the clusters the card holds at once."""
        plan, active = fused.plan_on_card(x0, taps, method, restart, rel_tol, warm_tv)
        print(f"{name}: plan route {plan.route}, {plan.clusters} CTAs per problem, "
              f"{plan.rows} rows per band, {plan.ctas} CTAs, {plan.smem} B of shared memory "
              f"per CTA, {active} clusters resident at once")

    fused_err, fused_ms = {}, {}
    for method in ("fista", "optista", "pogm"):
        kernel, plain = fused_pair(method)
        show_plan(f"fista_tv_fused[{method}]", x0hat, method)
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
        show_plan(f"fista_tv_fused[{name}, batch {BATCH_DYN}]", x0_dyn, **kw)
        hold_to_plain(f"fista_tv_fused[{name}]", kernel, plain, x0_dyn, show_counts=True)
        plain_ms, kernel_ms = alternate_ms(lambda: plain(x0_dyn), lambda: kernel(x0_dyn), reps=1)
        print(f"fista_tv_fused[{name}, batch {BATCH_DYN}]: kernel {kernel_ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound %.4f ms (%s)"
              % pgm_bound(x0_dyn, kernel(x0_dyn)[1], **kw))

    # 3d. row 3 against its plain version: 512² on its cluster route (one
    # launch) and 1024² on its row tiles (one launch per iteration), each
    # plan printed and its route read from the route counter
    draws = bench_suite_draws()
    img_admm, imgs512, imgs1024 = draws["admm"], draws[512], draws[1024]
    tiled_err, tiled_ms = {}, None
    for n, imgs, route in ((512, imgs512, "cluster"), (1024, imgs1024, "tiles")):
        s_n = build_solver(n, dev)
        taps_n = s_n.A.taps_hw()
        b_n = s_n.A.mv(torch.from_numpy(imgs).to(dev))
        x0_n = s_n.A.rmv_stencil(b_n).reshape(-1, n, n)
        lam_n = torch.full((x0_n.shape[0],), LAM, device=dev)
        plan, held = tiled.plan_on_card(x0_n, taps_n)
        print(f"fista_tv_tiled plan, {x0_n.shape[0]} x {n}²: {plan}; clusters resident at "
              f"once: {held}")
        require(plan.route == route, f"fista_tv_tiled at {n}²: {plan}, not the {route} route")

        def kernel(x0, lam_n=lam_n, taps_n=taps_n, **kw):
            return tiled.fista_tv_tiled(x0, taps_n, RHO, lam_n[: x0.shape[0]], ITERS,
                                        TV_ITERS, with_counts=True, **kw)

        def plain(x0, lam_n=lam_n, taps_n=taps_n, **kw):
            kw.setdefault("method", "fista")
            scal, tab, t2 = fused.kernel_args(x0, RHO, lam_n[: x0.shape[0]], kw["method"],
                                              ITERS, TV_ITERS)
            return tiled.fista_tv_tiled_torch(x0, scal, tab, t2, taps_n, **kw)

        tiled.fista_tv_tiled.route_launches = {"cluster": 0, "tiles": 0}
        tiled_err[n] = hold_to_plain(f"fista_tv_tiled[{n}², batch {x0_n.shape[0]}]",
                                     kernel, plain, x0_n)
        want = {"cluster": int(route == "cluster"), "tiles": ITERS * int(route == "tiles")}
        require(tiled.fista_tv_tiled.route_launches == want,
                f"fista_tv_tiled at {n}²: routes {tiled.fista_tv_tiled.route_launches}, "
                f"not {want}")
        if n == 512:
            tiled_ms = alternate_ms(lambda: plain(x0_n), lambda: kernel(x0_n), reps=3)
            print(f"fista_tv_tiled[512²]: kernel {tiled_ms[1]:.3f} ms, "
                  f"plain {tiled_ms[0]:.3f} ms")
            # the fused kernel's global route (one CTA per problem on
            # global scratch), which 512² takes, against its plain version
            def forced_kernel(x0, lam_n=lam_n, taps_n=taps_n):
                return fused.fista_tv_fused(x0, taps_n, RHO, lam_n, ITERS, TV_ITERS,
                                            with_counts=True)

            def forced_plain(x0, lam_n=lam_n, taps_n=taps_n):
                scal, tab, t2 = fused.kernel_args(x0, RHO, lam_n, "fista", ITERS, TV_ITERS)
                return fused.fista_tv_fused_torch(x0, scal, tab, t2, taps_n)

            fused.fista_tv_fused.route_launches = {"resident": 0, "global": 0}
            hold_to_plain(f"fista_tv_fused[forced to 512², batch {x0_n.shape[0]}]",
                          forced_kernel, forced_plain, x0_n)
            require(fused.fista_tv_fused.route_launches == {"resident": 0, "global": 1},
                    f"the fused kernel forced to 512² took the global route once: "
                    f"{fused.fista_tv_fused.route_launches}")
            forced = cuda_ms(lambda: forced_kernel(x0_n), reps=2)
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

    # 3h. the FFT kernels against their plain versions
    fft = fft_kernel_phase(dev, draws)

    # 3i. the PDHG, Kaczmarz and greedy Kaczmarz kernels against their plain
    # versions (with the sweep kernel's main path, Kaczmarz(backend="cuda"))
    pdhg_solver = pdhg_cell_solver(dev)
    print(f"pdhg_tv8_deblur256_b16: tau {pdhg_solver.tau:.6f} from the power iteration")
    pdhg = pdhg_kernel_phase(dev, pdhg_solver)
    kz = kaczmarz_systems(draws, dev)
    kacz = kaczmarz_kernel_phase(dev, kz)

    # 4. the flagship through the public API; the counts start at 0 here
    ref = np.load(os.path.join(ROOT, "bench_ref_f64.npz"))
    fused.fista_tv_fused.launches = 0
    fused.fista_tv_fused.route_launches = {"resident": 0, "global": 0}
    tv_fgp.prox_tv2d_fgp.launches = 0
    tv_fgp.prox_tv2d_fgp.route_launches = {"resident": 0, "global": 0}
    tiled.fista_tv_tiled.launches = 0
    x_fast = rtt.solve_batched_fast(solver, B)
    torch.cuda.synchronize()
    launches_fused = fused.fista_tv_fused.launches
    require(tiled.fista_tv_tiled.launches == 0, "the 256² flagship ran the tiled kernel")
    require(fused.fista_tv_fused.route_launches == {"resident": 1, "global": 0},
            f"the flagship's routes: {fused.fista_tv_fused.route_launches}")
    x_comp = rtt.solve_batched_unrolled(solver, B)
    torch.cuda.synchronize()
    launches_tv = tv_fgp.prox_tv2d_fgp.launches
    print(f"launches: fista_tv_fused {launches_fused}, tv_fgp {launches_tv}")
    require(launches_fused == 1, "solve_batched_fast did not run the fused kernel once")
    require(launches_tv == ITERS, f"solve_batched_unrolled ran the TV kernel {launches_tv}×")
    require(tv_fgp.prox_tv2d_fgp.route_launches == {"resident": ITERS, "global": 0},
            f"the composed flagship's TV routes: {tv_fgp.prox_tv2d_fgp.route_launches}")

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
    flagship_ms = {}
    for name, fn in (
        ("solve_batched_fast", lambda: rtt.solve_batched_fast(solver, B)),
        ("solve_batched_unrolled", lambda: rtt.solve_batched_unrolled(solver, B)),
    ):
        ms = flagship_ms[name] = cuda_ms(fn, reps=3)
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
        # the kernel's yardstick: the composed solve at the same shapes
        rtt.solve_batched_unrolled(s_cls, B)
        ms = cuda_ms(lambda: rtt.solve_batched_unrolled(s_cls, B), reps=1)
        print(f"solve_batched_unrolled[{cls}] (composed): {ms:.2f} ms per batch of {BATCH}")

    # 5. fista_tv_512_tiled_b16 through the public API; counts start at 0
    n5 = 512
    s5 = build_solver(n5, dev)
    xs5 = torch.from_numpy(imgs512).to(dev)
    B5 = s5.A.mv(xs5).T.contiguous()
    fused.fista_tv_fused.launches = 0
    tiled.fista_tv_tiled.launches = 0
    tiled.fista_tv_tiled.route_launches = {"cluster": 0, "tiles": 0}
    x5 = rtt.solve_batched_fast(s5, B5)
    torch.cuda.synchronize()
    launches_tiled = tiled.fista_tv_tiled.launches
    print(f"launches (512²): fista_tv_tiled {launches_tiled} "
          f"{tiled.fista_tv_tiled.route_launches}, fista_tv_fused {fused.fista_tv_fused.launches}")
    require(tiled.fista_tv_tiled.route_launches == {"cluster": 1, "tiles": 0},
            f"the 512² cell's row-3 routes: {tiled.fista_tv_tiled.route_launches}, not one "
            "launch on the cluster route")
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
    # the tiled kernel's yardstick: the composed solve at its shapes, once
    rtt.solve_batched_unrolled(s5, B5)
    library = {"fista_tv_tiled": cuda_ms(lambda: rtt.solve_batched_unrolled(s5, B5), reps=1)}
    print(f"fista_tv_512_tiled_b16: solve_batched_unrolled (composed) "
          f"{library['fista_tv_tiled']:.3f} ms per batch of 16")

    # 6. the ADMM-TV cells through the public API
    for name, cell, imgs, want, composed in (
        ("admm_tv_deblur256_b16_fused", ADMM256,
         np.broadcast_to(img_admm, (ADMM256[1], img_admm.size)), {"admm_tv_fused": 1}, True),
        ("admm_tv_512_tiled_b16", ADMM512, imgs512,
         {"admm_tv_tiled": launches_per_solve(*ADMM512[3:5])}, False),
    ):
        kernel = next(iter(want))
        counts, library[kernel] = admm_cell_phase(name, cell, dev, imgs, want, composed)
        admm[kernel]["launches"] = counts[kernel]

    # 8. the dense cells through the public API
    dense_launched, dense_library = dense_cell_phase(dev, systems)
    library.update(dense_library)

    # 9. the compressed-sensing and SENSE cells through the public API
    fft_launched, composed_ms = fft_cell_phase(dev, draws)

    # 10. the PDHG and Kaczmarz cells through the public API
    kernel_launched, kernel_composed = kernel_cell_phase(dev, draws, pdhg_solver, kz)
    print(f"phases 3-6, 8-10: {time.perf_counter() - t_start:.1f} s")

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
    # the FFT kernels at their timed shapes, an FFT counted at 5·n·log₂n
    # (2.5·n·log₂n where its input or output is real, row 8's image):
    # x0hat, the mask (or the spectral weights), the coil maps and the
    # scalars read, x written; SplitBregman's live CG steps of the timed run
    cs_hw, s_hw = CS_N * CS_N, SENSE_N * SENSE_N
    bounds["fista_l1_dft_fused"] = bound(CS_BATCH * dft_ops(cs_hw, CS_ITERS),
                                         f32 * ((2 * CS_BATCH + 1) * cs_hw + 2 * CS_BATCH))
    s_bytes = f32 * ((4 * SENSE_SLICES + 2 * SENSE_C + 1) * s_hw)
    bounds["sense_fused"] = bound(SENSE_SLICES * sense_ops(s_hw, SENSE_C, SENSE_ITERS),
                                  s_bytes + f32 * 2 * SENSE_SLICES)
    sb_live = fft["splitbregman_fused"]["live"].tolist()
    bounds["splitbregman_fused"] = bound(
        sum(sb_ops(s_hw, SENSE_C, *SB_SCHED[:2], SB_TV, v) for v in sb_live),
        s_bytes + f32 * 4 * SENSE_SLICES)
    # row 11 at the cell's shapes (x0 in, x out, the scalars); rows 12a,
    # 12b and 13 at their timed shapes: every input read once (A, or the
    # distinct rows the solve visits, x, vl, u, denom, eps, the index list;
    # the distinct rows of A and of the greedy table Gt the sweep draws,
    # denom, norms), every output written once (x, vl, r, the drawn rows)
    px = PDHG_BATCH * PDHG_N * PDHG_N
    bounds["pdhg_fused"] = bound(
        PDHG_ITERS * pdhg_ops(*(len(t) for t in pdhg_solver.A.taps_hw()), "tv8") * px,
        f32 * (2 * px + 3 * PDHG_BATCH))
    m, n, p = 1024, 256, KZ_TALL[2]
    vec = p * (2 * n + 4 * m + 1)
    bounds["kaczmarz_sweep"] = bound(p * kaczmarz_ops(n, m), f32 * (m * n + vec + m))
    steps, distinct = kacz["kaczmarz_solve"]["visited"]
    bounds["kaczmarz_solve"] = bound(p * kaczmarz_ops(n, steps) + KZ_TALL[0] * p * n,
                                     f32 * (distinct * n + vec + KZ_TALL[0] * 64))
    S, distinct = kacz["kaczmarz_greedy_sweep"]["visited"]
    bounds["kaczmarz_greedy_sweep"] = bound(
        p * greedy_ops(m, n, S), f32 * (distinct * (n + m) + 2 * m + p * (2 * n + 4 * m + 1 + S)))
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
        ("fista_l1_dft_fused", "fista_l1_dft_fused.cu",
         "rls_tpu/kernels/fista_l1_dft_fused.py:110", fft_launched["fista_l1_dft_fused"],
         fft["fista_l1_dft_fused"]["err"], fft["fista_l1_dft_fused"]["ms"]),
        ("sense_fused", "sense_fused.cu", "rls_tpu/kernels/sense_fused.py:85",
         fft_launched["fista_l21_sense_fused"], fft["sense_fused"]["err"],
         fft["sense_fused"]["ms"]),
        ("splitbregman_fused", "splitbregman_fused.cu",
         "rls_tpu/kernels/splitbregman_fused.py:217", fft_launched["splitbregman_l1_tv_fused"],
         fft["splitbregman_fused"]["err"], fft["splitbregman_fused"]["ms"]),
        ("pdhg_fused", "pdhg_fused.cu", "rls_tpu/kernels/pdhg_fused.py:185",
         kernel_launched["pdhg_fused"], pdhg["err"], pdhg["ms"]),
        ("kaczmarz_sweep", "kaczmarz.cu", "rls_tpu/kernels/kaczmarz_pallas.py:72",
         kacz["kaczmarz_sweep"]["launches"], kacz["kaczmarz_sweep"]["err"],
         kacz["kaczmarz_sweep"]["ms"]),
        ("kaczmarz_solve", "kaczmarz.cu", "rls_tpu/kernels/kaczmarz_pallas.py:206",
         kernel_launched["kaczmarz_solve"], kacz["kaczmarz_solve"]["err"],
         kacz["kaczmarz_solve"]["ms"]),
        ("kaczmarz_greedy_sweep", "kaczmarz_greedy.cu", "rls_tpu/kernels/kaczmarz_greedy.py:164",
         kernel_launched["kaczmarz_greedy_sweep"], kacz["kaczmarz_greedy_sweep"]["err"],
         kacz["kaczmarz_greedy_sweep"]["ms"]),
    )
    # one PyTorch call computes the same function only for CGNR's
    # regularized normal equations (torch.linalg.solve); none computes a
    # TV or a LASSO solve. For the fused and tiled PGM-TV kernels, the two
    # ADMM kernels and the dense PGM kernels the yardstick is the composed
    # solve_batched_unrolled at the kernel's shapes (the operator's
    # products, one TV kernel launch per iteration where the solve has a TV
    # prox): many calls, not one, and the time a faster kernel has to
    # beat; for the three FFT kernels the same solve with its normal op on
    # torch.fft (cuFFT); the same for PDHG (the cell) and the three
    # Kaczmarz rows (one sweep, the tall cell, one greedy sweep)
    library.update({
        "fista_tv_fused": flagship_ms["solve_batched_unrolled"],
        "fista_l1_dft_fused": composed_ms["fista_l1_dft_fused"],
        "sense_fused": composed_ms["fista_l21_sense_fused"],
        "splitbregman_fused": composed_ms["splitbregman_l1_tv_fused"],
        "pdhg_fused": kernel_composed["pdhg_fused"],
        "kaczmarz_sweep": kacz["kaczmarz_sweep"]["library_ms"],
        "kaczmarz_solve": kernel_composed["kaczmarz_solve"],
        "kaczmarz_greedy_sweep": kacz["kaczmarz_greedy_sweep"]["library_ms"],
    })
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


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_cases(out, cases, in_turns=False):
    """Time each case ``(name, fn, reps[, probe])`` of `cases` into `out`
    after one warm-up call: three readings of ``cuda_ms(fn, reps)`` under
    "{name} ms", case after case or, `in_turns`, one reading of every case
    in each of three rounds. Then ``probe()``, where a case has one, adds
    its entries under "{name} {key}"."""
    for group in [cases] if in_turns else [[case] for case in cases]:
        for name, fn, *_ in group:
            fn()
            out[f"{name} ms"] = []
        for _ in range(3):
            for name, fn, reps, *_ in group:
                out[f"{name} ms"].append(cuda_ms(fn, reps))
        for name, _, _, *probe in group:
            if probe:
                out.update({f"{name} {key}": v for key, v in probe[0]().items()})


def plan_probe(kernel, plan_args, *clock_args, **clock_kw):
    """A case's probe for a kernel module, as far as the tree under test
    has the pieces: ``plan_on_card(*plan_args)`` (with the clusters the
    card holds at once, where the planner counts them) and, on the
    resident route or where there is no planner, ``phase_clocks(*clock_args,
    **clock_kw)``: the SM clocks of CTA 0 by phase."""

    def probe():
        got, resident = {}, True
        if hasattr(kernel, "plan_on_card"):
            plan = kernel.plan_on_card(*plan_args)
            plan, extra = ((plan[0], {"resident_clusters": plan[1]}) if isinstance(plan, tuple)
                           else (plan, {}))
            got["plan"] = dict(vars(plan), **extra)
            resident = plan.route == "resident"
        if resident and hasattr(kernel, "phase_clocks"):
            got["clocks of CTA 0 by phase"] = kernel.phase_clocks(*clock_args, **clock_kw)
        return got

    return probe


def timing_run(root, mode):
    """The frame of the ``--time-*`` modes: the rls_tpu_torch package under
    `root` (this tree, or another one unpacked beside it) on card 0, TF32
    off; ``mode(dev, out)`` fills `out`, which starts with the root and the
    card's name and power limit, printed as one JSON line. Run a mode for
    two trees in turns (parent, change, change, parent) to compare their
    kernels on one card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"root": root, "card": card_line()}
    mode(torch.device("cuda", 0), out)
    print(json.dumps(out))
    return 0


def time_cgnr(dev, out):
    """``--time-cgnr [ROOT]``: the CGNR kernel at the two CGNR cells'
    shapes, and with no CG step (its set-up: Aᴴb, the plan, the scratch),
    beside torch.linalg.solve on the 1024×512 cell's regularized Gram."""
    import torch
    from rls_tpu_torch.kernels import cgnr_fused as cg

    out["kernel"] = os.path.relpath(cg.__file__, ROOT)
    systems = dense_systems(bench_suite_draws())
    cases = []
    for name, key, lam, iters, reps in (
        ("cgnr_l2_dense64_fused_b16", "cgnr64", CGNR64_LAM, CGNR64_ITERS, 50),
        ("cgnr_l2_dense_1024x512_b64", "cgnr1k", CGNR1K_LAM, CGNR1K_ITERS, 20),
    ):
        A, B = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in systems[key])
        bt = B.T.contiguous()
        lam_v = torch.full((bt.shape[0],), lam, device=dev)
        args = (bt, A, lam_v, min(iters, A.shape[1]))
        got, want = cg.cgnr_fused(*args), cg.cgnr_fused_torch(*args)
        out[f"{name} max|kernel - plain|"] = float((got - want).abs().max())
        cases += [(name, lambda a=args: cg.cgnr_fused(*a), reps, plan_probe(cg, (), *args)),
                  (f"{name} at 0 steps", lambda a=args[:3]: cg.cgnr_fused(*a, 0), reps)]
        if key == "cgnr1k":
            G = A.T @ A + lam * torch.eye(A.shape[1], device=dev)
            AtB = A.T @ B
            cases.append(("torch.linalg.solve", lambda: torch.linalg.solve(G, AtB), 10))
    time_cases(out, cases)


def time_pgm_tv(dev, out):
    """``--time-pgm-tv [ROOT]``: the fused PGM-TV kernel (row 2): FISTA,
    OptISTA and POGM at the flagship (256² × 64, 50 × 10), the five dynamic
    and warm schedules of phase 3c at batch 8 and FISTA at batch 8, FISTA
    at 256² × 16 beside the tiled kernel forced there, and the flagship
    cell through solve_batched_fast."""
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import fista_tv_fused as fused
    from rls_tpu_torch.kernels import fista_tv_tiled as tiled

    out["kernel"] = os.path.relpath(fused.__file__, ROOT)
    solver, B, _ = build_flagship(dev)
    taps = solver.A.taps_hw()
    x0hat = solver.A.rmv_stencil(B.T).reshape(BATCH, N, N)
    x0_dyn, x0_16 = x0hat[:BATCH_DYN].contiguous(), x0hat[:16].contiguous()
    runs = [(f"flagship {m}", x0hat, dict(method=m), 3) for m in ("fista", "optista", "pogm")]
    runs += [(f"batch {BATCH_DYN} {name}", x0_dyn, kw, 10) for name, kw in (
        ("fista", dict(method="fista")),
        ("fista gradient restart", dict(method="fista", restart="gradient")),
        ("pogm gradient restart, sigma_fac 0.9",
         dict(method="pogm", restart="gradient", sigma_fac=0.9)),
        ("fista early exit", dict(method="fista", rel_tol=1e-3)),
        ("pogm early exit", dict(method="pogm", rel_tol=1e-3)),
        ("fista warm_tv", dict(method="fista", warm_tv=True)),
    )]
    runs.append(("256² x 16 fista", x0_16, dict(method="fista"), 5))
    cases = []
    for name, x0, kw, reps in runs:
        args = (x0, taps, RHO, LAM, ITERS, TV_ITERS)
        plan_args = (x0, taps, kw["method"], kw.get("restart", "none"), kw.get("rel_tol"),
                     kw.get("warm_tv", False))
        cases.append((name, lambda a=args, kw=kw: fused.fista_tv_fused(*a, **kw), reps,
                      plan_probe(fused, plan_args, *args, **kw)))
    cases += [
        ("256² x 16 fista_tv_tiled",
         lambda: tiled.fista_tv_tiled(x0_16, taps, RHO, LAM, ITERS, TV_ITERS), 5),
        ("flagship solve_batched_fast", lambda: rtt.solve_batched_fast(solver, B), 3),
    ]
    time_cases(out, cases)


def time_splitbregman(dev, out):
    """``--time-splitbregman [ROOT]``: the fused SplitBregman kernel (row
    10) at BASELINE #4's schedule (4 × 8 × 8, TV 5) on the SENSE problem:
    the cell's 8 slices of 128² with 6 coils, the same tiled to 64 slices
    (more clusters than the card holds at once), and 8 slices with the
    first 1 and 3 coils; rows 8 and 9 (FISTA-L1-DFT on 16 distinct 256² CS
    problems, FISTA-L21-SENSE on the 8 slices) as controls; and the cell
    through solve_batched_fast."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import fista_l1_dft_fused as k8
    from rls_tpu_torch.kernels import sense_fused as k9
    from rls_tpu_torch.kernels import splitbregman_fused as k10

    out["kernel"] = os.path.relpath(k10.__file__, ROOT)
    maps, mask, X = sense_problem()
    op = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (SENSE_N, SENSE_N), device=dev)
    b = op.mv(torch.from_numpy(X).to(dev))
    x0 = op.rmv(b).reshape(SENSE_SLICES, 2, SENSE_N, SENSE_N)
    coils = (op.coils_r, op.coils_i)
    cases = []
    for name, x, C, reps in (
        (f"cell: {SENSE_SLICES} slices, {SENSE_C} coils", x0, SENSE_C, 2),
        (f"{8 * SENSE_SLICES} slices, {SENSE_C} coils", x0.repeat(8, 1, 1, 1), SENSE_C, 1),
        (f"{SENSE_SLICES} slices, 1 coil", x0, 1, 3),
        (f"{SENSE_SLICES} slices, 3 coils", x0, 3, 2),
    ):
        cr, ci = (c[:C].contiguous() for c in coils)
        args = (x, op.mask, cr, ci, SB_RHO, SB_RHO, SB_LAM, SB_LAM, *SB_SCHED, SB_TV, SB_TOL)
        cases.append((name, lambda a=args: k10.splitbregman_l1_tv_fused(*a), reps,
                      plan_probe(k10, (x, C), *args)))
    # rows 8 and 9, which this kernel's changes must not move
    img2, idx2 = bench_suite_draws()["cs"]
    op8 = rtt.SubsampledDFT2RealOperator.from_sample_idx(idx2, (CS_N, CS_N), device=dev)
    x8 = op8.rmv(op8.mv(torch.from_numpy(cs_phantoms(img2)).to(dev))).reshape(
        CS_BATCH, CS_N, CS_N)
    lam8 = torch.linspace(0.5, 2.0, CS_BATCH, device=dev) * CS_LAM
    solver = splitbregman_solver(op, dev)
    B = b.T.contiguous()
    cases += [
        ("row 8 fista_l1_dft_fused",
         lambda: k8.fista_l1_dft_fused(x8, op8.mask, RHO, lam8, CS_ITERS), 3),
        ("row 9 sense_fused",
         lambda: k9.fista_l21_sense_fused(x0, op.mask, *coils, RHO, SENSE_LAM, SENSE_ITERS), 3),
        ("cell solve_batched_fast", lambda: rtt.solve_batched_fast(solver, B), 2),
    ]
    time_cases(out, cases)


def cs_cell_solves(dev, op, img2):
    """The CS cell (fista_l1_cs_dft256_b16) as solve_batched_fast runs it
    (the bench tiles its one column 16 times), in turns with its composed
    solve_batched_unrolled (torch.fft) and row 8 on the same seed: cases of
    :func:`time_cases`."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import fista_l1_dft_fused as k8

    B8 = op.mv(torch.from_numpy(img2).to(dev))[:, None].repeat(1, CS_BATCH).contiguous()
    s8 = rtt.FISTA.create(op, reg=rtt.L1Regularization(CS_LAM), iterations=CS_ITERS, rho=RHO,
                          rel_tol=0.0, track_residual=False)
    x8 = op.rmv(B8.T).reshape(CS_BATCH, CS_N, CS_N).contiguous()
    return [
        ("row 8 fista_l1_dft_fused",
         lambda: k8.fista_l1_dft_fused(x8, op.mask, RHO, CS_LAM, CS_ITERS), 2),
        ("fista_l1_cs_dft256_b16 solve_batched_fast", lambda: rtt.solve_batched_fast(s8, B8), 2),
        ("fista_l1_cs_dft256_b16 solve_batched_unrolled",
         lambda: rtt.solve_batched_unrolled(s8, B8), 2),
    ]


def time_pdhg(dev, out):
    """``--time-pdhg [ROOT]``: the fused PDHG kernel (row 11) at the PDHG
    cell's operator and 200 iterations: tv8 on 16 distinct 256² problems
    (the phantoms of phase 3i), tviso and L1 + Positive on the same, tv8 on
    the first 4 and on the 16 tiled to 64; the cell through
    solve_batched_fast. Then row 8 as solve_batched_fast runs it on the CS
    cell, that cell through solve_batched_fast and its composed
    solve_batched_unrolled, in turns."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import pdhg_fused as pd

    out["kernel"] = os.path.relpath(pd.__file__, ROOT)
    solver = pdhg_cell_solver(dev)
    op = solver.A
    taps = op.taps_hw()
    xs = torch.from_numpy(phantoms(n=PDHG_N, batch=PDHG_BATCH)).to(dev)
    u = op.mv(xs).reshape(PDHG_BATCH, PDHG_N, PDHG_N).contiguous()
    out["tau"] = solver.tau
    cases = []
    for name, x, kind, prox, reps in (
        (f"cell: tv8, {PDHG_BATCH} x {PDHG_N}²", u, "tv8", "none", 1),
        (f"tviso, {PDHG_BATCH} x {PDHG_N}²", u, "tviso", "none", 3),
        (f"l1 positive, {PDHG_BATCH} x {PDHG_N}²", u, "l1", "positive", 3),
        (f"tv8, 4 x {PDHG_N}²", u[:4].contiguous(), "tv8", "none", 3),
        (f"tv8, 64 x {PDHG_N}²", u.repeat(4, 1, 1), "tv8", "none", 1),
    ):
        args = (x, taps, solver.sigma, solver.tau, PDHG_LAM, PDHG_ITERS, kind, prox)
        cases.append((name, lambda a=args: pd.pdhg_fused(*a), reps,
                      plan_probe(pd, (x, taps, kind), *args)))
    draws = bench_suite_draws()
    B = op.mv(torch.from_numpy(draws["admm"]).to(dev))[:, None].repeat(1, PDHG_BATCH).contiguous()
    cases.append(("cell solve_batched_fast", lambda: rtt.solve_batched_fast(solver, B), 1))
    time_cases(out, cases)
    img2, idx2 = draws["cs"]
    op8 = rtt.SubsampledDFT2RealOperator.from_sample_idx(idx2, (CS_N, CS_N), device=dev)
    time_cases(out, cs_cell_solves(dev, op8, img2), in_turns=True)


def time_fista_l1_dft(dev, out):
    """``--time-fista-l1-dft [ROOT]``: the fused FISTA-L1-DFT kernel (row
    8) at BASELINE #2's schedule (ρ = 0.95, 60 iterations, λ per problem
    around 2e-3): the CS cell's 16 distinct 256² problems (the phantoms of
    phase 3h), 1 and 64 problems of 256², 16 of 128² and 4 of 512² (the
    global route); then the cell as solve_batched_fast runs it, in turns
    with its composed solve_batched_unrolled (torch.fft) and the kernel,
    with the composed solve's device time by torch.profiler (the sum of its
    kernels' times, which host delays do not move) beside the kernel's;
    row 9 (FISTA-L21-SENSE on the 8 SENSE slices) as a control, with its
    cell's composed solve (wall and device time)."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import fista_l1_dft_fused as k8
    from rls_tpu_torch.kernels import sense_fused as k9

    out["kernel"] = os.path.relpath(k8.__file__, ROOT)
    img2, idx2 = bench_suite_draws()["cs"]
    op = rtt.SubsampledDFT2RealOperator.from_sample_idx(idx2, (CS_N, CS_N), device=dev)
    x16 = op.rmv(op.mv(torch.from_numpy(cs_phantoms(img2)).to(dev))).reshape(
        CS_BATCH, CS_N, CS_N)
    lam16 = torch.linspace(0.5, 2.0, CS_BATCH, device=dev) * CS_LAM
    rng = np.random.default_rng(13)

    def other(n, batch):
        """`batch` images of n² through a 35 % mask of their own."""
        o = rtt.SubsampledDFT2RealOperator.from_mask(rng.uniform(size=(n, n)) < 0.35, (n, n),
                                                     device=dev)
        imgs = torch.from_numpy(rng.normal(size=(batch, n * n)).astype(np.float32)).to(dev)
        return o.rmv(o.mv(imgs)).reshape(batch, n, n), o.mask, lam16[:batch]

    cases = []
    for name, x, mask, lam, reps in (
        (f"cell: {CS_BATCH} x {CS_N}²", x16, op.mask, lam16, 3),
        (f"1 x {CS_N}²", x16[:1].contiguous(), op.mask, lam16[:1], 5),
        (f"64 x {CS_N}²", x16.repeat(4, 1, 1), op.mask, lam16.repeat(4), 1),
        ("16 x 128²", *other(128, 16), 5),
        ("4 x 512² (global route)", *other(512, 4), 1),
    ):
        args = (x, mask, RHO, lam, CS_ITERS)
        cases.append((name, lambda a=args: k8.fista_l1_dft_fused(*a), reps,
                      plan_probe(k8, (x,), *args)))
    time_cases(out, cases)
    row8 = cs_cell_solves(dev, op, img2)
    time_cases(out, row8, in_turns=True)
    device_ms(out, (row8[0], row8[2]))
    # row 9, which this kernel's changes must not move, and its yardstick:
    # its cell's composed solve, wall and device time
    maps, mask, X = sense_problem()
    op9 = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (SENSE_N, SENSE_N), device=dev)
    x9 = op9.rmv(op9.mv(torch.from_numpy(X).to(dev))).reshape(SENSE_SLICES, 2, SENSE_N, SENSE_N)
    s9 = rtt.FISTA.create(op9, reg=rtt.L21Regularization(SENSE_LAM, slices=2),
                          iterations=SENSE_ITERS, rho=RHO)
    B9 = op9.mv(torch.from_numpy(X).to(dev)).T.contiguous()

    def composed9():
        return rtt.solve_batched_unrolled(s9, B9)

    time_cases(out, [
        ("row 9 sense_fused", lambda: k9.fista_l21_sense_fused(
            x9, op9.mask, op9.coils_r, op9.coils_i, RHO, SENSE_LAM, SENSE_ITERS), 2),
        ("row 9 composed solve_batched_unrolled", composed9, 1),
    ])
    out["row 9 composed device ms (profiler)"] = [
        sum(ms for ms, _, _ in device_kernels(composed9)) for _ in range(3)]


def device_ms(out, cases):
    """Three readings of each case's device time (``device_kernels``: the
    sum of the device kernels of one call, after a warm-up) into `out`
    under "{name} device ms (profiler)", and the largest kernels of the
    last reading."""
    for name, fn, *_ in cases:
        fn()
        readings = [device_kernels(fn) for _ in range(3)]
        out[f"{name} device ms (profiler)"] = [sum(ms for ms, _, _ in r) for r in readings]
        out[f"{name} device kernels (profiler, last)"] = [
            [key[:80], count, ms] for ms, count, key in readings[-1][:6]]


def time_sense(dev, out):
    """``--time-sense [ROOT]``: the fused FISTA-L21-SENSE kernel (row 9) at
    the SENSE cell's schedule (ρ = 0.95, λ = 1e-4, 80 iterations): the
    cell's 8 slices of 128² with 6 coils, the same tiled to 64 slices (more
    clusters than the card holds at once), 1 slice, 8 slices with the first
    1 and 3 coils and with 17 coils of their own (two rounds), and 4
    slices of 256² (the global route); then the cell's kernel in turns with
    its composed solve_batched_unrolled (torch.fft), both with their
    device time by torch.profiler; rows 8 (the CS cell's 16 problems) and
    10 (BASELINE #4) as controls."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import fista_l1_dft_fused as k8
    from rls_tpu_torch.kernels import sense_fused as k9
    from rls_tpu_torch.kernels import splitbregman_fused as k10

    out["kernel"] = os.path.relpath(k9.__file__, ROOT)
    maps, mask, X = sense_problem()
    op = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (SENSE_N, SENSE_N), device=dev)
    b = op.mv(torch.from_numpy(X).to(dev))
    x0 = op.rmv(b).reshape(SENSE_SLICES, 2, SENSE_N, SENSE_N)
    coils = (op.coils_r, op.coils_i)
    rng = np.random.default_rng(17)

    def maps_of(m):
        return tuple(torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
                     for v in (m.real, m.imag))

    g = 256
    x256 = torch.from_numpy(rng.normal(size=(4, 2, g, g)).astype(np.float32)).to(dev)
    mask256 = torch.from_numpy((rng.uniform(size=(g, g)) < 0.45).astype(np.float32)).to(dev)
    cases = []
    for name, x, m, cr, ci, reps in (
        (f"cell: {SENSE_SLICES} slices, {SENSE_C} coils", x0, op.mask, *coils, 3),
        (f"{8 * SENSE_SLICES} slices, {SENSE_C} coils", x0.repeat(8, 1, 1, 1), op.mask, *coils,
         1),
        (f"1 slice, {SENSE_C} coils", x0[:1].contiguous(), op.mask, *coils, 3),
        (f"{SENSE_SLICES} slices, 1 coil", x0, op.mask, *(c[:1].contiguous() for c in coils), 3),
        (f"{SENSE_SLICES} slices, 3 coils", x0, op.mask, *(c[:3].contiguous() for c in coils),
         3),
        (f"{SENSE_SLICES} slices, 17 coils", x0, op.mask, *maps_of(coil_maps(rng, 17)), 2),
        (f"4 slices of {g}², {SENSE_C} coils (global route)", x256, mask256,
         *maps_of(coil_maps(rng, SENSE_C, g)), 1),
    ):
        args = (x, m, cr, ci, RHO, SENSE_LAM, SENSE_ITERS)
        cases.append((name, lambda a=args: k9.fista_l21_sense_fused(*a), reps,
                      plan_probe(k9, (x, cr.shape[0]), *args)))
    time_cases(out, cases)
    # the cell in turns with its composed solve, and both device times
    s9 = rtt.FISTA.create(op, reg=rtt.L21Regularization(SENSE_LAM, slices=2),
                          iterations=SENSE_ITERS, rho=RHO)
    B9 = b.T.contiguous()
    cell = [
        ("row 9 sense_fused", lambda: k9.fista_l21_sense_fused(x0, op.mask, *coils, RHO,
                                                               SENSE_LAM, SENSE_ITERS), 2),
        ("row 9 composed solve_batched_unrolled", lambda: rtt.solve_batched_unrolled(s9, B9),
         1),
    ]
    time_cases(out, cell, in_turns=True)
    device_ms(out, cell)
    # rows 8 and 10, which this kernel's changes must not move
    img2, idx2 = bench_suite_draws()["cs"]
    op8 = rtt.SubsampledDFT2RealOperator.from_sample_idx(idx2, (CS_N, CS_N), device=dev)
    x8 = op8.rmv(op8.mv(torch.from_numpy(cs_phantoms(img2)).to(dev))).reshape(
        CS_BATCH, CS_N, CS_N)
    lam8 = torch.linspace(0.5, 2.0, CS_BATCH, device=dev) * CS_LAM
    sb_args = (x0, op.mask, *coils, SB_RHO, SB_RHO, SB_LAM, SB_LAM, *SB_SCHED, SB_TV, SB_TOL)
    time_cases(out, [
        ("row 8 fista_l1_dft_fused",
         lambda: k8.fista_l1_dft_fused(x8, op8.mask, RHO, lam8, CS_ITERS), 3),
        ("row 10 splitbregman_fused", lambda: k10.splitbregman_l1_tv_fused(*sb_args), 2),
    ])


def digest(x):
    """sha256 of a tensor's bytes: two trees' kernels agree bit for bit
    where their digests do."""
    import hashlib

    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()


def time_admm(dev, out):
    """``--time-admm [ROOT]``: the fused ADMM-TV kernel (row 4) at BASELINE
    #3's schedule (ρ = 0.1, λ = 2e-3, 12 × 6 × 8, tol_inner 1e-5, the 9 × 9
    Gaussian): the cell's 16 distinct 256² problems (the phantoms of phase
    3e), 1 and 64 problems of 256², Positive at batch 4, the cell at forced
    cluster sizes 6, 8 and 16 (where ROOT's kernel takes a forced size), 4
    problems of 4 × 12000 (the global route) and the tiled kernel (row 5)
    on the cell; then the cell's kernel in turns with its composed
    solve_batched_unrolled, both with their device time by torch.profiler;
    row 2 (FISTA at the flagship) as the control. Each plan and the
    kernel's clocks per phase where ROOT's package has them, and sha256
    digests of x from rows 2 and 5 and from row 4's global route, which a
    change of row 4's resident route leaves bit for bit."""
    import inspect

    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import _fgp_common
    from rls_tpu_torch.kernels import admm_tv_fused as k4
    from rls_tpu_torch.kernels import admm_tv_tiled as k5
    from rls_tpu_torch.kernels import fista_tv_fused as k2

    out["kernel"] = os.path.relpath(k4.__file__, ROOT)
    n, batch, lam, iters, cg, tv = ADMM256
    solver = build_admm(ADMM256, dev)
    op = solver.A
    taps = op.taps_hw()
    B = op.mv(torch.from_numpy(phantoms(batch=batch)).to(dev)).T.contiguous()
    x0 = op.rmv_stencil(B.T).reshape(batch, n, n)
    wide = torch.from_numpy(np.random.default_rng(11).normal(size=ADMM_WIDE)
                            .astype(np.float32)).to(dev)
    wide = _fgp_common.sepconv_stencil_normal(wide, *taps).contiguous()
    sched = (ADMM_RHO, lam, iters, cg, tv, ADMM_TOL)
    runs = [(f"cell: {batch} x {n}²", x0, {}, 3), (f"1 x {n}²", x0[:1].contiguous(), {}, 5),
            (f"64 x {n}²", x0.repeat(4, 1, 1), {}, 1),
            (f"positive, 4 x {n}²", x0[:4].contiguous(), {"prox": "positive"}, 5)]
    if "clusters" in inspect.signature(k4.admm_tv_fused).parameters:
        runs += [(f"cell at c = {c}", x0, {"clusters": c}, 3) for c in (6, 8, 16)]
    runs.append(("{} x {}x{} (global route)".format(*ADMM_WIDE), wide, {}, 1))
    cases = []
    for name, x, kw, reps in runs:
        args = (x, taps, *sched)
        plan_args = (x, taps) + ((kw["clusters"],) if "clusters" in kw else ())
        cases.append((name, lambda a=args, kw=kw: k4.admm_tv_fused(*a, **kw), reps,
                      plan_probe(k4, plan_args, *args, **kw)))
    cases.append((f"row 5 admm_tv_tiled, {batch} x {n}²",
                  lambda: k5.admm_tv_tiled(x0, taps, *sched), 3))
    time_cases(out, cases)
    # the cell in turns with its composed solve, and both device times
    cell = [("row 4 admm_tv_fused, cell", lambda: k4.admm_tv_fused(x0, taps, *sched), 3),
            ("row 4 composed solve_batched_unrolled", lambda: rtt.solve_batched_unrolled(solver, B),
             1)]
    time_cases(out, cell, in_turns=True)
    device_ms(out, cell)
    # row 2, which shares the band code, as the control
    s2, B2, _ = build_flagship(dev)
    x2 = s2.A.rmv_stencil(B2.T).reshape(BATCH, N, N)

    def row2():
        return k2.fista_tv_fused(x2, s2.A.taps_hw(), RHO, LAM, ITERS, TV_ITERS)

    time_cases(out, [("row 2 fista_tv_fused, flagship", row2, 3)])
    out["sha256 of x: row 2 flagship"] = digest(row2())
    out["sha256 of x: row 5 cell"] = digest(k5.admm_tv_tiled(x0, taps, *sched))
    out["sha256 of x: row 4 global route"] = digest(k4.admm_tv_fused(wide, taps, *sched))


def forced_tv(k1, x, lam, tv, c, own):
    """A TV prox launch of x (B, H, W) with its cluster size and the home of
    x, pv and ph forced (the private ``_launch``)."""
    return lambda: k1._launch(x, lam, tv, c, own)


def forced_probe(k1, dev, key, c, own):
    """The forced plan of ``forced_tv`` and the clusters the card holds."""
    B, H, W, _ = key

    def probe():
        plan, held = k1._card_plan(dev.index or 0, B, H, W, c, own)
        return {"plan": dict(vars(plan), resident_clusters=held)}

    return probe


def time_tv_fgp(dev, out):
    """``--time-tv-fgp [ROOT]``: the TV prox kernel (row 1) at TV_SHAPES
    (the composed flagship's 64 × 256², the ADMM cell's 16 × 256² at 8 dual
    iterations, 16 × 512², 8 × 1024², 4 × 4 × 12000, the global route at
    TV_WIDE and one problem of 256²), each with its CUDA-event time, its
    device time by torch.profiler and its bound (``bound``,
    ``fgp_loop_ops``). Where ROOT's kernel takes a forced plan (the
    private ``_launch``), every fitting cluster size at 64 × 256², 16 ×
    256² and 16 × 512² with x, pv and ph in shared memory where they fit
    and in global memory, and at 64 × 256² the planner's c with the two
    placements in turns. Then the composed solves that launch it (the
    flagship, the ADMM cell and the 512² cell, row 3's yardstick) with
    their device times. Each plan where ROOT's package has a planner, and
    sha256 digests of each case, of rows 2 and 4 as controls: a change of
    row 1's resident route leaves its global route and rows 2 and 4 bit
    for bit."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch import _build
    from rls_tpu_torch.kernels import admm_tv_fused as k4
    from rls_tpu_torch.kernels import fista_tv_fused as k2
    from rls_tpu_torch.kernels import tv_fgp as k1

    out["kernel"] = os.path.relpath(k1.__file__, ROOT)
    rng = np.random.default_rng(13)
    forced = hasattr(k1, "_card_plan")
    inputs, cases, sweep = {}, [], []
    for B, H, W, tv in TV_SHAPES:
        x = torch.from_numpy(rng.normal(size=(B, H, W)).astype(np.float32)).to(dev)
        lam = torch.from_numpy(rng.uniform(0.0, 0.2, size=B).astype(np.float32)).to(dev)
        lam[0] = 0.0
        inputs[B, H, W, tv] = x, lam
        out[f"{B} x {H}x{W}, {tv} dual bound ms"] = bound(fgp_loop_ops(tv) * B * H * W,
                                                          4 * (2 * B * H * W + B))

        def run(x=x, lam=lam, tv=tv):
            return k1.prox_tv2d_fgp(x.reshape(x.shape[0], -1), lam, x.shape[1:], tv)

        reps = 20 if x.numel() <= 2**22 else 5
        cases.append((f"{B} x {H}x{W}, {tv} dual", run, reps, plan_probe(k1, (x,))))
    if forced:
        limits = _build.device_limits(dev.index or 0)
        for key in ((64, 256, 256, 10), (16, 256, 256, 8), (16, 512, 512, 10)):
            (x, lam), (B, H, W, tv) = inputs[key], key
            on_chip = k1.own_shared_sizes(H, W, *limits)
            for c in k1.fitting_sizes(H, W, *limits):
                for own in ("shared", "global") if c in on_chip else ("global",):
                    sweep.append((f"{B} x {H}x{W}, {tv} dual, c = {c}, x pv ph {own}",
                                  forced_tv(k1, x, lam, tv, c, own), 20,
                                  forced_probe(k1, dev, key, c, own)))
    time_cases(out, cases + sweep)
    device_ms(out, cases + sweep)
    if forced:
        # the planner's c at 64 × 256² with the two placements, in turns
        (x, lam), (B, H, W, tv) = inputs[64, 256, 256, 10], (64, 256, 256, 10)
        c = k1.plan_on_card(x)[0].clusters
        time_cases(out, [(f"in turns: {B} x {H}x{W}, {tv} dual, c = {c}, x pv ph {own}",
                          forced_tv(k1, x, lam, tv, c, own), 20) for own in ("shared", "global")],
                   in_turns=True)
    for name, run, *_ in cases + sweep:
        out[f"sha256 of out: {name}"] = digest(run())
    # the composed solves that launch row 1, with their device times
    draws = bench_suite_draws()
    s2, B2, _ = build_flagship(dev)
    s3 = build_solver(512, dev)
    B3 = s3.A.mv(torch.from_numpy(np.ascontiguousarray(draws[512])).to(dev)).T.contiguous()
    s4 = build_admm(ADMM256, dev)
    B4 = s4.A.mv(torch.from_numpy(phantoms(batch=ADMM256[1])).to(dev)).T.contiguous()
    solves = [("flagship composed solve_batched_unrolled",
               lambda: rtt.solve_batched_unrolled(s2, B2), 1),
              ("admm_tv_deblur256_b16 composed solve_batched_unrolled",
               lambda: rtt.solve_batched_unrolled(s4, B4), 1),
              ("fista_tv_512_tiled_b16 composed solve_batched_unrolled",
               lambda: rtt.solve_batched_unrolled(s3, B3), 1)]
    time_cases(out, solves)
    device_ms(out, solves)
    # rows 2 and 4 as controls
    x2 = s2.A.rmv_stencil(B2.T).reshape(BATCH, N, N)
    out["sha256 of x: row 2 flagship"] = digest(
        k2.fista_tv_fused(x2, s2.A.taps_hw(), RHO, LAM, ITERS, TV_ITERS))
    n, batch, lam4, iters, cg, tv4 = ADMM256
    x4 = s4.A.rmv_stencil(B4.T).reshape(batch, n, n)
    out["sha256 of x: row 4 cell"] = digest(
        k4.admm_tv_fused(x4, s4.A.taps_hw(), ADMM_RHO, lam4, iters, cg, tv4, ADMM_TOL))


def time_tiled(dev, out):
    """``--time-tiled [ROOT]``: row 3 at the fista_tv_512_tiled_b16 cell
    (16 × 512², FISTA, 50 × 10, the 9 × 9 Gaussian) on the route its
    planner takes, and, where ROOT's row 3 has the cluster route, in turns
    with the row tiles (``tile_rows`` forced: the parent's kernel), c = 15
    in turns with c = 16, the cluster route's clocks of CTA 0 by phase,
    and at 16 × 256² the two placements (six planes and three, forced) in
    turns with their clocks and digests; the cell's composed
    solve_batched_unrolled; 8 × 1024² on the row tiles beside its composed
    solve, once each; the boundary of the dispatch at 16 × 384²: row 2,
    row 3 on its plan, on three planes and on the row tiles; each case's
    device time by torch.profiler; row 2 at the flagship as the control,
    with sha256 digests of row 2 and of row 3 on each route."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import fista_tv_fused as k2
    from rls_tpu_torch.kernels import fista_tv_tiled as k3

    out["kernel"] = os.path.relpath(k3.__file__, ROOT)
    cluster = hasattr(k3, "plan_fista_tv_tiled")
    draws = bench_suite_draws()

    def problem(n, imgs):
        s_n = build_solver(n, dev)
        B_n = s_n.A.mv(torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)).T.contiguous()
        x0 = s_n.A.rmv_stencil(B_n.T).reshape(-1, n, n).contiguous()
        return s_n, B_n, x0, s_n.A.taps_hw()

    s5, B5, x5, taps = problem(512, draws[512])
    args5 = (x5, taps, RHO, LAM, ITERS, TV_ITERS)
    tiles5 = k3.pick_tile_rows(512, 16, torch.cuda.get_device_properties(dev)
                               .multi_processor_count)
    row3 = [("512² x 16 row 3 default route", lambda: k3.fista_tv_tiled(*args5), 3,
             plan_probe(k3, (x5, taps)) if cluster else lambda: {})]
    if cluster:
        row3.append((f"512² x 16 row 3 tiles (tile_rows {tiles5})",
                     lambda: k3.fista_tv_tiled(*args5, tile_rows=tiles5), 1))
    time_cases(out, row3, in_turns=True)
    cases = list(row3)
    if cluster:
        forced = [(f"512² x 16 row 3 cluster c = {c}", lambda c=c: k3._run(*args5, clusters=c),
                   3) for c in (15, 16)]
        time_cases(out, forced, in_turns=True)
        out["512² x 16 row 3 clocks of CTA 0 by phase"] = k3.phase_clocks(*args5)
        solver, B, _ = build_flagship(dev)
        x16 = solver.A.rmv_stencil(B.T).reshape(BATCH, N, N)[:16].contiguous()
        args16 = (x16, solver.A.taps_hw(), RHO, LAM, ITERS, TV_ITERS)
        place = [(f"256² x 16 row 3 cluster c = 16, {own} planes",
                  lambda o=o: k3._run(*args16, clusters=16, own=o), 5)
                 for own, o in (("six", None), ("three", "global"))]
        time_cases(out, place, in_turns=True)
        for name, fn, *_ in place:
            out[f"sha256 of x: {name}"] = digest(fn()[0])
        for own, o in (("six", None), ("three", "global")):
            out[f"256² x 16 c = 16, {own} planes, clocks of CTA 0 by phase"] = k3.phase_clocks(
                *args16, clusters=16, own=o)
        cases += forced + place
    composed5 = [("512² x 16 composed solve_batched_unrolled",
                  lambda: rtt.solve_batched_unrolled(s5, B5), 1)]
    time_cases(out, composed5)
    # 8 × 1024² on the row tiles beside its composed solve, once each
    s10, B10, x10, taps10 = problem(1024, draws[1024])
    big = [("1024² x 8 row 3", lambda: k3.fista_tv_tiled(x10, taps10, RHO, LAM, ITERS,
                                                          TV_ITERS), 1),
           ("1024² x 8 composed solve_batched_unrolled",
            lambda: rtt.solve_batched_unrolled(s10, B10), 1)]
    for name, fn, reps in big:
        fn()
        out[f"{name} ms"] = [cuda_ms(fn, reps)]
        out[f"{name} device ms (profiler)"] = [sum(ms for ms, _, _ in device_kernels(fn))]
    if cluster:
        out["1024² x 8 row 3 plan"] = dict(vars(k3.plan_on_card(x10, taps10)[0]))
    del s10, B10, x10
    # the dispatch's boundary at 16 × 384²: row 2 and row 3's routes
    s4, B4, x4, taps4 = problem(384, draws[512].reshape(16, 512, 512)[:, :384, :384]
                                .reshape(16, -1))
    args4 = (x4, taps4, RHO, LAM, ITERS, TV_ITERS)
    tiles4 = k3.pick_tile_rows(384, 16, torch.cuda.get_device_properties(dev)
                               .multi_processor_count)
    edge = [("384² x 16 row 2", lambda: k2.fista_tv_fused(*args4), 3,
             plan_probe(k2, (x4, taps4), *args4)),
            ("384² x 16 row 3 tiles", lambda: k3.fista_tv_tiled(*args4, tile_rows=tiles4), 1)]
    if cluster:
        plan3 = k3._card_plan(dev.index or 0, *x4.shape, *(len(t) for t in taps4),
                              ("fista", "none", False), None, None, "global")[0]
        edge += [("384² x 16 row 3 default route", lambda: k3.fista_tv_tiled(*args4), 3,
                  plan_probe(k3, (x4, taps4))),
                 (f"384² x 16 row 3 three planes, c = {plan3.clusters}",
                  lambda: k3._run(*args4, clusters=plan3.clusters, own="global"), 3)]
        out["384² x 16 row 3 three-plane plan"] = dict(vars(plan3))
    time_cases(out, edge)
    cases += composed5 + edge
    device_ms(out, cases)
    # row 2 at the flagship, the control
    s2, B2, _ = build_flagship(dev)
    x2 = s2.A.rmv_stencil(B2.T).reshape(BATCH, N, N)

    def row2():
        return k2.fista_tv_fused(x2, s2.A.taps_hw(), RHO, LAM, ITERS, TV_ITERS)

    time_cases(out, [("row 2 fista_tv_fused, flagship", row2, 3)])
    out["sha256 of x: row 2 flagship"] = digest(row2())
    out["sha256 of x: 512² x 16 row 3 default route"] = digest(k3.fista_tv_tiled(*args5))
    out["sha256 of x: 512² x 16 row 3 tiles"] = digest(
        k3.fista_tv_tiled(*args5, tile_rows=tiles5))


def time_pgm_dense(dev, out):
    """``--time-pgm-dense [ROOT]``: the dense PGM kernel (row 7a) at the
    fista_l1_dense_cs_b16_fused cell (16 × 256 × 512, FISTA, λ = 1e-4, ρ =
    0.95/‖A‖₂², 600 iterations) and, where ROOT's row 7a has the grid
    route, in turns with the per-problem kernel forced (the parent's
    kernel); OptISTA and POGM at 100 iterations on both routes; FISTA at P
    = 1 and P = 137 (its own sparse phantoms) and with the gradient restart
    at 100 iterations; each case's device time by torch.profiler and the
    composed solve_batched_unrolled's; each plan and CTA 0's clocks by
    phase; and sha256 digests of row 7a on each route, of row 6 at both
    CGNR cells (timed as the control) and of row 7b, bit for bit between
    two trees where this kernel's change leaves them."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import cgnr_fused as k6
    from rls_tpu_torch.kernels import pgm_dense_fused as k7

    out["kernel"] = os.path.relpath(k7.__file__, ROOT)
    grid = hasattr(k7, "plan_pgm_dense")
    systems = dense_systems(bench_suite_draws())

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    a2b, b2b = systems["lasso"]
    A = t(a2b)
    rho = 0.95 / float(np.linalg.norm(a2b, 2)) ** 2
    rng = np.random.default_rng(5)
    x137 = (rng.normal(size=(512, 137)) * (rng.uniform(size=(512, 137)) < 0.05))
    batches = {"cell": t(b2b.T), "P = 1": t(b2b.T[:1]),
               "P = 137": t((a2b @ x137.astype(np.float32)).T)}

    def solve(b, method, iters, route=None, restart="none"):
        if route is None:
            return k7.pgm_dense_fused(b, A, LASSO_LAM, rho, 1.0, iters, method, "l1", restart,
                                      with_counts=True)
        scal, tab = k7.kernel_args(b, LASSO_LAM, rho, 1.0, method, iters)
        return k7._launch(b, A, scal, tab, (iters, method, "l1", restart, "none"), route=route)

    routes = ("grid", "per_problem") if grid else (None,)
    cases = []
    for label, b, method, iters, restart, reps in (
        ("cell: FISTA, 600 it.", batches["cell"], "fista", LASSO_ITERS, "none", 2),
        ("OptISTA, 100 it.", batches["cell"], "optista", SHORT_ITERS, "none", 5),
        ("POGM, 100 it.", batches["cell"], "pogm", SHORT_ITERS, "none", 5),
        ("FISTA gradient restart, 100 it.", batches["cell"], "fista", SHORT_ITERS, "gradient",
         5),
        ("P = 1: FISTA, 600 it.", batches["P = 1"], "fista", LASSO_ITERS, "none", 2),
        ("P = 137: FISTA, 600 it.", batches["P = 137"], "fista", LASSO_ITERS, "none", 1),
    ):
        pair = [(f"{label} {r or 'default route'}",
                 lambda b=b, m=method, i=iters, r=r, rs=restart: solve(b, m, i, r, rs), reps)
                for r in routes]
        time_cases(out, pair, in_turns=True)
        for name, fn, _ in pair:
            x, counts = fn()
            out[f"sha256 of x: {name}"] = digest(x)
            out[f"restarts: {name}"] = counts.tolist()
        if grid:
            out[f"plan: {label}"] = dict(vars(k7.card_plan(b, A)))
            out[f"clocks of CTA 0 by phase: {label}"] = k7.phase_clocks(
                b, A, LASSO_LAM, rho, 1.0, iters, method, "l1", restart)
        cases += pair
    device_ms(out, cases)
    # the composed solve at the cell, the yardstick
    s7 = rtt.FISTA.create(rtt.DenseOperator(A, device=dev), reg=rtt.L1Regularization(LASSO_LAM),
                          iterations=LASSO_ITERS, rho=rho, track_residual=False)
    B = batches["cell"].T.contiguous()
    composed = [("cell composed solve_batched_unrolled", lambda: rtt.solve_batched_unrolled(s7, B),
                 1)]
    time_cases(out, composed)
    device_ms(out, composed)
    # controls: row 6 at both CGNR cells (timed), row 7b at the complex case
    for name, key, lam, iters, reps in (
        ("row 6 cgnr_l2_dense64_fused_b16", "cgnr64", CGNR64_LAM, CGNR64_ITERS, 50),
        ("row 6 cgnr_l2_dense_1024x512_b64", "cgnr1k", CGNR1K_LAM, CGNR1K_ITERS, 20),
    ):
        A6, B6 = (t(a) for a in systems[key])
        args = (B6.T.contiguous(), A6, torch.full((B6.shape[1],), lam, device=dev),
                min(iters, A6.shape[1]))
        time_cases(out, [(name, lambda a=args: k6.cgnr_fused(*a), reps)])
        out[f"sha256 of x: {name}"] = digest(k6.cgnr_fused(*args))
    a_c, b_c = systems["cplx"]
    ar, ai = t(a_c.real.astype(np.float32)), t(a_c.imag.astype(np.float32))
    br, bi = t(b_c.real.T.astype(np.float32)), t(b_c.imag.T.astype(np.float32))
    rho_c = 0.95 / float(np.linalg.norm(a_c, 2)) ** 2

    def row7b():
        return k7.pgm_dense_fused_cplx(br, bi, ar, ai, LASSO_LAM, rho_c, 1.0, SHORT_ITERS,
                                       "fista", "l1", "gradient", "real", with_counts=True)

    time_cases(out, [("row 7b complex FISTA, gradient restart, real", row7b, 5)])
    xr, xi, counts = row7b()
    out["sha256 of x: row 7b"] = digest(torch.stack([xr, xi]))
    out["restarts: row 7b"] = counts.tolist()


def time_library(dev, out):
    """``--time-library [ROOT]``: the library yardstick of rows 2, 3, 4,
    5, 7a, 7b, 10, 11, 12a, 12b and 13 (PERF.md §6), the composed
    solve_batched_unrolled at the shapes of the main path: the FISTA-TV
    flagship, the 512² tiled FISTA-TV cell, the two ADMM-TV cells, the LASSO
    cell and the complex FISTA, BASELINE #4's SplitBregman on the 8 SENSE
    slices, the PDHG cell, one cyclic Kaczmarz sweep of the tall system,
    the tall streamed cell and one greedy sweep. Each with three wall
    readings (CUDA events, one call each) and three device times by
    torch.profiler (the sum of its kernels' times, which the host's launch
    gaps do not move)."""
    import torch
    import rls_tpu_torch as rtt

    draws = bench_suite_draws()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    solves = []

    def composed(row, solver, B):
        solves.append((f"row {row} composed solve_batched_unrolled",
                       lambda: rtt.solve_batched_unrolled(solver, B), 1))

    s2, B2, _ = build_flagship(dev)
    composed(2, s2, B2)
    s3 = build_solver(512, dev)
    composed(3, s3, s3.A.mv(t(draws[512])).T.contiguous())
    for row, cell, imgs in ((4, ADMM256, np.broadcast_to(draws["admm"], (ADMM256[1], 256 ** 2))),
                            (5, ADMM512, draws[512])):
        solver = build_admm(cell, dev)
        composed(row, solver, solver.A.mv(t(imgs)).T.contiguous())
    systems = dense_systems(draws)
    a2b, b2b = systems["lasso"]
    composed("7a", rtt.FISTA.create(
        rtt.DenseOperator(t(a2b), device=dev), reg=rtt.L1Regularization(LASSO_LAM),
        iterations=LASSO_ITERS, rho=0.95 / float(np.linalg.norm(a2b, 2)) ** 2,
        track_residual=False), t(b2b))
    a_c, b_c = systems["cplx"]
    composed("7b", rtt.FISTA.create(
        rtt.DenseOperator(t(a_c), device=dev),
        reg=[rtt.L1Regularization(LASSO_LAM), rtt.RealRegularization()],
        iterations=SHORT_ITERS, rho=0.95 / float(np.linalg.norm(a_c, 2)) ** 2,
        restart="gradient", track_residual=False), t(b_c))
    maps, mask, X = sense_problem()
    op10 = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (SENSE_N, SENSE_N), device=dev)
    composed(10, splitbregman_solver(op10, dev), op10.mv(t(X)).T.contiguous())
    s11 = pdhg_cell_solver(dev)
    composed(11, s11, s11.A.mv(t(draws["admm"]))[:, None].repeat(1, PDHG_BATCH).contiguous())
    kz = kaczmarz_systems(draws, dev)
    A, B16, Bt, _ = kz["tall"]
    dense = rtt.DenseOperator(A, device=dev)
    composed("12a", kaczmarz_solver(dense, (1, 1.0, 16), randomized=False), B16)
    composed("12b", kaczmarz_solver(dense, KZ_TALL), Bt)
    composed(13, kaczmarz_solver(dense, (1,) + KZ_GREEDY[1:], greedy=True), B16)
    time_cases(out, solves)
    device_ms(out, solves)


TIME_MODES = {
    "--time-cgnr": time_cgnr,
    "--time-pgm-tv": time_pgm_tv,
    "--time-splitbregman": time_splitbregman,
    "--time-pdhg": time_pdhg,
    "--time-fista-l1-dft": time_fista_l1_dft,
    "--time-sense": time_sense,
    "--time-admm": time_admm,
    "--time-tv-fgp": time_tv_fgp,
    "--time-tiled": time_tiled,
    "--time-library": time_library,
    "--time-pgm-dense": time_pgm_dense,
}


if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1] in TIME_MODES:
        sys.exit(timing_run(sys.argv[2] if len(sys.argv) > 2 else ROOT, TIME_MODES[sys.argv[1]]))
    sys.exit(main())
