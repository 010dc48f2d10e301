#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rls_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: CUDA must be present; TF32 is switched off for matmuls and
     cuDNN; the card's name and power limit are printed;
  2. build: the sixteen CUDA sources are compiled from
     rls_tpu_torch/csrc (one nvcc per source, all at once); phase 12
     (a)'s long signals' plain version starts on the CPU in a process of
     its own, which the run stops when it ends;
  3. each kernel against its plain PyTorch version on the card, with both
     times: the TV prox at TV_CHECKS (each plan printed and required:
     every shape the main path gives it on its resident route, with x, pv
     and ph in shared and in global memory, by the route counter, 8 ×
     1024² on its windowed route (held to its windowed plain version too,
     no global launch) and its global route at TV_WIDE, rows too wide
     for a window; forced windows at 16 × 512² with the resident plan's
     sha256, bit for bit) and the fused
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
     the plain version on the card; 5b. the 1024² cell's problems
     (fista_tv_1024_tiled_b8) through solve_batched_unrolled, the composed
     solve: with the counts at 0 just before, 50 launches of the TV prox,
     all on its windowed route (the route counter) and no other kernel,
     held on two columns against the same float64 solve, and timed once;
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
     complex kernel on a complex A (FISTA with gradient restart and Real,
     POGM) and on the real A with a complex b (its plan printed first,
     each case one launch on the grid route by the route counter);
  3h. each FFT kernel against its plain version, held to the plain
     version's own spread under b·(1 + 2⁻²³) (FFT_SPREAD), with both
     times: the fused FISTA-L1-DFT on 16 distinct 256² CS problems with λ
     per problem (60 iterations; its plan printed first, on the resident
     route by its route counter, and bit for bit the plain version), and
     its grid route (a team of CTAs a problem that meet in L2) on 4 and 16
     problems of 512² (bit for bit, timed with its bound and CTA 0's
     clocks, the route counter set to 0 just before and required to read
     one grid launch), the fused FISTA-L21-SENSE (bit for bit) and the fused
     SplitBregman L21 + TV (4 × 8 × 8, TV 5, with the live CG steps of
     kernel and plain version side by side), each with its plan printed
     first (route, CTAs per slice, row bands, rounds of coils, shared
     memory, clusters resident at once) and on its resident route by its
     route counter, on the 8 SENSE slices of 128² with 6 coils, the split
     routes of both (a coil's spectrum over a team of CTAs) on 2 slices of
     256 × 128 and their grid routes (each slice's coils over a team of
     CTAs that meet in L2) on 2 slices of 512² and 1 of 1024² (two rounds
     of coils), 6 coils, held alike and each required to run once on that
     route, and 20 launches of each at 512² required to give the first
     launch's bits (row 10 on a short schedule); the sha256 of every output at these power-of-two shapes and
     of rows 9 and 10 at 8 × 192² beside the parent tree's
     (PARENT_FFT_SHA256), required equal but for row 10's outputs that
     left the parent's route (FFT_DIGEST_MOVED: printed); an input whose
     sha256 is not the parent's fails the run: the digests must be
     recorded anew; then the mixed-radix FFT at sides with odd factors
     (MIXED_L1DFT, MIXED_SENSE): row 8 at 16 × 320² (resident, c = 16)
     and 4 × 64 × 448 (c = 4), 4 × 640², 2 × 1024² and 4 × 448² (the
     grid route: past a cluster of 16), and on uneven bands and blocks at 2 × 97 × 128 (a prime side, c =
     3), 4 × 225² (c = 12), 16 × 300² and 16 × 320 × 260 (c = 16), each
     output's sha256 beside the parent trees' (their global route at the
     uneven and the grid shapes) and required equal, rows 9 and 10 at 8 × 64 × 192
     (resident) and 8 × 192² (split), 6 coils, each plan printed, bit for
     bit (row 10: its spread and live CG steps) on its route by the route
     counter, each timed in turns with its plain version and printed with
     its bound, with the composed solve's device time (torch.profiler) at
     each shape;
  8. the dense cells through solve_batched_fast, each running its kernel
     once by the launch counters, with problems/s:
     cgnr_l2_dense64_fused_b16 (printed against a float64 DirectSolver;
     the refined CGNR, 3 rounds on 4 columns, held to TOL_PARITY and
     TOL_RESIDUAL), cgnr_l2_dense_1024x512_b64 (held on 4 columns, with a
     torch.linalg.solve yardstick), fista_l1_dense_cs_b16_fused (held to
     TOL_RESIDUAL on 2 columns against a float64 solve of the plain
     version), its OptISTA and POGM at 100 iterations (each of the three
     one launch on row 7a's grid route by the route counter, the plan
     printed first), and the complex FISTA case (one launch on row 7b's
     grid route by the route counter, the plan printed first);
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
     route counter; on the mixed-radix FFT the same settings at other
     sides: fista_l1_cs_dft320_b16 (resident route, also composed),
     fista_l1_cs_dft512_b16 (BASELINE #2 at 512²: one launch on the grid
     route by the route counter, also composed),
     fista_l21_sense192_6coil_b8 and splitbregman_sense192_6coil_b8 (the
     latter also composed; both one launch on the split route); each
     cell's composed solve is timed (wall, and device time by
     torch.profiler) as its kernel's
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
     counted, all on the warp route by the route counter); the streamed
     solve on the tall system (dense and padded CSR, 16 distinct b; the
     warp route required), the 64 MiB system (4 b), a complex system and
     a real A with a complex b, each plan printed and its one launch on
     that plan's route by the route counter, and both routes forced at
     the tall dense system; the greedy solve (20 sweeps of 64 steps, the
     tall system, batch 16) with forced rows and with sampled draws
     through greedy_solve, each one launch on its plan's route by the
     counters, whose rows must equal the plain version's, and the same
     with the block route forced (20 launches by the route counter); each
     held by `hold_dense` and timed in turns with its plain version,
     beside the composed solve at its shapes (the greedy sweep alone too);
 10. the PDHG and Kaczmarz cells through solve_batched_fast, each
     running its named dispatch row (pdhg, kaczmarz_streamed,
     kaczmarz_greedy) by the launch counters, with problems/s, two
     columns held to a float64 plain solve on the card (the PDHG cell to
     twice its plain f32 version's own departure where that exceeds
     TOL_PARITY) and the error against the true image beside the float64
     solve's own: pdhg_tv8_deblur256_b16_fused (also composed; its one
     launch on the resident route by the route counter),
     kaczmarz_rand_pos_tall_b16_streamed, kaczmarz_rand_pos_tall_b16_csr,
     kaczmarz_streamed_64MiB_b4 (each one launch on its plan's route by
     the route counter) and this script's kaczmarz_greedy_tall_b16 (one
     launch of the greedy solve on its plan's route);
 11. the composite, decorator, DAX and operator path, each case with the
     launch counters set to 0 just before it and read just after, and its
     times beside the card's name and power limit: (a) decorated terms
     that the JAX dispatch reads through sink / get_lam, each bit for bit
     its undecorated twin and one launch of its kernel
     (cgnr_l2_dense_1024x512_b64 with FixedScaledRegularization(L2(λ/4),
     4), pdhg_tv8_deblur256_b16_fused with FixedScaled(TV(2λ), 0.5),
     kaczmarz_rand_pos_tall_b16_streamed with
     FixedParameterRegularization(L2)), and the flagship with
     FixedScaled(TV(λ), 1), which row 2's type check rejects: the
     fallback warning, 50 resident tv_fgp launches, bit for bit the
     undecorated solve_batched_unrolled; then, each through
     solve_batched_fast's composed fallback and held on two columns to a
     float64 solve on the card (TOL_PARITY, or twice the f32 solve's own
     1-ulp spread where it cannot meet it, and TOL_RESIDUAL), with
     problems/s: (b) non-separable deblurring on DirectConvOperator (16 ×
     256², a seeded 9×9 blur of rank 2, FISTA + TV, 50 tv_fgp launches)
     and a FunctionOperator of its mv, whose vjp adjoint must match its
     rmv; (c) the SENSE problem of phase 9 as composites (per coil
     Sampling ∘ FFT ∘ Weighting, the coils stacked) with
     TransformedRegularization(L1, WaveletOperator db2), 80 iterations;
     (d) sparse-view CT on RadonOperator (8 × 128², 90 angles, FISTA + TV,
     50 tv_fgp launches) and its adjoint identity to 1e-5; (e)
     DaxKaczmarz (its float64 run on the rows its run drew, replayed from
     its seed) and DaxConstrained (min x ≥ −1e-4) on the tall Kaczmarz
     system's 16 distinct b;
 12. the last regularizers and the API surface, each case with the launch
     counters set to 0 just before it and read just after, its times beside
     the card's name and power limit: (a) the exact 1-D Condat kernel
     (csrc/tv_condat.cu) against its plain version, bit for bit, at 64 ×
     256² along each image axis, 16 × 1 × 65,536 (long signals: 16
     threads; the plain version runs on the CPU in a process started with
     the run) and 16 × 256² in float64, each one launch; (b) FISTA with
     TVRegularization(dims=1) on the flagship's 9×9 blur, 16 × 256², 50
     iterations through solve_batched_fast (the composed fallback with its
     named reason, 50 Condat launches); (c) Nuclear matrix completion, 8 ×
     256² of rank 8, 30 % of the entries by SamplingOperator, FISTA, 50
     iterations; (d) LLR on a cine series, 4 × 128² × 16 frames, complex,
     a per-frame 2-D FFT keeping 25 % of the phase-encode lines (the 8
     lowest always), 8×8 blocks with randshift, FISTA, 30 iterations, with
     torch.linalg.svd's CUDA drivers timed at its 1,024 blocks of 64 × 16;
     (e) PnP-ADMM with a CNN of 8 channels trained on the card by
     train_denoiser (200 steps at 64²), 16 × 256², whose error must beat
     CGNR-L2's; (b)-(e) held on two columns to float64 solves on the card
     (TOL_PARITY, or twice the f32 solve's own 1-ulp spread, and
     TOL_RESIDUAL), each with problems/s and the device's busy share; (f)
     the API on the card: solve_with_callbacks on the flagship (50 tv_fgp
     launches, bit for bit solve's), solve_trace on 4 of its problems, a
     checkpoint saved after 25 iterations and resumed (bit for bit),
     create_linear_solver by name (one fused launch, bit for bit) and
     profiling.trace writing a Chrome trace;
 13. rls_tpu_torch.parallel on a mesh of the cards, or of the one card
     named twice ([cuda:0, cuda:0], two shards in turn on its stream),
     each sharded call with the launch counters set to 0 just before it
     and read just after (its kernel once a shard, no other), its wall
     time beside the unsharded call's and the card's name and power
     limit: solve_fista_tv_fused_sharded on the flagship (64 × 256², 2 ×
     32) and solve_admm_tv_fused_sharded on BASELINE #3 (16 distinct
     256² phantoms), held bit for bit to the unsharded kernel on the
     whole batch; solve_cgnr_fused_sharded on
     cgnr_l2_dense_1024x512_b64, solve_pgm_dense_fused_sharded on
     fista_l1_dense_cs_b16_fused and solve_pdhg_fused_sharded on
     pdhg_tv8_deblur256_b16_fused, each with the plans of the whole batch
     and of a shard printed, bit for bit where they agree, else within
     DENSE_SPREAD × the unsharded kernel's own spread under b·(1 + 2⁻²³)
     (DENSE_FLOOR) and TOL_FUSED_MAX of max|x|; solve_batched_sharded on a
     composed FISTA-L1 (the 1024 × 512 cell's system, 100 iterations) and
     a CGNR on the 1024 × 512 cell's rows in one block per mesh entry
     (solve_batched, and solve_batched_fast's fallback naming the dense
     check's reason), each held to its unsharded solve at that bar and to
     float64 at TOL_PARITY and TOL_RESIDUAL;
 14. every examples/torch/*.py with --device cuda in a child process, four
     at a time, each of which must exit 0, with its wall time;
  7. the kernel table as one JSON line (launches on the main path, error
     against the plain version, kernel and plain times, the least time
     the card could take, `bound_ms`, and a library yardstick where one
     exists: the composed solve_batched_unrolled at the kernel's shapes,
     timed once in phases 5, 6 and 8 for the tiled FISTA, the two ADMM
     and the two dense PGM rows), then the result line {"ok": true,
     "device": {...}}.

Phases 3h and 3i run after 3g, phases 8–14 after phase 6; the table and
the result line come last. The flagship problem is rebuilt with numpy
exactly as bench.py:36-68 builds it, the other cells as
tools/bench_suite.py:79-102, :104-125, :127-151, :153-194, :204-306 and
:308-379 build them (replaying its seeded generators).

    python3 chip_smoke.py --digest-fft [ROOT]

runs phase 3h's power-of-two cases and rows 9 and 10 at 8 × 192² on the
rls_tpu_torch under ROOT, whatever routes its planners take, and prints
the sha256 of each input and kernel output as one JSON line: what
PARENT_FFT_SHA256 records of the parent tree.

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
cell through solve_batched_fast, then the 192² cell in turns with its
composed solve, the split shapes and the forced plans (as --time-sense),
with each plan and the kernel's clocks per phase where ROOT's package has
them.

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
128², the cell through solve_batched_fast, and the kernel in turns with
the cell's composed solve_batched_unrolled, whose device time
torch.profiler also reads; the shapes past a cluster of 16 (GRID_L1DFT:
4 × 512², 4 × 640², 2 × 1024², 16 × 512², 4 × 448², the grid route, or
the global route of a tree before it) with their device time, sha256,
bound, clocks and the composed solve's device time, and the forced grid
plans of GRID_SWEEP in turns where ROOT's wrapper takes `grid=`; the uneven shapes of phase
3h (2 × 97 × 128, 4 × 225², 16 × 300², 16 × 320 × 260) with their sha256
and the composed solve's device time at each, and, where ROOT's wrapper
takes `clusters=`, every cluster size forced at 97 × 128, 225², 300²
and 320² in turns; row 9 as a control; with each plan and the kernel's clocks per
phase where ROOT's package has them. Run it for the parent tree and this
one in turns (parent, change, change, parent) in one chip call.

    python3 chip_smoke.py --time-mixed-radix [ROOT]

times rows 8, 9 and 10 at phase 3h's mixed-radix shapes (MIXED_L1DFT,
MIXED_SENSE), the kernels alone, three readings each, with each plan.

    python3 chip_smoke.py --time-sense [ROOT]

does the same for the fused FISTA-L21-SENSE kernel (row 9): the SENSE
cell's 8 slices of 128² with 6 coils (80 iterations), 64 slices, 1 slice,
8 slices with 1, 3 and 17 coils, 4 slices of 256²; the kernel in turns
with the cell's composed solve_batched_unrolled, both with their device
time by torch.profiler, and the same at the 192² cell; 8 slices at each
shape the split route takes (SPLIT_SHAPES) and a sweep of forced plans
(teams and coils a round: SPLIT_SWEEP at 192², SPLIT_SWEEP_128 at 128²);
rows 8 and 10 as controls; with each plan and the kernel's clocks per
phase where ROOT's package has them; then rows 9 and 10 past a team of
16 (``time_sense512``): 2 slices of 512² in turns with the composed
solve (the grid route, or the global route of a tree before it), both
device times, the bound and CTA 0's clocks, and where ROOT's wrapper
takes ``grid=`` the forced grid plans of GRID_SWEEP_SENSE, 1 × 1024² and
the grid route forced at 384² and 448² beside the split route there.
``--time-splitbregman`` times the same 192² cell, shapes and sweep for
row 10.

    python3 chip_smoke.py --time-sense-grid [ROOT]

runs ``time_sense512`` alone for rows 9 and 10: run it for the parent
tree and this one in turns (parent, change, change, parent).

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
5 and 16 and 16 × 256² at 6, forced windows at 8 × 1024², each with its
device time by torch.profiler; the composed flagship, ADMM cell and 512²
solves that launch it and, at 1024² × 8, the composed FISTA-TV and ADMM-TV
solves beside rows 3 and 5 on their row tiles, with their device times;
each plan, and sha256 digests of every case and of rows 2 and 4 (bit for
bit between two trees where row 1's change leaves them).

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

does the same for the dense PGM kernels (rows 7a and 7b): the
fista_l1_dense_cs_b16_fused cell (600 iterations) on its grid route in
turns with the per-problem kernel forced, OptISTA and POGM at 100
iterations, FISTA with its gradient restart, at P = 1 and at P = 137; the
three complex cases of phase 3g (100 iterations); each on both routes
and with its device time by torch.profiler; the composed
solve_batched_unrolled and its device time at the 7a cell and at 7b's
timed case; each plan and the grid route's clocks of CTA 0 by phase; row
6 at both CGNR cells as the control; sha256 digests, and the entries of
x that differ from the trees timed before (.timing/pgm_dense/).

    python3 chip_smoke.py --time-kaczmarz [ROOT]

does the same for the Kaczmarz row kernel (rows 12a and 12b): one sweep of
the 12a cell (cyclic and shuffled), the three streamed cells of
tools/bench_suite.py, the complex system and the real A with a complex b,
each on its plan and, where ROOT's package has the routes, on both routes
forced and on the warp route with 1, 2, 4, 8 and 16 problems a CTA; rows
of 256 … 8192 entries on both routes (the crossover); each case's device
time by torch.profiler, its plan and the warp route's clocks of CTA 0's
warp 0 by phase; sha256 digests of x and vl, and the entries that differ
from the outputs of a tree timed before in the same directory
(.timing/kaczmarz/).

    python3 chip_smoke.py --time-composite [ROOT]

times phase 11's cells (b)-(e) and the flagship with a decorated TV
through solve_batched_fast (each the composed fallback): three wall
readings, three device times by torch.profiler with the largest
kernels, and the device's busy share.

    python3 chip_smoke.py --time-library [ROOT]

reads the library yardstick of rows 2, 3, 4, 5, 7a, 7b, 10, 11, 12a, 12b
and 13: the composed solve_batched_unrolled at each kernel's main-path
shapes, three wall readings and three device times by torch.profiler
each.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

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
# 3's and row 5's yardsticks), the 1024² composed solve (windows: no
# cluster holds a problem's bands), one-row bands, and the global route;
# each with its route and where its plan keeps x, pv and ph
TV_1024 = (8, 1024, 1024, 10)
TV_CHECKS = ((64, 256, 256, 10, "resident", "shared"), (16, 256, 256, 8, "resident", "global"),
             (16, 512, 512, 10, "resident", "global"), (*TV_1024, "windows", "shared"),
             (4, 4, 12000, 10, "resident", "global"), (*TV_WIDE, 10, "global", "global"))
# forced windows at 16 × 512² (interior rows, cluster size, placement),
# each bit for bit the resident plan: 2 windows of 256 (276 rows on 16
# CTAs, six planes) and 4 of 128 on 8 CTAs with x, pv, ph in global memory
TV_FORCED_WINDOWS = ((256, None, None), (128, 8, "global"))
# the kernel table's row of the windowed route, at the 1024² composed
# solve's shape (its launches: phase 5b)
TV_WINDOWS_ROW = "tv_fgp {}x{}x{} (windows)".format(*TV_1024[:3])
# the TV prox kernel's shapes in --time-tv-fgp: (B, H, W, dual iterations)
# of the composed flagship (50 launches), the ADMM cell's composed solve
# (12), the 512² composed solve (50) and the 1024² one, beside 4 × 4 ×
# 12000 (one-row bands), the global route and one problem
TV_SHAPES = ((64, 256, 256, 10), (16, 256, 256, 8), (16, 512, 512, 10), TV_1024,
             (4, 4, 12000, 10), (*TV_WIDE, 10), (1, 256, 256, 10))
# forced windows at 8 × 1024² in --time-tv-fgp, (interior rows, cluster
# size): the planner's pick on an H100 (c = 8 on 72-row windows, six
# planes), 16 and 15 CTAs on 144- and 134-row windows (six planes, priced
# the same), 8 CTAs on 134 rows and 16 on 276 (three planes, 2 % and 7 %
# more) and 7 on 63 (18 % more)
TV_WINDOW_SWEEP = ((52, 8), (124, 16), (114, 15), (114, 8), (256, 16), (43, 7))
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
# The mixed-radix FFT (sides with odd factors) in phase 3h: row 8's (B, H,
# W) and the route its planner takes; rows 9 and 10 at (H, W) with SENSE_C
# coils and SENSE_SLICES slices. 320² fits a cluster evenly only at c = 16
# (20-row bands), 64 × 448 at 4; 640², 448² (7 · 64) and 1024² fit no
# cluster of 16 (the grid route: teams of 33 and 66 CTAs a problem that
# meet in L2; the parent's global route, whose digests they keep); the
# prime 97 × 128 (c = 3: bands of 33, 32, 32 rows),
# the odd side 225² (c = 12), 300² (c = 16: bands of 19 or 18 rows) and
# 320 × 260, an 81 % phase field of view (c = 16), run on uneven bands and
# blocks (on the global route before); 64 × 192 a coil's padded spectrum
# in one CTA, 192² not: there each coil's spectrum is split over a team of
# 3 CTAs (the split route). Each case is timed under the key "{kernel}
# {H}x{W}"; the kernel table reads 320x320 and 192x192
MIXED_L1DFT = (((CS_BATCH, 320, 320), "resident"), ((4, 640, 640), "grid"),
               ((2, 1024, 1024), "grid"), ((4, 448, 448), "grid"),
               ((2, 97, 128), "resident"), ((4, 225, 225), "resident"),
               ((CS_BATCH, 300, 300), "resident"), ((CS_BATCH, 320, 260), "resident"),
               ((4, 64, 448), "resident"))
MIXED_SENSE = (((64, 192), "resident"), ((192, 192), "split"))
# the kernel table's rows of the mixed-radix FFT, and phase 9's cells at
# their shapes (launches and the composed solve)
MIXED_ROWS = ("fista_l1_dft_fused (320², mixed radix)", "sense_fused (192², mixed radix)",
              "splitbregman_fused (192², mixed radix)")
# the kernel table's rows of row 8 by route: the resident route at the CS
# cell (256²), the grid route at phase 9's 512² cell's batch (16 × 512²)
L1_ROW, GRID_ROW = ("fista_l1_dft_fused (256², resident route)",
                    "fista_l1_dft_fused (512², grid route)")
MIXED_CELLS = ("fista_l1_cs_dft320_b16", "fista_l21_sense192_6coil_b8",
               "splitbregman_sense192_6coil_b8")
# the sha256 (input, output) of phase 3h's power-of-two cases on the parent
# tree, by `python3 chip_smoke.py --digest-fft <parent tree>` on an NVIDIA
# H100 80GB HBM3, 700.00 W
PARENT_FFT_SHA256 = {
    "fista_l1_dft_fused[256², batch 16, 60 it.]": (
        "87de0c6eef40ce6394d4ed9d3f7e9298b54dc0f58369d74e990376ecba9616bd",
        "38eb2010bb50a66e944527a91fa0d2d0ef1e581b619e89ff66a8d6f6e5581536"),
    # 512² ran on the global route (one CTA a problem) on the tree before
    # the grid route
    "fista_l1_dft_fused[512², batch 4, 60 it.]": (
        "8d52cbf78670d63da95854ee900b818e483aafd3dbbe52c387a7361c57db57ea",
        "416d5cdcc905a900fab11c7b3dbfccc95a5bac96d0958ef6cff8c5515bca3e11"),
    # row 8 at phase 3h's mixed-radix shapes on the tree before uneven bands:
    # 320² and 64 × 448 on even clusters, 640² and the uneven shapes (97 ×
    # 128, 225², 300², 320 × 260) on the global route; 16 × 512², 1024² and
    # 448² on the global route of the tree before the grid route (recorded
    # by --digest-fft on it, NVIDIA H100 80GB HBM3, 700.00 W)
    "fista_l1_dft_fused[320×320, batch 16, 60 it.]": (
        "f9ad633ceb8a072be361c6bd2ba83dc66880811ae63fd3853625f1f34bcb9f61",
        "1368542a4693dc2f29e2665450daa6d78801254dfd9d7bd5479aef091f131570"),
    "fista_l1_dft_fused[64×448, batch 4, 60 it.]": (
        "f77e440b40666de7b31839d7ebb9b0de92a49fc38473dd040c08bbd4781f0a4e",
        "4239f4465cbb39cb8e07aa137d75539082a5165b2eb1a61be49b07f2a8789e50"),
    "fista_l1_dft_fused[640×640, batch 4, 60 it.]": (
        "451273a169f39fbb117ea9cfd758ac09b8b54113649f1c42145b949d976eb028",
        "a7d774f4a5cae503127fe8bdf6b572dfadde58933486120e8b2c045e8be08b6b"),
    "fista_l1_dft_fused[97×128, batch 2, 60 it.]": (
        "59daea7d8411d22fd0eb98002b08f09aae57811682fd7ea65333880b22a119a2",
        "b2227810ad29ce1a2914cd0019ea9fc57bb6dae675d134650f24d4bc2b2cbe5e"),
    "fista_l1_dft_fused[225×225, batch 4, 60 it.]": (
        "5d79f40991c2bb9b71abd83a58d82ab8722ed07ac68bc9fb3ca8d9a9852b10b4",
        "e402a83f0d3a3fa7e2ba628e53052e9d75536e0b5d7383c47db92a6a5fa3c278"),
    "fista_l1_dft_fused[300×300, batch 16, 60 it.]": (
        "2eb1e9500f1eaed8fdcfa9cde804fa173bb9f45341c2af468e0f9dafda5e2535",
        "2ff5be7907c8254194f213f4a60b67d3b6064097d08c9a74ea67e1edd2a06704"),
    "fista_l1_dft_fused[320×260, batch 16, 60 it.]": (
        "bafbc1a254b251ed2d488bbd353a6c8874da405a8f8787447c2336cd4c9ab99c",
        "dc54cf149a5dbbc46a7f6a17a7801567518ec454adc1df10156d36a078f4a3d2"),
    "fista_l1_dft_fused[512², batch 16, 60 it.]": (
        "c5acef9d857bb4eebf090c629f9c694bf6fb9e03b2a69205fde97a0d7f57d8d1",
        "658192db1f767d7fa0c8e1229154c02fbfdbcc584391eb930645e869e03f9c0d"),
    "fista_l1_dft_fused[1024×1024, batch 2, 60 it.]": (
        "cad32235b884c81f52c291ba1e534b8ab94a32c3b525900d4dfeda8d98d9ee9f",
        "cbe284e9111d08df9a120fba44a72a20dc47450588f61107e8366717e116d4d4"),
    "fista_l1_dft_fused[448×448, batch 4, 60 it.]": (
        "950c2c674ebea21fa6240bf1760dfc2cf4c3daa7f7102b835f449d896306c9eb",
        "87b3aa65df6f91fa16559d492a2e6624f6821795da61e5482ba550f0f0fb8353"),
    "sense_fused[128², 6 coils, 8 slices, 80 it.]": (
        "ced28527da67d765ca5380d081f7764ba1187578529d85fac2a8cc40203b17b2",
        "7f97813783919df7d6135cc152f7853c137f4cad440e969c0772e2f02d00a8c2"),
    "splitbregman_fused[128², 6 coils, 8 slices, 4×8×8, TV 5]": (
        "ced28527da67d765ca5380d081f7764ba1187578529d85fac2a8cc40203b17b2",
        "317a3bcc765ff76e511e552773cdeb9a4892821735eac84980306339794b2e8b"),
    # rows 9 and 10 at 512² ran on the global route (one CTA a slice) on the
    # tree before the grid route
    "sense_fused[grid route, 512², 6 coils, 2 slices, 80 it.]": (
        "3f65f9a03257c0323357be9a9472b93f431d1cfeca868e0d63ea0f8694120ef0",
        "56d10dd49c24165d6efe422e398e9ccbe32e107ad4d1e0283f9de1a3858bb0d7"),
    "splitbregman_fused[grid route, 512², 6 coils, 2 slices, 4×8×8, TV 5]": (
        "3f65f9a03257c0323357be9a9472b93f431d1cfeca868e0d63ea0f8694120ef0",
        "902c84ead10703860bea360c2d986487d4c6efd6a36784334f37e5d5c96e8d56"),
    # rows 9 and 10 at 192² and 256 × 128 ran on the global route on the
    # parent tree
    "sense_fused[192×192, 6 coils, 8 slices, 80 it.]": (
        "0c68cf3dafd83a793ef6ac55368b4b6cd28b74fe522b372d423740ac50866ef7",
        "3f0a2dfe4108ee860889ac2a003d08c66cfe1e282e8ad2179a4053f65d6be611"),
    "splitbregman_fused[192×192, 6 coils, 8 slices, 4×8×8, TV 5]": (
        "0c68cf3dafd83a793ef6ac55368b4b6cd28b74fe522b372d423740ac50866ef7",
        "b9943f2e2ea14ea79ea0c7c3962f49bf0816b607d38a6ef36f6bac04afb9e1f8"),
    "sense_fused[split route, 256×128, 6 coils, 2 slices, 80 it.]": (
        "fcbc9dd7b6c4c5d159fc045f9e70227134e7b9f53b0d0138651ebd118a04dd17",
        "2ee5c4b3a09051ccb14f05fca7c4f9a881a7fd4acd5bee86f011f9b889e1a1b0"),
    "splitbregman_fused[split route, 256×128, 6 coils, 2 slices, 4×8×8, TV 5]": (
        "fcbc9dd7b6c4c5d159fc045f9e70227134e7b9f53b0d0138651ebd118a04dd17",
        "4ceefa6e5f8f9c29c3918f2ddd52462b200d91d7282d3ad8f2edfc52cf2f7be2"),
}
# Row 10's outputs that left the parent's route (the global one) for the
# split route: their CG sums are double sums taken over another set of
# CTAs, which may round apart, so they are held to the spread and the live
# CG steps (FFT_SPREAD) and their digests are printed beside the parent's,
# not required equal.
FFT_DIGEST_MOVED = (
    "splitbregman_fused[split route, 256×128, 6 coils, 2 slices, 4×8×8, TV 5]",
    "splitbregman_fused[192×192, 6 coils, 8 slices, 4×8×8, TV 5]",
)
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
# phase 11, the composite, decorator, DAX and operator path: (b) a seeded
# 9×9 blur of rank 2 (two rotated anisotropic Gaussians) on DC_BATCH of
# bench.py's 256² phantoms, FISTA + TV (λ = LAM) at ρ = RHO, ITERS ×
# TV_ITERS; (d) sparse-view CT: CT_BATCH seeded 128² phantoms, CT_ANGLES
# angles over [0, π), 128 detectors, FISTA + TV (λ = CT_LAM; the
# measurements sum 128 samples a ray), ρ = 0.95 / ‖AᴴA‖ by the power
# iteration, ITERS × TV_ITERS; (e) DAX on the tall Kaczmarz system's 16
# distinct b, λ = DAX_LAM, DAX_SCHED = (outer, inner) iterations, the
# weights of DaxKaczmarz U[0.5, 1.5] from default_rng(9)
DC_BATCH = 16
CT_N, CT_ANGLES, CT_BATCH, CT_LAM = 128, 90, 8, 5.0
DAX_LAM, DAX_SCHED = 1e-6, (3, 2)
# phase 12: (a) the Condat kernel's cases, (batch shape, axis of the line,
# dtype); the long-line case's plain version runs on the CPU in a process of
# its own (--condat-plain), from CONDAT_LONG's seeded signals; (b) FISTA with
# TV(dims=1), TV1_BATCH of the flagship's problems at λ = LAM, ITERS
# iterations; (c) Nuclear matrix completion: NUC_BATCH seeded rank-NUC_RANK
# 256² matrices, NUC_FRACTION of the entries, λ = NUC_LAM, ITERS
# iterations; (d) LLR on a cine series: LLR_BATCH complex series of LLR_N²
# × LLR_FRAMES, LLR_LINES of the LLR_N phase-encode lines a frame (the 8
# lowest always), LLR_BLOCK blocks, λ = LLR_LAM, LLR_ITERS iterations; (e)
# PnP-ADMM at tests/test_regularization.py:163-200's settings (λ = 0.3, ρ =
# 0.5, 25 × 6, noise 0.02, the identity transform, a 5-tap Gaussian) on
# PNP_BATCH phantoms of 256², the CNN trained by train_denoiser at PNP_TRAIN
# = (n, channels, steps, noise), CGNR-L2 (λ = 1e-6, 12 iterations) beside it
CONDAT_CASES = (((64, 256, 256), 1, "float32"), ((64, 256, 256), 2, "float32"),
                ((16, 1, 65536), 2, "float32"), ((16, 256, 256), 2, "float64"))
CONDAT_LONG = (16, 1, 65536)
TV1_BATCH = 16
NUC_BATCH, NUC_RANK, NUC_FRACTION, NUC_LAM = 8, 8, 0.3, 2.0
LLR_BATCH, LLR_N, LLR_FRAMES, LLR_LINES, LLR_BLOCK = 4, 128, 16, 32, (8, 8)
LLR_LAM, LLR_ITERS = 0.05, 30
PNP_BATCH, PNP_TRAIN = 16, (64, 8, 200, 0.08)
# the SVT of LLR's blocks by the driver in use, against float64: 1e-4 of
# its largest entry (f32 SVDs hold ~1e-6)
SVT_BAR = 1e-4


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
    """The launch counters of the seventeen kernel wrappers, by name; with
    `reset`, set them to 0 first (and the TV prox, PGM-TV (rows 2 and 3),
    ADMM-TV (rows 4 and 5), SplitBregman, PDHG, FISTA-L1-DFT,
    FISTA-L21-SENSE, dense PGM (rows 7a and 7b), Kaczmarz (rows 12a, 12b),
    greedy Kaczmarz (row 13, the solve and the sweep alone) and Condat (row
    14) kernels' counts by route)."""
    from rls_tpu_torch.kernels import admm_tv_fused, admm_tv_tiled, cgnr_fused, fista_l1_dft_fused
    from rls_tpu_torch.kernels import fista_tv_fused, fista_tv_tiled, pgm_dense_fused, sense_fused
    from rls_tpu_torch.kernels import kaczmarz_greedy, kaczmarz_streamed, pdhg_fused
    from rls_tpu_torch.kernels import splitbregman_fused, tv_condat, tv_fgp

    fns = (tv_fgp.prox_tv2d_fgp, fista_tv_fused.fista_tv_fused, fista_tv_tiled.fista_tv_tiled,
           admm_tv_fused.admm_tv_fused, admm_tv_tiled.admm_tv_tiled, cgnr_fused.cgnr_fused,
           pgm_dense_fused.pgm_dense_fused, pgm_dense_fused.pgm_dense_fused_cplx,
           fista_l1_dft_fused.fista_l1_dft_fused, sense_fused.fista_l21_sense_fused,
           splitbregman_fused.splitbregman_l1_tv_fused, pdhg_fused.pdhg_fused,
           kaczmarz_streamed.kaczmarz_sweep, kaczmarz_streamed.kaczmarz_solve,
           kaczmarz_greedy.kaczmarz_greedy_solve, kaczmarz_greedy.kaczmarz_greedy_sweep,
           tv_condat.prox_tv1d_condat)
    if reset:
        for fn in fns:
            fn.launches = 0
        tv_fgp.prox_tv2d_fgp.route_launches = {"resident": 0, "windows": 0, "global": 0}
        for fn in (fista_tv_fused.fista_tv_fused, admm_tv_fused.admm_tv_fused,
                   pdhg_fused.pdhg_fused):
            fn.route_launches = {"resident": 0, "global": 0}
        fista_l1_dft_fused.fista_l1_dft_fused.route_launches = {"resident": 0, "grid": 0}
        for fn in (splitbregman_fused.splitbregman_l1_tv_fused,
                   sense_fused.fista_l21_sense_fused):
            fn.route_launches = {"resident": 0, "split": 0, "grid": 0}
        for fn in (fista_tv_tiled.fista_tv_tiled, admm_tv_tiled.admm_tv_tiled):
            fn.route_launches = {"cluster": 0, "tiles": 0}
        for fn in (pgm_dense_fused.pgm_dense_fused, pgm_dense_fused.pgm_dense_fused_cplx):
            fn.route_launches = {"grid": 0, "per_problem": 0}
        for fn in (kaczmarz_streamed.kaczmarz_sweep, kaczmarz_streamed.kaczmarz_solve):
            fn.route_launches = {"warp": 0, "block": 0}
        for fn in (kaczmarz_greedy.kaczmarz_greedy_solve, kaczmarz_greedy.kaczmarz_greedy_sweep):
            fn.route_launches = {"resident": 0, "block": 0}
        tv_condat.prox_tv1d_condat.route_launches = {"resident": 0, "global": 0}
    return {fn.__name__: fn.launches for fn in fns}


def admm_kernel_phase(dev, cases):
    """Each ADMM-TV kernel against its plain version: `cases` holds
    (cell, kernel wrapper, phantoms (batch, n²)); x0hat is the exact
    adjoint of the blurred phantoms. Each is held to the plain version's
    1-ulp spread with equal live CG steps, at the cell's batch and with
    the Positive projection at batch 4, and timed in turns with its plain
    version; then the other kernel at the same size is timed alone. Each
    launch's plan is printed and its route read from the kernel's route
    counter, set to 0 just before: the fused kernel (row 4) must take its
    resident route at its cell and is held alike on its global route at
    ADMM_WIDE; the tiled kernel (row 5) its cluster route at its cell, and
    it is held alike on its row tiles (`tile_rows` forced) at batch 4.
    Returns {wrapper name: {"err", "ms": (plain, kernel), "live", "plan"}}."""
    import torch

    from rls_tpu_torch.kernels import _fgp_common
    from rls_tpu_torch.kernels import admm_tv_fused as admm_fused
    from rls_tpu_torch.kernels import admm_tv_tiled as admm_tiled

    def hold_on_route(label, kernel, plain, x0, route, tile_rows=None):
        """hold_to_plain, the launch's plan printed first and its route
        counter required to read one solve on `route` (row 4: "resident"
        or "global"; row 5: "cluster", or "tiles" with `tile_rows`)."""
        if route in ("resident", "global"):
            fn, (plan, active) = admm_fused.admm_tv_fused, admm_fused.plan_on_card(x0, taps)
            want = {"resident": int(route == "resident"), "global": int(route == "global")}
        else:
            fn = admm_tiled.admm_tv_tiled
            plan, active = admm_tiled.plan_on_card(x0, taps, tile_rows)
            tiles = admm_tiled.launches_per_solve(*cell[3:5])
            want = {"cluster": int(route == "cluster"), "tiles": tiles * (route == "tiles")}
        print(f"{label}: plan route {plan.route}, {plan.clusters} CTAs per problem, "
              f"{plan.rows} rows per band, {plan.ctas} CTAs, {plan.smem} B of shared memory per "
              f"CTA{'' if plan.route != 'cluster' else ', ' + plan.own + ' own-row planes'}, "
              f"{active} clusters resident at once")
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        err = hold_to_plain(label, kernel, plain, x0, show_counts=True, spread=ADMM_SPREAD)
        got = fn.route_launches
        require(got == want, f"{label}: expected one solve on the {route} route, got {got}")
        return err, plan

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
        x4 = x0[:4].contiguous()
        if wrapper is admm_fused.admm_tv_fused:
            err, plan = hold_on_route(label, kernel, plain, x0, "resident")
            err = max(err, hold_on_route(label4, *pair4, x4, "resident")[0])
            # the global route: rows too wide for a band, x0hat = AᴴA of noise
            B, H, W = ADMM_WIDE
            wide = torch.from_numpy(np.random.default_rng(11).normal(size=ADMM_WIDE)
                                    .astype(np.float32)).to(dev)
            wide = _fgp_common.sepconv_stencil_normal(wide, *taps).contiguous()
            err = max(err, hold_on_route(f"{wrapper.__name__}[{B} x {H}x{W}, global route]",
                                         kernel, plain, wide, "global")[0])
        else:
            err, plan = hold_on_route(label, kernel, plain, x0, "cluster")
            err = max(err, hold_on_route(label4, *pair4, x4, "cluster")[0])
            # the row tiles at batch 4, `tile_rows` as the card would pick it
            tile_rows = admm_tiled.pick_tile_rows(
                n, 4, torch.cuda.get_device_properties(dev).multi_processor_count)
            tiles4 = pair(cell, lambda *a, **kw: wrapper(*a, tile_rows=tile_rows, **kw), taps,
                          "positive")
            err = max(err, hold_on_route(f"{label4}, row tiles of {tile_rows}", *tiles4, x4,
                                         "tiles", tile_rows)[0])
        live = kernel(x0)[1].tolist()
        ms = alternate_ms(lambda: plain(x0), lambda: kernel(x0), reps=3)
        print(f"{label}: kernel {ms[1]:.3f} ms, plain {ms[0]:.3f} ms")
        out[wrapper.__name__] = {"err": err, "ms": ms, "live": live, "plan": plan}
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
    (they must equal `launches`, every other counter 0, the fused
    kernel's on its resident route and the tiled kernel's on its cluster
    route), two columns held
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
        if "admm_tv_tiled" in want:
            from rls_tpu_torch.kernels import admm_tv_tiled as admm_tiled

            routes = admm_tiled.admm_tv_tiled.route_launches
            print(f"routes ({label}): admm_tv_tiled {routes}")
            require(routes == {"cluster": want["admm_tv_tiled"], "tiles": 0},
                    f"{label}: the tiled kernel's routes {routes}, not the cluster one")
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
    """Print a dense PGM plan (rows 7a and 7b): its route and, on the grid
    route, the cut of the cooperative grid."""
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

    # complex data as planes: the complex A, and the real A with a complex
    # b, each case one launch on the grid route (the route counter)
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

        name = f"pgm_dense_fused_cplx[{label}]"
        print_pgm_dense_plan(name, pd.card_plan(br, ar, cplx=True))
        pd.pgm_dense_fused_cplx.route_launches = {"grid": 0, "per_problem": 0}
        note("pgm_dense_fused_cplx", hold_dense(name, kernel, plain, (br, bi)))
        routes = pd.pgm_dense_fused_cplx.route_launches
        require(routes == {"grid": 1, "per_problem": 0},
                f"{name}: routes {routes}, not one grid launch")
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
        if kernel in ("pgm_dense_fused", "pgm_dense_fused_cplx"):
            routes = getattr(pd, kernel).route_launches
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
    print_pgm_dense_plan(name, pd.card_plan(t(b_c.real.T), t(a_c.real), cplx=True))
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


def sense_problem(n=SENSE_N):
    """tools/bench_suite.py:153-184's SENSE problem, from its own
    default_rng(0): smooth complex coil maps normalized to a unit sum of
    squares, the 45 % k-space mask with its fully sampled 20×20 centre,
    and 8 complex phantoms; at n² (the bench's 128² by default, the same
    draws at another side). Returns numpy (maps (C, H, W) complex64, mask
    (H, W), X (8, 2·H·W) split [re; im] float32)."""
    H = W = n
    rng4 = np.random.default_rng(0)
    maps = coil_maps(rng4, SENSE_C, n)
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
    5·n·log₂n whatever the kernel implements, at every n (at n = r·2ᵃ with
    r odd too: the least an FFT of that size needs, which the kernel's
    direct p-point odd stages exceed)."""
    return 5 * hw * float(np.log2(hw))


def rfft_ops(hw):
    """f32 operations of one 2-D FFT of hw points whose input or output is
    real: half a complex one."""
    return fft_ops(hw) / 2


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
    return err, kc, got


def composed_device_ms(solver, B):
    """The composed solve_batched_unrolled's device time on B (torch.fft
    normal ops: cuFFT), by torch.profiler after a warm-up: the sum of its
    device kernels' times, which host delays do not move."""
    import rls_tpu_torch as rtt

    rtt.solve_batched_unrolled(solver, B)  # warm-up: cuFFT's plans
    return sum(ms for ms, _, _ in device_kernels(lambda: rtt.solve_batched_unrolled(solver, B)))


def sense_case(rng, H, W, C, batch):
    """A SENSE case of random maps normalized to a unit sum of squares, a
    45 % mask and `batch` random split images: (maps, mask, X) numpy."""
    maps = rng.normal(size=(C, H, W)) + 1j * rng.normal(size=(C, H, W))
    maps /= np.sqrt((np.abs(maps) ** 2).sum(0))
    mask = (rng.uniform(size=(H, W)) < 0.45).astype(np.float32)
    return maps, mask, rng.normal(size=(batch, 2 * H * W)).astype(np.float32)


def fft_kernel_phase(dev, draws, mixed=True, timed=True, routes=True):
    """Phase 3h: each FFT kernel against its plain version at its main-path
    shape, held by `hold_fft` and timed in turns with it: FISTA-L1 on 16
    distinct 256² CS problems with λ per problem (and its grid route at 4
    and 16 × 512², with its bound and CTA 0's clocks), FISTA-L21 and
    SplitBregman on the 8 SENSE slices, each on its resident route by the
    route counter; then FISTA-L21 and SplitBregman
    at 256 × 128 (the split route: a coil's spectrum over a team of CTAs)
    and 2 × 512² and 1 × 1024² (the grid route: a slice's coils over a team
    of CTAs that meet in L2), held but not timed, and 20 launches of each
    at 512² held to the first launch's bits (``grid_repeats``). The sha256 of every
    kernel output at these power-of-two shapes (and of its input) goes to
    out["digests"]. With `mixed`, the mixed-radix FFT at sides with odd
    factors (MIXED_*): row 8 at 16 × 320² and 4 × 64 × 448 (resident,
    even), 4 × 640², 2 × 1024² and 4 × 448² (grid), and on uneven bands
    and blocks at 2 × 97 ×
    128 (a prime side), 4 × 225², 16 × 300² and 16 × 320 × 260, rows 9 and
    10 at 8 × 64 × 192 (resident) and 8 × 192² (split), each by the route
    counter, each timed with its bound, with the composed solve's device
    time (torch.profiler) at each shape; row 8's and the 192² outputs'
    sha256 go to out["digests"] under route-free names (the parent trees
    ran the uneven shapes, 192², 512², 640², 1024² and 448² on the global
    route). Without `mixed`
    (``--digest-fft``), the same shapes are held and their digests taken,
    untimed. Without `routes`, no route counter is checked:
    ``--digest-fft`` runs the parent tree, whose routes differ. Returns {kernel: {"err", "ms":
    (plain, kernel), "live", "bound", "composed_device_ms"}} and
    "digests"."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import _dft_common as dc
    from rls_tpu_torch.kernels import fista_l1_dft_fused as k8
    from rls_tpu_torch.kernels import sense_fused as k9
    from rls_tpu_torch.kernels import splitbregman_fused as k10
    from rls_tpu_torch.kernels.fista_tv_fused import _momentum_table, problem_scalars

    out = {"digests": {}}
    bump = 1.0 + 2.0**-23

    def held(name, kernel, plain, x0, x0u, counts=False, bitwise=False, timed_here=False,
             reps=2, key=None, fn=None, route=None, digest_as=None):
        if fn is not None:  # the hold's one launch on `route`, before any timing
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        err, live, got = hold_fft(name, kernel, plain, x0, x0u, counts, bitwise)
        if fn is not None and routes:
            routed(fn, name, route)
        out["digests"][digest_as or name] = (digest(x0), digest(got))
        entry = {"err": err, "live": live}
        if timed and timed_here:
            ms = alternate_ms(lambda: plain(x0), lambda: kernel(x0), reps=reps)
            print(f"{name}: kernel {ms[1]:.3f} ms, plain {ms[0]:.3f} ms")
            entry["ms"] = ms
        out[key or name.split("[")[0]] = entry
        return entry

    def routed(fn, name, want):
        got = fn.route_launches
        print(f"{name}: launches by route {got}")
        require(got == {r: int(r == want) for r in got} and got.get(want) == 1,
                f"{name}: expected one launch on the {want} route, got {got}")

    def l1_plan(name, x0):
        plan, active = k8.plan_on_card(x0)
        parts, (_, H, W) = "", x0.shape
        if plan.route != "global" and (H % plan.clusters or W % plan.clusters):
            rows = sorted({b - a for a, b in map(plan.band, range(plan.clusters))})
            cols = sorted({b - a for a, b in map(plan.block, range(plan.clusters))})
            parts = f" (uneven: bands of {rows} rows, blocks of {cols} columns)"
        if plan.route == "grid":
            parts += (f", {plan.slots} slots, {plan.rounds} round(s), chunks of "
                      f"{plan.row_lines} rows and {plan.col_lines} columns")
        held = "grid CTAs" if plan.route == "grid" else "clusters"
        print(f"{name}: plan route {plan.route}, {plan.clusters} CTAs per problem, "
              f"{plan.rows}-row bands, {plan.cols}-column blocks{parts}, {plan.ctas} CTAs, "
              f"{plan.smem} B of shared memory per CTA, {active} {held} resident at once")
        return plan

    def sense_plan(module, name, x0):
        plan = module.plan_on_card(x0, SENSE_C)
        if plan.route == "grid":
            print(f"{name}: plan route grid, a team of {plan.team} CTAs a slice, {plan.slots} "
                  f"slots, {plan.per_round} coils a round in {plan.rounds} round(s), chunks of "
                  f"{plan.row_lines} rows and {plan.col_lines} columns, {plan.ctas} CTAs, "
                  f"{plan.smem} B of shared memory per CTA, {plan.resident_clusters} grid CTAs "
                  f"resident at once")
            return plan
        print(f"{name}: plan route {plan.route}, {plan.clusters} CTAs per slice, "
              f"{getattr(plan, 'team', 1)} CTA(s) a coil, {plan.rounds} round(s), {plan.ctas} "
              f"CTAs, {plan.smem} B of shared memory per CTA, {plan.resident_clusters} clusters "
              f"resident at once")
        return plan

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
    name = f"fista_l1_dft_fused[{CS_N}², batch {CS_BATCH}, {CS_ITERS} it.]"
    l1_plan(name, x0)
    held(name, lambda x: (k8.fista_l1_dft_fused(x, op.mask, RHO, lam, CS_ITERS), None),
         lambda x: (k8.fista_l1_dft_fused_torch(x, scal, tab, tables), None), x0, x0u,
         bitwise=True, timed_here=True, fn=k8.fista_l1_dft_fused, route="resident")
    # its grid route (a team of CTAs per problem that meet in L2), which a
    # spectrum too large for a cluster's bands takes: 4 problems of 512² on
    # a 35 % mask, held to the bit and to the parent's global-route digest,
    # timed with its bound and CTA 0's clocks; then the 512² cell's batch
    # (16 distinct problems: 16 slots of 8 CTAs), the kernel table's grid
    # row
    gn, gb = 512, 4
    rng = np.random.default_rng(11)
    gop = rtt.SubsampledDFT2RealOperator.from_mask(rng.uniform(size=(gn, gn)) < 0.35, (gn, gn),
                                                    device=dev)
    gbv = gop.mv(torch.from_numpy(rng.normal(size=(gb, gn * gn)).astype(np.float32)).to(dev))
    gx0, gx0u = (gop.rmv(v).reshape(gb, gn, gn) for v in (gbv, gbv * bump))
    glam = torch.linspace(0.5, 2.0, gb, device=dev) * CS_LAM
    gscal = problem_scalars(gx0, RHO, glam)
    gtables = dc.dft_tables(gop.mask)
    for gb_, key in ((gb, "fista_l1_dft_fused grid"), (CS_BATCH, "fista_l1_dft_fused grid b16")):
        if gb_ != gb:  # 16 problems of their own on the same mask
            gbv = gop.mv(torch.from_numpy(rng.normal(size=(gb_, gn * gn)).astype(np.float32))
                         .to(dev))
            gx0, gx0u = (gop.rmv(v).reshape(gb_, gn, gn) for v in (gbv, gbv * bump))
            glam = torch.linspace(0.5, 2.0, gb_, device=dev) * CS_LAM
            gscal = problem_scalars(gx0, RHO, glam)
        name = f"fista_l1_dft_fused[grid route, {gn}², batch {gb_}, {CS_ITERS} it.]"
        plan = l1_plan(name, gx0)
        require(not routes or plan.route == "grid", f"{name}: planned {plan}")
        entry = held(name, lambda x, g=glam: (k8.fista_l1_dft_fused(x, gop.mask, RHO, g,
                                                                     CS_ITERS), None),
                     lambda x, sc=gscal: (k8.fista_l1_dft_fused_torch(x, sc, tab, gtables),
                                          None),
                     gx0, gx0u, bitwise=True, timed_here=True, reps=1, key=key,
                     fn=k8.fista_l1_dft_fused, route="grid",
                     digest_as=f"fista_l1_dft_fused[{gn}², batch {gb_}, {CS_ITERS} it.]")
        if timed:
            entry["bound"] = bound(gb_ * dft_ops(gn * gn, CS_ITERS),
                                   4 * ((2 * gb_ + 1) * gn * gn + 2 * gb_))
            print(f"{name}: bound {entry['bound'][0]:.4f} ms ({entry['bound'][1]})")
            entry["clocks"] = k8.phase_clocks(gx0, gop.mask, RHO, glam, CS_ITERS)
            print(f"{name}: CTA 0's SM clocks by phase {entry['clocks']}")

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
    name = f"sense_fused[{SENSE_N}², {SENSE_C} coils, {SENSE_SLICES} slices, {SENSE_ITERS} it.]"
    plan = sense_plan(k9, name, x0)
    print(f"{name}: bands {[plan.band(q) for q in range(plan.clusters)]}")
    held(name, lambda x: (k9.fista_l21_sense_fused(x, op.mask, *coils, RHO, SENSE_LAM,
                                                   SENSE_ITERS), None),
         lambda x: (k9.fista_l21_sense_fused_torch(x, scal, tab, coils, tables), None), x0, x0u,
         bitwise=True, timed_here=True, fn=k9.fista_l21_sense_fused, route="resident")
    scal, t2 = k10.kernel_args(x0, SB_RHO, SB_RHO, SB_LAM, SB_LAM, SB_TV)
    name = (f"splitbregman_fused[{SENSE_N}², {SENSE_C} coils, {SENSE_SLICES} slices, "
            f"{'×'.join(map(str, SB_SCHED))}, TV {SB_TV}]")
    sense_plan(k10, name, x0)
    held(name, lambda x: k10.splitbregman_l1_tv_fused(x, op.mask, *coils, SB_RHO, SB_RHO, SB_LAM,
                                                      SB_LAM, *SB_SCHED, SB_TV, SB_TOL,
                                                      with_counts=True),
         lambda x: k10.splitbregman_l1_tv_fused_torch(x, scal, t2, coils, tables, *SB_SCHED,
                                                      SB_TOL),
         x0, x0u, counts=True, timed_here=True, reps=1, fn=k10.splitbregman_l1_tv_fused,
         route="resident")

    # the split routes of rows 9 and 10 (a coil's spectrum over a team of
    # CTAs), which a spectrum too large for one CTA takes: 2 slices of 256 ×
    # 128 at 6 coils, row 9 at SENSE_ITERS iterations, row 10 on BASELINE
    # #4's schedule; held to the bit (row 9, and to the parent's global-route
    # digest) and to the spread (row 10), not timed
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
    name = f"sense_fused[split route, {gh}×{gw}, {SENSE_C} coils, {gb} slices, {SENSE_ITERS} it.]"
    sense_plan(k9, name, gx0)
    gscal = k9.problem_scalars(gx0, RHO, SENSE_LAM)
    held(name, lambda x: (k9.fista_l21_sense_fused(x, gop.mask, *gcoils, RHO, SENSE_LAM,
                                                   SENSE_ITERS), None),
         lambda x: (k9.fista_l21_sense_fused_torch(x, gscal, tab, gcoils, gtables), None),
         gx0, gx0u, bitwise=True, key="sense_fused split", fn=k9.fista_l21_sense_fused,
         route="split")
    name = (f"splitbregman_fused[split route, {gh}×{gw}, {SENSE_C} coils, {gb} slices, "
            f"{'×'.join(map(str, SB_SCHED))}, TV {SB_TV}]")
    sense_plan(k10, name, gx0)
    scal, t2 = k10.kernel_args(gx0, SB_RHO, SB_RHO, SB_LAM, SB_LAM, SB_TV)
    held(name, lambda x: k10.splitbregman_l1_tv_fused(x, gop.mask, *gcoils, SB_RHO, SB_RHO,
                                                      SB_LAM, SB_LAM, *SB_SCHED, SB_TV, SB_TOL,
                                                      with_counts=True),
         lambda x: k10.splitbregman_l1_tv_fused_torch(x, scal, t2, gcoils, gtables, *SB_SCHED,
                                                      SB_TOL),
         gx0, gx0u, counts=True, key="splitbregman_fused split",
         fn=k10.splitbregman_l1_tv_fused, route="split")

    # the grid routes of rows 9 and 10 (each slice's coils over a team of
    # CTAs that meet in L2), which a spectrum too large for any team of 16
    # takes: 2 slices of 512² at 6 coils (every coil in one round), on the
    # schedules above, held alike (row 9 to the bit; both to the parent's
    # global-route digests); then 1 slice of 1024² (two rounds of 3 coils),
    # and 20 launches of each row at 512² held to the first launch's bits
    # (row 10 on a short schedule); not timed
    gn = 512
    op512, gbv, gx0, gcoils = sense512_case(dev)
    gx0u = op512.rmv(gbv * bump).reshape(gx0.shape)
    gtables = dc.dft_tables(op512.mask)
    x512 = gx0
    for gx0, gx0u, gop, gcoils, gtables, gb, gn, tag in (
            (gx0, gx0u, op512, gcoils, gtables, 2, gn, "grid route"),
            (*sense1024_case(dev, bump), 1, 1024, "grid route, two rounds of coils")):
        name = f"sense_fused[{tag}, {gn}², {SENSE_C} coils, {gb} slices, {SENSE_ITERS} it.]"
        plan = sense_plan(k9, name, gx0)
        require(not routes or plan.route == "grid", f"{name}: planned {plan}")
        gscal = k9.problem_scalars(gx0, RHO, SENSE_LAM)
        held(name, lambda x, m=gop.mask, c=gcoils: (k9.fista_l21_sense_fused(
                 x, m, *c, RHO, SENSE_LAM, SENSE_ITERS), None),
             lambda x, sc=gscal, c=gcoils, t=gtables: (k9.fista_l21_sense_fused_torch(
                 x, sc, tab, c, t), None),
             gx0, gx0u, bitwise=True, key=f"sense_fused {tag}", fn=k9.fista_l21_sense_fused,
             route="grid")
        name = (f"splitbregman_fused[{tag}, {gn}², {SENSE_C} coils, {gb} slices, "
                f"{'×'.join(map(str, SB_SCHED))}, TV {SB_TV}]")
        plan = sense_plan(k10, name, gx0)
        require(not routes or plan.route == "grid", f"{name}: planned {plan}")
        scal, t2 = k10.kernel_args(gx0, SB_RHO, SB_RHO, SB_LAM, SB_LAM, SB_TV)
        held(name, lambda x, m=gop.mask, c=gcoils: k10.splitbregman_l1_tv_fused(
                 x, m, *c, SB_RHO, SB_RHO, SB_LAM, SB_LAM, *SB_SCHED, SB_TV, SB_TOL,
                 with_counts=True),
             lambda x, sc=scal, t2=t2, c=gcoils, t=gtables: k10.splitbregman_l1_tv_fused_torch(
                 x, sc, t2, c, t, *SB_SCHED, SB_TOL),
             gx0, gx0u, counts=True, key=f"splitbregman_fused {tag}",
             fn=k10.splitbregman_l1_tv_fused, route="grid")
    if routes:
        out["grid repeats"] = grid_repeats(op512, x512, k9, k10)
    if not mixed:
        # the digests alone (--digest-fft): row 8 at every MIXED_L1DFT shape,
        # rows 9 and 10 at 192²
        cases = (mixed_fft_cases(dev, rows=("fista_l1",))
                 + mixed_fft_cases(dev, rows=("sense", "splitbregman"), shapes=[(192, 192)]))
        for case in cases:
            held(case["name"], case["kernel"], case["plain"], case["x0"], case["x0u"],
                 counts=case["counts"], bitwise=not case["counts"], key=case["key"],
                 fn=case["fn"], route=case["route"], digest_as=case["digest"])
        return out

    # the mixed-radix FFT at MIXED_*, each on its route, bit for bit, timed
    # in turns with its plain version, its bound and the composed solve's
    # device time at its shape
    for case in mixed_fft_cases(dev):
        name = case["name"]
        if case["module"] is k8:
            require(l1_plan(name, case["x0"]).route == case["route"], f"{name}: planned otherwise")
        else:
            plan = sense_plan(case["module"], name, case["x0"])
            require(plan.route == case["route"], f"{name}: planned {plan}")
        entry = held(name, case["kernel"], case["plain"], case["x0"], case["x0u"],
                     counts=case["counts"], bitwise=not case["counts"], timed_here=True,
                     reps=case["reps"], key=case["key"], fn=case["fn"], route=case["route"],
                     digest_as=case["digest"])
        if timed:
            entry["bound"] = case["bound"](entry["live"])
            print(f"{name}: bound {entry['bound'][0]:.4f} ms ({entry['bound'][1]})")
        entry["composed_device_ms"] = composed_device_ms(case["solver"], case["B"])
        print(f"{name}: composed solve_batched_unrolled (torch.fft) device time "
              f"{entry['composed_device_ms']:.3f} ms (profiler)")
    return out


def mixed_fft_cases(dev, rows=("fista_l1", "sense", "splitbregman"), shapes=None):
    """The mixed-radix FFT's cases of phase 3h (MIXED_L1DFT, MIXED_SENSE;
    of `rows` alone, and at (H, W) of `shapes` alone where given), as
    dicts: name, key ("{kernel} {H}x{W}"), `digest` (the route-free name
    its sha256 goes under), the kernel module and its
    wrapper `fn`, the route its planner takes, `kernel` and `plain` (x0 →
    (x, counts)), x0 and x0u (the seed of b·(1 + 2⁻²³)), `counts` (row 10:
    held to the spread, with its live CG steps), `reps`, the composed
    `solver` and its right-hand sides `B`, and `bound(live)` → (ms, kind):
    every input read once, x written once, an FFT of n = r·2ᵃ points
    counted at 5·n·log₂n, row 10's CG steps as `live` counts them; row
    8's cases also carry their `mask` and λ (`lam`)."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import _dft_common as dc
    from rls_tpu_torch.kernels import fista_l1_dft_fused as k8
    from rls_tpu_torch.kernels import sense_fused as k9
    from rls_tpu_torch.kernels import splitbregman_fused as k10
    from rls_tpu_torch.kernels.fista_tv_fused import _momentum_table, problem_scalars

    f32, bump = 4, 1.0 + 2.0**-23
    cases = []
    tab = torch.as_tensor(_momentum_table("fista", CS_ITERS), device=dev)
    for (mb, mh, mw), want in MIXED_L1DFT:
        if "fista_l1" not in rows or (shapes is not None and (mh, mw) not in shapes):
            continue
        rng = np.random.default_rng(mh * mw)
        mop = rtt.SubsampledDFT2RealOperator.from_mask(rng.uniform(size=(mh, mw)) < 0.35,
                                                        (mh, mw), device=dev)
        mbv = mop.mv(torch.from_numpy(rng.normal(size=(mb, mh * mw)).astype(np.float32)).to(dev))
        mx0, mx0u = (mop.rmv(v).reshape(mb, mh, mw) for v in (mbv, mbv * bump))
        mlam = torch.linspace(0.5, 2.0, mb, device=dev) * CS_LAM
        mscal = problem_scalars(mx0, RHO, mlam)
        mtables = dc.dft_tables(mop.mask)
        hw = mh * mw
        cases.append(dict(
            name=f"fista_l1_dft_fused[{want} route, {mh}×{mw}, batch {mb}, {CS_ITERS} it.]",
            key=f"fista_l1_dft_fused {mh}x{mw}", module=k8, fn=k8.fista_l1_dft_fused,
            digest=f"fista_l1_dft_fused[{mh}×{mw}, batch {mb}, {CS_ITERS} it.]",
            route=want, x0=mx0, x0u=mx0u, counts=False, reps=2, mask=mop.mask, lam=mlam,
            kernel=lambda x, m=mop.mask, lam=mlam: (
                k8.fista_l1_dft_fused(x, m, RHO, lam, CS_ITERS), None),
            plain=lambda x, sc=mscal, tb=mtables: (k8.fista_l1_dft_fused_torch(x, sc, tab, tb),
                                                   None),
            solver=rtt.FISTA.create(mop, reg=rtt.L1Regularization(CS_LAM), iterations=CS_ITERS,
                                    rho=RHO, rel_tol=0.0, track_residual=False),
            B=mbv.T.contiguous(),
            bound=lambda live, mb=mb, hw=hw: bound(mb * dft_ops(hw, CS_ITERS),
                                                   f32 * ((2 * mb + 1) * hw + 2 * mb))))

    stab = torch.as_tensor(_momentum_table("fista", SENSE_ITERS), device=dev)
    for (mh, mw), want in MIXED_SENSE:
        if shapes is not None and (mh, mw) not in shapes:
            continue
        maps, mask, X = sense_case(np.random.default_rng(mh + mw), mh, mw, SENSE_C,
                                   SENSE_SLICES)
        mop = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (mh, mw), device=dev)
        mbv = mop.mv(torch.from_numpy(X).to(dev))
        mshape = (SENSE_SLICES, 2, mh, mw)
        mx0, mx0u = mop.rmv(mbv).reshape(mshape), mop.rmv(mbv * bump).reshape(mshape)
        mcoils, mtables = (mop.coils_r, mop.coils_i), dc.dft_tables(mop.mask)
        mscal = k9.problem_scalars(mx0, RHO, SENSE_LAM)
        hw = mh * mw
        m_bytes = f32 * ((4 * SENSE_SLICES + 2 * SENSE_C + 1) * hw)
        sense_case_of = dict(
            name=(f"sense_fused[{want} route, {mh}×{mw}, {SENSE_C} coils, {SENSE_SLICES} slices, "
                  f"{SENSE_ITERS} it.]"),
            key=f"sense_fused {mh}x{mw}", module=k9, fn=k9.fista_l21_sense_fused, route=want,
            digest=f"sense_fused[{mh}×{mw}, {SENSE_C} coils, {SENSE_SLICES} slices, "
                   f"{SENSE_ITERS} it.]",
            x0=mx0, x0u=mx0u, counts=False, reps=2,
            kernel=lambda x, m=mop.mask, c=mcoils: (
                k9.fista_l21_sense_fused(x, m, *c, RHO, SENSE_LAM, SENSE_ITERS), None),
            plain=lambda x, sc=mscal, c=mcoils, tb=mtables: (
                k9.fista_l21_sense_fused_torch(x, sc, stab, c, tb), None),
            solver=rtt.FISTA.create(mop, reg=rtt.L21Regularization(SENSE_LAM, slices=2),
                                    iterations=SENSE_ITERS, rho=RHO),
            B=mbv.T.contiguous(),
            bound=lambda live, hw=hw, nb=m_bytes: bound(
                SENSE_SLICES * sense_ops(hw, SENSE_C, SENSE_ITERS), nb + f32 * 2 * SENSE_SLICES))
        if "sense" in rows:
            cases.append(sense_case_of)
        sscal, t2 = k10.kernel_args(mx0, SB_RHO, SB_RHO, SB_LAM, SB_LAM, SB_TV)
        sb_case = dict(
            name=(f"splitbregman_fused[{want} route, {mh}×{mw}, {SENSE_C} coils, {SENSE_SLICES} "
                  f"slices, {'×'.join(map(str, SB_SCHED))}, TV {SB_TV}]"),
            key=f"splitbregman_fused {mh}x{mw}", module=k10, fn=k10.splitbregman_l1_tv_fused,
            digest=f"splitbregman_fused[{mh}×{mw}, {SENSE_C} coils, {SENSE_SLICES} slices, "
                   f"{'×'.join(map(str, SB_SCHED))}, TV {SB_TV}]",
            route=want, x0=mx0, x0u=mx0u, counts=True, reps=1,
            kernel=lambda x, m=mop.mask, c=mcoils: k10.splitbregman_l1_tv_fused(
                x, m, *c, SB_RHO, SB_RHO, SB_LAM, SB_LAM, *SB_SCHED, SB_TV, SB_TOL,
                with_counts=True),
            plain=lambda x, sc=sscal, t2=t2, c=mcoils, tb=mtables: (
                k10.splitbregman_l1_tv_fused_torch(x, sc, t2, c, tb, *SB_SCHED, SB_TOL)),
            solver=splitbregman_solver(mop, dev), B=mbv.T.contiguous(),
            bound=lambda live, hw=hw, nb=m_bytes: bound(
                sum(sb_ops(hw, SENSE_C, *SB_SCHED[:2], SB_TV, v) for v in live.tolist()),
                nb + f32 * 4 * SENSE_SLICES))
        if "splitbregman" in rows:
            cases.append(sb_case)
    return cases


def check_fft_digests(digests):
    """Print the sha256 of each output of phase 3h that PARENT_FFT_SHA256
    records (the power-of-two shapes, and rows 9 and 10 at 192²) beside
    the parent tree's and require them equal, but for FFT_DIGEST_MOVED
    (printed only), and each input's equal to the parent's: an input made
    otherwise (its operator changed, or another cuFFT) leaves the outputs
    nothing to be compared with, and fails the run until the digests are
    recorded anew by ``--digest-fft`` on the parent tree."""
    for name, (d_in, d_out) in digests.items():
        if name not in PARENT_FFT_SHA256:
            continue
        p_in, p_out = PARENT_FFT_SHA256[name]
        moved = name in FFT_DIGEST_MOVED
        print(f"sha256[{name}]: output {d_out[:16]}…, parent {p_out[:16]}… "
              f"({'equal' if d_out == p_out else 'DIFFERENT'}"
              f"{', not required: another route' if moved else ''}); input "
              f"{'equal' if d_in == p_in else 'DIFFERENT'}")
        require(d_in == p_in,
                f"{name}: the input is not the one the parent's digests were taken on; record "
                "PARENT_FFT_SHA256 anew with --digest-fft on the parent tree")
        require(moved or d_out == p_out, f"{name}: the output moved from the parent's bits")
    require(all(name in digests for name in PARENT_FFT_SHA256),
            "phase 3h lacks a power-of-two case of the parent's")


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

    H, W = op.im_shape
    n = H * W
    return rtt.SplitBregman.create(
        op,
        reg=[rtt.L21Regularization(SB_LAM, slices=2),
             rtt.TVRegularization(SB_LAM, shape=(2, H, W), dims=(1, 2),
                                  iterations_tv=SB_TV)],
        reg_trafo=[rtt.IdentityOperator(2 * n, torch.float32, device=dev),
                   rtt.IdentityOperator(2 * n, torch.float32, device=dev)],
        iterations=SB_SCHED[0], iterations_inner=SB_SCHED[1], iterations_cg=SB_SCHED[2],
        unroll_cg=True, rho=[SB_RHO, SB_RHO], tol_inner=SB_TOL,
    )


def cs_image(n, seed):
    """BASELINE #2's image drawn at n²: 8 squares of 12², amplitudes U(0.3,
    1), from default_rng(seed), and its sorted sample indices (35 % of the
    spectrum). Returns (image (n²,) float32, indices)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((n, n), np.float32)
    for _ in range(8):
        i0, j0 = rng.integers(0, n - 20, 2)
        img[i0 : i0 + 12, j0 : j0 + 12] += rng.uniform(0.3, 1.0)
    return img.reshape(-1), np.sort(rng.choice(n * n, size=int(0.35 * n * n), replace=False))


def fft_cell_phase(dev, draws):
    """Phase 9: the CS / SENSE cells through solve_batched_fast, each with
    the launch counters set to 0 just before the solve and read just after
    (one launch of its kernel on the route its planner takes, none of any
    other), problems/s, and two columns held by `parity_fft` to a float64
    solve of the plain version on the card; BASELINE #2 and #4 also
    through solve_batched_unrolled (the composed torch.fft path: no
    kernel). The power-of-two cells (256², 128²), BASELINE #2 at 512² (row
    8's grid route) and, on the mixed-radix FFT, the same settings at 320²
    (row 8) and 192² (rows 9 and 10). Every
    cell's composed solve is timed, wall and device time (torch.profiler):
    the yardstick of its kernel. Returns ({cell: (kernel, launches)},
    {cell: composed ms}, {cell: composed device ms})."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import _dft_common as dc
    from rls_tpu_torch.kernels import fista_l1_dft_fused as k8
    from rls_tpu_torch.kernels import sense_fused as k9
    from rls_tpu_torch.kernels import splitbregman_fused as k10
    from rls_tpu_torch.kernels.fista_tv_fused import _momentum_table, problem_scalars

    launched, composed_ms, composed_dev = {}, {}, {}
    routed = {fn.__name__: fn for fn in (k8.fista_l1_dft_fused, k9.fista_l21_sense_fused,
                                         k10.splitbregman_l1_tv_fused)}

    def run(name, solver, B, xs_true, kernel, ref, composed, unit="problems/s",
            route="resident"):
        K = B.shape[1]
        launch_counts(reset=True)
        x = rtt.solve_batched_fast(solver, B)
        torch.cuda.synchronize()
        got = launch_counts()
        print(f"launches ({name}): {got}")
        require(got == {**{k: 0 for k in got}, kernel: 1},
                f"{name}: expected one launch of {kernel} and no others")
        routes = routed[kernel].route_launches
        print(f"launches ({name}) by route: {routes}")
        require(routes == {r: int(r == route) for r in routes} and routes.get(route) == 1,
                f"{name}: expected one launch on the {route} route, got {routes}")
        launched[name] = (kernel, 1)
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
        composed_dev[name] = composed_device_ms(solver, B)
        composed_ms[name] = cuda_ms(lambda: rtt.solve_batched_unrolled(solver, B), reps=2)
        print(f"{name}: solve_batched_unrolled (torch.fft) {K / (composed_ms[name] / 1e3):.1f} "
              f"{unit} ({composed_ms[name]:.3f} ms per batch of {K}; device time "
              f"{composed_dev[name]:.3f} ms by torch.profiler) beside the kernel's "
              f"{K / (ms / 1e3):.1f} {unit}")

    # fista_l1_cs_dft256_b16: the bench tiles its one column 16 times;
    # fista_l1_cs_dft320_b16 and fista_l1_cs_dft512_b16, BASELINE #2's
    # settings at 320² and 512² (the image and the 35 % sample drawn the
    # same way at that side; 512², the usual matrix of a high-resolution
    # scan, fits no cluster of 16: the grid route)
    for cell, n, (img, idx), route in (
            ("fista_l1_cs_dft256_b16", CS_N, draws["cs"], "resident"),
            ("fista_l1_cs_dft320_b16", 320, cs_image(320, 320), "resident"),
            ("fista_l1_cs_dft512_b16", 512, cs_image(512, 512), "grid")):
        op = rtt.SubsampledDFT2RealOperator.from_sample_idx(idx, (n, n), device=dev)
        xt = torch.from_numpy(img).to(dev)
        B = op.mv(xt)[:, None].repeat(1, CS_BATCH).contiguous()
        solver = rtt.FISTA.create(op, reg=rtt.L1Regularization(CS_LAM), iterations=CS_ITERS,
                                  rho=RHO, rel_tol=0.0, track_residual=False)
        op64 = rtt.SubsampledDFT2RealOperator.from_sample_idx(idx, (n, n), dtype=torch.float64,
                                                              device=dev)
        x0 = op64.rmv(B[:, :2].T.double()).reshape(2, n, n)
        scal = problem_scalars(x0, RHO, CS_LAM, np.float64)
        tab = torch.as_tensor(_momentum_table("fista", CS_ITERS, dtype=np.float64), device=dev)
        x64 = k8.fista_l1_dft_fused_torch(x0, scal, tab, dc.dft_tables(op64.mask, torch.float64))
        print(f"{cell}: plan {k8.plan_on_card(op.rmv(B.T).reshape(CS_BATCH, n, n))[0]}")
        run(cell, solver, B, xt[None].repeat(CS_BATCH, 1), "fista_l1_dft_fused",
            (op64, x64.reshape(2, -1)), composed=True, route=route)

    # the SENSE cells: tools/bench_suite.py's problem at 128², and the same
    # draws at 192² (rows 9 and 10 on their split routes: a coil's padded
    # spectrum fits no CTA, so a team of CTAs holds it)
    for n, route in ((SENSE_N, "resident"), (192, "split")):
        maps, mask, X = sense_problem(n)
        op = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (n, n), device=dev)
        op64 = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (n, n), dtype=torch.float64,
                                                   device=dev)
        xs = torch.from_numpy(X).to(dev)
        B = op.mv(xs).T.contiguous()
        x0 = op64.rmv(B[:, :2].T.double()).reshape(2, 2, n, n)
        coils64, tables64 = (op64.coils_r, op64.coils_i), dc.dft_tables(op64.mask, torch.float64)
        solver = rtt.FISTA.create(op, reg=rtt.L21Regularization(SENSE_LAM, slices=2),
                                  iterations=SENSE_ITERS, rho=RHO)
        scal = k9.problem_scalars(x0, RHO, SENSE_LAM, np.float64)
        tab = torch.as_tensor(_momentum_table("fista", SENSE_ITERS, dtype=np.float64), device=dev)
        x64 = k9.fista_l21_sense_fused_torch(x0, scal, tab, coils64, tables64).reshape(2, -1)
        run(f"fista_l21_sense{n}_6coil_b8", solver, B, xs, "fista_l21_sense_fused", (op64, x64),
            composed=False, unit="slices/s", route=route)
        solver = splitbregman_solver(op, dev)
        scal, t2 = k10.kernel_args(x0, SB_RHO, SB_RHO, SB_LAM, SB_LAM, SB_TV, np.float64)
        x64, live64 = k10.splitbregman_l1_tv_fused_torch(x0, scal, t2, coils64, tables64,
                                                         *SB_SCHED, SB_TOL)
        print(f"splitbregman_sense{n}_6coil_b8: float64 plain solve's live CG steps "
              f"{live64.tolist()} of {SB_SCHED[0] * SB_SCHED[1] * SB_SCHED[2]}")
        run(f"splitbregman_sense{n}_6coil_b8", solver, B, xs, "splitbregman_l1_tv_fused",
            (op64, x64.reshape(2, -1)), composed=True, unit="slices/s", route=route)
    return launched, composed_ms, composed_dev


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


def kaczmarz_plan(solver, B):
    """The row kernel's plan for `solve_kaczmarz_streamed(solver, B)` (a
    real A with a complex b: its 2K real problems)."""
    import torch

    from rls_tpu_torch.kernels import kaczmarz_streamed as ks

    if not solver.A.dtype.is_complex and B.is_complex():
        B = torch.cat([B.real, B.imag], dim=1)
    rows, cols, _, x0 = ks.solver_operands(solver, B)[:4]
    return ks.card_plan(rows, x0, cols)


def print_kaczmarz_plan(name, plan):
    if plan.route == "block":
        print(f"{name}: plan block, one CTA of 256 threads per problem, {plan.smem} B")
        return
    print(f"{name}: plan warp, {plan.ctas} CTAs of {plan.groups} problem(s) + the producer, "
          f"{plan.ring} slots, x in {plan.x_in}"
          + (f" ({plan.x_lanes} a lane)" if plan.x_lanes else "")
          + f", vl in {plan.vl_in} memory, {plan.smem} B")


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


def greedy_solve_ops(m, n, steps, sweeps):
    """f32 operations of a greedy solve of one problem: `sweeps` sweeps of
    `steps` steps, each followed by Positive (n) and the refresh (A x: 2mn;
    r = (u − ε·vl) − A x: 3m)."""
    return sweeps * (greedy_ops(m, n, steps) + 2 * m * n + 3 * m + n)


def print_greedy_plan(name, plan):
    print(f"{name}: plan {plan.route}" + (
        f", {plan.rows} row(s) of r a thread, a ring of {plan.ring}, x in {plan.x_in}, "
        f"{plan.threads} threads, {plan.smem} B" if plan.route == "resident" else ""))


def kaczmarz_kernel_phase(dev, kz):
    """Phase 3i, rows 12a, 12b and 13, each held by `hold_dense`:
    12a through Kaczmarz(backend="cuda") (cyclic and shuffled, KZ_SWEEPS
    sweeps of the tall system, batch 16: the main path of the sweep kernel,
    its launches counted, each plan printed and every launch required on
    the warp route), one sweep timed in turns with its plain version and
    the composed one-sweep solve; 12b through solve_kaczmarz_streamed on
    the tall system (dense and padded CSR, 16 distinct b; the warp route
    required), the 64 MiB system (4 b), a complex system and the tall real
    A with complex b, each plan printed and its one launch required on that
    plan's route, then both routes forced on the tall dense system, the
    tall dense solve timed in turns with its plain version; 13 through
    greedy_solve (the cell's 20 sweeps of 64 steps, batch 16) with forced
    rows and with sampled draws, each one launch on its plan's route,
    whose rows must equal the plain version's, then the same on the block
    route forced (20 launches each), the solve and one sweep
    timed in turns with their plain versions, and the composed 20-sweep
    greedy solve. Returns {kernel: {"err", "ms", ...}}."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import kaczmarz_greedy as kg
    from rls_tpu_torch.kernels import kaczmarz_streamed as ks

    A, B16, _, _ = kz["tall"]
    out = {k: {"err": 0.0} for k in ("kaczmarz_sweep", "kaczmarz_solve", "kaczmarz_greedy_solve")}

    def note(name, err):
        out[name]["err"] = max(out[name]["err"], err)

    # 12a: the sweep kernel through Kaczmarz(backend="cuda")
    dense = rtt.DenseOperator(A, device=dev)
    out["kaczmarz_sweep"]["launches"] = 0
    for order in ("cyclic", "shuffled"):
        s = kaczmarz_solver(dense, (KZ_SWEEPS, 1.0, 16), randomized=False,
                            shuffle_rows=order == "shuffled", backend="cuda")
        plan = kaczmarz_plan(s, B16)
        print_kaczmarz_plan(f"kaczmarz_sweep[{order}]", plan)
        require(plan.route == "warp", f"{order}: the 12a cell plans the {plan.route} route")
        launch_counts(reset=True)
        x = rtt.solve_batched_unrolled(s, B16)
        torch.cuda.synchronize()
        got = launch_counts()
        routes = ks.kaczmarz_sweep.route_launches
        print(f"launches (Kaczmarz backend=cuda, {order}, {KZ_SWEEPS} sweeps): {got}; "
              f"by route {routes}")
        require(got == {**{k: 0 for k in got}, "kaczmarz_sweep": KZ_SWEEPS},
                f"{order}: expected {KZ_SWEEPS} launches of kaczmarz_sweep and no others")
        require(routes == {"warp": KZ_SWEEPS, "block": 0},
                f"{order}: expected {KZ_SWEEPS} launches on the warp route, got {routes}")
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
        plan = kaczmarz_plan(s, B)
        print_kaczmarz_plan(f"kaczmarz_solve[{label}]", plan)
        if label.startswith("1024x256 dense") or label.startswith("1024x256 padded"):
            require(plan.route == "warp", f"{label}: the tall cell plans the {plan.route} route")
        launch_counts(reset=True)
        note("kaczmarz_solve", hold_dense(
            f"kaczmarz_solve[{label}]", lambda b, s=s: (rtt.solve_kaczmarz_streamed(s, b).T, None),
            lambda b, s=s: (streamed_plain(s, b).T, None), (B,), counts=False))
        routes = ks.kaczmarz_solve.route_launches
        print(f"kaczmarz_solve[{label}]: launches by route {routes}")
        require(routes == {**{r: 0 for r in routes}, plan.route: 1},
                f"{label}: expected one launch on the {plan.route} route, got {routes}")
    # both routes forced at the tall dense cell
    s = cases[0][1]

    def forced(b, route):
        ops = ks.solver_operands(s, b)
        x, _ = ks._forced(*ops[:1], *ops[2:], prox="positive", route=route)
        return x[:, 0], None

    for route in ks.ROUTES:
        launch_counts(reset=True)
        note("kaczmarz_solve", hold_dense(
            f"kaczmarz_solve[1024x256 dense, batch 16, the {route} route forced]",
            lambda b, r=route: forced(b, r), lambda b: (streamed_plain(s, b).T, None), (B16,),
            counts=False))
        routes = ks.kaczmarz_solve.route_launches
        require(routes == {**{r: 0 for r in routes}, route: 1},
                f"the {route} route forced: launches by route {routes}")
    rows, _, idx, x0, vl0, u, denom, eps, sweeps, reuse = ks.solver_operands(cases[0][1], B16)
    out["kaczmarz_solve"]["ms"] = alternate_ms(
        lambda: ks.kaczmarz_solve_torch(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse,
                                        "positive"),
        lambda: ks.kaczmarz_solve(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, "positive"),
        reps=2)
    # the rows the timed solve visits, and how many distinct ones it reads
    out["kaczmarz_solve"]["visited"] = (int((idx >= 0).sum()), int(torch.unique(idx).numel()))

    # 13: the greedy solve, forced and sampled, each one launch on its plan
    sg = kaczmarz_solver(dense, KZ_GREEDY, greedy=True)
    T, S = sg.iterations, sg.sub_matrix_size
    plan = kg.card_plan(16, 1024, 256, dev)
    print_greedy_plan("kaczmarz_greedy_solve[1024x256, batch 16]", plan)
    plain = kg.kaczmarz_greedy_solve_torch
    forced = torch.from_numpy(np.random.default_rng(6).integers(0, 1024, size=(T, S))
                              .astype(np.int32)).to(dev)
    for label, fr in (("forced rows", forced), ("sampled draws", None)):
        launch_counts(reset=True)
        _, rk = kg.greedy_solve(sg, B16, forced_rows=fr)
        torch.cuda.synchronize()
        got, routes = launch_counts(), kg.kaczmarz_greedy_solve.route_launches
        require(got == {**{k: 0 for k in got}, "kaczmarz_greedy_solve": 1}
                and routes == {**{r: 0 for r in routes}, plan.route: 1},
                f"kaczmarz_greedy_solve[{label}]: launches {got}, by route {routes}")
        _, rp = kg.greedy_solve(sg, B16, forced_rows=fr, solve=plain)
        differ = int((rk != rp).sum())
        print(f"kaczmarz_greedy_solve[{label}]: one launch on the {plan.route} route; "
              f"{rk.numel()} rows drawn ({T} sweeps × {S} steps × 16 problems), {differ} differ "
              f"from the plain version's, {int(torch.unique(rk).numel())} distinct")
        require(differ == 0, f"kaczmarz_greedy_solve[{label}]: {differ} drawn rows differ")
        note("kaczmarz_greedy_solve", hold_dense(
            f"kaczmarz_greedy_solve[{label}, 1024x256, batch 16, {T}×{S}]",
            lambda b, fr=fr: (kg.greedy_solve(sg, b, forced_rows=fr)[0].T, None),
            lambda b, fr=fr: (kg.greedy_solve(sg, b, forced_rows=fr, solve=plain)[0].T, None),
            (B16,), counts=False))
    # the block route (the planner's past 4096 rows) forced at the cell: the
    # PR 6 kernel once a sweep, the projection and the refresh between them

    def block(*args):
        return kg._forced(*args, route="block")

    for label, fr in (("forced rows", forced), ("sampled draws", None)):
        launch_counts(reset=True)
        _, rk = kg.greedy_solve(sg, B16, forced_rows=fr, solve=block)
        torch.cuda.synchronize()
        got, routes = launch_counts(), kg.kaczmarz_greedy_solve.route_launches
        require(got == {**{k: 0 for k in got}, "kaczmarz_greedy_solve": T}
                and routes == {"resident": 0, "block": T},
                f"kaczmarz_greedy_solve[{label}, the block route forced]: launches {got}, by "
                f"route {routes}")
        _, rp = kg.greedy_solve(sg, B16, forced_rows=fr, solve=plain)
        differ = int((rk != rp).sum())
        print(f"kaczmarz_greedy_solve[{label}, the block route forced]: {T} launches on the "
              f"block route; {rk.numel()} rows drawn, {differ} differ from the plain version's")
        require(differ == 0,
                f"kaczmarz_greedy_solve[{label}, the block route forced]: {differ} rows differ")
        note("kaczmarz_greedy_solve", hold_dense(
            f"kaczmarz_greedy_solve[{label}, the block route forced, 1024x256, batch 16, "
            f"{T}×{S}]",
            lambda b, fr=fr: (kg.greedy_solve(sg, b, forced_rows=fr, solve=block)[0].T, None),
            lambda b, fr=fr: (kg.greedy_solve(sg, b, forced_rows=fr, solve=plain)[0].T, None),
            (B16,), counts=False))
    # the timed solve: the rows it draws, and how many distinct ones it reads
    out["kaczmarz_greedy_solve"]["visited"] = (
        S, T, int(torch.unique(kg.greedy_solve(sg, B16)[1]).numel()))
    print(f"kaczmarz_greedy_solve (timed solve): {out['kaczmarz_greedy_solve']['visited'][2]} "
          "distinct rows drawn")
    out["kaczmarz_greedy_solve"]["ms"] = alternate_ms(
        lambda: kg.greedy_solve(sg, B16, solve=plain), lambda: kg.greedy_solve(sg, B16), reps=1)
    Ag, Gt, dg, ng, eg, fn, bt = kg.greedy_operands(sg, B16)
    z = (torch.zeros(16, 256, device=dev), torch.zeros(16, 1024, device=dev), bt)
    sweep_ms = alternate_ms(
        lambda: kg.kaczmarz_greedy_sweep_torch(Ag, Gt, dg, ng, *z, eg, fn, None, S, sg.seed, 0),
        lambda: kg.kaczmarz_greedy_sweep(Ag, Gt, dg, ng, *z, eg, fn, None, S, sg.seed, 0),
        reps=2)
    print(f"kaczmarz_greedy_sweep (one sweep of {S} steps): kernel {sweep_ms[1]:.3f} ms, "
          f"plain {sweep_ms[0]:.3f} ms")
    rtt.solve_batched_unrolled(sg, B16)
    out["kaczmarz_greedy_solve"]["library_ms"] = cuda_ms(
        lambda: rtt.solve_batched_unrolled(sg, B16), 1)
    for name, row in out.items():
        print(f"{name}: kernel {row['ms'][1]:.3f} ms, plain {row['ms'][0]:.3f} ms"
              + (f", composed {row['library_ms']:.3f} ms" if "library_ms" in row else ""))
    return out


def parity_cols(name, x, B, mv64, x64, xs_true, bar=TOL_PARITY, res_bar=TOL_RESIDUAL,
                spread=None):
    """The first k columns of a solve `x` (n × K) against the float64
    solutions `x64` (n × k): the worst column's relative error (≤ `bar`,
    TOL_PARITY unless a cell's own f32 arithmetic cannot meet it) and
    |‖A x − b‖ − ‖A x64 − b‖| / ‖b‖ with A in float64 (≤ `res_bar`);
    printed with the error against the true images `xs_true` (n, the same
    for every column, or n × K) beside the float64 solve's own. Given
    `spread()` (the f32 solve's relative change under b·(1 + 2⁻²³)), an
    error above `bar` is held to twice that spread instead (phase 10's
    rule), and the bar that held is printed. Returns both."""
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
    truth = xs_true.to(x64.dtype)
    truth = (truth[:, None] if truth.ndim == 1 else truth).expand(-1, x.shape[1])
    rec = float(torch.linalg.norm(x.to(x64.dtype) - truth) / torch.linalg.norm(truth))
    rec64 = float(torch.linalg.norm(x64 - truth[:, :k]) / torch.linalg.norm(truth[:, :k]))
    held = ""
    if spread is not None:
        held = f" (bar {bar:.3e}: TOL_PARITY)"
        if rel > bar:
            s = spread()
            bar = max(bar, 2 * s)
            held = f" (bar {bar:.3e}: twice the f32 solve's 1-ulp spread {s:.3e})"
    print(f"{name}: recon_rel_err {rec:.4e} (float64 solve {rec64:.4e}), parity_max_rel_err vs "
          f"f64 {rel:.3e}{held}, parity_residual_rel_diff vs f64 {res:.3e}")
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
    from rls_tpu_torch.kernels import kaczmarz_streamed as ks
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
        if row in ("kaczmarz_streamed", "kaczmarz_greedy"):
            if row == "kaczmarz_streamed":
                plan, routes = kaczmarz_plan(solver, B), ks.kaczmarz_solve.route_launches
            else:
                plan = kg.card_plan(B.shape[1], *solver.A.shape, B.device)
                routes = kg.kaczmarz_greedy_solve.route_launches
            print(f"launches ({name}) by route: {routes}")
            require(routes == {**{r: 0 for r in routes}, plan.route: 1},
                    f"{name}: expected one launch on the {plan.route} route, got {routes}")
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
    x = run(name, sg, Bt, "kaczmarz_greedy", {"kaczmarz_greedy_solve": 1})
    _, rows = kg.greedy_solve(sg, Bt)  # the same draws as the run above
    s64 = as_float64(sg)
    x64 = torch.cat([kg.greedy_solve(s64, Bt[:, j:j + 1].double(), forced_rows=rows[:, j, :],
                                     dtype=torch.float64, solve=kg.kaczmarz_greedy_solve_torch)[0]
                     for j in range(2)], dim=1)
    parity_cols(name, x, Bt, s64.A.mv, x64, xtk)
    return launched, composed


def nonseparable_kernel(k=9, seed=11):
    """A seeded k×k blur of rank 2: two anisotropic Gaussians (widths
    U[0.8, 2.5]) rotated by U[0, π), summed and normalized to sum 1."""
    rng = np.random.default_rng(seed)
    ax = np.arange(k) - k // 2
    yy, xx = np.meshgrid(ax, ax, indexing="ij")
    kern = np.zeros((k, k))
    for _ in range(2):
        th = rng.uniform(0.0, np.pi)
        s1, s2 = rng.uniform(0.8, 2.5, size=2)
        u = xx * np.cos(th) + yy * np.sin(th)
        v = -xx * np.sin(th) + yy * np.cos(th)
        kern += np.exp(-(u**2 / (2 * s1**2) + v**2 / (2 * s2**2)))
    return kern / kern.sum()


def ct_phantoms(batch=CT_BATCH, n=CT_N, seed=5):
    """Seeded CT phantoms: an ellipse of 1 holding five ellipses of
    U[−0.5, 0.5] (centres U[−0.5, 0.5], radii U[0.05, 0.25] of the half
    width), (batch, n²) float32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n] / (n - 1) * 2 - 1
    imgs = np.zeros((batch, n, n), np.float32)
    for b in range(batch):
        imgs[b][(yy / 0.9) ** 2 + (xx / 0.7) ** 2 <= 1] = 1.0
        for _ in range(5):
            cy, cx = rng.uniform(-0.5, 0.5, 2)
            ry, rx = rng.uniform(0.05, 0.25, 2)
            imgs[b][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] += rng.uniform(-0.5, 0.5)
    return imgs.reshape(batch, -1)


def fallback(name, fn, reason=None):
    """fn() (a solve_batched_fast call), which must warn that no fused
    kernel applies and fall back to the composed path, naming `reason`
    among its rejections where one is given."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    msg = " ".join(str(w.message) for w in caught)
    require("falling back" in msg,
            f"{name}: solve_batched_fast did not fall back to the composed path")
    require(reason is None or reason in msg,
            f"{name}: the fallback does not name {reason!r}: {msg}")
    return out


def ulp_spread(solve, B2):
    """The relative change of the worst of the columns of `solve(B2)` under
    B2·(1 + 2⁻²³)."""
    import torch

    x, xp = solve(B2), solve(B2 * (1.0 + 2.0**-23))
    return float(max(torch.linalg.norm(x[:, j] - xp[:, j]) / torch.linalg.norm(x[:, j])
                     for j in range(x.shape[1])))


def counted_run(name, fn, want):
    """fn() with the launch counters set to 0 just before and read just
    after: `want` and no others (the TV prox's launches all on its resident
    route). Returns (its result, its ms by CUDA events)."""
    import torch

    from rls_tpu_torch.kernels import tv_fgp

    launch_counts(reset=True)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    got = launch_counts()
    print(f"launches ({name}): {got}")
    require(got == {**{k: 0 for k in got}, **want},
            f"{name}: expected the launches {want} and no others")
    if "prox_tv2d_fgp" in want:
        routes = tv_fgp.prox_tv2d_fgp.route_launches
        require(routes == {"resident": want["prox_tv2d_fgp"], "windows": 0, "global": 0},
                f"{name}: tv_fgp routes {routes}, not all resident")
    return out, start.elapsed_time(stop)


def composite_phase(dev, draws, flagship, B_flag, systems, pdhg_solver, kz):
    """Phase 11, the composite, decorator, DAX and operator path, each case
    with the launch counters set to 0 just before it and read just after,
    and its times beside the card's name and power limit:
    (a) decorated terms into existing kernels, each bit for bit its
        undecorated twin and one launch of that kernel:
        cgnr_l2_dense_1024x512_b64 with FixedScaled(L2(λ/4), 4),
        pdhg_tv8_deblur256_b16_fused with FixedScaled(TV(2λ), 0.5) and
        kaczmarz_rand_pos_tall_b16_streamed with FixedParameter(L2); the
        flagship with FixedScaled(TV(λ), 1), which row 2 rejects, through
        solve_batched_fast: the fallback warning, ITERS resident tv_fgp
        launches, bit for bit the undecorated solve_batched_unrolled;
    (b) non-separable deblurring on DirectConvOperator (FISTA + TV through
        the fallback, ITERS tv_fgp launches), two columns held to a
        float64 solve on the card; a FunctionOperator wrapping its mv, the
        vjp adjoint against its rmv;
    (c) multi-coil SENSE from composites (per coil Sampling ∘ FFT ∘
        Weighting, the coils stacked) with a wavelet prior
        (Transformed(L1, WaveletOperator db2)), held to float64;
    (d) sparse-view CT on RadonOperator (FISTA + TV, ITERS tv_fgp
        launches), held to float64, and its adjoint identity;
    (e) DaxKaczmarz and DaxConstrained on the tall Kaczmarz system through
        the fallback, each held to a float64 run (DaxKaczmarz's rows forced
        to the ones the float32 run drew)."""
    import dataclasses

    import torch

    import rls_tpu_torch as rtt

    card = card_line()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def timed(name, fn, K, unit="problems/s"):
        """One more call of `fn`, which its counted run has warmed (cuFFT's
        plans, cuDNN's algorithms), by CUDA events."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ms = cuda_ms(fn, 1)
        print(f"{name}: {K / (ms / 1e3):.1f} {unit} ({ms:.2f} ms per batch of {K}; {card})")

    # (a) decorated terms into the kernels their JAX checks let them reach
    A1k, B1k = map(t, systems["cgnr1k"])
    dense1k = rtt.DenseOperator(A1k, device=dev)
    tv_shape = (PDHG_N, PDHG_N)
    Bp = pdhg_solver.A.mv(t(draws["admm"]))[:, None].repeat(1, PDHG_BATCH).contiguous()
    Ak, Bk = kz["tall"][0], kz["tall"][2]
    densek = rtt.DenseOperator(Ak, device=dev)
    kz_kw = dict(iterations=KZ_TALL[0], sub_matrix_fraction=KZ_TALL[1], randomized=True,
                 precompute_order=True)
    for name, label, dec, twin, B, kernel in (
        ("cgnr_l2_dense_1024x512_b64", "FixedScaled(L2(λ/4), 4)",
         rtt.CGNR.create(dense1k, reg=rtt.FixedScaledRegularization(
             rtt.L2Regularization(CGNR1K_LAM / 4), 4.0), iterations=CGNR1K_ITERS),
         rtt.CGNR.create(dense1k, reg=rtt.L2Regularization(CGNR1K_LAM),
                         iterations=CGNR1K_ITERS), B1k, "cgnr_fused"),
        ("pdhg_tv8_deblur256_b16_fused", "FixedScaled(TV(2λ), 0.5)",
         rtt.PDHG.create(pdhg_solver.A, reg=rtt.FixedScaledRegularization(
             rtt.TVRegularization(2 * PDHG_LAM, shape=tv_shape), 0.5),
             iterations=PDHG_ITERS, sigma=PDHG_SIGMA, tau=pdhg_solver.tau),
         pdhg_solver, Bp, "pdhg_fused"),
        ("kaczmarz_rand_pos_tall_b16_streamed", "FixedParameter(L2)",
         rtt.Kaczmarz.create(densek, reg=[
             rtt.FixedParameterRegularization(rtt.L2Regularization(KZ_LAM)),
             rtt.PositiveRegularization()], **kz_kw),
         rtt.Kaczmarz.create(densek, reg=[rtt.L2Regularization(KZ_LAM),
                                          rtt.PositiveRegularization()], **kz_kw),
         Bk, "kaczmarz_solve"),
    ):
        name_dec = f"{name} with {label}"
        x_dec = counted_run(name_dec, lambda: rtt.solve_batched_fast(dec, B), {kernel: 1})[0]
        x_twin = counted_run(name, lambda: rtt.solve_batched_fast(twin, B), {kernel: 1})[0]
        require(torch.equal(x_dec, x_twin), f"{name_dec}: differs from its undecorated twin")
        print(f"{name_dec}: bit for bit its undecorated twin")
        timed(name_dec, lambda: rtt.solve_batched_fast(dec, B), B.shape[1])
    dec = rtt.FISTA.create(flagship.A, reg=rtt.FixedScaledRegularization(flagship.reg, 1.0),
                           iterations=ITERS, rho=RHO, rel_tol=0.0, track_residual=False)
    name = "the flagship with FixedScaled(TV, 1.0)"
    x_dec = counted_run(name, lambda: fallback(name, lambda: rtt.solve_batched_fast(dec, B_flag)),
                    {"prox_tv2d_fgp": ITERS})[0]
    x_twin = rtt.solve_batched_unrolled(flagship, B_flag)
    require(torch.equal(x_dec, x_twin),
            f"{name}: differs from the undecorated solve_batched_unrolled")
    print(f"{name}: fell back, bit for bit the undecorated solve_batched_unrolled")
    timed(name, lambda: rtt.solve_batched_fast(dec, B_flag), BATCH)

    # (b)-(e): each cell through solve_batched_fast (the fallback), two
    # columns held to a float64 solve on the card, then the cell's own checks
    for name, cell in composite_cells(dev, kz).items():
        s, B = cell["solver"], cell["B"]
        x, ms = counted_run(name, lambda: fallback(name, lambda: rtt.solve_batched_fast(s, B)),
                        cell["launches"])
        if "rows" in cell:
            # DaxKaczmarz: the rows the run drew, replayed from its seed; the
            # run again on them gives its bits, and the float64 run visits them
            rows = cell["rows"]()
            require(torch.equal(rtt.solve_batched_unrolled(
                dataclasses.replace(s, _forced_rows=rows), B), x),
                f"{name}: the replayed rows do not give the run's bits")
            print(f"{name}: {rows.numel()} row updates, {int(rows.unique().numel())} distinct "
                  f"rows of {s.A.out_size}")
        s64, op64 = cell["float64"]()
        x64 = rtt.solve_batched_unrolled(s64, B[:, :2].to(op64.dtype))
        spread = None
        if cell["timed"]:  # the DAX cells, whose f32 solve is ~1 s, take TOL_PARITY alone
            spread = lambda: ulp_spread(lambda b: rtt.solve_batched_unrolled(s, b), B[:, :2])  # noqa: E731
        parity_cols(name, x, B, op64.mv, x64, cell["truth"], spread=spread)
        cell["check"](x, op64)
        if cell["timed"]:
            timed(name, lambda: rtt.solve_batched_fast(s, B), B.shape[1], cell["unit"])
        else:  # the counted run's own time: a second run costs ~1 s
            print(f"{name}: {B.shape[1] / (ms / 1e3):.1f} {cell['unit']} ({ms:.2f} ms per batch "
                  f"of {B.shape[1]}, the counted run; {card})")

def composite_cells(dev, kz):
    """Phase 11's cells (b)-(e), by name: each with its float32 solver, B
    (one problem a column), the true images (n × K), the launches one
    solve_batched_fast call must make, a function building the float64 solver and
    operator, whether to time it apart from its counted run, the unit of its
    rate, and for DaxKaczmarz a replay of the rows its run draws."""
    import dataclasses

    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.models.solvers import dax

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cells = {}
    # (b) non-separable deblurring on DirectConvOperator
    kern = nonseparable_kernel()
    sv = np.linalg.svd(kern, compute_uv=False)
    print(f"non-separable 9x9 kernel: σ2/σ1 = {sv[1] / sv[0]:.3e}")
    require(sv[1] > 1e-6 * sv[0], "the phase-11 kernel is separable")

    def deblur(op, backend):
        tv = rtt.TVRegularization(LAM, shape=(N, N), iterations_tv=TV_ITERS, backend=backend)
        return rtt.FISTA.create(op, reg=tv, iterations=ITERS, rho=RHO, rel_tol=0.0,
                                track_residual=False)

    def deblur64():
        op64 = rtt.DirectConvOperator(kern, (N, N), device=dev)
        return deblur(op64, "torch"), op64

    def vjp_adjoint(op, B):
        """A FunctionOperator of op's mv: its vjp adjoint against op.rmv."""
        fop = rtt.FunctionOperator(op.mv, n=op.in_size, m=op.out_size, device=dev)
        Y = B[:, :4].T.contiguous()
        got, want = fop.rmv(Y), op.rmv(Y)
        err = float((got - want).abs().max() / want.abs().max())
        print(f"FunctionOperator(DirectConvOperator.mv): max|vjp adjoint - rmv| = {err:.3e} of max")
        require(err <= 1e-5, f"FunctionOperator's vjp adjoint disagrees with the rmv: {err:.3e}")

    opd = rtt.DirectConvOperator(kern.astype(np.float32), (N, N), device=dev)
    xs = t(phantoms(n=N, batch=DC_BATCH))
    Bd = opd.mv(xs).T.contiguous()
    cells[f"direct_conv_deblur256_b{DC_BATCH}"] = dict(
        solver=deblur(opd, "cuda"), B=Bd, truth=xs.T, launches={"prox_tv2d_fgp": ITERS},
        float64=deblur64, timed=True, unit="problems/s",
        check=lambda x, op64: vjp_adjoint(opd, Bd))

    # (c) multi-coil SENSE from composites, with a wavelet prior
    maps, mask, X = sense_problem()
    hw = SENSE_N * SENSE_N
    idx = np.flatnonzero(mask.ravel())

    def sense(cdt, rdt):
        coils = [rtt.SamplingOperator(idx, hw, device=dev)
                 @ rtt.FFTOperator((SENSE_N, SENSE_N), device=dev)
                 @ rtt.WeightingOperator(m.ravel().astype(cdt), device=dev) for m in maps]
        op = rtt.StackedOperator(coils)
        wav = rtt.WaveletOperator((SENSE_N, SENSE_N), "db2", dtype=rdt, device=dev)
        return rtt.FISTA.create(
            op, reg=rtt.TransformedRegularization(rtt.L1Regularization(SENSE_LAM), wav),
            iterations=SENSE_ITERS, rho=RHO, rel_tol=0.0, track_residual=False), op

    def beats_zero_filled(name, x, op64, B, xs):
        xs = xs.to(torch.complex128)
        zf = float(torch.linalg.norm(op64.rmv(B.T.to(torch.complex128)) - xs)
                   / torch.linalg.norm(xs))
        rec = float(torch.linalg.norm(x.T - xs) / torch.linalg.norm(xs))
        print(f"{name}: zero-filled Aᴴb recon_rel_err {zf:.4f}")
        require(rec < zf, f"{name}: the reconstruction is no better than the zero-filled Aᴴb")

    ss, ops = sense(np.complex64, torch.float32)
    xs = t((X[:, :hw] + 1j * X[:, hw:]).astype(np.complex64))
    Bs = ops.mv(xs).T.contiguous()
    name = f"composite_sense{SENSE_N}_{SENSE_C}coil_wavelet_b{SENSE_SLICES}"
    cells[name] = dict(
        solver=ss, B=Bs, truth=xs.T, launches={},
        float64=lambda: sense(np.complex128, torch.float64), timed=True, unit="slices/s",
        check=lambda x, op64, name=name, xs=xs: beats_zero_filled(name, x, op64, Bs, xs))

    # (d) sparse-view CT on RadonOperator; ρ from the power iteration
    angles = np.linspace(0.0, np.pi, CT_ANGLES, endpoint=False)
    opr = rtt.RadonOperator(angles, (CT_N, CT_N), CT_N, device=dev)
    sr = rtt.FISTA.create(opr, reg=rtt.TVRegularization(CT_LAM, shape=(CT_N, CT_N),
                                                        iterations_tv=TV_ITERS, backend="cuda"),
                          iterations=ITERS, rel_tol=0.0, track_residual=False)
    print(f"radon: ρ = 0.95 / {0.95 / float(sr.rho):.2f} from the power iteration")

    def ct64():
        op64 = rtt.RadonOperator(angles, (CT_N, CT_N), CT_N, dtype=torch.float64, device=dev)
        tv = rtt.TVRegularization(CT_LAM, shape=(CT_N, CT_N), iterations_tv=TV_ITERS)
        return rtt.FISTA.create(op64, reg=tv, iterations=ITERS, rho=float(sr.rho), rel_tol=0.0,
                                track_residual=False), op64

    def adjoint_identity(op):
        """⟨A x, y⟩ = ⟨x, Aᴴ y⟩ on the card for uniform x, y ≥ 0 (no
        cancellation), both sides summed in float64."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        xa = torch.rand(op.in_size, generator=gen, device=dev)
        ya = torch.rand(op.out_size, generator=gen, device=dev)
        lhs = torch.dot(op.mv(xa).double(), ya.double())
        rhs = torch.dot(xa.double(), op.rmv(ya).double())
        adj = float((lhs - rhs).abs() / lhs.abs())
        print(f"radon: ⟨Ax, y⟩ = {float(lhs):.6e}, ⟨x, Aᴴy⟩ = {float(rhs):.6e}, relative gap "
              f"{adj:.3e} (the backprojection scatters with atomics)")
        require(adj <= 1e-5, f"radon: the adjoint identity fails by {adj:.3e}")

    xs = t(ct_phantoms(CT_BATCH, CT_N))
    cells[f"radon_ct{CT_N}_{CT_ANGLES}views_b{CT_BATCH}"] = dict(
        solver=sr, B=opr.mv(xs).T.contiguous(), truth=xs.T, launches={"prox_tv2d_fgp": ITERS},
        float64=ct64, timed=True, unit="problems/s", check=lambda x, op64: adjoint_identity(opr))

    # (e) DAX on the tall Kaczmarz system's 16 distinct b
    Ak, Bz = kz["tall"][0], kz["tall"][1]
    x16 = t(np.abs(np.random.default_rng(3).normal(size=(256, 16))).astype(np.float32))
    w = np.random.default_rng(9).uniform(0.5, 1.5, size=Ak.shape[0]).astype(np.float32)
    outer, inner = DAX_SCHED
    for name, cls, kw in (
        ("dax_kaczmarz_tall_b16", rtt.DaxKaczmarz,
         dict(weights=w, enforce_real=True, enforce_positive=True)),
        ("dax_constrained_tall_b16", rtt.DaxConstrained, {}),
    ):
        def make(A, cls=cls, kw=kw):
            op = rtt.DenseOperator(A, device=dev)
            return cls.create(op, lam=DAX_LAM, iterations=outer, iterations_inner=inner, **kw), op

        s = make(Ak)[0]
        cell = dict(solver=s, B=Bz, truth=x16, launches={}, timed=False, unit="problems/s",
                    check=lambda x, op64: None)
        if cls is rtt.DaxKaczmarz:
            def replay(s=s):
                gen = torch.Generator(device=dev)
                gen.manual_seed(s.seed)
                return torch.stack([dax.draw_rows(s.probs, s.n_nonzero_rows * inner, gen)
                                    for _ in range(outer)])

            def dax64(make=make, replay=replay):
                s64, op64 = make(Ak.double())
                return dataclasses.replace(s64, _forced_rows=replay()), op64

            cell.update(rows=replay, float64=dax64)
        else:
            def nonnegative(x, op64, name=name):  # B x ≥ 0 with B = I
                print(f"{name}: min x = {float(x.min()):.3e}")
                require(float(x.min()) >= -1e-4, f"{name}: min x {float(x.min()):.3e} < -1e-4")

            cell.update(float64=lambda make=make: make(Ak.double()), check=nonnegative)
        cells[name] = cell
    return cells

def condat_long_input():
    """Phase 12 (a)'s long signals: CONDAT_LONG piecewise-constant lines (a
    jump of N(0, 1) with probability 2e-3 an entry) plus noise of σ 0.1,
    and one λ per signal in [0.05, 0.5], from default_rng(23)."""
    P, _, L = CONDAT_LONG
    rng = np.random.default_rng(23)
    jumps = rng.uniform(size=(P, L)) < 2e-3
    x = np.cumsum(rng.normal(size=(P, L)) * jumps, axis=1) + 0.1 * rng.normal(size=(P, L))
    lam = rng.uniform(0.05, 0.5, size=P)
    return x.astype(np.float32).reshape(CONDAT_LONG), lam.astype(np.float32)


def condat_plain_child() -> int:
    """``--condat-plain``: the Condat prox's plain version on the CPU (one
    thread) at phase 12 (a)'s long signals; writes the result and its
    seconds to stdout as two .npy records."""
    import io

    import torch

    sys.path.insert(0, ROOT)
    from rls_tpu_torch.kernels.tv_condat import prox_tv1d_condat_torch

    torch.set_num_threads(1)
    x, lam = condat_long_input()
    t0 = time.perf_counter()
    out = prox_tv1d_condat_torch(torch.from_numpy(x), torch.from_numpy(lam), 2).numpy()
    buf = io.BytesIO()
    np.save(buf, out)
    np.save(buf, np.float64(time.perf_counter() - t0))
    sys.stdout.buffer.write(buf.getvalue())
    return 0


# the processes this run starts, stopped when it ends
CHILDREN = []


def start_condat_plain():
    """Start the long signals' plain version (``--condat-plain``) on the
    CPU, beside the run: it takes tens of seconds, one event a step."""
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--condat-plain"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    CHILDREN.append(proc)
    return proc


def stop_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def condat_lines(N, dtype, seed=0):
    """Phase 12 (a)'s adversarial lines (30, N) and their λs, six of each:
    noise at λ = 0, 1e-6, 0.05, 0.3, 2 and 1e4 (past every line's
    variation: one segment a line, no restart), constant lines, ramps,
    alternating ±1 (λ about 1, the jumps' half height) and piecewise-constant
    lines plus noise; from default_rng(seed + N)."""
    rng = np.random.default_rng(seed + N)
    lam = np.array([0.0, 1e-6, 0.05, 0.3, 2.0, 1e4])
    k = np.arange(N)
    jumps = rng.uniform(size=(6, N)) < 2e-3
    lines = [rng.normal(size=(6, N)), np.repeat(rng.normal(size=(6, 1)), N, axis=1),
             k[None, :] * rng.normal(size=(6, 1)),
             np.tile(np.where(k % 2 == 0, 1.0, -1.0), (6, 1)),
             np.cumsum(rng.normal(size=(6, N)) * jumps, axis=1) + 0.1 * rng.normal(size=(6, N))]
    lams = [lam, lam, lam, np.array([0.0, 1e-6, 0.5, 0.999, 1.0, 1e4]),
            rng.uniform(0.05, 0.5, size=6)]
    return np.concatenate(lines).astype(dtype), np.concatenate(lams).astype(dtype)


def condat_kernel_phase(dev, child):
    """Phase 12 (a): the Condat kernel against its plain version, bit for
    bit, each case one prox call by its counter (on its plan's route, or
    the forced one): CONDAT_CASES and the main path's shape (16 × 256²
    along the image's axis 1, float32) with both times; then λ = 0 and λ
    past every line's variation at the main shape, the adversarial lines
    of `condat_lines` at N = 1, 2, 3, one more than the main shape's chunk
    and 256, phase 12 (b)'s prox inputs at its first and last iterations,
    and the main shape on each route forced. Returns the main path shape's
    (max|kernel − plain|, plain ms, kernel ms, bound)."""
    import io

    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import tv_condat

    card = card_line()
    main_case = ((TV1_BATCH, N, N), 2, "float32")
    out = None

    def hold(name, fn, x, lam, axis, route=None):
        lines = x.numel() // x.shape[axis]
        plan = tv_condat.card_plan(lines, x.shape[axis], x.dtype, x.device, route)
        got = counted_run(name, fn, {"prox_tv1d_condat": 1})[0]
        routes = tv_condat.prox_tv1d_condat.route_launches
        require(routes[plan.route] == 1, f"{name}: routes {routes}, planned {plan.route}")
        require(bool(torch.isfinite(got).all() or not torch.isfinite(x).all()),
                f"{name}: non-finite values")
        return got, plan

    for shape, axis, dtype in CONDAT_CASES + (main_case,):
        name = f"tv_condat[{' x '.join(map(str, shape))} along axis {axis}, {dtype}]"
        long = shape == CONDAT_LONG
        x, lam = condat_case(dev, shape, axis, dtype)
        got, plan = hold(name, lambda: tv_condat.prox_tv1d_condat(x, lam, axis), x, lam, axis)
        if long:
            raw, err_txt = child.communicate(timeout=900)
            require(child.returncode == 0,
                    f"{name}: the plain version's process failed: {err_txt.decode()[-2000:]}")
            buf = io.BytesIO(raw)
            want = torch.from_numpy(np.load(buf)).to(dev)
            plain_ms, where = float(np.load(buf)) * 1e3, "CPU, one thread"
        else:  # the plain version's one call, timed by CUDA events
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            want = tv_condat.prox_tv1d_condat_torch(x, lam, axis)
            stop.record()
            torch.cuda.synchronize()
            plain_ms, where = start.elapsed_time(stop), "card"
        err = float((got - want).abs().max())
        require(torch.equal(got, want), f"{name}: differs from its plain version by {err:.3e}")
        ms = cuda_ms(lambda: tv_condat.prox_tv1d_condat(x, lam, axis), 2 if long else 10)
        elems = x.numel()
        bnd = bound(4 * elems, x.element_size() * (2 * elems + shape[0]))
        print(f"{name}: bit for bit its plain version; kernel {ms:.3f} ms, plain {plain_ms:.1f} "
              f"ms ({where}), bound {bnd[0]:.4f} ms ({bnd[1]}), {x.numel() // shape[axis]} "
              f"lines of {shape[axis]} on the {plan.route} route (chunks of {plan.chunk}); "
              f"{card}")
        if (shape, axis, dtype) == main_case:
            out = (err, plain_ms, ms, bnd)
    # the edges: each one call, bit for bit
    xm, lm = condat_case(dev, main_case[0], 2, "float32")
    edges = [(f"λ = {lv:g} at the main shape", xm, torch.tensor(lv, device=dev), 2, None)
             for lv in (0.0, 1e4)]
    chunk = tv_condat.card_plan(TV1_BATCH * N, N, torch.float32, xm.device).chunk
    for n_line in (1, 2, 3, chunk + 1, N):
        for dtype in ("float32", "float64"):
            c_np, l_np = condat_lines(n_line, dtype)
            edges.append((f"adversarial lines of {n_line} ({dtype})",
                          torch.from_numpy(c_np).to(dev), torch.from_numpy(l_np).to(dev), 1,
                          None))
    s, _, B, _ = tv1_cell(dev)
    calls = condat_prox_inputs(lambda: rtt.solve_batched_fast(s, B, warn=False))
    for tag, (x, lam, axis) in (("first", calls[0]), ("last", calls[-1])):
        edges.append((f"(b)'s prox input at its {tag} iteration", x, lam, axis, None))
    for route in tv_condat.ROUTES:
        edges.append((f"the main shape on the {route} route", xm, lm, 2, route))
    for what, x, lam, axis, route in edges:
        name = f"tv_condat[{what}]"
        got, plan = hold(name, lambda: tv_condat._prox(x, lam, axis, route=route), x, lam, axis,
                         route)
        want = tv_condat.prox_tv1d_condat_torch(x, lam, axis)
        require(torch.equal(got, want),
                f"{name}: differs from its plain version by {float((got - want).abs().max()):.3e}")
        print(f"{name}: bit for bit its plain version, {tuple(x.shape)} along axis {axis}, one "
              f"call on the {plan.route} route (chunks of {plan.chunk})")
    return out


def cine_series(n, frames, batch, seed=41):
    """Seeded complex cine series (batch, n² × frames), frames fastest: a
    static disc and three discs whose radii beat over the frames, under a
    smooth quadratic phase."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n] / n
    t = np.arange(frames) / frames
    phase = np.exp(1j * 0.8 * np.pi * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2))[..., None]
    out = np.zeros((batch, n, n, frames), np.complex64)
    for p in range(batch):
        img = 0.3 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2 < 0.16)[..., None] * np.ones(frames)
        for _ in range(3):
            cx, cy = rng.uniform(0.3, 0.7, size=2)
            r0, amp, ph = rng.uniform(0.04, 0.1), rng.uniform(0.3, 0.8), rng.uniform(0, 2 * np.pi)
            rad = r0 * (1 + 0.3 * np.sin(2 * np.pi * t + ph))
            img = img + amp * (((xx[..., None] - cx) ** 2 + (yy[..., None] - cy) ** 2) < rad ** 2)
        out[p] = img * phase
    return out.reshape(batch, -1)


def cine_operator(dev, n, frames, seed=43):
    """The cine's per-frame 2-D FFT keeping LLR_LINES phase-encode lines a
    frame (the 8 lowest always, the rest drawn from default_rng(seed)),
    from the port's operators: frame t is Sampling(its k-space lines) ∘
    FFT ∘ Sampling(frame t of the series), the frames stacked."""
    import rls_tpu_torch as rtt

    rng = np.random.default_rng(seed)
    hw = n * n
    low = np.arange(-4, 4) % n  # the unshifted FFT keeps the lowest lines at both ends
    others = np.setdiff1d(np.arange(n), low)
    parts = []
    for t in range(frames):
        rows = np.sort(np.concatenate([low, rng.choice(others, LLR_LINES - 8, replace=False)]))
        kidx = (rows[:, None] * n + np.arange(n)).ravel()
        parts.append(rtt.SamplingOperator(kidx, hw, device=dev)
                     @ rtt.FFTOperator((n, n), device=dev)
                     @ rtt.SamplingOperator(np.arange(hw) * frames + t, hw * frames, device=dev))
    return rtt.StackedOperator(parts)


def svd_drivers(blocks):
    """torch.linalg.svd's CUDA drivers on `blocks`: each one's ms (its
    second call) and its SVT's largest error against the float64 SVT
    (relative to its largest entry), printed; the driver in use
    (prox.CUDA_SVD_DRIVER) must hold SVT_BAR. Returns {driver: (ms, err)}."""
    import torch

    from rls_tpu_torch.models import prox

    b64 = blocks.to(torch.complex128 if blocks.is_complex() else torch.float64)
    u, sv, vh = torch.linalg.svd(b64, full_matrices=False)
    lam = float(sv[..., 0].median()) / 4
    want = (u * torch.clamp(sv - lam, min=0).unsqueeze(-2).to(u.dtype)) @ vh
    out = {}
    for driver in (None, "gesvd", "gesvdj", "gesvda"):
        fn = lambda: torch.linalg.svd(blocks, full_matrices=False, driver=driver)  # noqa: E731
        try:
            u, sv, vh = fn()
        except RuntimeError as e:
            print(f"svd driver {driver}: failed ({str(e)[:120]})")
            continue
        got = (u * torch.clamp(sv - lam, min=0).unsqueeze(-2).to(u.dtype)) @ vh
        err = float((got.to(want.dtype) - want).abs().max() / want.abs().max())
        ms = cuda_ms(fn, 1)
        out[driver] = (ms, err)
        print(f"svd driver {driver}: {ms:.3f} ms for {blocks.shape[0]} blocks of "
              f"{blocks.shape[1]} x {blocks.shape[2]} {blocks.dtype}, SVT error vs float64 "
              f"{err:.3e}")
    chosen = prox.CUDA_SVD_DRIVER
    held = {d: v for d, v in out.items() if v[1] <= SVT_BAR}
    require(chosen in held, f"the SVD driver {chosen} does not hold the SVT bar {SVT_BAR}")
    fastest = min(held, key=lambda d: held[d][0])
    print(f"svd driver in use: {chosen} ({held[chosen][0]:.3f} ms); fastest holding the bar "
          f"{SVT_BAR}: {fastest} ({held[fastest][0]:.3f} ms)")
    return out


def regularizer_cells(dev):
    """Phase 12's cells (b)-(e), by name: each with its float32 solver, B
    (one problem a column), the true images (n × K), the launches one
    solve_batched_fast call makes, the reason its fallback names, a function
    building the float64 solver and its operator's mv, its rate's unit, and
    a check of the result."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.models import denoisers

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cells = {}
    # (b) FISTA with the exact 1-D TV along the rows on the flagship's blur
    def tv1(dtype):
        op = rtt.SeparableConvOperator.from_kernel(gaussian_kernel(), im_shape=(N, N),
                                                   dtype=dtype, device=dev)
        tv = rtt.TVRegularization(LAM, shape=(N, N), dims=1)
        return rtt.FISTA.create(op, reg=tv, iterations=ITERS, rho=RHO, rel_tol=0.0,
                                track_residual=False), op

    s, op = tv1(torch.float32)
    xs = t(phantoms(n=N, batch=TV1_BATCH))
    cells[f"fista_tv1d_condat_deblur256_b{TV1_BATCH}"] = dict(
        solver=s, B=op.mv(xs).T.contiguous(), truth=xs.T, launches={"prox_tv1d_condat": ITERS},
        reason="pgm_tv: fused path requires 2-D TV over both axes",
        float64=lambda: (lambda s64, op64: (s64, op64.mv))(*tv1(torch.float64)),
        unit="problems/s", check=lambda x: None)

    # (c) Nuclear matrix completion
    n = N
    rng = np.random.default_rng(31)
    U = rng.normal(size=(NUC_BATCH, n, NUC_RANK))
    V = rng.normal(size=(NUC_BATCH, n, NUC_RANK))
    X = (U @ V.transpose(0, 2, 1) / np.sqrt(NUC_RANK)).reshape(NUC_BATCH, -1).astype(np.float32)
    idx = np.sort(rng.choice(n * n, size=int(NUC_FRACTION * n * n), replace=False))
    ops = rtt.SamplingOperator(idx, n * n, device=dev)
    sn = rtt.FISTA.create(ops, reg=rtt.NuclearRegularization(NUC_LAM, svt_shape=(n, n)),
                          iterations=ITERS, rho=RHO, rel_tol=0.0, track_residual=False)
    xs = t(X)
    Bn = ops.mv(xs).T.contiguous()

    def beats_zero_filled(name, op, B, xs):
        def check(x):
            zf = float(torch.linalg.norm(op.rmv(B.T) - xs) / torch.linalg.norm(xs))
            rec = float(torch.linalg.norm(x.T - xs) / torch.linalg.norm(xs))
            print(f"{name}: recon_rel_err {rec:.4f}, zero-filled Aᴴb {zf:.4f}")
            require(rec < zf, f"{name}: the reconstruction is no better than the zero-filled Aᴴb")
        return check

    name = f"nuclear_completion256_rank{NUC_RANK}_b{NUC_BATCH}"
    cells[name] = dict(
        solver=sn, B=Bn, truth=xs.T, launches={},
        reason="pgm_tv: fused path requires SeparableConvOperator",
        float64=lambda: (sn, ops.mv), unit="problems/s",
        check=beats_zero_filled(name, ops, Bn, xs))

    # (d) LLR on a cine series
    opc = cine_operator(dev, LLR_N, LLR_FRAMES)
    xs = t(cine_series(LLR_N, LLR_FRAMES, LLR_BATCH))
    Bc = opc.mv(xs).T.contiguous()
    llr = rtt.LLRRegularization(LLR_LAM, shape=(LLR_N, LLR_N), block_size=LLR_BLOCK)
    sl = rtt.FISTA.create(opc, reg=llr, iterations=LLR_ITERS, rho=RHO, rel_tol=0.0,
                          track_residual=False)
    blocks, _ = rtt.prox._block_partition(
        opc.rmv(Bc.T).reshape(LLR_BATCH, LLR_N, LLR_N, LLR_FRAMES), LLR_BLOCK)
    svd_drivers(blocks.reshape(-1, *blocks.shape[2:]).contiguous())
    svd_drivers(ops.rmv(Bn.T).reshape(NUC_BATCH, n, n).contiguous())  # Nuclear's matrices
    name = f"llr_cine{LLR_N}x{LLR_FRAMES}_b{LLR_BATCH}"
    cells[name] = dict(
        solver=sl, B=Bc, truth=xs.T, launches={},
        reason="fista_l1_dft: fused path requires SubsampledDFT2RealOperator",
        float64=lambda: (sl, opc.mv), unit="series/s",
        check=beats_zero_filled(name, opc, Bc, xs))

    # (e) PnP-ADMM with a CNN trained on the card
    pn, ch, steps, sigma = PNP_TRAIN
    losses = []
    t0 = time.perf_counter()
    params = denoisers.train_denoiser(pn, channels=ch, steps=steps, noise_sigma=sigma, seed=0,
                                      device=dev, losses=losses)
    print(f"train_denoiser: {steps} steps at {pn}² ({ch} channels) in "
          f"{time.perf_counter() - t0:.2f} s, loss {np.mean(losses[:10]):.5f} → "
          f"{np.mean(losses[-10:]):.5f}")
    require(np.mean(losses[-10:]) < np.mean(losses[:10]), "train_denoiser: the loss did not fall")
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    kern = np.outer(g, g) / np.outer(g, g).sum()

    def pnp(dtype):
        op = rtt.SeparableConvOperator.from_kernel(kern, im_shape=(N, N), dtype=dtype,
                                                   device=dev)
        model = denoisers.make_pnp_model({k: v.to(dtype) for k, v in params.items()})
        reg = rtt.PnPRegularization(0.3, model=model, shape=(N, N),
                                    input_transform=rtt.IdentityTransform)
        return rtt.ADMM.create(op, reg=reg, iterations=25, iterations_cg=6, rho=0.5), op

    sp, opp = pnp(torch.float32)
    xs = t(denoisers._phantom_batch(np.random.default_rng(51), N, PNP_BATCH).reshape(
        PNP_BATCH, -1))
    noise = 0.02 * np.random.default_rng(52).normal(size=(opp.out_size, PNP_BATCH))
    Bp = (opp.mv(xs).T + t(noise.astype(np.float32))).contiguous()
    name = f"pnp_admm_cnn_deblur256_b{PNP_BATCH}"

    def beats_cgnr(x, name=name, xs=xs):
        s_l2 = rtt.CGNR.create(opp, reg=rtt.L2Regularization(1e-6), iterations=12)
        x_l2 = rtt.solve_batched_fast(s_l2, Bp, warn=False)
        err = float(torch.linalg.norm(x.T - xs) / torch.linalg.norm(xs))
        err_l2 = float(torch.linalg.norm(x_l2.T - xs) / torch.linalg.norm(xs))
        print(f"{name}: recon_rel_err {err:.4f}, CGNR-L2 {err_l2:.4f}")
        require(err < err_l2, f"{name}: PnP {err:.4f} does not beat CGNR-L2 {err_l2:.4f}")

    cells[name] = dict(
        solver=sp, B=Bp, truth=xs.T, launches={},
        reason="admm_tv: fused path requires exactly one TVRegularization term",
        float64=lambda: (lambda s64, op64: (s64, op64.mv))(*pnp(torch.float64)),
        unit="problems/s", check=beats_cgnr)
    return cells


def api_phase(dev, flagship, B):
    """Phase 12 (f): the API on the card, on the flagship FISTA-TV."""
    import io

    import torch

    import rls_tpu_torch as rtt

    Bt = B.T.contiguous()
    x_solve = rtt.solve(flagship, B)
    seen = []
    cmp = rtt.CompareSolutionCallback(x_solve.T)
    x_cb = counted_run("solve_with_callbacks", lambda: rtt.solve_with_callbacks(
        flagship, Bt, callbacks=[cmp, lambda run, it: seen.append(it)]),
        {"prox_tv2d_fgp": ITERS})[0]
    require(seen == list(range(ITERS + 1)), f"solve_with_callbacks: iterations {seen}")
    require(torch.equal(x_cb.T, x_solve), "solve_with_callbacks: differs from solve")
    print(f"solve_with_callbacks: {ITERS + 1} calls, bit for bit solve; nrmsd to the solution "
          f"{float(cmp.results[0].mean()):.3e} → {float(cmp.results[-1].mean()):.3e}")
    B4 = B[:, :4].contiguous()
    x4, (xs4, met4, act4) = rtt.solve_trace(flagship, B4.T.contiguous())
    require(tuple(xs4.shape) == (4, ITERS, N * N) and bool(act4.all()),
            f"solve_trace: {tuple(xs4.shape)}, {int(act4.sum())} active steps")
    require(torch.equal(x4.T, rtt.solve(flagship, B4)) and torch.equal(xs4[:, -1], x4),
            "solve_trace: differs from solve")
    print(f"solve_trace: (4, {ITERS}, {N * N}) solutions, bit for bit solve")
    state = flagship.init(Bt)
    for _ in range(ITERS // 2):
        state = flagship.step(state)
    buf = io.BytesIO()
    rtt.save_state(buf, state)
    size = buf.tell()
    buf.seek(0)
    loaded = rtt.load_state(buf, flagship.init(Bt))
    x_res, _ = rtt.resume(flagship, loaded)
    require(torch.equal(x_res.T, x_solve), "checkpoint: the resumed solve differs from solve")
    print(f"checkpoint after {ITERS // 2} iterations ({size / 2**20:.1f} MiB): resumed bit for "
          "bit solve")
    s_name = rtt.create_linear_solver("fista", flagship.A, reg=flagship.reg, iterations=ITERS,
                                      rho=RHO, rel_tol=0.0, track_residual=False)
    B8 = B[:, :8].contiguous()
    x_a = counted_run("create_linear_solver('fista')", lambda: rtt.solve_batched_fast(s_name, B8),
                      {"fista_tv_fused": 1})[0]
    require(torch.equal(x_a, rtt.solve_batched_fast(flagship, B8)),
            "create_linear_solver: differs from the flagship solver")
    print("create_linear_solver('fista'): one fused launch, bit for bit the flagship's")
    logdir = os.path.join(ROOT, ".timing", "phase12_trace")
    with rtt.trace(logdir):
        rtt.solve_batched_fast(flagship, B8)
    path = os.path.join(logdir, "trace.json")
    require(os.path.getsize(path) > 0, "profiling.trace wrote no trace")
    timing = rtt.time_solver(rtt.solve_batched_fast, flagship, B8, reps=2)
    print(f"profiling.trace: {os.path.getsize(path)} bytes in {path}; time_solver: first call "
          f"{timing['compile_s']:.4f} s, then {timing['mean_s']:.4f} s per solve of 8")


def regularizer_phase(dev, flagship, B_flag, child):
    """Phase 12: (a) the Condat kernel, (b)-(e) the regularizer cells
    through solve_batched_fast, each held on two columns to a float64 solve
    on the card, with problems/s and the device's busy share, and (f) the
    API. Returns the Condat row's (launches on (b), error, plain ms, ms,
    bound)."""
    import torch

    import rls_tpu_torch as rtt

    card = card_line()
    err, plain_ms, ms, bnd = condat_kernel_phase(dev, child)
    launches = None
    for name, cell in regularizer_cells(dev).items():
        s, B = cell["solver"], cell["B"]
        fn = lambda: rtt.solve_batched_fast(s, B)  # noqa: E731
        x = counted_run(name, lambda: fallback(name, fn, cell["reason"]), cell["launches"])[0]
        if "prox_tv1d_condat" in cell["launches"]:
            launches = cell["launches"]["prox_tv1d_condat"]
        s64, mv64 = cell["float64"]()
        dt64 = torch.complex128 if B.is_complex() else torch.float64
        x64 = rtt.solve_batched_unrolled(s64, B[:, :2].to(dt64))
        spread = lambda: ulp_spread(lambda b: rtt.solve_batched_unrolled(s, b), B[:, :2])  # noqa: E731
        parity_cols(name, x, B, mv64, x64, cell["truth"], spread=spread)
        cell["check"](x)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            wall = cuda_ms(lambda: rtt.solve_batched_fast(s, B, warn=False), 1)
            rows = device_kernels(lambda: rtt.solve_batched_fast(s, B, warn=False))
        busy = sum(r[0] for r in rows)
        condat = [(k_ms, count) for k_ms, count, key in rows if "tv_condat" in key]
        if condat:
            print(f"{name}: the Condat kernel {condat[0][0] / condat[0][1]:.3f} ms a launch "
                  f"({condat[0][1]} launches, device time)")
        top = "; ".join(f"{key[:50]} {k_ms:.2f} ms ({count}×)" for k_ms, count, key in rows[:3])
        print(f"{name}: {B.shape[1] / (wall / 1e3):.1f} {cell['unit']} ({wall:.2f} ms per batch "
              f"of {B.shape[1]}; {card}); device busy {busy:.2f} ms ({100 * busy / wall:.1f}%): "
              f"{top}")
    api_phase(dev, flagship, B_flag)
    return launches, err, plain_ms, ms, bnd


def shard_mesh(dev):
    """Phase 13's mesh: every card, or this card twice where there is one."""
    import torch

    from rls_tpu_torch.parallel import make_mesh

    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    devices = [torch.device("cuda", i) for i in range(count)] if count > 1 else [dev, dev]
    return make_mesh(devices=devices)


def wall_ms(fn, reps):
    """Mean host milliseconds of `fn()` over `reps` runs, from a
    synchronized start to a synchronized end (every card of the mesh)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def sharded_timing(name, sharded, whole, reps, card):
    """Wall times of the sharded and the unsharded call, in turns (whole,
    sharded, sharded, whole), after one warm-up of each; printed with the
    card's name and power limit. Returns (sharded ms, unsharded ms)."""
    whole(), sharded()
    w1 = wall_ms(whole, reps)
    s1 = wall_ms(sharded, reps)
    s2 = wall_ms(sharded, reps)
    w2 = wall_ms(whole, reps)
    ms, ms_whole = (s1 + s2) / 2, (w1 + w2) / 2
    print(f"{name}: sharded {ms:.3f} ms, unsharded {ms_whole:.3f} ms wall per call "
          f"(sharded / unsharded {ms / ms_whole:.3f}; {card})")
    return ms, ms_whole


def parallel_phase(dev, flagship, B_flag, systems, pdhg_solver, draws):
    """Phase 13: rls_tpu_torch.parallel on the card. The mesh is every
    card, or this card twice where there is one (two shards in turn on its
    stream). Each sharded call runs with the launch counters set to 0 just
    before it and read just after: its kernel once per shard and no other.
    The fused TV solves (the flagship, BASELINE #3) are held bit for bit to
    the unsharded kernel on the whole batch; the dense and PDHG solves bit
    for bit where the shard's printed plan is the whole batch's, else to
    the kernel-vs-plain bar (DENSE_SPREAD × the unsharded kernel's own
    spread under b·(1 + 2⁻²³), DENSE_FLOOR; TOL_FUSED_MAX of max|x|); the
    composed FISTA-L1 through solve_batched_sharded and a row-sharded CGNR
    (the 1024 × 512 cell's rows in as many blocks as the mesh has entries)
    to their unsharded solve at that bar and to float64 at TOL_PARITY and
    TOL_RESIDUAL. Prints the wall time of each sharded call beside the
    unsharded one. Returns {case: (sharded ms, unsharded ms)}."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch import _build, parallel
    from rls_tpu_torch.kernels import admm_tv_fused as admm_fused
    from rls_tpu_torch.kernels import cgnr_fused
    from rls_tpu_torch.kernels import fista_tv_fused as fused
    from rls_tpu_torch.kernels import pdhg_fused as pdf
    from rls_tpu_torch.kernels import pgm_dense_fused as pd

    card = card_line()
    mesh = shard_mesh(dev)
    shards = mesh.size
    print(f"phase 13 mesh: {[str(d) for d in mesh.devices.flat]} on axis 'batch' "
          f"({shards} shards; {card})")
    times = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def counted(name, fn, kernel):
        launch_counts(reset=True)
        out = fn()
        torch.cuda.synchronize()
        got = launch_counts()
        print(f"launches ({name}): {got}")
        want = {kernel: shards} if kernel else {}
        require(got == {**{k: 0 for k in got}, **want},
                f"{name}: expected the launches {want} and no others")
        return out

    def bar_of(whole, B):
        """The kernel-vs-plain bar, from the unsharded call's own spread."""
        want, ulp = whole(B), whole(B * (1.0 + 2.0**-23))
        spread = float(torch.linalg.norm(ulp - want) / torch.linalg.norm(want))
        return max(DENSE_SPREAD * spread, DENSE_FLOOR), spread

    def held(name, got, want, bitwise, B, whole):
        same = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        norm = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        print(f"{name}: sharded against unsharded: bitwise {same}, max {err:.3e}, rel. 2-norm "
              f"{norm:.3e} (max|x| {float(want.abs().max()):.3f})")
        require(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
        if bitwise:
            require(same, f"{name}: the sharded solve is not bit for bit the unsharded one")
            return
        bar, spread = bar_of(whole, B)
        print(f"{name}: the unsharded solve under b(1 + 2^-23): rel. 2-norm {spread:.3e} "
              f"(bar {bar:.3e})")
        require(norm <= bar and err <= TOL_FUSED_MAX * float(want.abs().max()),
                f"{name}: the sharded solve disagrees: max {err:.3e}, rel. 2-norm {norm:.3e}")

    def fused_case(name, wrapper, whole, solver, B, kernel, plan_of, bitwise=None):
        k = B.shape[1] // shards
        plan, plan_shard = plan_of(B.shape[1]), plan_of(k)
        print(f"{name}: plan of the whole batch ({B.shape[1]}): {plan}")
        print(f"{name}: plan of a shard ({k}): {plan_shard}")
        got = counted(f"{name} sharded", lambda: wrapper(solver, B, mesh), kernel)
        want = whole(solver, B)
        held(name, got, want, plan == plan_shard if bitwise is None else bitwise, B,
             lambda b: whole(solver, b))
        times[name] = sharded_timing(name, lambda: wrapper(solver, B, mesh),
                                     lambda: whole(solver, B), 3, card)

    # the flagship (64 × 256², FISTA-TV, 50 × 10) and BASELINE #3 (16 ×
    # 256² distinct phantoms, ADMM-TV 12 × 6 × 8): bit for bit
    taps = flagship.A.taps_hw()

    def tv_plan(k):
        return fused.plan_on_card(torch.empty((k, N, N), device=dev), taps, "fista")[0]

    fused_case(f"fista_tv (flagship, {B_flag.shape[1]} x {N}^2)",
               parallel.solve_fista_tv_fused_sharded,
               rtt.solve_pgm_tv_fused, flagship, B_flag, "fista_tv_fused", tv_plan, True)
    admm = build_admm(ADMM256, dev)
    B_admm = admm.A.mv(t(phantoms(*ADMM256[:2]))).T.contiguous()

    def admm_plan(k):
        n = ADMM256[0]
        return admm_fused.plan_on_card(torch.empty((k, n, n), device=dev), taps)[0]

    fused_case("admm_tv (BASELINE #3, %d x %d^2)" % ADMM256[1::-1],
               parallel.solve_admm_tv_fused_sharded,
               rtt.solve_admm_tv_fused, admm, B_admm, "admm_tv_fused", admm_plan, True)

    # the dense cells and the PDHG cell: bit for bit where the plans agree
    a1k, b1k = map(t, systems["cgnr1k"])
    cgnr = rtt.CGNR.create(rtt.DenseOperator(a1k, device=dev),
                           reg=rtt.L2Regularization(CGNR1K_LAM), iterations=CGNR1K_ITERS)

    def cgnr_plan(k):
        return cgnr_fused.plan_cgnr(*a1k.shape, k, *_build.device_limits(dev.index or 0))

    fused_case("cgnr_l2_dense_1024x512_b64", parallel.solve_cgnr_fused_sharded,
               rtt.solve_cgnr_fused, cgnr, b1k, "cgnr_fused", cgnr_plan)
    a2b, b2b = map(t, systems["lasso"])
    lasso = rtt.FISTA.create(rtt.DenseOperator(a2b, device=dev),
                             reg=rtt.L1Regularization(LASSO_LAM), iterations=LASSO_ITERS,
                             rho=0.95 / float(np.linalg.norm(systems["lasso"][0], 2)) ** 2,
                             track_residual=False)

    def lasso_plan(k):
        return pd.card_plan(b2b[:, :k].T, a2b)

    fused_case("fista_l1_dense_cs_b16_fused", parallel.solve_pgm_dense_fused_sharded,
               rtt.solve_pgm_dense_fused, lasso, b2b, "pgm_dense_fused", lasso_plan)
    u = t(draws["admm"])
    B_pdhg = pdhg_solver.A.mv(u)[:, None].repeat(1, PDHG_BATCH).contiguous()
    taps_p = pdhg_solver.A.taps_hw()

    def pdhg_plan(k):
        return pdf.plan_on_card(torch.empty((k, PDHG_N, PDHG_N), device=dev), taps_p, "tv8")[0]

    fused_case("pdhg_tv8_deblur256_b16_fused", parallel.solve_pdhg_fused_sharded,
               rtt.solve_pdhg_fused, pdhg_solver, B_pdhg, "pdhg_fused", pdhg_plan)

    # the composed path: FISTA-L1 on the 1024 × 512 cell's system (100
    # iterations) through solve_batched_sharded, and a row-sharded CGNR of
    # that cell through solve_batched and solve_batched_fast's fallback
    x64_of = {}
    rho = 0.95 / float(np.linalg.norm(systems["cgnr1k"][0], 2)) ** 2

    def fista_l1(A):
        return rtt.FISTA.create(rtt.DenseOperator(A, device=dev), reg=rtt.L1Regularization(1e-4),
                                iterations=100, rho=rho, rel_tol=0.0, track_residual=False)

    fista = fista_l1(a1k)
    name = "composed FISTA-L1 1024x512 b64"
    got = counted(f"{name} sharded", lambda: parallel.solve_batched_sharded(fista, b1k, mesh),
                  None)
    held(name, got, rtt.solve_batched(fista, b1k), False, b1k,
         lambda b: rtt.solve_batched(fista, b))
    x64_of[name] = rtt.solve_batched(fista_l1(a1k.double()), b1k[:, :4].double())
    dense_parity(name, got, b1k, a1k.double(), x64_of[name])
    times[name] = sharded_timing(name, lambda: parallel.solve_batched_sharded(fista, b1k, mesh),
                                 lambda: rtt.solve_batched(fista, b1k), 1, card)

    rows_mesh = parallel.make_mesh(axis_names=("rows",), devices=list(mesh.devices.flat))
    op_rows = parallel.row_sharded_operator(a1k, rows_mesh, axis="rows")
    cg_rows = rtt.CGNR.create(op_rows, reg=rtt.L2Regularization(CGNR1K_LAM),
                              iterations=CGNR1K_ITERS)
    name = f"row-sharded CGNR 1024x512 b64 ({len(op_rows.blocks)} row blocks)"
    got = counted(name, lambda: rtt.solve_batched(cg_rows, b1k), None)
    whole = lambda b: rtt.solve_batched(cgnr, b)  # noqa: E731
    held(name, got, whole(b1k), False, b1k, whole)
    ds = rtt.DirectSolver.create(rtt.DenseOperator(a1k.double(), device=dev),
                                 reg=rtt.L2Regularization(CGNR1K_LAM))
    dense_parity(name, got, b1k, a1k.double(), rtt.solve_batched_unrolled(ds, b1k[:, :4].double()))
    fast = counted(f"{name} through solve_batched_fast", lambda: fallback(
        name, lambda: rtt.solve_batched_fast(cg_rows, b1k),
        "cgnr_dense: fused CGNR path requires a dense operator A"), None)
    require(bool(torch.isfinite(fast).all()), f"{name}: solve_batched_fast gave non-finite values")
    times[name] = sharded_timing(name, lambda: rtt.solve_batched(cg_rows, b1k),
                                 lambda: whole(b1k), 1, card)
    return times


def examples_phase(dev):
    """Phase 14: every examples/torch/*.py with --device cuda in a child
    process (four at a time), each of which must exit 0; each one's wall
    time printed."""
    import glob

    paths = sorted(glob.glob(os.path.join(ROOT, "examples", "torch", "[!_]*.py")))
    require(len(paths) == 13, f"phase 14: {len(paths)} torch examples, not 13")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
    pending, running, failed = list(paths), [], []
    t0 = time.perf_counter()
    try:
        while pending or running:
            while pending and len(running) < 4:
                path = pending.pop(0)
                proc = subprocess.Popen([sys.executable, path, "--device", dev.type], env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
                running.append((path, proc, time.perf_counter()))
            path, proc, start = running[0]
            try:
                out = proc.communicate(timeout=240)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                out = proc.communicate()[0]
            running.pop(0)
            print(f"example {os.path.basename(path)}: exit {proc.returncode}, "
                  f"{time.perf_counter() - start:.1f} s")
            if proc.returncode != 0:
                failed.append(os.path.basename(path))
                print(out[-3000:])
    finally:
        for _, proc, _ in running:
            proc.kill()
            proc.communicate()
    print(f"phase 14: {len(paths)} examples in {time.perf_counter() - t0:.1f} s")
    require(not failed, f"phase 14: examples failed: {failed}")


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

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = card_line()
    print(smi)
    # phase 12 (a)'s long signals: their plain version runs on the CPU, in a
    # process of its own, beside the whole run
    condat_child = start_condat_plain()
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
    # shapes the main path gives it on its resident and windowed routes and
    # TV_WIDE on its global route, each plan and route by the route counter
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(BATCH, N, N)).astype(np.float32)).to(dev)
    lam = torch.from_numpy(
        (RHO * LAM * rng.uniform(0.0, 400.0, size=BATCH)).astype(np.float32)
    ).to(dev)
    lam[0] = 0.0
    err_tv = 0.0
    tv_inputs = {}
    for k, (B1, H1, W1, tv1, route, own) in enumerate(TV_CHECKS):
        name = f"{B1} x {H1}x{W1}, {tv1} dual"
        xt = x if (B1, H1, W1) == (BATCH, N, N) else torch.from_numpy(
            np.random.default_rng(12 + k).normal(size=(B1, H1, W1)).astype(np.float32)).to(dev)
        tv_inputs[B1, H1, W1, tv1] = xt
        plan, held = tv_fgp.plan_on_card(xt, tv1)
        print(f"tv_fgp plan, {name}: {plan}; clusters resident at once: {held}")
        require((plan.route, plan.own) == (route, own),
                f"tv_fgp at {name}: {plan}, not the {route} route with x, pv and ph in {own} "
                "memory")
        tv_fgp.prox_tv2d_fgp.route_launches = {"resident": 0, "windows": 0, "global": 0}
        got = tv_fgp.prox_tv2d_fgp(xt.reshape(B1, -1), lam[:B1], (H1, W1),
                                   tv1).reshape(xt.shape)
        want = tv_fgp.prox_tv2d_fgp_torch(xt, lam[:B1], tv1)
        torch.cuda.synchronize()
        routes = {r: int(r == route) for r in ("resident", "windows", "global")}
        require(tv_fgp.prox_tv2d_fgp.route_launches == routes,
                f"tv_fgp at {name}: routes {tv_fgp.prox_tv2d_fgp.route_launches}, not {route}")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"tv_fgp, {name} ({route} route): max|kernel - plain| = {err:.3e} "
              f"(max|x| {scale:.3f})")
        require(torch.isfinite(got).all(), f"tv_fgp kernel gave non-finite values at {name}")
        require(err <= TOL_TV * scale, f"tv_fgp kernel disagrees at {name}: {err:.3e}")
        if route == "windows":
            # its own plain version too: the plain FGP on each window, the
            # interiors stitched (bit for bit the whole image's)
            win = tv_fgp.prox_tv2d_fgp_windows_torch(xt, lam[:B1], tv1, plan)
            require(torch.equal(win, want),
                    f"tv_fgp at {name}: the windowed plain version is not the whole image's")
            err_win = err
        elif route == "resident":
            err_tv = max(err_tv, err)  # the main path's shapes, for the kernel table
    # forced windows at 16 × 512²: the resident plan's bits
    xt, lam16 = tv_inputs[16, 512, 512, 10], lam[:16].contiguous()
    resident_sha = digest(tv_fgp.prox_tv2d_fgp(xt.reshape(16, -1), lam16, (512, 512),
                                               10).reshape(xt.shape))
    for interior, clusters, own in TV_FORCED_WINDOWS:
        plan, held = tv_fgp._card_plan(dev.index or 0, 16, 512, 512, clusters, own, 10, interior)
        sha = digest(tv_fgp._launch(xt, lam16, 10, clusters, own, interior))
        print(f"tv_fgp forced windows, 16 x 512x512: {plan}; clusters resident at once: "
              f"{held}; sha256 {sha} (resident {resident_sha})")
        require(plan.route == "windows" and sha == resident_sha,
                f"tv_fgp: forced windows of {interior} rows at 16 x 512² differ from the "
                "resident route")
    x1k, lam8 = tv_inputs[TV_1024], lam[:TV_1024[0]].contiguous()
    plain_win, ms_win = alternate_ms(
        lambda: tv_fgp.prox_tv2d_fgp_torch(x1k, lam8, TV_ITERS),
        lambda: tv_fgp.prox_tv2d_fgp(x1k.reshape(TV_1024[0], -1), lam8, TV_1024[1:3],
                                     TV_ITERS),
        reps=5,
    )
    print(f"tv_fgp windows, {TV_WINDOWS_ROW}: kernel {ms_win:.3f} ms, plain {plain_win:.3f} ms")
    del tv_inputs, x1k
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

    # 3h. the FFT kernels against their plain versions, at powers of two
    # (their outputs' sha256 beside the parent tree's) and at sides with odd
    # factors (the mixed-radix FFT)
    t3h = time.perf_counter()
    fft = fft_kernel_phase(dev, draws)
    check_fft_digests(fft["digests"])
    print(f"phase 3h: {time.perf_counter() - t3h:.1f} s")

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
    tv_fgp.prox_tv2d_fgp.route_launches = {"resident": 0, "windows": 0, "global": 0}
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
    require(tv_fgp.prox_tv2d_fgp.route_launches == {"resident": ITERS, "windows": 0,
                                                    "global": 0},
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

    # 5b. the composed FISTA-TV solve at 1024² × 8 (the fista_tv_1024_tiled_b8
    # cell's problems) through solve_batched_unrolled: row 1 on its windowed
    # route, ITERS launches and no other; counts start at 0 here
    n1k = TV_1024[1]
    s1k = build_solver(n1k, dev)
    xs1k = torch.from_numpy(imgs1024).to(dev)
    B1k = s1k.A.mv(xs1k).T.contiguous()
    launch_counts(reset=True)
    x1k = rtt.solve_batched_unrolled(s1k, B1k)
    torch.cuda.synchronize()
    launches_win = tv_fgp.prox_tv2d_fgp.route_launches["windows"]
    counts = launch_counts()
    print(f"launches (composed 1024² x {B1k.shape[1]}): {counts}, tv_fgp routes "
          f"{tv_fgp.prox_tv2d_fgp.route_launches}")
    require(counts == {**dict.fromkeys(counts, 0), "prox_tv2d_fgp": ITERS}
            and tv_fgp.prox_tv2d_fgp.route_launches == {"resident": 0, "windows": ITERS,
                                                        "global": 0},
            f"the composed 1024² solve: {counts}, not {ITERS} launches of row 1 on its "
            "windowed route")
    require(tuple(x1k.shape) == (n1k * n1k, B1k.shape[1]), f"1024²: bad result {x1k.shape}")
    # two columns against a float64 solve of the plain version on the card
    s64 = build_solver(n1k, dev, dtype=torch.float64)
    x0_64 = s64.A.rmv_stencil(B1k[:, :2].T.double()).reshape(2, n1k, n1k)
    scal64, tab64, t2_64 = fused.kernel_args(x0_64, RHO, LAM, "fista", ITERS, TV_ITERS,
                                             dtype=np.float64)
    x64 = tiled.fista_tv_tiled_torch(x0_64, scal64, tab64, t2_64, taps)[0].reshape(2, -1)
    parity_f64("fista_tv_1024 composed (row 1 windows)", x1k, B1k, xs1k, s64.A, x64)
    ms1k = cuda_ms(lambda: rtt.solve_batched_unrolled(s1k, B1k), reps=1)
    print(f"fista_tv_1024 composed solve_batched_unrolled: {ms1k:.2f} ms per batch of "
          f"{B1k.shape[1]}")
    del s64, x0_64, x64, x1k

    # 6. the ADMM-TV cells through the public API
    for name, cell, imgs, want, composed in (
        ("admm_tv_deblur256_b16_fused", ADMM256,
         np.broadcast_to(img_admm, (ADMM256[1], img_admm.size)), {"admm_tv_fused": 1}, True),
        ("admm_tv_512_tiled_b16", ADMM512, imgs512, {"admm_tv_tiled": 1}, False),
    ):
        kernel = next(iter(want))
        counts, library[kernel] = admm_cell_phase(name, cell, dev, imgs, want, composed)
        admm[kernel]["launches"] = counts[kernel]

    # 8. the dense cells through the public API
    dense_launched, dense_library = dense_cell_phase(dev, systems)
    library.update(dense_library)

    # 9. the compressed-sensing and SENSE cells through the public API
    t9 = time.perf_counter()
    fft_launched, composed_ms, composed_dev = fft_cell_phase(dev, draws)
    print(f"phase 9: {time.perf_counter() - t9:.1f} s")

    # 10. the PDHG and Kaczmarz cells through the public API
    kernel_launched, kernel_composed = kernel_cell_phase(dev, draws, pdhg_solver, kz)

    # 11. the composite, decorator, DAX and operator path
    t11 = time.perf_counter()
    composite_phase(dev, draws, solver, B, systems, pdhg_solver, kz)
    print(f"phase 11: {time.perf_counter() - t11:.1f} s")

    # 12. the last regularizers and the API surface
    t12 = time.perf_counter()
    condat = regularizer_phase(dev, solver, B, condat_child)
    print(f"phase 12: {time.perf_counter() - t12:.1f} s")

    # 13. rls_tpu_torch.parallel: batch shards and row blocks on the card
    t13 = time.perf_counter()
    parallel_phase(dev, solver, B, systems, pdhg_solver, draws)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s")

    # 14. the torch examples, each in a child process
    t14 = time.perf_counter()
    examples_phase(dev)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s")
    print(f"phases 3-6, 8-14: {time.perf_counter() - t_start:.1f} s")

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
        TV_WINDOWS_ROW: bound(fgp_loop_ops(TV_ITERS) * math.prod(TV_1024[:3]),
                              f32 * (2 * math.prod(TV_1024[:3]) + TV_1024[0])),
        "fista_tv_fused": bound(fista_ops * flag_px, f32 * 2 * flag_px),
        "fista_tv_tiled": bound(fista_ops * n5px, f32 * 2 * n5px),
    }
    for name, cell in (("admm_tv_fused", ADMM256), ("admm_tv_tiled", ADMM512)):
        n, batch, _, iters, _, tv = cell
        ops = sum(admm_ops(ntap_h, ntap_w, tv, iters, v, False) for v in admm[name]["live"])
        bounds[name] = bound(ops * n * n, f32 * (2 * batch * n * n + batch))
        plan = admm[name]["plan"]
        print(f"{name} at {n}² x {batch}: {plan.route} route ({plan.clusters} CTAs per problem, "
              f"{plan.rows} rows per band), {admm[name]['launches']} launch(es) on the main "
              f"path, kernel {admm[name]['ms'][1]:.3f} ms, bound {bounds[name][0]:.4f} ms")
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
    bounds[L1_ROW] = bound(CS_BATCH * dft_ops(cs_hw, CS_ITERS),
                           f32 * ((2 * CS_BATCH + 1) * cs_hw + 2 * CS_BATCH))
    # row 8's grid route at 16 × 512² (phase 3h, where it has its bound)
    g8 = fft["fista_l1_dft_fused grid b16"]
    bounds[GRID_ROW] = g8["bound"]
    print(f"{GRID_ROW}: kernel table row from phase 3h's 16 × 512² and phase 9's "
          f"fista_l1_cs_dft512_b16 (composed device time "
          f"{composed_dev['fista_l1_cs_dft512_b16']:.3f} ms by torch.profiler)")
    s_bytes = f32 * ((4 * SENSE_SLICES + 2 * SENSE_C + 1) * s_hw)
    bounds["sense_fused"] = bound(SENSE_SLICES * sense_ops(s_hw, SENSE_C, SENSE_ITERS),
                                  s_bytes + f32 * 2 * SENSE_SLICES)
    sb_live = fft["splitbregman_fused"]["live"].tolist()
    bounds["splitbregman_fused"] = bound(
        sum(sb_ops(s_hw, SENSE_C, *SB_SCHED[:2], SB_TV, v) for v in sb_live),
        s_bytes + f32 * 4 * SENSE_SLICES)
    # the same at the mixed-radix FFT's shapes of the table (16 × 320², 8 ×
    # 192²), from phase 3h, where every mixed-radix case has its bound
    m8, m9, m10 = (fft[f"{k} {hw}"] for k, hw in (
        ("fista_l1_dft_fused", "320x320"), ("sense_fused", "192x192"),
        ("splitbregman_fused", "192x192")))
    for name, m in zip(MIXED_ROWS, (m8, m9, m10)):
        bounds[name] = m["bound"]
    for name, cell in zip(MIXED_ROWS, MIXED_CELLS):
        print(f"{name}: kernel table row from phase 3h's timed shape and phase 9's {cell} "
              f"(composed device time {composed_dev[cell]:.3f} ms by torch.profiler)")
    print(f"fista_l1_dft_fused at 320² x {CS_BATCH}: composed device time in phase 3h "
          f"{m8['composed_device_ms']:.3f} ms")
    # row 11 at the cell's shapes (x0 in, x out, the scalars); rows 12a
    # and 12b at their timed shapes: every input read once (A, or the
    # distinct rows the solve visits, x, vl, u, denom, eps, the index
    # list), every output written once (x, vl)
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
    # row 13, the greedy solve: A (the refresh reads all of it) and the rows
    # of Gt the solve draws, denom and norms read once; b and ε in; x, vl,
    # r and the drawn rows out
    S, T, distinct = kacz["kaczmarz_greedy_solve"]["visited"]
    bounds["kaczmarz_greedy_solve"] = bound(
        p * greedy_solve_ops(m, n, S, T),
        f32 * (m * n + distinct * m + 2 * m + p * (n + 3 * m + 1 + T * S)))
    # the Condat kernel at the main path's shape (phase 12 (b)'s prox, 16 ×
    # 256² along the rows): each entry read once and written once, λ read
    bounds["tv_condat"] = condat[4]
    rows = (
        ("tv_fgp", "tv_fgp.cu", "rls_tpu/kernels/tv_pallas.py:69", launches_tv, err_tv,
         (plain_tv, ms_tv)),
        (TV_WINDOWS_ROW, "tv_fgp.cu", "rls_tpu/kernels/tv_pallas.py:69", launches_win, err_win,
         (plain_win, ms_win)),
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
        ("pgm_dense_fused", "pgm_dense_grid.cu", "rls_tpu/kernels/pgm_dense_fused.py:355",
         dense_launched["pgm_dense_fused"], dense["pgm_dense_fused"]["err"],
         dense["pgm_dense_fused"]["ms"]),
        ("pgm_dense_fused_cplx", "pgm_dense_grid_cplx.cu",
         "rls_tpu/kernels/pgm_dense_fused.py:458",
         dense_launched["pgm_dense_fused_cplx"], dense["pgm_dense_fused_cplx"]["err"],
         dense["pgm_dense_fused_cplx"]["ms"]),
        (L1_ROW, "fista_l1_dft_fused.cu",
         "rls_tpu/kernels/fista_l1_dft_fused.py:110", fft_launched["fista_l1_cs_dft256_b16"][1],
         fft["fista_l1_dft_fused"]["err"], fft["fista_l1_dft_fused"]["ms"]),
        (GRID_ROW, "fista_l1_dft_fused.cu", "rls_tpu/kernels/fista_l1_dft_fused.py:110",
         fft_launched["fista_l1_cs_dft512_b16"][1], g8["err"], g8["ms"]),
        ("sense_fused", "sense_fused.cu", "rls_tpu/kernels/sense_fused.py:85",
         fft_launched["fista_l21_sense128_6coil_b8"][1], fft["sense_fused"]["err"],
         fft["sense_fused"]["ms"]),
        ("splitbregman_fused", "splitbregman_fused.cu",
         "rls_tpu/kernels/splitbregman_fused.py:217",
         fft_launched["splitbregman_sense128_6coil_b8"][1], fft["splitbregman_fused"]["err"],
         fft["splitbregman_fused"]["ms"]),
        (MIXED_ROWS[0], "fista_l1_dft_fused.cu", "rls_tpu/kernels/fista_l1_dft_fused.py:110",
         fft_launched[MIXED_CELLS[0]][1], m8["err"], m8["ms"]),
        (MIXED_ROWS[1], "sense_fused.cu", "rls_tpu/kernels/sense_fused.py:85",
         fft_launched[MIXED_CELLS[1]][1], m9["err"], m9["ms"]),
        (MIXED_ROWS[2], "splitbregman_fused.cu", "rls_tpu/kernels/splitbregman_fused.py:217",
         fft_launched[MIXED_CELLS[2]][1], m10["err"], m10["ms"]),
        ("pdhg_fused", "pdhg_fused.cu", "rls_tpu/kernels/pdhg_fused.py:185",
         kernel_launched["pdhg_fused"], pdhg["err"], pdhg["ms"]),
        ("kaczmarz_sweep", "kaczmarz.cu", "rls_tpu/kernels/kaczmarz_pallas.py:72",
         kacz["kaczmarz_sweep"]["launches"], kacz["kaczmarz_sweep"]["err"],
         kacz["kaczmarz_sweep"]["ms"]),
        ("kaczmarz_solve", "kaczmarz.cu", "rls_tpu/kernels/kaczmarz_pallas.py:206",
         kernel_launched["kaczmarz_solve"], kacz["kaczmarz_solve"]["err"],
         kacz["kaczmarz_solve"]["ms"]),
        ("kaczmarz_greedy_solve", "kaczmarz_greedy.cu", "rls_tpu/kernels/kaczmarz_greedy.py:164",
         kernel_launched["kaczmarz_greedy_solve"], kacz["kaczmarz_greedy_solve"]["err"],
         kacz["kaczmarz_greedy_solve"]["ms"]),
        ("tv_condat", "tv_condat.cu",
         "rls_tpu/models/tv_condat.py:25 (no Pallas counterpart: a vmapped lax.while_loop)",
         condat[0], condat[1], (condat[2], condat[3])),
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
    # Kaczmarz rows (one sweep, the tall cell, the 20-sweep greedy solve)
    library.update({
        "fista_tv_fused": flagship_ms["solve_batched_unrolled"],
        L1_ROW: composed_ms["fista_l1_cs_dft256_b16"],
        GRID_ROW: composed_ms["fista_l1_cs_dft512_b16"],
        "sense_fused": composed_ms["fista_l21_sense128_6coil_b8"],
        "splitbregman_fused": composed_ms["splitbregman_sense128_6coil_b8"],
        **{row: composed_ms[cell] for row, cell in zip(MIXED_ROWS, MIXED_CELLS)},
        "pdhg_fused": kernel_composed["pdhg_fused"],
        "kaczmarz_sweep": kacz["kaczmarz_sweep"]["library_ms"],
        "kaczmarz_solve": kernel_composed["kaczmarz_solve"],
        "kaczmarz_greedy_solve": kacz["kaczmarz_greedy_solve"]["library_ms"],
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
    resident route (or the SENSE kernels' split route) or where there is no
    planner (or row 8's grid route), ``phase_clocks(*clock_args,
    **clock_kw)``: the SM clocks of
    CTA 0 by phase."""

    def probe():
        got, resident = {}, True
        if hasattr(kernel, "plan_on_card"):
            plan = kernel.plan_on_card(*plan_args)
            plan, extra = ((plan[0], {"resident_clusters": plan[1]}) if isinstance(plan, tuple)
                           else (plan, {}))
            got["plan"] = dict(vars(plan), **extra)
            resident = plan.route in ("resident", "split", "grid")
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
    through solve_batched_fast. Then the 192² cell in turns with its
    composed solve_batched_unrolled (both device times by torch.profiler,
    the kernel's phase clocks), 8 slices at each SPLIT_SHAPES shape, and
    the forced plans of SPLIT_SWEEP at 192² and SPLIT_SWEEP_128 at the cell
    (``split_cases``); 2 slices of 512² (the grid route) in turns with
    the composed solve, both device times, the clocks and the bound, the
    forced grid plans, 1 × 1024² and the grid route forced beside the split
    route at 384² and 448² (``time_sense512``)."""
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
    # the 192² cell (splitbregman_sense192_6coil_b8) in turns with its
    # composed solve, both device times, the phase clocks; then the split
    # shapes and the forced plans at 192²
    op192, b192, x192, coils192 = sense192_cell(dev)
    s192 = splitbregman_solver(op192, dev)
    B192 = b192.T.contiguous()
    args192 = (x192, op192.mask, *coils192, SB_RHO, SB_RHO, SB_LAM, SB_LAM, *SB_SCHED, SB_TV,
               SB_TOL)
    cell = [
        ("192² row 10 splitbregman_fused", lambda: k10.splitbregman_l1_tv_fused(*args192), 1,
         plan_probe(k10, (x192, SENSE_C), *args192)),
        ("192² row 10 composed solve_batched_unrolled",
         lambda: rtt.solve_batched_unrolled(s192, B192), 1),
    ]
    time_cases(out, cell, in_turns=True)
    device_ms(out, cell)

    def row10(x, m, cr, ci, clock_args=False, **kw):
        args = (x, m, cr, ci, SB_RHO, SB_RHO, SB_LAM, SB_LAM, *SB_SCHED, SB_TV, SB_TOL)
        return (args, kw) if clock_args else k10.splitbregman_l1_tv_fused(*args, **kw)

    time_cases(out, split_cases(dev, k10, row10, (x192, op192.mask, coils192),
                                (x0, op.mask, coils)))
    time_sense512(dev, out, "splitbregman")


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
    phase 3h), 1 and 64 problems of 256² and 16 of 128²; then the cell as solve_batched_fast runs it, in turns
    with its composed solve_batched_unrolled (torch.fft) and the kernel,
    with the composed solve's device time by torch.profiler (the sum of its
    kernels' times, which host delays do not move) beside the kernel's;
    the shapes past a cluster of 16 (``time_l1dft_grid``); the uneven
    shapes of phase 3h (``time_l1dft_uneven``: 2 × 97 × 128, 4 ×
    225², 16 × 300², 16 × 320 × 260, and 16 × 320², 4 × 64 × 448 as even
    controls, with their sha256 and the composed solve's device time, and
    the forced-size sweep at 97 × 128, 225², 300² and 320²); row 9
    (FISTA-L21-SENSE on the 8 SENSE slices) as a control, with its cell's
    composed solve (wall and device time)."""
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
    ):
        args = (x, mask, RHO, lam, CS_ITERS)
        cases.append((name, lambda a=args: k8.fista_l1_dft_fused(*a), reps,
                      plan_probe(k8, (x,), *args)))
    time_cases(out, cases)
    row8 = cs_cell_solves(dev, op, img2)
    time_cases(out, row8, in_turns=True)
    device_ms(out, (row8[0], row8[2]))
    time_l1dft_grid(dev, out)
    time_l1dft_uneven(dev, out)
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


# row 8's shapes past a cluster of 16 (the grid route; the global route of
# a tree before it) that --time-fista-l1-dft times, (B, H, W), and the
# forced grid plans (team, slots) it sweeps where the tree takes `grid=`
GRID_L1DFT = ((4, 512, 512), (4, 640, 640), (2, 1024, 1024), (16, 512, 512), (4, 448, 448))
GRID_SWEEP = {(16, 512, 512): ((16, 8), (33, 4), (66, 2)), (4, 512, 512): ((66, 2), (132, 1)),
              (2, 1024, 1024): ((132, 1),)}


def l1dft_case(dev, mb, mh, mw):
    """Row 8's case at (mb, mh, mw) as phase 3h's mixed-radix cases make
    it (a 35 % mask and random images from default_rng(mh · mw), λ per
    problem): dict of x0, mask, lam, the composed solver and its B."""
    import torch

    import rls_tpu_torch as rtt

    rng = np.random.default_rng(mh * mw)
    op = rtt.SubsampledDFT2RealOperator.from_mask(rng.uniform(size=(mh, mw)) < 0.35, (mh, mw),
                                                   device=dev)
    b = op.mv(torch.from_numpy(rng.normal(size=(mb, mh * mw)).astype(np.float32)).to(dev))
    solver = rtt.FISTA.create(op, reg=rtt.L1Regularization(CS_LAM), iterations=CS_ITERS,
                              rho=RHO, rel_tol=0.0, track_residual=False)
    return dict(x0=op.rmv(b).reshape(mb, mh, mw), mask=op.mask,
                lam=torch.linspace(0.5, 2.0, mb, device=dev) * CS_LAM, solver=solver,
                B=b.T.contiguous())


def time_l1dft_grid(dev, out):
    """--time-fista-l1-dft's shapes past a cluster of 16 (GRID_L1DFT): each
    kernel alone (CUDA events, three readings, with its plan and CTA 0's
    clocks where the tree has a timer on its route), its device time and
    the composed solve's by torch.profiler, its output's sha256 (the
    parent's global route gives the same bits) and its bound; then the
    forced plans of GRID_SWEEP in turns, where the tree's wrapper takes
    `grid=`."""
    import inspect

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import fista_l1_dft_fused as k8

    cases = {shape: l1dft_case(dev, *shape) for shape in GRID_L1DFT}
    timed = []
    for (mb, mh, mw), c in cases.items():
        key = f"grid shape {mb} x {mh}x{mw}"
        args = (c["x0"], c["mask"], RHO, c["lam"], CS_ITERS)
        timed.append((key, lambda a=args: k8.fista_l1_dft_fused(*a), 1,
                      plan_probe(k8, (c["x0"],), *args)))
        out[f"{key} sha256"] = digest(k8.fista_l1_dft_fused(*args))
        out[f"{key} bound"] = bound(mb * dft_ops(mh * mw, CS_ITERS),
                                    4 * ((2 * mb + 1) * mh * mw + 2 * mb))
    time_cases(out, timed)
    device_ms(out, timed)
    device_ms(out, [(f"grid shape {mb} x {mh}x{mw} composed solve_batched_unrolled",
                     lambda c=c: rtt.solve_batched_unrolled(c["solver"], c["B"]))
                    for (mb, mh, mw), c in cases.items()])
    if "grid" not in inspect.signature(k8.fista_l1_dft_fused).parameters:
        return
    sweep = []
    for shape, grids in GRID_SWEEP.items():
        c = cases[shape]
        for g in grids:
            args = (c["x0"], c["mask"], RHO, c["lam"], CS_ITERS)
            sweep.append((f"grid shape {shape[0]} x {shape[1]}x{shape[2]} forced {g}",
                          lambda a=args, g=g: k8.fista_l1_dft_fused(*a, grid=g), 1,
                          lambda a=args, g=g: {"clocks of CTA 0 by phase": k8.phase_clocks(
                              *a, grid=g)}))
    time_cases(out, sweep, in_turns=True)
    device_ms(out, sweep)


# row 8's uneven shapes of phase 3h (MIXED_L1DFT) that --time-fista-l1-dft
# times beside the parent tree's global route, with 320² and 64 × 448 (even
# plans on the mixed-radix kernel) as controls, and the shapes at which it
# sweeps every cluster size the kernel takes (where the tree takes
# `clusters=`): 97 × 128, 225² and 300², which have no even size, and
# 320², whose one even size (16) meets the uneven ones
UNEVEN_L1DFT = ("97x128", "225x225", "300x300", "320x260", "320x320", "64x448")
L1DFT_SWEEP = ("97x128", "225x225", "300x300", "320x320")


def time_l1dft_uneven(dev, out):
    """--time-fista-l1-dft's uneven shapes and their controls: each kernel
    alone with its plan and CTA 0's clocks (where the tree plans a
    cluster), its output's sha256 (the parent's global route gives the
    same bits), and the
    composed solve's device time by torch.profiler; then every size of
    ``cluster_sizes`` forced at L1DFT_SWEEP, in turns, where the tree's
    wrapper takes `clusters=`."""
    import inspect

    import rls_tpu_torch as rtt
    from rls_tpu_torch import _build
    from rls_tpu_torch.kernels import fista_l1_dft_fused as k8

    cases = {c["key"].split()[-1]: c for c in mixed_fft_cases(dev, rows=("fista_l1",))}
    timed = []
    for key in UNEVEN_L1DFT:
        c = cases[key]
        args = (c["x0"], c["mask"], RHO, c["lam"], CS_ITERS)
        timed.append((f"{key} x {c['x0'].shape[0]}", lambda a=args: k8.fista_l1_dft_fused(*a), 2,
                      plan_probe(k8, (c["x0"],), *args)))
        out[f"{key} sha256"] = digest(k8.fista_l1_dft_fused(*args))
    time_cases(out, timed)
    device_ms(out, [(f"{key} composed solve_batched_unrolled",
                     lambda c=cases[key]: rtt.solve_batched_unrolled(c["solver"], c["B"]))
                    for key in UNEVEN_L1DFT])
    if "clusters" not in inspect.signature(k8.fista_l1_dft_fused).parameters:
        return
    limits = _build.device_limits(dev.index or 0)
    sweep = []
    for key in L1DFT_SWEEP:
        c = cases[key]
        B, H, W = c["x0"].shape
        for n in k8.cluster_sizes(H, W, *limits):
            sweep.append((f"{key} x {B} forced c={n}", lambda c=c, n=n: k8.fista_l1_dft_fused(
                c["x0"], c["mask"], RHO, c["lam"], CS_ITERS, clusters=n), 2))
    time_cases(out, sweep, in_turns=True)


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


# The shapes at which the SENSE kernels' planners take the split route
# (teams of 3, 3, 5, 8, 11 and 15 CTAs a coil at 6 coils), timed on 8
# slices by --time-sense and --time-splitbregman beside the parent tree's
# global route; and the forced plans (team, coils a round) swept at 192²
SPLIT_SHAPES = ((192, 192), (256, 128), (256, 256), (320, 320), (384, 384), (448, 448))
SPLIT_SWEEP = ((3, 3), (3, 2), (3, 1), (4, 3), (4, 2), (5, 3), (5, 2), (6, 2), (8, 2), (6, 1),
               (12, 1), (16, 1))
# the split route forced at the 128² SENSE cells, which the planner keeps
# resident: two CTAs a coil (ROADMAP follow-up a), one round and two
SPLIT_SWEEP_128 = ((2, 6), (2, 3))


def split_cases(dev, module, kernel, sense192, sense128):
    """Cases of :func:`time_cases` for row 9 or 10 (`module`; `kernel(x,
    mask, cr, ci, **kw)` its call) on the split route: SENSE_SLICES slices
    of 6 coils at each SPLIT_SHAPES shape (192²: the cell's problem
    `sense192` = (x0, mask, coils), the others random), each with its plan
    and phase clocks, then each forced plan of SPLIT_SWEEP at 192² and of
    SPLIT_SWEEP_128 at the 128² cell (`sense128`) where the tree under test
    takes a forced plan (a parent tree runs every shape on the route its
    planner takes)."""
    import inspect

    import torch

    rng = np.random.default_rng(23)
    cases = []
    for H, W in SPLIT_SHAPES:
        if (H, W) == (192, 192):
            x, m, (cr, ci) = sense192
        else:
            x = torch.from_numpy(rng.normal(size=(SENSE_SLICES, 2, H, W)).astype(np.float32))
            x = x.to(dev)
            m = torch.from_numpy((rng.uniform(size=(H, W)) < 0.45).astype(np.float32)).to(dev)
            maps = coil_maps(rng, SENSE_C, max(H, W))[:, :H, :W]
            cr, ci = (torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
                      for v in (maps.real, maps.imag))
        args = (x, m, cr, ci)
        clock_args, clock_kw = kernel(*args, clock_args=True)
        cases.append((f"split shape {H}x{W}", lambda a=args: kernel(*a), 1,
                      plan_probe(module, (x, SENSE_C), *clock_args, **clock_kw)))
    if "split" not in inspect.signature(module.plan_on_card).parameters:
        return cases
    for (x, m, (cr, ci)), sweep in ((sense192, SPLIT_SWEEP), (sense128, SPLIT_SWEEP_128)):
        for split in sweep:
            args = (x, m, cr, ci)
            clock_args, clock_kw = kernel(*args, clock_args=True, split=split)
            cases.append((f"{x.shape[-2]}x{x.shape[-1]} forced team {split[0]}, {split[1]} coils "
                          f"a round", lambda a=args, sp=split: kernel(*a, split=sp), 1,
                          plan_probe(module, (x, SENSE_C, split), *clock_args, **clock_kw)))
    return cases


def sense192_cell(dev):
    """Phase 9's 192² SENSE cell (fista_l21_sense192_6coil_b8 and
    splitbregman_sense192_6coil_b8): the operator, b (8 slices), x0 =
    Aᴴb (8, 2, 192, 192) and the coils."""
    import torch

    import rls_tpu_torch as rtt

    maps, mask, X = sense_problem(192)
    op = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (192, 192), device=dev)
    b = op.mv(torch.from_numpy(X).to(dev))
    return op, b, op.rmv(b).reshape(SENSE_SLICES, 2, 192, 192), (op.coils_r, op.coils_i)


def sense_grid_case(dev, n, slices, seed):
    """`slices` slices of n² with 6 coils of random maps and a 45 % mask
    (default_rng(`seed`)): the operator, b, x0 = Aᴴb (slices, 2, n, n) and
    the coils."""
    import torch

    import rls_tpu_torch as rtt

    rng = np.random.default_rng(seed)
    maps = rng.normal(size=(SENSE_C, n, n)) + 1j * rng.normal(size=(SENSE_C, n, n))
    maps /= np.sqrt((np.abs(maps) ** 2).sum(0))
    mask = (rng.uniform(size=(n, n)) < 0.45).astype(np.float32)
    op = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (n, n), device=dev)
    b = op.mv(torch.from_numpy(rng.normal(size=(slices, 2 * n * n)).astype(np.float32)).to(dev))
    return op, b, op.rmv(b).reshape(slices, 2, n, n), (op.coils_r, op.coils_i)


def sense512_case(dev):
    """Phase 3h's case of rows 9 and 10 past a team of 16 (their grid
    route): 2 slices of 512² (``sense_grid_case``, default_rng(12))."""
    return sense_grid_case(dev, 512, 2, 12)


def sense1024_case(dev, bump):
    """Phase 3h's case of rows 9 and 10 in two rounds of coils: 1 slice of
    1024² (``sense_grid_case``, default_rng(13)): x0 = Aᴴb (1, 2, 1024, 1024),
    the same of b·`bump`, the operator, the coils and the DFT tables."""
    from rls_tpu_torch.kernels import _dft_common as dc

    op, b, x0, coils = sense_grid_case(dev, 1024, 1, 13)
    return x0, op.rmv(b * bump).reshape(x0.shape), op, coils, dc.dft_tables(op.mask)


def grid_repeats(op, x0, k9, k10, launches=20):
    """Rows 9 and 10 at 2 × 512² on the grid route, `launches` launches
    each (row 10 on a short schedule, 1 × 2 × 3, TV 2), every output and
    row 10's live CG steps required equal to the first launch's, the route
    counters required to read `launches` grid launches: a race between the
    CTAs of a team would show as a launch that differs. Returns the count
    of launches of each row."""
    import torch

    coils = (op.coils_r, op.coils_i)
    got = {}
    for fn, call in (
            (k9.fista_l21_sense_fused,
             lambda: (k9.fista_l21_sense_fused(x0, op.mask, *coils, RHO, SENSE_LAM,
                                               SENSE_ITERS), None)),
            (k10.splitbregman_l1_tv_fused,
             lambda: k10.splitbregman_l1_tv_fused(x0, op.mask, *coils, SB_RHO, SB_RHO, SB_LAM,
                                                  SB_LAM, 1, 2, 3, 2, SB_TOL,
                                                  with_counts=True))):
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        first, first_counts = call()
        same = True
        for _ in range(launches - 1):
            x, counts = call()
            same = same and bool(torch.equal(x, first)) and (
                counts is None or counts.tolist() == first_counts.tolist())
        name = fn.__name__
        print(f"{name}[grid route, 512², {launches} launches]: bit for bit {same}, launches by "
              f"route {fn.route_launches}")
        require(same, f"{name}: the grid route gave other bits in {launches} launches")
        require(fn.route_launches == {"resident": 0, "split": 0, "grid": launches},
                f"{name}: expected {launches} grid launches, got {fn.route_launches}")
        got[name] = launches
    return got


# the forced grid plans (team, slots, coils a round) of rows 9 and 10 swept
# at 2 × 512² by --time-sense and --time-splitbregman (the planner's is the
# first), and the shapes of the split route at which the grid route is
# forced beside it (SENSE_SLICES slices, 6 coils)
GRID_SWEEP_SENSE = ((66, 2, 6), (66, 2, 3), (66, 2, 2), (64, 2, 6), (33, 2, 6), (132, 1, 6),
                    (132, 1, 3))
GRID_BESIDE_SPLIT = (384, 448)


def sense_grid_plan(module, x0):
    """(team, slots, coils a round) of the grid plan that `module`'s
    planner would make for x0 ((B, 2, H, W), SENSE_C coils) on this card
    (``sense_fused.plan_grid``), for forcing it where the planner takes
    another route."""
    from rls_tpu_torch import _build
    from rls_tpu_torch.kernels import sense_fused as k9

    B, _, H, W = x0.shape
    _, smem_max = _build.device_limits(x0.device.index or 0)
    head, phases = ((0, len(k9.GRID_PHASES)) if module is k9
                    else (module.GRID_HEAD, len(module.GRID_PHASES)))
    plan = k9.plan_grid(module.__name__, B, H, W, SENSE_C, 132, smem_max, head, phases)
    return plan.team, plan.slots, plan.per_round


def time_sense512(dev, out, row):
    """Row 9 (`row` "sense") or 10 ("splitbregman") past a team of 16: at 2
    slices of 512², 6 coils (``sense512_case``: the grid route; a parent
    tree's global route) the kernel in turns with its composed
    solve_batched_unrolled, both device times by torch.profiler, the plan,
    CTA 0's clocks by phase and the bound (row 10: at the live CG steps of
    its run). Where the tree under test takes `grid=`: the forced plans of
    GRID_SWEEP_SENSE at 2 × 512²; 1 × 1024² (two rounds of coils) in turns
    with its composed solve, both device times, its plan, clocks and
    bound; and at each GRID_BESIDE_SPLIT side (SENSE_SLICES slices) the
    split route the planner takes, the grid route forced on the plan
    ``sense_grid_plan`` gives, and the composed solve, in turns."""
    import inspect

    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import sense_fused as k9
    from rls_tpu_torch.kernels import splitbregman_fused as k10

    n = 9 if row == "sense" else 10
    module, kernel = (k9, k9.fista_l21_sense_fused) if row == "sense" else (
        k10, k10.splitbregman_l1_tv_fused)

    def case(op, b, x0, coils, label, grid=False):
        """The cases of one shape: the kernel (on the planner's route, and
        with `grid` also forced onto the grid route) and the composed
        solve; the bound's entry."""
        S, hw = x0.shape[0], op.im_shape[0] * op.im_shape[1]
        nbytes = 4 * ((4 * S + 2 * SENSE_C + 1) * hw)
        if row == "sense":
            solver = rtt.FISTA.create(op, reg=rtt.L21Regularization(SENSE_LAM, slices=2),
                                      iterations=SENSE_ITERS, rho=RHO)
            args = (x0, op.mask, *coils, RHO, SENSE_LAM, SENSE_ITERS)
            out[f"{label} row 9 bound"] = bound(S * sense_ops(hw, SENSE_C, SENSE_ITERS),
                                                nbytes + 4 * 2 * S)
        else:
            solver = splitbregman_solver(op, dev)
            args = (x0, op.mask, *coils, SB_RHO, SB_RHO, SB_LAM, SB_LAM, *SB_SCHED, SB_TV,
                    SB_TOL)
            live = kernel(*args, with_counts=True)[1].tolist()
            out[f"{label} row 10 live CG steps"] = live
            out[f"{label} row 10 bound"] = bound(
                sum(sb_ops(hw, SENSE_C, *SB_SCHED[:2], SB_TV, v) for v in live),
                nbytes + 4 * 4 * S)
        B = b.T.contiguous()
        name = f"{label} row {n} {module.__name__.split('.')[-1]}"
        cases = [(name, lambda: kernel(*args), 1, plan_probe(module, (x0, SENSE_C), *args))]
        if grid:
            g = sense_grid_plan(module, x0)
            cases.append((f"{name} forced grid {g}", lambda: kernel(*args, grid=g), 1,
                          plan_probe(module, (x0, SENSE_C, None, g), *args, grid=g)))
        cases.append((f"{label} row {n} composed solve_batched_unrolled",
                      lambda: rtt.solve_batched_unrolled(solver, B), 1))
        return cases, args

    op, b, x0, coils = sense512_case(dev)
    cell, args = case(op, b, x0, coils, "512²")
    out[f"512² row {n} plan"] = vars(module.plan_on_card(x0, SENSE_C))
    time_cases(out, cell, in_turns=True)
    device_ms(out, cell)
    if "grid" not in inspect.signature(module.plan_on_card).parameters:
        return
    time_cases(out, [(f"512² row {n} forced grid {g}", lambda g=g: kernel(*args, grid=g), 1,
                      plan_probe(module, (x0, SENSE_C, None, g), *args, grid=g))
                     for g in GRID_SWEEP_SENSE])
    cell, _ = case(*sense_grid_case(dev, 1024, 1, 13), "1024²")
    time_cases(out, cell, in_turns=True)
    device_ms(out, cell)
    rng = np.random.default_rng(31)
    for side in GRID_BESIDE_SPLIT:
        maps = coil_maps(rng, SENSE_C, side)
        mask = (rng.uniform(size=(side, side)) < 0.45).astype(np.float32)
        opn = rtt.SenseDFT2RealOperator.from_maps(maps, mask, (side, side), device=dev)
        bn = opn.mv(torch.from_numpy(rng.normal(size=(SENSE_SLICES, 2 * side * side))
                                     .astype(np.float32)).to(dev))
        xn = opn.rmv(bn).reshape(SENSE_SLICES, 2, side, side)
        cell, _ = case(opn, bn, xn, (opn.coils_r, opn.coils_i), f"{side}²", grid=True)
        time_cases(out, cell, in_turns=True)
        device_ms(out, cell)


def time_sense_grid(dev, out):
    """``--time-sense-grid [ROOT]``: ``time_sense512`` of rows 9 and 10
    alone (the cases past a team of 16), for turns against a parent tree
    in one chip call."""
    from rls_tpu_torch.kernels import sense_fused as k9

    out["kernel"] = os.path.relpath(k9.__file__, ROOT)
    for row in ("sense", "splitbregman"):
        time_sense512(dev, out, row)


def time_sense(dev, out):
    """``--time-sense [ROOT]``: the fused FISTA-L21-SENSE kernel (row 9) at
    the SENSE cell's schedule (ρ = 0.95, λ = 1e-4, 80 iterations): the
    cell's 8 slices of 128² with 6 coils, the same tiled to 64 slices (more
    clusters than the card holds at once), 1 slice, 8 slices with the first
    1 and 3 coils and with 17 coils of their own (two rounds), and 4
    slices of 256² (the split route); then the cell's kernel in turns with
    its composed solve_batched_unrolled (torch.fft), both with their
    device time by torch.profiler; the same for the 192² cell, with the
    kernel's phase clocks; 8 slices at each SPLIT_SHAPES shape and the
    forced plans of SPLIT_SWEEP at 192² and SPLIT_SWEEP_128 at the cell
    (``split_cases``); 2 slices of 512² (the grid route) in turns with
    the composed solve, both device times, the clocks and the bound, the
    forced grid plans, 1 × 1024² and the grid route forced beside the split
    route at 384² and 448² (``time_sense512``); rows 8 (the CS cell's 16
    problems) and 10 (BASELINE #4) as controls."""
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
        (f"4 slices of {g}², {SENSE_C} coils", x256, mask256,
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
    # the 192² cell (fista_l21_sense192_6coil_b8) in turns with its composed
    # solve, both device times, the phase clocks; then the split shapes and
    # the forced plans at 192²
    op192, b192, x192, coils192 = sense192_cell(dev)
    s192 = rtt.FISTA.create(op192, reg=rtt.L21Regularization(SENSE_LAM, slices=2),
                            iterations=SENSE_ITERS, rho=RHO)
    B192 = b192.T.contiguous()
    args192 = (x192, op192.mask, *coils192, RHO, SENSE_LAM, SENSE_ITERS)
    cell = [
        ("192² row 9 sense_fused", lambda: k9.fista_l21_sense_fused(*args192), 2,
         plan_probe(k9, (x192, SENSE_C), *args192)),
        ("192² row 9 composed solve_batched_unrolled",
         lambda: rtt.solve_batched_unrolled(s192, B192), 1),
    ]
    time_cases(out, cell, in_turns=True)
    device_ms(out, cell)

    def row9(x, m, cr, ci, clock_args=False, **kw):
        args = (x, m, cr, ci, RHO, SENSE_LAM, SENSE_ITERS)
        return (args, kw) if clock_args else k9.fista_l21_sense_fused(*args, **kw)

    time_cases(out, split_cases(dev, k9, row9, (x192, op192.mask, coils192),
                                (x0, op.mask, coils)))
    time_sense512(dev, out, "sense")
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
    placements in turns; where ROOT's kernel has the windowed route, the
    forced windows of TV_WINDOW_SWEEP at 8 × 1024² in turns. Then the
    composed solves that launch it (the flagship, the ADMM cell and the
    512² cell, row 3's yardstick) and, at 1024² × 8, the composed FISTA-TV
    and ADMM-TV solves beside rows 3 and 5 on their row tiles, with their
    device times. Each plan where ROOT's package has a planner, and sha256
    digests of each case, of rows 2 and 4 as controls: a change of row 1's
    resident route leaves its global route and rows 2 and 4 bit for bit.
    Run it for the parent tree and this one in turns (P C C P): 8 × 1024²
    takes the parent's global route and this tree's windows."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch import _build
    from rls_tpu_torch.kernels import admm_tv_fused as k4
    from rls_tpu_torch.kernels import admm_tv_tiled as k5
    from rls_tpu_torch.kernels import fista_tv_fused as k2
    from rls_tpu_torch.kernels import fista_tv_tiled as k3
    from rls_tpu_torch.kernels import tv_fgp as k1

    out["kernel"] = os.path.relpath(k1.__file__, ROOT)
    rng = np.random.default_rng(13)
    forced = hasattr(k1, "_card_plan")
    # this tree's planner takes the dual iterations, and has the windows
    windows = hasattr(k1, "prox_tv2d_fgp_windows_torch")
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
        cases.append((f"{B} x {H}x{W}, {tv} dual", run, reps,
                      plan_probe(k1, (x, tv) if windows else (x,))))
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
        c = k1.plan_on_card(*((x, tv) if windows else (x,)))[0].clusters
        time_cases(out, [(f"in turns: {B} x {H}x{W}, {tv} dual, c = {c}, x pv ph {own}",
                          forced_tv(k1, x, lam, tv, c, own), 20) for own in ("shared", "global")],
                   in_turns=True)
    if windows:
        # forced windows at 8 × 1024² (the planner weighs them alike)
        (x, lam), (B, H, W, tv) = inputs[TV_1024], TV_1024
        tiles = []
        for interior, c in TV_WINDOW_SWEEP:
            name = f"{B} x {H}x{W}, {tv} dual, windows of {interior} rows on c = {c}"
            tiles.append((name, lambda interior=interior, c=c: k1._launch(x, lam, tv, c, None,
                                                                          interior), 5,
                          lambda interior=interior, c=c: {"plan": dict(vars(k1._card_plan(
                              dev.index or 0, B, H, W, c, None, tv, interior)[0]))}))
        time_cases(out, tiles, in_turns=True)
        device_ms(out, tiles)
        sweep += tiles
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
    # 1024² × 8: the composed FISTA-TV and ADMM-TV solves (row 1 at 1024²,
    # 50 and 10 launches) beside rows 3 and 5 on their row tiles
    s10 = build_solver(1024, dev)
    B10 = s10.A.mv(torch.from_numpy(np.ascontiguousarray(draws[1024])).to(dev)).T.contiguous()
    x10 = s10.A.rmv_stencil(B10.T).reshape(-1, 1024, 1024)
    a10 = build_admm((1024, 8) + ADMM512[2:], dev)
    Ba10 = a10.A.mv(torch.from_numpy(np.ascontiguousarray(draws[1024])).to(dev)).T.contiguous()
    xa10 = a10.A.rmv_stencil(Ba10.T).reshape(-1, 1024, 1024).contiguous()
    lam5, iters5, cg5, tv5 = ADMM512[2:]
    big = [("1024² x 8 FISTA-TV composed solve_batched_unrolled",
            lambda: rtt.solve_batched_unrolled(s10, B10), 1),
           ("1024² x 8 row 3 fista_tv_tiled",
            lambda: k3.fista_tv_tiled(x10, s10.A.taps_hw(), RHO, LAM, ITERS, TV_ITERS), 1),
           ("1024² x 8 ADMM-TV composed solve_batched_unrolled",
            lambda: rtt.solve_batched_unrolled(a10, Ba10), 1),
           ("1024² x 8 row 5 admm_tv_tiled",
            lambda: k5.admm_tv_tiled(xa10, a10.A.taps_hw(), ADMM_RHO, lam5, iters5, cg5, tv5,
                                     ADMM_TOL), 1)]
    time_cases(out, big)
    device_ms(out, big)
    del s10, B10, x10, a10, Ba10, xa10
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


def time_admm_tiled(dev, out):
    """``--time-admm-tiled [ROOT]``: row 5 at the admm_tv_512_tiled_b16
    cell (16 × 512², ρ = 0.1, λ = 5e-4, 10 × 5 × 10, tol_inner 1e-5, the
    9 × 9 Gaussian) on the route its planner takes, in turns with the row
    tiles (``tile_rows`` forced: the parent's kernel); where ROOT's row 5
    has the cluster route, c = 14, 15 and 16 in turns and CTA 0's clocks by
    phase; the cell's composed solve_batched_unrolled; 8 × 1024² on the row
    tiles beside its composed solve, once each; 16 × 384² on row 4, on row
    5's plan, on three planes forced and on the row tiles; each case's
    device time by torch.profiler; rows 2, 3 and 4 at their cells (the
    flagship, fista_tv_512_tiled_b16, admm_tv_deblur256_b16) as controls;
    sha256 digests of x from rows 2–5 (and row 4's global route) and of
    row 5's live CG steps."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import _fgp_common
    from rls_tpu_torch.kernels import admm_tv_fused as k4
    from rls_tpu_torch.kernels import admm_tv_tiled as k5
    from rls_tpu_torch.kernels import fista_tv_fused as k2
    from rls_tpu_torch.kernels import fista_tv_tiled as k3

    out["kernel"] = os.path.relpath(k5.__file__, ROOT)
    cluster = hasattr(k5, "plan_admm_tv_tiled")
    draws = bench_suite_draws()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def problem(cell, imgs):
        solver = build_admm(cell, dev)
        B = solver.A.mv(torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)).T.contiguous()
        x0 = solver.A.rmv_stencil(B.T).reshape(-1, cell[0], cell[0]).contiguous()
        _, _, lam, iters, cg, tv = cell
        return solver, B, (x0, solver.A.taps_hw(), ADMM_RHO, lam, iters, cg, tv, ADMM_TOL)

    s5, B5, args5 = problem(ADMM512, draws[512])
    tiles5 = k5.pick_tile_rows(512, 16, sms)
    row5 = [("512² x 16 row 5 default route", lambda: k5.admm_tv_tiled(*args5), 3),
            (f"512² x 16 row 5 tiles (tile_rows {tiles5})",
             lambda: k5.admm_tv_tiled(*args5, tile_rows=tiles5), 3)]
    time_cases(out, row5, in_turns=True)
    cases = list(row5)
    if cluster:
        out["512² x 16 row 5 plan"] = dict(vars(k5.plan_on_card(*args5[:2])[0]))
        forced = [(f"512² x 16 row 5 cluster c = {c}", lambda c=c: k5._run(*args5, clusters=c),
                   3) for c in (14, 15, 16)]
        time_cases(out, forced, in_turns=True)
        out["512² x 16 row 5 clocks of CTA 0 by phase"] = k5.phase_clocks(*args5)
        cases += forced
    composed5 = [("512² x 16 composed solve_batched_unrolled",
                  lambda: rtt.solve_batched_unrolled(s5, B5), 1)]
    time_cases(out, composed5)
    cases += composed5
    # 8 × 1024² on the row tiles beside its composed solve, once each
    s10, B10, args10 = problem((1024, 8) + ADMM512[2:], draws[1024])
    big = [("1024² x 8 row 5", lambda: k5.admm_tv_tiled(*args10), 1),
           ("1024² x 8 composed solve_batched_unrolled",
            lambda: rtt.solve_batched_unrolled(s10, B10), 1)]
    for name, fn, reps in big:
        fn()
        out[f"{name} ms"] = [cuda_ms(fn, reps)]
        out[f"{name} device ms (profiler)"] = [sum(ms for ms, _, _ in device_kernels(fn))]
    if cluster:
        out["1024² x 8 row 5 plan"] = dict(vars(k5.plan_on_card(*args10[:2])[0]))
    del s10, B10, args10
    # 16 × 384²: row 4, and row 5 on its plan (five planes where they fit),
    # on three planes forced and on its row tiles
    _, _, args4 = problem((384, 16) + ADMM512[2:], draws[512].reshape(16, 512, 512)
                          [:, :384, :384].reshape(16, -1))
    tiles4 = k5.pick_tile_rows(384, 16, sms)
    edge = [("384² x 16 row 4", lambda: k4.admm_tv_fused(*args4), 3),
            (f"384² x 16 row 5 tiles (tile_rows {tiles4})",
             lambda: k5.admm_tv_tiled(*args4, tile_rows=tiles4), 3)]
    if cluster:
        c4 = k5.plan_on_card(*args4[:2])[0].clusters
        edge += [("384² x 16 row 5 default route", lambda: k5.admm_tv_tiled(*args4), 3),
                 (f"384² x 16 row 5 three planes, c = {c4}",
                  lambda: k5._run(*args4, clusters=c4, own="global"), 3)]
        out["384² x 16 row 5 plan"] = dict(vars(k5.plan_on_card(*args4[:2])[0]))
        out["384² x 16 row 4 plan"] = dict(vars(k4.plan_on_card(*args4[:2])[0]))
    time_cases(out, edge, in_turns=True)
    cases += edge
    device_ms(out, cases)
    # rows 2, 3 and 4 at their cells, the controls
    s2, B2, _ = build_flagship(dev)
    x2 = s2.A.rmv_stencil(B2.T).reshape(BATCH, N, N)
    s3 = build_solver(512, dev)
    B3 = s3.A.mv(torch.from_numpy(draws[512]).to(dev)).T.contiguous()
    x3 = s3.A.rmv_stencil(B3.T).reshape(16, 512, 512).contiguous()
    _, _, args256 = problem(ADMM256, phantoms(batch=ADMM256[1]))
    wide = torch.from_numpy(np.random.default_rng(11).normal(size=ADMM_WIDE)
                            .astype(np.float32)).to(dev)
    wide = _fgp_common.sepconv_stencil_normal(wide, *args256[1]).contiguous()
    controls = {
        "row 2 fista_tv_fused, flagship":
            lambda: k2.fista_tv_fused(x2, s2.A.taps_hw(), RHO, LAM, ITERS, TV_ITERS),
        "row 3 fista_tv_tiled, 512² x 16":
            lambda: k3.fista_tv_tiled(x3, s3.A.taps_hw(), RHO, LAM, ITERS, TV_ITERS),
        "row 4 admm_tv_fused, 256² x 16": lambda: k4.admm_tv_fused(*args256),
    }
    ctl = [(name, fn, 3) for name, fn in controls.items()]
    time_cases(out, ctl, in_turns=True)
    device_ms(out, ctl)
    for name, fn in controls.items():
        out[f"sha256 of x: {name}"] = digest(fn())
    out["sha256 of x: row 4 global route"] = digest(k4.admm_tv_fused(wide, *args256[1:]))
    for name, kw in (("default route", {}), ("tiles", {"tile_rows": tiles5})):
        x, live = k5.admm_tv_tiled(*args5, with_counts=True, **kw)
        out[f"sha256 of x: 512² x 16 row 5 {name}"] = digest(x)
        out[f"sha256 of live CG steps: 512² x 16 row 5 {name}"] = digest(live)
        out[f"live CG steps: 512² x 16 row 5 {name}"] = live.tolist()


def time_pgm_dense(dev, out):
    """``--time-pgm-dense [ROOT]``: the dense PGM kernels. Row 7a at the
    fista_l1_dense_cs_b16_fused cell (16 × 256 × 512, FISTA, λ = 1e-4, ρ =
    0.95/‖A‖₂², 600 iterations) and, where ROOT's row 7a has the grid
    route, in turns with the per-problem kernel forced; OptISTA and POGM at
    100 iterations on both routes; FISTA at P = 1 and P = 137 (its own
    sparse phantoms) and with the gradient restart at 100 iterations. Row
    7b at phase 3g's three complex cases (the complex 256 × 512 A at batch
    16, FISTA with the gradient restart and Real, and POGM; the real A with
    a complex b, FISTA with the gradient restart; 100 iterations), on its
    default route and, where ROOT's row 7b has the grid route, on both
    routes in turns. Each case's device time by torch.profiler, each plan
    and CTA 0's clocks by phase, the composed solve_batched_unrolled's
    device time at the 7a cell and at 7b's timed case; row 6 at both CGNR
    cells as the control; sha256 digests of every x and, against the
    outputs of every tree timed before from this directory
    (.timing/pgm_dense/), the count of entries that differ."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import cgnr_fused as k6
    from rls_tpu_torch.kernels import pgm_dense_fused as k7

    out["kernel"] = os.path.relpath(k7.__file__, ROOT)
    grid = hasattr(k7, "plan_pgm_dense")
    cgrid = hasattr(k7, "phase_clocks_cplx")
    systems = dense_systems(bench_suite_draws())
    saved = {}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def keep(name, x):
        out[f"sha256 of x: {name}"] = digest(x)
        saved[name] = x.cpu()

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
            keep(name, x)
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
    # row 7b: phase 3g's complex cases
    croutes = ("grid", "per_problem") if cgrid else (None,)
    ccases = []
    for label, key, method, restart, prox in (
        ("row 7b complex A, FISTA gradient restart, real", "cplx", "fista", "gradient", "real"),
        ("row 7b complex A, POGM", "cplx", "pogm", "none", "none"),
        ("row 7b real A, complex b, FISTA gradient restart", "real_a_cplx_b", "fista",
         "gradient", "none"),
    ):
        a, b = systems[key]
        ar, ai = t(a.real.astype(np.float32)), t(a.imag.astype(np.float32))
        br, bi = t(b.real.T.astype(np.float32)), t(b.imag.T.astype(np.float32))
        args = (LASSO_LAM, 0.95 / float(np.linalg.norm(a, 2)) ** 2, 1.0, SHORT_ITERS, method,
                "l1", restart, prox)

        def solve7b(route, br=br, bi=bi, ar=ar, ai=ai, args=args):
            if route is None:
                return k7.pgm_dense_fused_cplx(br, bi, ar, ai, *args, with_counts=True)
            scal, tab = k7.kernel_args(br, *args[:3], args[4], args[3])
            return k7._launch_cplx(br, bi, ar, ai, scal, tab, args[3:], route=route)

        pair = [(f"{label} {r or 'default route'}", lambda r=r, f=solve7b: f(r), 5)
                for r in croutes]
        time_cases(out, pair, in_turns=True)
        for name, fn, _ in pair:
            xr, xi, counts = fn()
            keep(name, torch.stack([xr, xi]))
            out[f"restarts: {name}"] = counts.tolist()
        if cgrid:
            xr, xi, _ = solve7b(None)
            keep(f"{label} default route", torch.stack([xr, xi]))
            out[f"plan: {label}"] = dict(vars(k7.card_plan(br, ar, cplx=True)))
            out[f"clocks of CTA 0 by phase: {label}"] = k7.phase_clocks_cplx(br, bi, ar, ai,
                                                                             *args)
        if key == "cplx" and method == "fista":
            s7b = rtt.FISTA.create(
                rtt.DenseOperator(t(a), device=dev),
                reg=[rtt.L1Regularization(LASSO_LAM), rtt.RealRegularization()],
                iterations=SHORT_ITERS, rho=args[1], restart="gradient", track_residual=False)
            B7b = t(b)
            composed.append((f"{label} composed solve_batched_unrolled",
                             lambda: rtt.solve_batched_unrolled(s7b, B7b), 1))
        ccases += pair
    device_ms(out, ccases)
    time_cases(out, composed)
    device_ms(out, composed)
    # the control: row 6 at both CGNR cells (timed)
    for name, key, lam, iters, reps in (
        ("row 6 cgnr_l2_dense64_fused_b16", "cgnr64", CGNR64_LAM, CGNR64_ITERS, 50),
        ("row 6 cgnr_l2_dense_1024x512_b64", "cgnr1k", CGNR1K_LAM, CGNR1K_ITERS, 20),
    ):
        A6, B6 = (t(a) for a in systems[key])
        args6 = (B6.T.contiguous(), A6, torch.full((B6.shape[1],), lam, device=dev),
                 min(iters, A6.shape[1]))
        time_cases(out, [(name, lambda a=args6: k6.cgnr_fused(*a), reps)])
        keep(name, k6.cgnr_fused(*args6))
    # the entries that differ from the trees timed before in this directory
    store = os.path.join(ROOT, ".timing", "pgm_dense")
    os.makedirs(store, exist_ok=True)
    tag = re.sub(r"[^A-Za-z0-9]+", "_", os.path.abspath(out["root"])).strip("_")
    for f in sorted(os.listdir(store)):
        if f == f"{tag}.pt":
            continue
        other = torch.load(os.path.join(store, f))
        for name, x in saved.items():
            if name in other:
                out[f"entries of x differing from {f}: {name}"] = [
                    int((x.view(torch.int32) != other[name].view(torch.int32)).sum()), x.numel()]
    torch.save(saved, os.path.join(store, f"{tag}.pt"))


def time_library(dev, out):
    """``--time-library [ROOT]``: the library yardstick of rows 2, 3, 4,
    5, 7a, 7b, 10, 11, 12a, 12b and 13 (PERF.md §6), the composed
    solve_batched_unrolled at the shapes of the main path: the FISTA-TV
    flagship, the 512² tiled FISTA-TV cell, the two ADMM-TV cells, the LASSO
    cell and the complex FISTA, BASELINE #4's SplitBregman on the 8 SENSE
    slices, the PDHG cell, one cyclic Kaczmarz sweep of the tall system,
    the tall streamed cell and the greedy cell. Each with three wall
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
    composed(13, kaczmarz_solver(dense, KZ_GREEDY, greedy=True), Bt)
    time_cases(out, solves)
    device_ms(out, solves)


def time_kaczmarz(dev, out):
    """``--time-kaczmarz [ROOT]``: the Kaczmarz row kernel (rows 12a and
    12b) at its cells: one sweep of the 12a cell (1024×256, batch 16, all
    rows, cyclic and shuffled), the tall streamed cell (dense and padded
    CSR, 20 sweeps of 64 rows, batch 16, Positive), the 64 MiB cell
    (8192×2048, 8 sweeps of 1024 rows, 4 distinct b), the complex system
    and the tall real A with a complex b; each on its plan and, where
    ROOT's package has the routes, on the block route and on the warp route
    with 1, 2, 4, 8 and 16 problems a CTA (as far as the batch goes); then
    one cyclic sweep of 1024 rows of n = 256 … 8192 entries, batch 16, on
    both routes (the crossover). Each case: three readings of its device
    time by torch.profiler, the row kernel's alone and the call's; each
    cell's plan and the warp route's clocks of CTA 0's warp 0 by phase;
    sha256 digests of x and vl, and, against the outputs of every tree
    timed before from this directory (.timing/kaczmarz/), the
    count of entries that differ. Row 13 (one greedy sweep) as the
    control."""
    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import kaczmarz_greedy as kg
    from rls_tpu_torch.kernels import kaczmarz_streamed as ks

    out["kernel"] = os.path.relpath(ks.__file__, ROOT)
    routed = hasattr(ks, "plan_kaczmarz")
    kz = kaczmarz_systems(bench_suite_draws(), dev)
    A, B16, Bt, _ = kz["tall"]
    A2, B4 = kz["64mib"][:2]
    Ac, Bc = kz["complex"]
    dense = rtt.DenseOperator(A, device=dev)
    csr = rtt.PaddedCSROperator.from_dense(A.cpu().numpy(), device=dev)
    sweep = (1, 1.0, 16)
    cells = [
        ("12a: one cyclic sweep, 1024x256 x 16", kaczmarz_solver(dense, sweep, randomized=False),
         B16, "none"),
        ("12a: one shuffled sweep, 1024x256 x 16",
         kaczmarz_solver(dense, sweep, randomized=False, shuffle_rows=True), B16, "none"),
        ("12b: tall dense, 20 x 64 rows x 16", kaczmarz_solver(dense, KZ_TALL), Bt, None),
        ("12b: tall padded CSR, 20 x 64 rows x 16", kaczmarz_solver(csr, KZ_TALL), Bt, None),
        ("12b: 64 MiB, 8 x 1024 rows x 4",
         kaczmarz_solver(rtt.DenseOperator(A2, device=dev), KZ_64MIB), B4, None),
        ("12b: complex 512x128, 3 cyclic sweeps x 4",
         kaczmarz_solver(rtt.DenseOperator(Ac, device=dev), (3, 1.0, 4), randomized=False,
                         positive=False), Bc, None),
        ("12b: tall real A, complex b, 20 x 64 rows x 8",
         kaczmarz_solver(dense, KZ_TALL, positive=False), kz["complex_b"], None),
    ]
    runs = []  # (case, operands, prox, route, groups)
    for name, solver, B, prox in cells:
        if not solver.A.dtype.is_complex and B.is_complex():
            B = torch.cat([B.real, B.imag], dim=1)
        ops = ks.solver_operands(solver, B)
        prox = prox or ks.sweep_projection(solver)
        runs.append((f"{name} plan", ops, prox, None, None))
        if routed:
            plan = ks.card_plan(ops[0], ops[3], ops[1])
            out[f"plan: {name}"] = dict(vars(plan))
            runs.append((f"{name} block", ops, prox, "block", None))
            runs += [(f"{name} warp g={g}", ops, prox, "warp", g) for g in (1, 2, 4, 8, 16)
                     if g <= B.shape[1]]
            out[f"clocks of CTA 0 warp 0 by phase: {name}"] = ks.phase_clocks(
                *ops[:1], *ops[2:], prox, ops[1])
    # the crossover: one cyclic sweep of 1024 rows, batch 16, n = 256 … 8192
    rng = np.random.default_rng(19)
    for n in (256, 512, 1024, 2048, 4096, 8192):
        An = torch.from_numpy((rng.normal(size=(1024, n)) / np.sqrt(n)).astype(np.float32)).to(dev)
        Bn = An @ torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32)).to(dev)
        ops = ks.solver_operands(kaczmarz_solver(rtt.DenseOperator(An, device=dev), sweep,
                                                 randomized=False), Bn)
        name = f"crossover: one sweep, 1024x{n} x 16"
        runs.append((f"{name} plan", ops, "none", None, None))
        if routed:
            out[f"plan: {name}"] = dict(vars(ks.card_plan(ops[0], ops[3])))
            for r in ks.ROUTES:
                g = 1 if r == "warp" else None
                try:
                    ks.card_plan(ops[0], ops[3], None, g, r)
                except ValueError as err:  # the route fits no CTA at this width
                    out[f"{name} {r}"] = str(err)
                    continue
                runs.append((f"{name} {r}", ops, "none", r, g))

    def call(ops, prox, route, groups):
        rows, cols, idx, x0, vl0, u, denom, eps, sweeps, reuse = ops
        if route is None:
            return ks.kaczmarz_solve(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols)
        return ks._forced(rows, idx, x0, vl0, u, denom, eps, sweeps, reuse, prox, cols, groups,
                          route)

    saved = {}
    for name, ops, prox, route, groups in runs:
        fn = lambda o=ops, p=prox, r=route, g=groups: call(o, p, r, g)  # noqa: E731
        fn()
        readings = [device_kernels(fn) for _ in range(3)]
        out[f"{name} kernel device ms (profiler)"] = [
            sum(ms for ms, _, key in r if "kaczmarz" in key) for r in readings]
        out[f"{name} device ms (profiler)"] = [sum(ms for ms, _, _ in r) for r in readings]
        x, vl = fn()
        out[f"sha256 of x, vl: {name}"] = [digest(x), digest(vl)]
        saved[name] = (x.cpu(), vl.cpu())
    # row 13 as the control: one greedy sweep of the tall system, batch 16
    sg = kaczmarz_solver(dense, KZ_GREEDY, greedy=True)
    Ag, Gt, dg, ng, eg, fnorm, bt = kg.greedy_operands(sg, B16)
    z = (torch.zeros(16, 256, device=dev), torch.zeros(16, 1024, device=dev), bt)
    args = (Ag, Gt, dg, ng, *z, eg, fnorm, None, sg.sub_matrix_size, sg.seed, 0)
    greedy = [("row 13 greedy sweep (control)", lambda: kg.kaczmarz_greedy_sweep(*args), 5)]
    time_cases(out, greedy)
    device_ms(out, greedy)
    out["sha256 of x: row 13 greedy sweep (control)"] = digest(kg.kaczmarz_greedy_sweep(*args)[0])
    # the entries that differ from the trees timed before in this directory
    keep = os.path.join(ROOT, ".timing", "kaczmarz")
    os.makedirs(keep, exist_ok=True)
    tag = re.sub(r"[^A-Za-z0-9]+", "_", os.path.abspath(out["root"])).strip("_")
    for f in sorted(os.listdir(keep)):
        if f == f"{tag}.pt":
            continue
        other = torch.load(os.path.join(keep, f))
        for name, (x, vl) in saved.items():
            if name in other:
                ox, ovl = other[name]
                out[f"entries of x, vl differing from {f}: {name}"] = [
                    int((x.view(torch.int32) != ox.view(torch.int32)).sum()),
                    int((vl.view(torch.int32) != ovl.view(torch.int32)).sum()),
                    x.numel(), vl.numel()]
    torch.save(saved, os.path.join(keep, f"{tag}.pt"))


# the greedy solve's (m, n) about the crossover of its two routes, batch 4
GREEDY_CROSSOVER = ((2048, 256), (2048, 2048), (4096, 256), (4096, 2048))


def resident_instance(mangled):
    """'rows R, x in registers|shared[, timer]' for a mangled name of the
    greedy kernel's resident route, else None."""
    m = re.search(r"kaczmarz_greedy_resident_kernelILi(\d+)ELb([01])ELb([01])E", mangled)
    if not m:
        return None
    return (f"rows {m.group(1)}, x in {'registers' if m.group(2) == '1' else 'shared'}"
            + (", timer" if m.group(3) == "1" else ""))


def time_kaczmarz_greedy(dev, out):
    """``--time-kaczmarz-greedy [ROOT]``: the greedy kernel (row 13) at its
    cell: one sweep of 64 steps from r = b (the tall system, batch 16, the
    16 distinct b of phase 3i) and kaczmarz_greedy_tall_b16's solve through
    greedy_solve (20 sweeps, Positive and the refresh after each), and the
    greedy solve of the 64 MiB system (8192 × 2048, its 4 distinct b, 20
    sweeps of 512 steps: past the resident route's rows) and of its leading
    blocks GREEDY_CROSSOVER (m/16 steps a sweep); where ROOT's package has
    the routes, the plans, the cell's two cases again on the block route
    and the blocks' solves again on each route forced, and where it has
    `_build.ptxas_report`, the registers and spills of every instantiation
    of the resident route. Each case: three readings by CUDA events and
    three of its device time by torch.profiler (the greedy kernel's alone
    and the call's); CTA 0's clocks by phase (one sweep with its refresh,
    and the cell's solve) where ROOT has the timer; sha256 digests of x, vl
    and the rows (the solve's vl and r where ROOT's solve returns them) and,
    against the outputs of every tree timed before from this directory
    (.timing/kaczmarz_greedy/), the count of entries that differ; the
    composed 20-sweep solve's device time as the yardstick."""
    import functools

    import torch
    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import kaczmarz_greedy as kg

    out["kernel"] = os.path.relpath(kg.__file__, ROOT)
    routed = hasattr(kg, "plan_kaczmarz_greedy")
    from rls_tpu_torch import _build
    if hasattr(_build, "ptxas_report"):
        out["ptxas of the resident route: registers, spill stores, spill loads (bytes)"] = {
            resident_instance(k): [v["registers"], v["spill_stores"], v["spill_loads"]]
            for k, v in sorted(_build.ptxas_report("kaczmarz_greedy.cu").items())
            if resident_instance(k)}
    kz = kaczmarz_systems(bench_suite_draws(), dev)
    A, B16, Bt, _ = kz["tall"]
    sg = kaczmarz_solver(rtt.DenseOperator(A, device=dev), KZ_GREEDY, greedy=True)
    S, T = sg.sub_matrix_size, sg.iterations
    Ag, Gt, dg, ng, eg, fnorm, bt = kg.greedy_operands(sg, B16)
    z = (torch.zeros(16, 256, device=dev), torch.zeros(16, 1024, device=dev), bt)
    sweep = (Ag, Gt, dg, ng, *z, eg, fnorm, None, S, sg.seed, 0)
    # a system past the resident route's 4096 rows: the 64 MiB A (8192 × 2048)
    # with its 4 distinct b, 20 sweeps of 512 steps (the block route here)
    A2, B4 = kz["64mib"][:2]
    s2 = kaczmarz_solver(rtt.DenseOperator(A2, device=dev), KZ_GREEDY, greedy=True)
    cases = [("one sweep", lambda: kg.kaczmarz_greedy_sweep(*sweep), 5),
             ("cell solve", lambda: kg.greedy_solve(sg, Bt), 2),
             ("8192x2048 solve, batch 4", lambda: kg.greedy_solve(s2, B4), 2)]
    # its leading m × n blocks about the routes' crossover, each b = A x with
    # the 64 MiB cell's 4 distinct x: 20 sweeps of m/16 steps
    xs = torch.from_numpy(np.abs(np.random.default_rng(4).normal(size=(2048, 4)))
                          .astype(np.float32)).to(dev)
    blocks = {}
    for m, n in GREEDY_CROSSOVER:
        Am = A2[:m, :n].contiguous()
        blocks[m, n] = (kaczmarz_solver(rtt.DenseOperator(Am, device=dev), KZ_GREEDY,
                                        greedy=True), Am @ xs[:n])
        cases.append((f"{m}x{n} solve, batch 4",
                      lambda sb=blocks[m, n]: kg.greedy_solve(*sb), 2))
    if routed:
        out["plan 8192x2048"] = dict(vars(kg.card_plan(4, 8192, 2048, dev)))
        for m, n in GREEDY_CROSSOVER:
            out[f"plan {m}x{n}"] = dict(vars(kg.card_plan(4, m, n, dev)))
        out["plan"] = dict(vars(kg.card_plan(16, 1024, 256, dev)))
        block = functools.partial(kg._forced, route="block")
        cases += [("one sweep, block route", lambda: kg._sweep(*sweep, route="block"), 5),
                  ("cell solve, block route", lambda: kg.greedy_solve(sg, Bt, solve=block), 2)]
        resident = functools.partial(kg._forced, route="resident")
        cases += [(f"{m}x{n} solve, batch 4, {name} route",
                   lambda sb=blocks[m, n], f=f: kg.greedy_solve(*sb, solve=f), 2)
                  for m, n in GREEDY_CROSSOVER
                  for name, f in (("resident", resident), ("block", block))]
    time_cases(out, cases)
    for name, fn, _ in cases:
        readings = [device_kernels(fn) for _ in range(3)]
        out[f"{name} kernel device ms (profiler)"] = [
            sum(ms for ms, _, key in r if "kaczmarz_greedy" in key) for r in readings]
        out[f"{name} device ms (profiler)"] = [sum(ms for ms, _, _ in r) for r in readings]
    cell = kg.greedy_operands(sg, Bt)
    if hasattr(kg, "phase_clocks"):
        out["clocks of CTA 0 by phase: one sweep and its refresh"] = kg.phase_clocks(
            Ag, Gt, dg, ng, bt, eg, fnorm, None, S, 1, sg.seed, "positive")
        out["clocks of CTA 0 by phase: cell solve"] = kg.phase_clocks(
            *cell[:4], cell[6], cell[4], cell[5], None, S, T, sg.seed, "positive")
    saved = {"one sweep": kg.kaczmarz_greedy_sweep(*sweep)}
    x, rows = kg.greedy_solve(s2, B4)
    saved["8192x2048 solve"] = (x.T, rows)
    x, rows = kg.greedy_solve(sg, Bt)
    saved["cell solve"] = (x.T, rows)
    if hasattr(kg, "kaczmarz_greedy_solve"):
        saved["cell solve"] = kg.kaczmarz_greedy_solve(*cell[:4], cell[6], cell[4], cell[5], None,
                                                       S, T, sg.seed, "positive")
    for name, outs in saved.items():
        out[f"sha256 of x, vl, r, rows: {name}"] = [digest(t) for t in outs]
    saved = {k: tuple(t.cpu() for t in v) for k, v in saved.items()}
    composed = [("composed 20-sweep solve", lambda: rtt.solve_batched_unrolled(sg, Bt), 1)]
    device_ms(out, composed)
    # the entries that differ from the trees timed before in this directory
    keep = os.path.join(ROOT, ".timing", "kaczmarz_greedy")
    os.makedirs(keep, exist_ok=True)
    tag = re.sub(r"[^A-Za-z0-9]+", "_", os.path.abspath(out["root"])).strip("_")
    for f in sorted(os.listdir(keep)):
        if f == f"{tag}.pt":
            continue
        other = torch.load(os.path.join(keep, f))
        for name, outs in saved.items():
            if name in other:
                theirs = other[name]
                if len(theirs) != len(outs):  # a solve with only (x, rows): x and rows
                    outs, theirs = (outs[0], outs[-1]), (theirs[0], theirs[-1])
                out[f"entries differing from {f}: {name}"] = [
                    [int((a.view(torch.int32) != b.view(torch.int32)).sum()), a.numel()]
                    for a, b in zip(outs, theirs)]
    torch.save(saved, os.path.join(keep, f"{tag}.pt"))


def condat_case(dev, shape, axis, dtype, seed=None):
    """Phase 12 (a)'s seeded input of a Condat case: the long signals at
    CONDAT_LONG, else bench.py's phantoms plus noise of σ 0.1, one λ per
    problem in [0.05, 0.5], from default_rng(29 + axis) (or `seed`)."""
    import torch

    if shape == CONDAT_LONG:
        x_np, lam_np = condat_long_input()
    else:
        rng = np.random.default_rng(29 + axis if seed is None else seed)
        x_np = phantoms(n=shape[1], batch=shape[0]).reshape(shape)
        x_np = x_np + 0.1 * rng.normal(size=shape)
        lam_np = rng.uniform(0.05, 0.5, size=shape[0])
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(np.ascontiguousarray(x_np)).to(dev, tdt),
            torch.from_numpy(lam_np).to(dev, tdt))


def tv1_cell(dev, dtype=None):
    """Phase 12 (b)'s solver: FISTA with TV(dims=1) (λ = LAM) on the
    flagship's blur, ITERS iterations, and B: TV1_BATCH of the flagship's
    phantoms blurred, one a column."""
    import torch

    import rls_tpu_torch as rtt

    dtype = dtype or torch.float32
    op = rtt.SeparableConvOperator.from_kernel(gaussian_kernel(), im_shape=(N, N), dtype=dtype,
                                               device=dev)
    tv = rtt.TVRegularization(LAM, shape=(N, N), dims=1)
    s = rtt.FISTA.create(op, reg=tv, iterations=ITERS, rho=RHO, rel_tol=0.0,
                         track_residual=False)
    xs = torch.from_numpy(phantoms(n=N, batch=TV1_BATCH)).to(dev, dtype)
    return s, op, op.mv(xs).T.contiguous(), xs


def condat_prox_inputs(solve):
    """The Condat prox's inputs (x, λ, axis) over one call of `solve()`,
    each call's, in order."""
    import torch

    from rls_tpu_torch.models import tv_condat as mtc

    calls, inner = [], mtc.prox_tv1d_condat

    def record(x, lam, axis):
        calls.append((x.clone(), lam.clone() if torch.is_tensor(lam) else lam, axis))
        return inner(x, lam, axis)

    mtc.prox_tv1d_condat = record
    try:
        solve()
    finally:
        mtc.prox_tv1d_condat = inner
    return calls


# --time-condat: the shapes of phase 12 (a), and the chunks and lines a CTA
# swept (forced plans) at each of them
CONDAT_TIMED = (("16x256^2 axis 2", (16, 256, 256), 2, "float32"),
                ("64x256^2 axis 1", (64, 256, 256), 1, "float32"),
                ("64x256^2 axis 2", (64, 256, 256), 2, "float32"),
                ("16x65536", CONDAT_LONG, 2, "float32"),
                ("16x256^2 axis 2 float64", (16, 256, 256), 2, "float64"))
CONDAT_SWEEP = {"16x256^2 axis 2": ((32, 2), (64, 2), (64, 4)),
                "64x256^2 axis 1": ((32, 4), (64, 4), (64, 8)),
                "16x65536": ((32, None), (64, None), (128, None)),
                "(b) first": ((32, 2), (64, 2), (128, 1)),
                "(b) last": ((32, 2), (64, 2), (128, 1))}


def time_condat(dev, out):
    """``--time-condat [ROOT]``: the Condat kernel (row 14) at CONDAT_TIMED
    (phase 12 (a)'s shapes) and on phase 12 (b)'s prox inputs captured at
    its first and last iterations, and (b)'s batch through
    solve_batched_fast: three readings by CUDA events and three of the
    device time by torch.profiler (the Condat kernels' alone); sha256
    digests of every output (equal across trees: both are bit for bit the
    plain version). Where ROOT's kernel has the planner: each case's plan,
    the run's counts (walkers stitched, long, done; the stitch distances'
    mean and largest; the chain's own events), CTA 0's clocks by phase on
    the resident route, and CONDAT_SWEEP's forced chunks and lines a CTA,
    each held bit for bit to the planned call."""
    import torch

    import rls_tpu_torch as rtt
    from rls_tpu_torch.kernels import tv_condat as kc

    out["kernel"] = os.path.relpath(kc.__file__, ROOT)
    planned = hasattr(kc, "plan_tv_condat")
    cases, saved = [], {}
    for name, shape, axis, dtype in CONDAT_TIMED:
        x, lam = condat_case(dev, shape, axis, dtype)
        cases.append((name, x, lam, axis))
    s, op, B, _ = tv1_cell(dev)
    calls = condat_prox_inputs(lambda: rtt.solve_batched_fast(s, B, warn=False))
    out["(b) prox calls"] = len(calls)
    for tag, (x, lam, axis) in (("first", calls[0]), ("last", calls[-1])):
        cases.append((f"(b) {tag} iterate {tuple(x.shape)} axis {axis}", x, lam, axis))
    timed = [(name, lambda x=x, lam=lam, axis=axis: kc.prox_tv1d_condat(x, lam, axis),
              2 if "65536" in name else 10) for name, x, lam, axis in cases]
    timed.append(("(b) batch solve_batched_fast",
                  lambda: rtt.solve_batched_fast(s, B, warn=False), 1))
    time_cases(out, timed)
    for name, fn, _ in timed:
        readings = [device_kernels(fn) for _ in range(3)]
        out[f"{name} condat kernels by name, ms (profiler)"] = {
            key[:90]: ms for ms, _, key in readings[-1] if "tv_condat" in key}
        out[f"{name} condat device ms (profiler)"] = [
            sum(ms for ms, _, key in r if "tv_condat" in key) for r in readings]
        out[f"{name} device ms (profiler)"] = [sum(ms for ms, _, _ in r) for r in readings]
        out[f"{name} condat kernels (profiler)"] = sorted(
            {key[:60] for ms, _, key in readings[-1] if "tv_condat" in key})
    for name, x, lam, axis in cases:
        saved[name] = kc.prox_tv1d_condat(x, lam, axis)
        out[f"sha256: {name}"] = digest(saved[name])
    wall = min(out["(b) batch solve_batched_fast ms"])
    out["(b) problems/s"] = TV1_BATCH / (wall / 1e3)
    if not planned:
        return
    for name, x, lam, axis in cases:
        lines = x.numel() // x.shape[axis]
        plan = kc.card_plan(lines, x.shape[axis], x.dtype, x.device)
        out[f"plan: {name}"] = dict(vars(plan))
        counts = kc.walk_counts(x, lam, axis)
        counts["stitch distance mean"] = counts["stitch distance sum"] / max(counts["stitched"], 1)
        out[f"counts: {name}"] = counts
        if plan.route == "resident":
            out[f"clocks of CTA 0 by phase: {name}"] = kc.phase_clocks(x, lam, axis)
    forced = []
    for name, x, lam, axis in cases:
        sweep = next((v for k, v in CONDAT_SWEEP.items() if name == k or
                      (k.startswith("(b)") and name.startswith(k))), ())
        for chunk, lpc in sweep:
            key = f"{name}, chunk {chunk}" + (f", {lpc} lines a CTA" if lpc else "")
            fn = lambda x=x, lam=lam, axis=axis, chunk=chunk, lpc=lpc: kc._prox(  # noqa: E731
                x, lam, axis, chunk=chunk, lines_per_cta=lpc)
            require(torch.equal(fn(), saved[name]), f"{key}: differs from the planned call")
            lines = x.numel() // x.shape[axis]
            out[f"plan: {key}"] = dict(vars(kc.card_plan(lines, x.shape[axis], x.dtype, x.device,
                                                         chunk=chunk, lines_per_cta=lpc)))
            forced.append((key, fn, 2 if "65536" in name else 10))
    # a walk's cost an event: CTA 0's walking clocks of one walker on one
    # line of 16,384 (noise at λ = 1e4: advances only; 0: a jump an entry;
    # 0.3), over its events
    rng = np.random.default_rng(5)
    for lam_v in (1e4, 0.0, 0.3):
        x = torch.from_numpy(rng.normal(size=(1, 16384))).to(dev, torch.float32)
        clocks = kc.phase_clocks(x, lam_v, 1, chunk=16384, lines_per_cta=1)
        got = kc.prox_tv1d_condat(x, lam_v, 1)
        out[f"one walker, 16384, lambda {lam_v:g}: segments"] = int(
            (got[0, 1:] != got[0, :-1]).sum()) + 1
        out[f"one walker, 16384, lambda {lam_v:g}: clocks by phase"] = clocks
        out[f"one walker, 16384, lambda {lam_v:g}: walking clocks an entry"] = (
            clocks["walking"] / 16384)
    time_cases(out, forced)
    for name, fn, _ in forced:
        out[f"{name} condat device ms (profiler)"] = [
            sum(ms for ms, _, key in device_kernels(fn) if "tv_condat" in key) for _ in range(3)]


def time_composite(dev, out):
    """``--time-composite [ROOT]``: phase 11's cells (b)-(e) through
    solve_batched_fast (the composed fallback) and the flagship with a
    decorated TV: after a warm-up, three wall readings of one call (CUDA
    events), three readings of its device time by torch.profiler (the sum
    of its kernels, with the largest of the last), and the device's busy
    share of the wall time."""
    import torch

    import rls_tpu_torch as rtt

    kz = kaczmarz_systems(bench_suite_draws(), dev)
    cases = [(name, lambda c=c: rtt.solve_batched_fast(c["solver"], c["B"], warn=False))
             for name, c in composite_cells(dev, kz).items()]
    flagship, B, _ = build_flagship(dev)
    dec = rtt.FISTA.create(flagship.A, reg=rtt.FixedScaledRegularization(flagship.reg, 1.0),
                           iterations=ITERS, rho=RHO, rel_tol=0.0, track_residual=False)
    cases.append(("flagship, FixedScaled(TV, 1.0)",
                  lambda: rtt.solve_batched_fast(dec, B, warn=False)))
    for name, fn in cases:
        fn()
        out[f"{name} wall ms"] = [cuda_ms(fn, 1) for _ in range(3)]
    device_ms(out, cases)
    for name, _ in cases:
        wall, busy = min(out[f"{name} wall ms"]), min(out[f"{name} device ms (profiler)"])
        out[f"{name} device busy share"] = busy / wall
        print(f"{name}: wall {wall:.2f} ms, device {busy:.2f} ms ({100 * busy / wall:.1f}%)")


def digest_fft(dev, out):
    """``--digest-fft [ROOT]``: phase 3h's power-of-two cases (rows 8, 9
    and 10 on every route, held to their plain versions), row 8 at every
    MIXED_L1DFT shape and rows 9 and 10 at 8 × 192² on the tree under
    ROOT, on whatever route its planners take (no route counter is
    checked), with the sha256 of each input and kernel output: what
    PARENT_FFT_SHA256 records of the parent tree."""
    out["digests"] = fft_kernel_phase(dev, bench_suite_draws(), mixed=False, timed=False,
                                      routes=False)["digests"]


def time_mixed_radix(dev, out):
    """``--time-mixed-radix [ROOT]``: rows 8, 9 and 10 at phase 3h's
    mixed-radix shapes (``mixed_fft_cases``), the kernels alone on the tree
    under ROOT, three readings each (``time_cases``), with each plan."""
    cases = []
    for case in mixed_fft_cases(dev):
        module, x0 = case["module"], case["x0"]

        def plan(module=module, x0=x0):
            got = (module.plan_on_card(x0) if module.__name__.endswith("fista_l1_dft_fused")
                   else module.plan_on_card(x0, SENSE_C))
            return {"plan": vars(got[0] if isinstance(got, tuple) else got)}

        cases.append((case["key"], lambda c=case: c["kernel"](c["x0"]), case["reps"], plan))
    time_cases(out, cases)


TIME_MODES = {
    "--digest-fft": digest_fft,
    "--time-mixed-radix": time_mixed_radix,
    "--time-composite": time_composite,
    "--time-cgnr": time_cgnr,
    "--time-pgm-tv": time_pgm_tv,
    "--time-splitbregman": time_splitbregman,
    "--time-pdhg": time_pdhg,
    "--time-fista-l1-dft": time_fista_l1_dft,
    "--time-sense": time_sense,
    "--time-sense-grid": time_sense_grid,
    "--time-admm": time_admm,
    "--time-tv-fgp": time_tv_fgp,
    "--time-tiled": time_tiled,
    "--time-admm-tiled": time_admm_tiled,
    "--time-library": time_library,
    "--time-pgm-dense": time_pgm_dense,
    "--time-kaczmarz": time_kaczmarz,
    "--time-kaczmarz-greedy": time_kaczmarz_greedy,
    "--time-condat": time_condat,
}


if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1] in TIME_MODES:
        sys.exit(timing_run(sys.argv[2] if len(sys.argv) > 2 else ROOT, TIME_MODES[sys.argv[1]]))
    if sys.argv[1:2] == ["--condat-plain"]:
        sys.exit(condat_plain_child())
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
