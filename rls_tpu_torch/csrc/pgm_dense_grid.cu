// The grid route of the dense PGM solve on real data: the entry point of
// pgm_dense_grid.cuh's kernel (row 7a's grid route; the design, the
// barrier table and the bounds are in the header).
//
// Replaces the TPU kernel rls_tpu/kernels/pgm_dense_fused.py:_kernel
// (:47-129; launched by solve_pgm_dense_fused, :355, pallas_call :436).
#include "pgm_dense_grid.cuh"

extern "C" {

// The grid route on real data: b (P, m) f32, one problem per row; A (m, n)
// f32 row-major; scal (P, 3) [lam_eff, rho, theta0]; tab the momentum
// table (steps, 4) for OptISTA and POGM; out (P, n); counts (P,) int32, the
// restarts. Codes: method fista | optista | pogm, kind l1 | l2, restart
// none | gradient | gradient_mapping (FISTA), proj none | positive. The
// plan (planned in Python by plan_pgm_dense): `slabs` slabs of `rows`
// rows, `groups` groups of `group_size` problems, A's slab in shared
// memory with `resident`, `smem` bytes of shared memory per CTA. Scratch:
// part (groups, slabs, ceil(group_size / 8), n, 8) and rdots (groups,
// slabs, group_size) float64, xpub (groups, ceil(group_size / 8), n, 8)
// f32 (16-byte aligned), bar (groups, 32) uint32 zeros; prof: null, or
// kGridPhases int64 that receive CTA 0's clocks per phase. Returns
// cudaErrorInvalidValue for a schedule or a plan that does not cover the
// shapes or whose smem differs from grid_smem_bytes,
// cudaErrorCooperativeLaunchTooLarge for a grid that cannot be resident at
// once (the cooperative launch's own check), else the launch's error.
int pgm_dense_grid_launch(const void* b, const void* A, const void* scal, const void* tab,
                          void* out, void* counts, void* part, void* rdots, void* xpub,
                          void* bar, void* prof, int P, int m, int n, int steps, int method,
                          int kind, int restart, int proj, int slabs, int rows, int groups,
                          int group_size, int resident, int smem, void* stream) {
    const GridArgs args{static_cast<const float*>(b), nullptr, static_cast<const float*>(A),
                        nullptr, static_cast<const float*>(scal), static_cast<const float*>(tab),
                        static_cast<float*>(out), static_cast<int*>(counts),
                        static_cast<double*>(part), static_cast<double*>(rdots),
                        static_cast<float*>(xpub), static_cast<unsigned*>(bar),
                        static_cast<long long*>(prof), P, m, n, steps, restart, proj, slabs,
                        rows, groups, group_size};
    return launch<false>(args, method, kind, resident, smem, stream);
}

}  // extern "C"
