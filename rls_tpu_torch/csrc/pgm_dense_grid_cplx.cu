// The grid route of the dense PGM solve on complex data as (re, im)
// planes: the entry point of pgm_dense_grid.cuh's kernel (row 7b's grid
// route; the design, the barrier table and the bounds are in the header).
//
// Replaces the TPU kernel rls_tpu/kernels/pgm_dense_fused.py:_kernel_cplx
// (:132-262; launched by _solve_cplx, :458, pallas_call :518).
#include "pgm_dense_grid.cuh"

extern "C" {

// The grid route on complex data as planes: br, bi (P, m); ar, ai (m, n);
// out (2, P, n), the re then the im plane; proj also real (zero the
// imaginary plane); part (groups, slabs, ceil(group_size / 8), 4, n, 8)
// float64, the four real products of the partial v; xpub (groups, 2,
// ceil(group_size / 8), n, 8) f32; the rest and the plan as
// pgm_dense_grid_launch takes them, `smem` as grid_smem_bytes counts it
// for complex data.
int pgm_dense_grid_cplx_launch(const void* br, const void* bi, const void* ar, const void* ai,
                               const void* scal, const void* tab, void* out, void* counts,
                               void* part, void* rdots, void* xpub, void* bar, void* prof, int P,
                               int m, int n, int steps, int method, int kind, int restart,
                               int proj, int slabs, int rows, int groups, int group_size,
                               int resident, int smem, void* stream) {
    const GridArgs args{static_cast<const float*>(br), static_cast<const float*>(bi),
                        static_cast<const float*>(ar), static_cast<const float*>(ai),
                        static_cast<const float*>(scal), static_cast<const float*>(tab),
                        static_cast<float*>(out), static_cast<int*>(counts),
                        static_cast<double*>(part), static_cast<double*>(rdots),
                        static_cast<float*>(xpub), static_cast<unsigned*>(bar),
                        static_cast<long long*>(prof), P, m, n, steps, restart, proj, slabs,
                        rows, groups, group_size};
    return launch<true>(args, method, kind, resident, smem, stream);
}

}  // extern "C"
