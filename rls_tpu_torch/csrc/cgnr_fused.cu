// The whole batched CGNR solve on a dense matrix in one launch, one problem
// per CTA.
//
// Replaces the TPU kernel rls_tpu/kernels/cgnr_fused.py:_kernel (:86-130;
// launched by solve_cgnr_fused, :174, pallas_call :260). Per problem, from
// x = 0 and r = p = A^T b, `steps` times
//   q = A p, v = A^T q, zeta = r.r, denom = p.v + lam p.p
//   alpha = zeta > 0 ? zeta / (denom == 0 ? 1 : denom) : 0
//   x += alpha p, r = (r - alpha v) - (lam alpha) p
//   beta = r.r / (zeta > 0 ? zeta : 1), p = r + beta p
// then x = max(x, 0) with the Positive projection. The guards make a step
// past convergence (r = p = 0) the identity. The plain PyTorch version,
// which this code follows op for op, is cgnr_fused_torch in
// rls_tpu_torch/kernels/cgnr_fused.py.
//
// Numerics: the matvec entries and the four dots are summed in double in a
// fixed order and rounded to f32 (rls::mv_rows / mv_cols, rls::block_sum3);
// every thread then derives alpha and beta from the same f32 scalars with
// f32 ops that nvcc may not contract (rls::fmul & co), and takes the same
// branch. The updates are separate f32 ops too, so the kernel differs from
// its plain version only where two double sums round to different floats.
//
// What bounds it on an H100: a step is 4 m n + 10 n f32 operations per
// problem (two matvecs, three dots, three updates), so the solve is
// operations-bound at the card's peak. The kernel is far from that bound.
// A (m x n f32, up to ~2.5 MiB where the TPU gate allows 4 m n 4 B + 2 MiB
// <= 12 MiB) stays in the 50 MB L2, and each CTA re-reads it from L2 twice
// per step (once along the rows for q, once down the columns for v), so the
// L2's bandwidth, shared by all CTAs, limits a step; and at batch 16 only
// 16 of the 132 SMs hold a CTA. The planes r, p, v (n) and q (m) live in
// global scratch that the wrapper allocates, so every shape the TPU gate
// accepts runs (16 x 36000 as well as 1024 x 512).
#include <cuda_runtime.h>

#include "dense_common.cuh"

namespace {

constexpr int kThreads = rls::kDenseThreads;

__global__ void __launch_bounds__(kThreads)
cgnr_fused_kernel(const float* __restrict__ b, const float* __restrict__ A,
                  const float* __restrict__ lam, float* __restrict__ out,
                  float* __restrict__ scratch, int m, int n, int steps, int positive) {
    __shared__ double s_red[3 * (kThreads / 32)];
    const int pb = blockIdx.x;
    float* r = scratch + static_cast<size_t>(pb) * (3 * n + m);
    float* p = r + n;
    float* v = p + n;
    float* q = v + n;
    float* x = out + static_cast<size_t>(pb) * n;
    const float lm = lam[pb];

    // r = A^T b, x = r * 0, p = r
    rls::mv_cols<false>(A, nullptr, b + static_cast<size_t>(pb) * m, nullptr, r, nullptr, m, n);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        x[j] = rls::fmul(r[j], 0.f);
        p[j] = r[j];
    }
    __syncthreads();

    double acc[3];
    for (int it = 0; it < steps; ++it) {
        rls::mv_rows<false>(A, nullptr, p, nullptr, q, nullptr, m, n);
        __syncthreads();
        rls::mv_cols<false>(A, nullptr, q, nullptr, v, nullptr, m, n);
        acc[0] = acc[1] = acc[2] = 0.0;
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
            const float rj = r[j];
            const float pj = p[j];
            acc[0] += rls::dmul(rj, rj);
            acc[1] += rls::dmul(pj, v[j]);
            acc[2] += rls::dmul(pj, pj);
        }
        rls::block_sum3(acc, s_red);
        const float zeta = static_cast<float>(acc[0]);
        const float denom = rls::fadd(static_cast<float>(acc[1]),
                                      rls::fmul(lm, static_cast<float>(acc[2])));
        const float alpha = zeta > 0.f ? rls::fdiv(zeta, denom == 0.f ? 1.f : denom) : 0.f;
        const float la = rls::fmul(lm, alpha);
        acc[0] = acc[1] = acc[2] = 0.0;
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
            const float pj = p[j];
            x[j] = rls::fadd(x[j], rls::fmul(alpha, pj));
            const float rn = rls::fsub(rls::fsub(r[j], rls::fmul(alpha, v[j])), rls::fmul(la, pj));
            r[j] = rn;
            acc[0] += rls::dmul(rn, rn);
        }
        rls::block_sum3(acc, s_red);
        const float beta = rls::fdiv(static_cast<float>(acc[0]), zeta > 0.f ? zeta : 1.f);
        for (int j = threadIdx.x; j < n; j += blockDim.x)
            p[j] = rls::fadd(r[j], rls::fmul(beta, p[j]));
        __syncthreads();
    }
    if (positive)
        for (int j = threadIdx.x; j < n; j += blockDim.x) x[j] = fmaxf(x[j], 0.f);
}

}  // namespace

extern "C" {

// b: (P, m) f32, one problem per row; A: (m, n) f32 row-major; lam: (P,);
// out: (P, n); scratch: (P, 3 n + m); positive: clip x at 0 at the end.
int cgnr_fused_launch(const void* b, const void* A, const void* lam, void* out, void* scratch,
                      int P, int m, int n, int steps, int positive, void* stream) {
    if (P <= 0) return 0;
    cgnr_fused_kernel<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(b), static_cast<const float*>(A),
        static_cast<const float*>(lam), static_cast<float*>(out), static_cast<float*>(scratch),
        m, n, steps, positive);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
