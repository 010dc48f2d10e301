// Device code of the dense-matrix kernels (cgnr_fused.cu, pgm_dense_fused.cu):
// the matvec pair q = A x and v = A^H q, read from A in row-major f32 by one
// CTA, real or in the complex pattern on (re, im) planes.
//
// Every entry is summed in double from the f32 products (exact in double)
// and rounded to f32 once. For a complex apply each of the four real dot
// products is rounded on its own before they are combined in f32, as the
// plain PyTorch versions (kernels/cgnr_fused.py, kernels/pgm_dense_fused.py)
// combine four float64 matmuls rounded to f32. The sums' order is fixed, so
// a kernel's result does not change from run to run.
//
// A matvec is bound by the latency of A's loads from L2, not by the
// arithmetic: each thread's sum is one dependent chain, so the loops are
// unrolled (the order of the sum stays the same) to keep several loads of
// a thread in flight at once.
#pragma once

#include <cuda_runtime.h>

#include "pgm_tv_common.cuh"

namespace rls {

constexpr int kDenseThreads = 512;

// The sum of v over a warp, in lane 0.
__device__ __forceinline__ double warp_sum(double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ double dmul(float a, float b) {
    return static_cast<double>(a) * static_cast<double>(b);
}

// q = A x, one warp per row, each lane summing a stride of the row (reads
// along the row). Complex (kCplx): qr = Ar xr - Ai xi, qi = Ai xr + Ar xi.
template <bool kCplx>
__device__ __forceinline__ void mv_rows(const float* __restrict__ ar,
                                        const float* __restrict__ ai, const float* xr,
                                        const float* xi, float* qr, float* qi, int m,
                                        int n) {
    const int lane = threadIdx.x & 31;
    const int nw = blockDim.x >> 5;
    for (int i = threadIdx.x >> 5; i < m; i += nw) {
        const float* rr = ar + static_cast<size_t>(i) * n;
        const float* ri = kCplx ? ai + static_cast<size_t>(i) * n : nullptr;
        double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
        for (int j = lane; j < n; j += 32) {
            s[0] += dmul(rr[j], xr[j]);
            if constexpr (kCplx) {
                s[1] += dmul(ri[j], xi[j]);
                s[2] += dmul(ri[j], xr[j]);
                s[3] += dmul(rr[j], xi[j]);
            }
        }
        for (int k = 0; k < (kCplx ? 4 : 1); ++k) s[k] = warp_sum(s[k]);
        if (lane == 0) {
            if constexpr (kCplx) {
                qr[i] = fsub(static_cast<float>(s[0]), static_cast<float>(s[1]));
                qi[i] = fadd(static_cast<float>(s[2]), static_cast<float>(s[3]));
            } else {
                qr[i] = static_cast<float>(s[0]);
            }
        }
    }
}

// v = A^H q, one thread per column summing over the rows in order
// (neighbouring threads read neighbouring entries of a row). Complex:
// vr = Ar^T qr + Ai^T qi, vi = Ar^T qi - Ai^T qr. Thread t owns the columns
// j = t, t + blockDim.x, ...: the callers' element loops use the same
// mapping, so a thread reads back what it wrote without a barrier.
template <bool kCplx>
__device__ __forceinline__ void mv_cols(const float* __restrict__ ar,
                                        const float* __restrict__ ai, const float* qr,
                                        const float* qi, float* vr, float* vi, int m,
                                        int n) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 8
        for (int i = 0; i < m; ++i) {
            const size_t k = static_cast<size_t>(i) * n + j;
            s[0] += dmul(ar[k], qr[i]);
            if constexpr (kCplx) {
                s[1] += dmul(ai[k], qi[i]);
                s[2] += dmul(ar[k], qi[i]);
                s[3] += dmul(ai[k], qr[i]);
            }
        }
        if constexpr (kCplx) {
            vr[j] = fadd(static_cast<float>(s[0]), static_cast<float>(s[1]));
            vi[j] = fsub(static_cast<float>(s[2]), static_cast<float>(s[3]));
        } else {
            vr[j] = static_cast<float>(s[0]);
        }
    }
}

}  // namespace rls
