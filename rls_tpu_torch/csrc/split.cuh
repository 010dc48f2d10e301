// A side of n points split over k parts as evenly as possible, and the
// floats of a CTA's band of rows and block of columns when the spectrum of
// an H x W image is split so over a cluster: the layout of the FFT
// kernels' cluster routes (rows 8, 9 and 10: fista_l1_dft_fused.cu's
// resident route, whose bands and blocks split H and W over the cluster,
// and sense_split.cuh's split route, which splits them over a team). The
// planners (kernels/fista_l1_dft_fused.py, kernels/sense_fused.py) count
// the same floats.
#pragma once

#include "dft_common.cuh"

namespace rls {

// A side of n points split over k parts (1 <= k <= n): part j holds
// [start(j), start(j) + size(j)), n / k points, one more for the first
// n % k parts.
struct Split {
    int base, rem;
    Divisor by_big, by_base;
    __device__ Split(int n, int k) : base(n / k), rem(n % k), by_big(n / k + 1), by_base(n / k) {}
    __device__ __forceinline__ int start(int j) const { return j * base + min(j, rem); }
    __device__ __forceinline__ int size(int j) const { return base + (j < rem ? 1 : 0); }
    // the part that holds point i
    __device__ __forceinline__ int owner(int i) const {
        const int cut = rem * (base + 1);
        return i < cut ? by_big.div(i) : rem + by_base.div(i - cut);
    }
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Floats of a CTA's band (ceil(H / team) rows of W points) and of its
// block (H rows of ceil(W / team) points at the pitch ceil(W / team) + 1)
// when H and W are split over `team` parts, each plane (re or im), rounded
// up to 4 floats: the planners (kernels/fista_l1_dft_fused.py
// resident_smem_bytes, kernels/sense_fused.py split_smem_bytes) count the
// same.
__host__ __device__ inline size_t split_band_floats(int H, int W, int team) {
    return ceil4(static_cast<size_t>(ceil_div(H, team)) * W);
}
__host__ __device__ inline size_t split_block_floats(int H, int W, int team) {
    return ceil4(static_cast<size_t>(H) * (ceil_div(W, team) + 1));
}

}  // namespace rls
