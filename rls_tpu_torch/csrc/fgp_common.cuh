// Device functions shared by the TV-FGP prox kernel (tv_fgp.cu), the PGM-TV
// and ADMM-TV kernels and the fused PDHG kernel (pdhg_fused.cu): the
// forward differences, their adjoint, and the zero-padded stencil passes of
// a separable convolution.
//
// Counterparts of rls_tpu/kernels/_fgp_common.py: the roll-based
// gradients of _fgp_grid (:636-667) and the stencil passes of
// make_sepconv_stencil_ops (:303-371); the plain PyTorch versions are in
// rls_tpu_torch/kernels/_fgp_common.py and follow the same op order.
//
// Layout: one CTA owns one problem; its (H, W) planes are row-major in
// global memory. Every pass is a block-stride sweep over the pixels; the
// caller puts __syncthreads() between passes that read neighbours.
#pragma once

#include <cuda_runtime.h>

namespace rls {

// jnp.clip(v, lo, hi) == minimum(maximum(v, lo), hi)
__device__ __forceinline__ float clip(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

// gv(u)[r, c] = u[r + 1, c] - u[r, c]. On the TPU the last row wraps and is
// then killed by the mask or the zero clip bound; callers here never
// evaluate it (they write the masked value, 0, directly).
__device__ __forceinline__ float grad_v(const float* u, int i, int W) {
    return u[i + W] - u[i];
}

// gh(u)[r, c] = u[r, c + 1] - u[r, c]; the last column as for grad_v.
__device__ __forceinline__ float grad_h(const float* u, int i) {
    return u[i + 1] - u[i];
}

// gt(pv, ph) = (roll(pv, 1, 0) - pv) + (roll(ph, 1, 1) - ph): the roll
// brings the duals' last row / column to index 0, and those are exactly
// zero, so row -1 and column -1 read as 0.
__device__ __forceinline__ float grad_t(const float* pv, const float* ph,
                                        int i, int r, int c, int W) {
    const float up = r > 0 ? pv[i - W] : 0.f;
    const float left = c > 0 ? ph[i - 1] : 0.f;
    return (up - pv[i]) + (left - ph[i]);
}

// acc + t v, or t v for the first tap. With kRound the product and the sum
// are rounded on their own, as the plain PyTorch passes round them; else
// nvcc may contract them into one FMA (~1 ulp per tap).
template <bool kRound>
__device__ __forceinline__ float tap_acc(float acc, float t, float v, bool first) {
    if constexpr (kRound) {
        const float tv = __fmul_rn(t, v);
        return first ? tv : __fadd_rn(acc, tv);
    } else {
        return first ? t * v : acc + t * v;
    }
}

// One zero-padded 1-D pass at pixel (r, c) along the rows (dim 0):
// sum_k t_k u[r + s_k, c] with s_k = k - K/2, negated for the adjoint,
// summed in tap order (zero outside the image).
template <bool kRound = false>
__device__ __forceinline__ float stencil_v(const float* u, int r, int c,
                                           const float* taps, int K,
                                           bool adjoint, int H, int W) {
    const int R = K / 2;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
        const int rr = r + (adjoint ? R - k : k - R);
        const float v = (rr >= 0 && rr < H) ? u[rr * W + c] : 0.f;
        acc = tap_acc<kRound>(acc, taps[k], v, k == 0);
    }
    return acc;
}

// The same pass along the columns (dim 1).
template <bool kRound = false>
__device__ __forceinline__ float stencil_h(const float* u, int r, int c,
                                           const float* taps, int K,
                                           bool adjoint, int W) {
    const int R = K / 2;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
        const int cc = c + (adjoint ? R - k : k - R);
        const float v = (cc >= 0 && cc < W) ? u[r * W + cc] : 0.f;
        acc = tap_acc<kRound>(acc, taps[k], v, k == 0);
    }
    return acc;
}

// Block-stride pass writing stencil_v over a whole plane.
template <bool kRound = false>
__device__ __forceinline__ void stencil_v_pass(const float* __restrict__ u,
                                               float* __restrict__ out,
                                               const float* taps, int K,
                                               bool adjoint, int H, int W) {
    for (int i = threadIdx.x; i < H * W; i += blockDim.x) {
        const int r = i / W;
        out[i] = stencil_v<kRound>(u, r, i - r * W, taps, K, adjoint, H, W);
    }
}

template <bool kRound = false>
__device__ __forceinline__ void stencil_h_pass(const float* __restrict__ u,
                                               float* __restrict__ out,
                                               const float* taps, int K,
                                               bool adjoint, int H, int W) {
    for (int i = threadIdx.x; i < H * W; i += blockDim.x) {
        const int r = i / W;
        out[i] = stencil_h<kRound>(u, r, i - r * W, taps, K, adjoint, W);
    }
}

}  // namespace rls
