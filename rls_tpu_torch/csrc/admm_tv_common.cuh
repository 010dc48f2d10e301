// Device code of the ADMM-TV kernels, shared by the fused kernel
// (admm_tv_fused.cu: one CTA per problem, the whole solve in one launch)
// and the row-tiled kernel (admm_tv_tiled.cu: one CTA per row tile, a
// sequence of launches): the composite CG matvec (A^H A + rho I) on the
// exact stencil Gram, the masked CG's scalar rules, and the z-update.
//
// Counterparts in rls_tpu/kernels/admm_tv_fused.py: matvec and cg
// (:89-117) and the ADMM body (:131-146); the plain PyTorch version, which
// this code follows op for op, is admm_tv_fused_torch in
// rls_tpu_torch/kernels/admm_tv_fused.py.
//
// The CG's sums (||beta||^2, r.r, p.q) are taken per thread in double, in
// a fixed order, then over the block (rls::block_sum3) or over the tiles
// in tile order, and rounded to f32; the plain version sums in f32. The
// scalars are then formed with f32 ops that nvcc may not contract
// (rls::fmul & co), and every thread of a problem evaluates the same
// `active` and takes the same branch.
#pragma once

#include <cuda_runtime.h>

#include "pgm_tv_common.cuh"

namespace rls {

// The first three passes of A^H A on a window of `rows` image rows: the
// column pass, its adjoint and the row pass, leaving the row pass in t1
// for gram_last. The caller synchronises before (the passes read `in`'s
// neighbours); this ends with a barrier.
__device__ __forceinline__ void gram_passes(const float* in, float* t1, float* t2,
                                            const float* taps, int kh, int kw,
                                            int rows, int W) {
    stencil_v_pass(in, t1, taps, kh, false, rows, W);
    __syncthreads();
    stencil_v_pass(t1, t2, taps, kh, true, rows, W);
    __syncthreads();
    stencil_h_pass(t2, t1, taps + kh, kw, false, rows, W);
    __syncthreads();
}

// The fourth pass at pixel i (row r of the window): (A^H A in)[i].
__device__ __forceinline__ float gram_last(const float* t1, int i, int r,
                                           const float* taps, int kh, int kw,
                                           int W) {
    return stencil_h(t1, r, i - r * W, taps + kh, kw, true, W);
}

// The masked CG's scalar rules, exactly as pcg(unroll=True) guards them:
// a step is live while ||r|| = sqrt(rz) exceeds its target; a frozen step
// takes alpha = 0; denom = pq == 0 ? 1 : pq; beta = rz == 0 ? 0 :
// rz_new / rz.
__device__ __forceinline__ bool cg_active(float rz, float target) {
    return __fsqrt_rn(rz) > target;
}

__device__ __forceinline__ float cg_alpha(bool active, float rz, float pq) {
    return active ? fdiv(rz, pq == 0.f ? 1.f : pq) : 0.f;
}

__device__ __forceinline__ float cg_beta(float rz, float rz_new) {
    return rz == 0.f ? 0.f : fdiv(rz_new, rz);
}

// The prox scale lambda / (2 rho), with rho = 0 read as 1 (the z-update
// then takes x + u and the prox is not used).
__device__ __forceinline__ float prox_scale(float rho, float lam) {
    return fdiv(lam, fmul(2.f, rho != 0.f ? rho : 1.f));
}

// z at pixel i of a window: the FGP result xg - gt(pv, ph) (xg itself
// without dual iterations), or xg = x + u where rho = 0.
__device__ __forceinline__ float z_value(const float* xg, const float* pv,
                                         const float* ph, int i, int r, int W,
                                         int tv_iterations, float rho) {
    const float v = xg[i];
    if (rho == 0.f || tv_iterations == 0) return v;
    return v - grad_t(pv, ph, i, r, i - r * W, W);
}

}  // namespace rls
