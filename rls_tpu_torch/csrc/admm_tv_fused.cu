// The whole batched ADMM-TV solve in one launch, one problem per CTA.
//
// Replaces the TPU kernel rls_tpu/kernels/admm_tv_fused.py:_kernel
// (:44-153; launched by admm_tv_fused, :156, pallas_call :180) with its
// exact stencil Gram: per outer iteration
//   beta = x0hat + rho (z - u)
//   x    = masked CG on (A^H A + rho I) x = beta, cg_iterations steps from
//          the previous x; a step is live while ||r|| > tol_inner ||beta||
//   x    = max(x, 0)                      (with the Positive projection)
//   z    = FGP-TV(x + u, lambda / 2 rho)  (x + u where rho = 0)
//   u    = u + x - z
// The FGP is the fold form of _fgp_unrolled_fold (rls::fold_fgp), valid
// because lambda / (2 rho) is the same at every outer iteration. The CG's
// three sums are block sums in double, in a fixed order; every thread
// evaluates the same `active` and takes the same branch. The kernel also
// counts each problem's live CG steps.
//
// What bounds it on an H100: as for the fused PGM-TV kernel, a 256^2 f32
// plane (256 KiB) is larger than a block's shared memory, so the 13 planes
// (x, z, u, r, p, q, two stencil temporaries, xg and the four FGP duals)
// live in global scratch that the wrapper allocates, and every pass is a
// block-wide sweep over global memory separated by __syncthreads(). A CG
// step is six sweeps (four stencil passes, the x / r update, the p update)
// and two block reductions; an outer iteration adds the CG start (four
// sweeps, one reduction) and the z-update (2 tv_iterations + 2 sweeps).
// At batch 16 the live set (16 x 13 planes, 54 MB) is about the size of the
// 50 MB L2, and only 16 of the 132 SMs hold a CTA: the kernel is bound by
// the latency of one CTA's dependent sweeps, not by the card's bandwidth
// or arithmetic. The design keeps one launch per solve and no host round
// trip; spreading a problem over several CTAs is the tiled kernel
// (admm_tv_tiled.cu).
#include <cuda_runtime.h>

#include "admm_tv_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTaps = 63;  // per axis; the wrapper checks it

__global__ void __launch_bounds__(kThreads)
admm_tv_fused_kernel(const float* __restrict__ x0hat, const float* __restrict__ scal,
                     const float* __restrict__ t2tab, const float* __restrict__ taps,
                     int kh, int kw, float* __restrict__ out,
                     float* __restrict__ scratch, int* __restrict__ counts, int B, int H,
                     int W, int iterations, int cg_iterations, int tv_iterations,
                     float tol_inner, int positive) {
    __shared__ float s_taps[2 * kMaxTaps];
    __shared__ double s_red[3 * (kThreads / 32)];
    for (int k = threadIdx.x; k < kh + kw; k += blockDim.x) s_taps[k] = taps[k];

    const int b = blockIdx.x;
    const int n = H * W;
    const size_t plane = static_cast<size_t>(B) * n;
    const size_t off = static_cast<size_t>(b) * n;
    auto sp = [&](int k) { return scratch + k * plane + off; };
    const float* x0 = x0hat + off;
    float* x = out + off;
    float* z = sp(0);
    float* u = sp(1);
    float* r = sp(2);
    float* p = sp(3);
    float* q = sp(4);
    float* t1 = sp(5);
    float* t2 = sp(6);
    float* xg = sp(7);
    float* pv = sp(8);
    float* ph = sp(9);
    float* rv = sp(10);
    float* rh = sp(11);

    const float rho = scal[2 * b];
    const float lam_z = rls::prox_scale(rho, scal[2 * b + 1]);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float zero = x0[i] * 0.f;
        x[i] = zero;
        z[i] = zero;
        u[i] = zero;
    }
    __syncthreads();

    int live = 0;
    double acc[3];
    for (int it = 0; it < iterations; ++it) {
        // the CG's start: beta, r = beta - (A^H A + rho I) x, p = r, with
        // ||beta||^2 and r.r
        rls::gram_passes(x, t1, t2, s_taps, kh, kw, H, W);
        acc[0] = acc[1] = acc[2] = 0.0;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int row = i / W;
            const float beta = x0[i] + rho * (z[i] - u[i]);
            const float res = beta - (rls::gram_last(t1, i, row, s_taps, kh, kw, W) + rho * x[i]);
            r[i] = res;
            p[i] = res;
            acc[0] += static_cast<double>(beta * beta);
            acc[1] += static_cast<double>(res * res);
        }
        rls::block_sum3(acc, s_red);
        const float target = rls::fmul(tol_inner, __fsqrt_rn(static_cast<float>(acc[0])));
        float rz = static_cast<float>(acc[1]);

        for (int j = 0; j < cg_iterations; ++j) {
            // q = (A^H A + rho I) p and p.q
            rls::gram_passes(p, t1, t2, s_taps, kh, kw, H, W);
            acc[0] = acc[1] = acc[2] = 0.0;
            for (int i = threadIdx.x; i < n; i += blockDim.x) {
                const int row = i / W;
                const float pval = p[i];
                const float qval = rls::gram_last(t1, i, row, s_taps, kh, kw, W) + rho * pval;
                q[i] = qval;
                acc[0] += static_cast<double>(pval * qval);
            }
            rls::block_sum3(acc, s_red);
            const bool active = rls::cg_active(rz, target);
            live += active ? 1 : 0;
            const float alpha = rls::cg_alpha(active, rz, static_cast<float>(acc[0]));
            // x += alpha p, r -= alpha q, and r.r
            acc[0] = acc[1] = acc[2] = 0.0;
            for (int i = threadIdx.x; i < n; i += blockDim.x) {
                x[i] = x[i] + alpha * p[i];
                const float rn = r[i] - alpha * q[i];
                r[i] = rn;
                acc[0] += static_cast<double>(rn * rn);
            }
            rls::block_sum3(acc, s_red);
            const float rz_new = static_cast<float>(acc[0]);
            const float beta_c = rls::cg_beta(rz, rz_new);
            // p = active ? r + beta_c p : p (every thread agrees on active)
            if (active)
                for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = r[i] + beta_c * p[i];
            rz = rz_new;
            __syncthreads();
        }

        // the projection, then z = FGP(x + u), then u
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            float xv = x[i];
            if (positive) {
                xv = fmaxf(xv, 0.f);
                x[i] = xv;
            }
            xg[i] = xv + u[i];
        }
        __syncthreads();
        if (tv_iterations > 0 && rho != 0.f)
            rls::fold_fgp(xg, pv, ph, rv, rh, t1, lam_z, t2tab, tv_iterations, false, H, W);
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int row = i / W;
            const float zv = rls::z_value(xg, pv, ph, i, row, W, tv_iterations, rho);
            z[i] = zv;
            u[i] = (u[i] + x[i]) - zv;
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) counts[b] = live;
}

}  // namespace

extern "C" {

// x0hat, out: (B, H, W) f32; scal: (B, 2) [rho, lam_eff]; t2tab:
// (tv_iterations, 2) [1 + t2, t2]; taps: kh + kw floats; scratch: 12
// planes of (B, H, W); counts: (B,) int32, the live CG steps; positive:
// project x onto x >= 0 after each x-update.
int admm_tv_fused_launch(const void* x0hat, const void* scal, const void* t2tab,
                         const void* taps, int kh, int kw, void* out, void* scratch,
                         void* counts, int B, int H, int W, int iterations,
                         int cg_iterations, int tv_iterations, float tol_inner,
                         int positive, void* stream) {
    if (kh > kMaxTaps || kw > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
    admm_tv_fused_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x0hat), static_cast<const float*>(scal),
        static_cast<const float*>(t2tab), static_cast<const float*>(taps), kh, kw,
        static_cast<float*>(out), static_cast<float*>(scratch), static_cast<int*>(counts), B,
        H, W, iterations, cg_iterations, tv_iterations, tol_inner, positive);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
