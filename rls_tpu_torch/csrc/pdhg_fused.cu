// The whole fixed-iteration PDHG (Chambolle-Pock) solve on a separable
// convolution in one launch, one problem per CTA.
//
// Replaces the TPU kernel rls_tpu/kernels/pdhg_fused.py:_kernel (:97-182,
// with _grad8_ops :56-94; launched by pdhg_fused, :185, pallas_call :205).
// Per iteration, from x = y1 = y2 = 0:
//   y1 = (y1 + sigma (A x - u)) * (1 / (1 + sigma))
//   y2 = conj-prox(y2 + sigma Phi x)
//   x  = x - tau (A^H y1 + Phi^H y2), then max(x, 0) with Positive
// A and A^H are the zero-padded stencil passes of the TV kernels
// (fgp_common.cuh, rows then columns). Phi by `kind`:
//   kTv8   the 8 directional differences of Grad8Operator, plane k
//          x[r, c] - x[r + dr_k, c + dc_k] where defined, else 0; the
//          conj-prox is the sequential weighted projection (direction k's
//          group norm uses the already thresholded planes 0..k-1, squares
//          summed from plane 0); Phi^H sums, in plane order, q_k minus q_k
//          shifted back by (dr_k, dc_k);
//   kTviso the 2 masked forward differences x[r+1] - x[r], x[c+1] - x[c]
//          and the elementwise lambda-ball clip; Phi^H y = ((pv[r-1] - pv)
//          + ph[c-1]) - ph;
//   kL1    Phi = I with the same clip.
// No gap is computed: it never feeds the iterate, and the fixed-iteration
// composed solve ignores it. The plain PyTorch version, which this code
// follows op for op, is pdhg_fused_torch in rls_tpu_torch/kernels/
// pdhg_fused.py. Every product and sum is rounded on its own (rls::fmul &
// co., stencil passes with kRound), so nvcc contracts nothing and the
// kernel can agree with the plain version bit for bit.
//
// What bounds it on an H100: per pixel and iteration the four stencil
// passes (4 K - 2 operations for a K-tap kernel) and the dual/primal
// updates (~120 operations for kTv8, ~20 for kL1), so the solve is
// operations-bound at the card's peak. As in the other fused TV kernels,
// a 256^2 plane (256 KiB) does not fit a block's shared memory: x, y1, the
// stencil temporary and the dual planes (8, 2 or 1) live in global scratch
// that the wrapper allocates, each iteration is four block-wide sweeps over
// them separated by __syncthreads(), and at batch 16 only 16 of the 132
// SMs hold a CTA. The kernel is bound by the latency of one CTA's
// dependent sweeps; the TPU's VMEM gate (:222-229) has no counterpart.
#include <cuda_runtime.h>

#include "pgm_tv_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTaps = 63;  // per axis; the wrapper checks it
enum { kTv8 = 0, kTviso = 1, kL1 = 2 };

// (row, column) offset of the subtracted sample per plane (_DIRS8)
__constant__ int kDr[8] = {1, 0, 1, 1, 2, 2, 1, 1};
__constant__ int kDc[8] = {0, 1, 1, -1, 1, -1, 2, -2};

// plane k of the 8-direction gradient is defined at (r, c)
__device__ __forceinline__ bool defined8(int k, int r, int c, int H, int W) {
    const int dr = kDr[k];
    const int dc = kDc[k];
    if (r < 0 || r >= H - dr) return false;
    return dc >= 0 ? (c >= 0 && c < W - dc) : (c >= -dc && c < W);
}

// mag > lam ? p / max(mag, 1e-30) * lam : p
__device__ __forceinline__ float clip_conj(float p, float lam) {
    const float mag = fabsf(p);
    return mag > lam ? rls::fmul(rls::fdiv(p, fmaxf(mag, 1e-30f)), lam) : p;
}

__device__ __forceinline__ float sign(float v) {
    return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

__global__ void __launch_bounds__(kThreads)
pdhg_fused_kernel(const float* __restrict__ u_all, const float* __restrict__ scal,
                  const float* __restrict__ taps, const float* __restrict__ weights, int kh,
                  int kw, float* __restrict__ out, float* __restrict__ scratch, int B, int H,
                  int W, int iterations, int kind, int positive) {
    __shared__ float s_taps[2 * kMaxTaps];
    __shared__ float s_w[8];
    for (int k = threadIdx.x; k < kh + kw; k += blockDim.x) s_taps[k] = taps[k];
    if (threadIdx.x < 8) s_w[threadIdx.x] = weights[threadIdx.x];

    const int b = blockIdx.x;
    const int n = H * W;
    const size_t plane = static_cast<size_t>(B) * n;
    const size_t off = static_cast<size_t>(b) * n;
    const float* u = u_all + off;
    float* x = out + off;
    float* y1 = scratch + off;
    float* t1 = scratch + plane + off;
    float* y2[8];
    const int np = kind == kTv8 ? 8 : (kind == kTviso ? 2 : 1);
    for (int k = 0; k < np; ++k) y2[k] = scratch + (2 + k) * plane + off;

    const float sigma = scal[3 * b];
    const float tau = scal[3 * b + 1];
    const float lam = scal[3 * b + 2];
    const float inv1s = rls::fdiv(1.f, rls::fadd(1.f, sigma));
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float zero = rls::fmul(u[i], 0.f);
        x[i] = zero;
        y1[i] = zero;
        for (int k = 0; k < np; ++k) y2[k][i] = zero;
    }
    __syncthreads();

    const float* th = s_taps;
    const float* tw = s_taps + kh;
    for (int it = 0; it < iterations; ++it) {
        // A x: the row pass, then (below) the column pass
        rls::stencil_v_pass<true>(x, t1, th, kh, false, H, W);
        __syncthreads();
        // the dual updates, pixel by pixel (x is not written in this sweep)
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int r = i / W;
            const int c = i - r * W;
            const float ax = rls::stencil_h<true>(t1, r, c, tw, kw, false, W);
            y1[i] = rls::fmul(rls::fadd(y1[i], rls::fmul(sigma, rls::fsub(ax, u[i]))), inv1s);
            if (kind == kTv8) {
                float p[8];
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const float g = defined8(k, r, c, H, W)
                                        ? rls::fsub(x[i], x[i + kDr[k] * W + kDc[k]])
                                        : 0.f;
                    p[k] = rls::fadd(y2[k][i], rls::fmul(sigma, g));
                }
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    float s = rls::fmul(p[0], p[0]);
#pragma unroll
                    for (int q = 1; q < 8; ++q) s = rls::fadd(s, rls::fmul(p[q], p[q]));
                    const float gnorm = __fsqrt_rn(s);
                    p[k] = rls::fmul(rls::fmul(s_w[k], sign(p[k])), fminf(gnorm, lam));
                }
#pragma unroll
                for (int k = 0; k < 8; ++k) y2[k][i] = p[k];
            } else if (kind == kTviso) {
                const float gv = r < H - 1 ? rls::fsub(x[i + W], x[i]) : 0.f;
                const float gh = c < W - 1 ? rls::fsub(x[i + 1], x[i]) : 0.f;
                y2[0][i] = clip_conj(rls::fadd(y2[0][i], rls::fmul(sigma, gv)), lam);
                y2[1][i] = clip_conj(rls::fadd(y2[1][i], rls::fmul(sigma, gh)), lam);
            } else {
                y2[0][i] = clip_conj(rls::fadd(y2[0][i], rls::fmul(sigma, x[i])), lam);
            }
        }
        __syncthreads();
        // A^H y1: the row pass, then (below) the column pass
        rls::stencil_v_pass<true>(y1, t1, th, kh, true, H, W);
        __syncthreads();
        // the primal update (reads the duals' neighbours, writes x[i] only)
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int r = i / W;
            const int c = i - r * W;
            const float aty = rls::stencil_h<true>(t1, r, c, tw, kw, true, W);
            float d;
            if (kind == kTv8) {
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const int rr = r - kDr[k];
                    const int cc = c - kDc[k];
                    const float q = defined8(k, r, c, H, W) ? y2[k][i] : 0.f;
                    const float qs = defined8(k, rr, cc, H, W) ? y2[k][rr * W + cc] : 0.f;
                    const float term = rls::fsub(q, qs);
                    d = k == 0 ? term : rls::fadd(d, term);
                }
            } else if (kind == kTviso) {
                const float up = r > 0 ? y2[0][i - W] : 0.f;
                const float left = c > 0 ? y2[1][i - 1] : 0.f;
                d = rls::fsub(rls::fadd(rls::fsub(up, y2[0][i]), left), y2[1][i]);
            } else {
                d = y2[0][i];
            }
            float xv = rls::fsub(x[i], rls::fmul(tau, rls::fadd(aty, d)));
            if (positive) xv = fmaxf(xv, 0.f);
            x[i] = xv;
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" {

// u, out: (B, H, W) f32; scal: (B, 3) [sigma, tau, lam_eff]; taps: kh + kw
// floats; weights: the 8 plane weights of kTv8; scratch: 2 + planes of
// (B, H, W) (planes 8, 2, 1 for kind 0, 1, 2); positive: max(x, 0) after
// every primal update.
int pdhg_fused_launch(const void* u, const void* scal, const void* taps, const void* weights,
                      int kh, int kw, void* out, void* scratch, int B, int H, int W,
                      int iterations, int kind, int positive, void* stream) {
    if (kh > kMaxTaps || kw > kMaxTaps || kind < kTv8 || kind > kL1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B <= 0) return 0;
    pdhg_fused_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(u), static_cast<const float*>(scal),
        static_cast<const float*>(taps), static_cast<const float*>(weights), kh, kw,
        static_cast<float*>(out), static_cast<float*>(scratch), B, H, W, iterations, kind,
        positive);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
