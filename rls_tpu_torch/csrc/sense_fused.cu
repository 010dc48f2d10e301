// The whole batched FISTA-L21 multi-coil SENSE solve in one launch, one
// slice per CTA.
//
// Replaces the TPU kernel rls_tpu/kernels/sense_fused.py:_kernel (:33-82;
// launched by fista_l21_sense_fused, :85, pallas_call :107). The complex
// image x = (xr, xi), complex L1 as the group soft threshold over (re, im)
// pairs; per iteration, from x = x_prev = 0:
//   m   = x + a (x - x_prev)                  (both planes; a: table column 0)
//   g   = m - rho (sum_c conj(C_c) F^H M F C_c m - x0hat)
//   |g| = sqrt(gr^2 + gi^2)
//   x   = g max((|g| - rho lam) / (|g| == 0 ? 1 : |g|), 0)
// The SENSE normal op (dft_common.cuh) runs the masked normal op of the
// in-kernel FFT once per coil; the gradient step and the threshold are
// formed as the last coil's inverse row pass stores. Every f32 operation is rounded on its own, as in
// the plain PyTorch version (rls_tpu_torch/kernels/sense_fused.py), with
// which it agrees bit for bit.
//
// What bounds it on an H100: per iteration C normal ops of three passes over
// the spectrum (2 C complex 2-D transforms at 5 n log2 n: 13.8 MFLOP at
// 128^2 and 6 coils), each a chain of barrier-separated radix-2 stages
// (some 840 barriers per iteration). One CTA per slice: at 8 slices only 8
// of the 132 SMs work, so the kernel is bound by the latency of that chain,
// not by bytes or operations.
#include <cuda_runtime.h>

#include "dft_common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
sense_fused_kernel(const float* __restrict__ x0hat, const float* __restrict__ scal,
                   const float* __restrict__ tab, const float* __restrict__ tw,
                   const float* __restrict__ weights, const float* __restrict__ coils_r,
                   const float* __restrict__ coils_i, float* __restrict__ out,
                   float* __restrict__ scratch, int B, int H, int W, int C, int iterations) {
    __shared__ rls::FftShared s;
    rls::load_twiddles(s, tw, H, W);

    const int b = blockIdx.x;
    const int n = H * W;
    const size_t plane = static_cast<size_t>(B) * n;
    const size_t off = static_cast<size_t>(b) * n;
    auto sp = [&](int k) { return scratch + k * plane + off; };
    const float* x0r = x0hat + 2 * off;
    const float* x0i = x0r + n;
    float* xr = out + 2 * off;
    float* xi = xr + n;
    float* mr = sp(0);
    float* mi = sp(1);
    float* pr = sp(2);
    float* pi = sp(3);
    float* kr = sp(4);
    float* ki = sp(5);
    float* accr = sp(6);
    float* acci = sp(7);

    const float rho = scal[2 * b];
    const float t = rls::fmul(rho, scal[2 * b + 1]);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float zero = x0r[i] * 0.f;
        xr[i] = zero;
        xi[i] = zero;
        pr[i] = zero;
        pi[i] = zero;
    }
    __syncthreads();

    for (int it = 0; it < iterations; ++it) {
        const float a = tab[4 * it];
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const float vr = xr[i], vi = xi[i];
            mr[i] = rls::fadd(vr, rls::fmul(a, rls::fsub(vr, pr[i])));
            mi[i] = rls::fadd(vi, rls::fmul(a, rls::fsub(vi, pi[i])));
        }
        __syncthreads();
        auto finish = [&](int i, float nr, float ni) {
            const float gr = rls::fsub(mr[i], rls::fmul(rho, rls::fsub(nr, x0r[i])));
            const float gi = rls::fsub(mi[i], rls::fmul(rho, rls::fsub(ni, x0i[i])));
            const float gn = __fsqrt_rn(rls::fadd(rls::fmul(gr, gr), rls::fmul(gi, gi)));
            const float sc = fmaxf(rls::fdiv(rls::fsub(gn, t), gn == 0.f ? 1.f : gn), 0.f);
            pr[i] = xr[i];
            pi[i] = xi[i];
            xr[i] = rls::fmul(gr, sc);
            xi[i] = rls::fmul(gi, sc);
        };
        rls::sense_normal(mr, mi, coils_r, coils_i, C, kr, ki, accr, acci, weights, finish, s, H,
                          W);
    }
}

}  // namespace

extern "C" {

// x0hat, out: (B, 2, H, W) f32, the split [re; im] image; scal: (B, 2) [rho,
// lam_eff]; tab: (iterations, 4), the momentum table; tw: H + W floats
// [Re_H, Im_H, Re_W, Im_W]; weights: (H, W) the spectral weights; coils_r,
// coils_i: (C, H, W); scratch: 8 planes of (B, H, W). H and W powers of two,
// 2..1024.
int sense_fused_launch(const void* x0hat, const void* scal, const void* tab, const void* tw,
                       const void* weights, const void* coils_r, const void* coils_i,
                       void* out, void* scratch, int B, int H, int W, int C, int iterations,
                       void* stream) {
    if (H > rls::kFftMax || W > rls::kFftMax || C < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    sense_fused_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x0hat), static_cast<const float*>(scal),
        static_cast<const float*>(tab), static_cast<const float*>(tw),
        static_cast<const float*>(weights), static_cast<const float*>(coils_r),
        static_cast<const float*>(coils_i), static_cast<float*>(out),
        static_cast<float*>(scratch), B, H, W, C, iterations);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
