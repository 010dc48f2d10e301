// The whole batched FISTA-L1 compressed-sensing solve on a subsampled 2-D
// DFT in one launch, one problem per CTA.
//
// Replaces the TPU kernel rls_tpu/kernels/fista_l1_dft_fused.py:_kernel
// (:32-107; launched by fista_l1_dft_fused, :110, pallas_call :129). Per
// iteration, from x = x_prev = 0:
//   x_mom = x + a (x - x_prev)                 (a: momentum table, column 0)
//   xg    = x_mom - rho (Re(F^H M F x_mom) - x0hat)
//   x     = max(|xg| - rho lam, 0) (xg + eps) / (|xg| + eps)
// The normal op is the in-kernel FFT of dft_common.cuh on the real image
// (im = 0 in, the real part out); the momentum is formed as the forward row
// pass loads x_mom, and the gradient step and the soft threshold as the
// inverse row pass stores each pixel. Every f32 operation is rounded on its
// own (rls::fmul & co.), as in the plain PyTorch version
// (rls_tpu_torch/kernels/fista_l1_dft_fused.py), with which it agrees bit
// for bit.
//
// What bounds it on an H100: a 256^2 problem is 10.5 MFLOP of FFT per
// iteration (two complex 2-D transforms at 5 n log2 n), where the TPU
// kernel's dense matrix sandwiches take ~400 MFLOP. A plane (512 KiB
// complex) is larger than a block's shared memory, so each normal op makes
// three passes over the spectrum in global memory (rows forward, columns
// forward-weight-inverse, rows back), each staging 4096 points at a time
// through shared memory, with a barrier after every radix-2 stage: some 600
// barriers per iteration. One CTA per problem: at batch 16 only 16 of the
// 132 SMs work, each running that chain of dependent stages, so the kernel
// is bound by its latency, not by bytes or operations. Spreading a problem
// over several CTAs, and several stages kept in registers between
// barriers, are later work.
#include <cuda_runtime.h>

#include "dft_common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
fista_l1_dft_fused_kernel(const float* __restrict__ x0hat, const float* __restrict__ scal,
                          const float* __restrict__ tab, const float* __restrict__ tw,
                          const float* __restrict__ weights, float* __restrict__ out,
                          float* __restrict__ scratch, int B, int H, int W, int iterations) {
    __shared__ rls::FftShared s;
    rls::load_twiddles(s, tw, H, W);

    const int b = blockIdx.x;
    const int n = H * W;
    const size_t plane = static_cast<size_t>(B) * n;
    const size_t off = static_cast<size_t>(b) * n;
    const float* x0 = x0hat + off;
    float* x = out + off;
    float* xp = scratch + off;
    float* xm = scratch + plane + off;
    float* kr = scratch + 2 * plane + off;
    float* ki = scratch + 3 * plane + off;

    const float rho = scal[2 * b];
    const float t = rls::fmul(rho, scal[2 * b + 1]);
    const float eps = 1.1920928955078125e-07f;  // 2^-23, float32's eps
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float zero = x0[i] * 0.f;
        x[i] = zero;
        xp[i] = zero;
    }
    __syncthreads();

    for (int it = 0; it < iterations; ++it) {
        const float a = tab[4 * it];
        auto load = [&](int i) {
            const float xv = x[i];
            const float m = rls::fadd(xv, rls::fmul(a, rls::fsub(xv, xp[i])));
            xm[i] = m;
            return make_float2(m, 0.f);
        };
        auto store = [&](int i, float nr, float) {
            const float m = xm[i];
            const float xg = rls::fsub(m, rls::fmul(rho, rls::fsub(nr, x0[i])));
            const float mag = fabsf(xg);
            const float shrink = fmaxf(rls::fsub(mag, t), 0.f);
            xp[i] = x[i];
            x[i] = rls::fdiv(rls::fmul(shrink, rls::fadd(xg, eps)), rls::fadd(mag, eps));
        };
        rls::masked_normal(load, store, kr, ki, weights, s, H, W);
    }
}

}  // namespace

extern "C" {

// x0hat, out: (B, H, W) f32; scal: (B, 2) [rho, lam_eff]; tab: (iterations,
// 4), the momentum table; tw: H + W floats [Re_H, Im_H, Re_W, Im_W] (the
// first H / 2 and W / 2 twiddles of each axis); weights: (H, W) the spectral
// weights; scratch: 4 planes of (B, H, W). H and W powers of two, 2..1024.
int fista_l1_dft_fused_launch(const void* x0hat, const void* scal, const void* tab,
                              const void* tw, const void* weights, void* out, void* scratch,
                              int B, int H, int W, int iterations, void* stream) {
    if (H > rls::kFftMax || W > rls::kFftMax) return static_cast<int>(cudaErrorInvalidValue);
    fista_l1_dft_fused_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x0hat), static_cast<const float*>(scal),
        static_cast<const float*>(tab), static_cast<const float*>(tw),
        static_cast<const float*>(weights), static_cast<float*>(out),
        static_cast<float*>(scratch), B, H, W, iterations);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
