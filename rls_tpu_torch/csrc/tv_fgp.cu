// Batched 2-D anisotropic TV prox by FGP (fast gradient projection on the
// TV dual), one problem per CTA.
//
// Replaces the TPU kernel rls_tpu/kernels/tv_pallas.py:_kernel (launched by
// prox_tv2d_fgp_pallas, :69), which runs the fori FGP of
// rls_tpu/kernels/_fgp_common.py:939-964 with the image and four dual
// planes resident in VMEM. This kernel computes the same function in f32:
//   lam_safe = lam > 0 ? lam : 1,  inv8 = 1 / (8 lam_safe)
//   xtmp = x - lam gt(r)
//   q    = clip(r + g(xtmp) inv8, -1, 1) * mask
//   t'   = (1 + sqrt(1 + 4 t^2)) / 2,  t2 = (t - 1) / t'   (f32, on device)
//   r    = (1 + t2) q - t2 p,  p = q
//   out  = x - lam gt(p)
// The scalar recurrence uses round-to-nearest intrinsics so it is not
// contracted; the plane arithmetic may be FMA-contracted by nvcc (about
// 1 ulp per op against the plain PyTorch version).
//
// What bounds it on an H100: a 256^2 f32 plane is 256 KiB, more than the
// 227 KB of shared memory a block may use, so the planes (xtmp and the
// four duals) live in global scratch that the wrapper allocates, and each
// FGP iteration is two block-wide sweeps (about 13 plane reads and writes
// per pixel) separated by __syncthreads(). At batch 64 the live set
// (~1.5 MiB per problem) exceeds the 50 MB L2, so the kernel is bound by
// memory traffic and by the latency of one CTA per SM: 64 CTAs keep 64 of
// the 132 SMs busy. Splitting a problem across CTAs with halo rows, and
// keeping row tiles in shared memory, is later work.
#include <cuda_runtime.h>

#include "fgp_common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
tv_fgp_kernel(const float* __restrict__ x, const float* __restrict__ lam,
              float* __restrict__ out, float* __restrict__ scratch, int B,
              int H, int W, int iterations) {
    const int b = blockIdx.x;
    const int n = H * W;
    const size_t plane = (size_t)B * n;
    const size_t off = (size_t)b * n;
    const float* xb = x + off;
    float* ob = out + off;
    float* xtmp = scratch + off;
    float* pv = scratch + plane + off;
    float* ph = scratch + 2 * plane + off;
    float* rv = scratch + 3 * plane + off;
    float* rh = scratch + 4 * plane + off;

    const float lam_b = lam[b];
    const float lam_safe = lam_b > 0.f ? lam_b : 1.f;
    const float inv8 = __fdiv_rn(1.f, __fmul_rn(8.f, lam_safe));

    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        pv[i] = 0.f;
        ph[i] = 0.f;
        rv[i] = 0.f;
        rh[i] = 0.f;
    }
    __syncthreads();

    float t = 1.f;
    for (int it = 0; it < iterations; ++it) {
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int r = i / W;
            const int c = i - r * W;
            xtmp[i] = xb[i] - lam_b * rls::grad_t(rv, rh, i, r, c, W);
        }
        __syncthreads();

        const float t_new = __fdiv_rn(
            __fadd_rn(1.f, __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(__fmul_rn(4.f, t), t)))),
            2.f);
        const float t2 = __fdiv_rn(__fsub_rn(t, 1.f), t_new);
        const float c1 = __fadd_rn(1.f, t2);
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int r = i / W;
            const int c = i - r * W;
            const float qv = r < H - 1
                ? rls::clip(rv[i] + rls::grad_v(xtmp, i, W) * inv8, -1.f, 1.f)
                : 0.f;
            const float qh = c < W - 1
                ? rls::clip(rh[i] + rls::grad_h(xtmp, i) * inv8, -1.f, 1.f)
                : 0.f;
            rv[i] = c1 * qv - t2 * pv[i];
            rh[i] = c1 * qh - t2 * ph[i];
            pv[i] = qv;
            ph[i] = qh;
        }
        __syncthreads();
        t = t_new;
    }

    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / W;
        const int c = i - r * W;
        ob[i] = xb[i] - lam_b * rls::grad_t(pv, ph, i, r, c, W);
    }
}

}  // namespace

extern "C" {

// x, out: (B, H, W) f32; lam: (B,) f32; scratch: 5 planes of (B, H, W).
int tv_fgp_launch(const void* x, const void* lam, void* out, void* scratch,
                  int B, int H, int W, int iterations, void* stream) {
    tv_fgp_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(lam),
        static_cast<float*>(out), static_cast<float*>(scratch), B, H, W,
        iterations);
    return static_cast<int>(cudaGetLastError());
}

// The card's SM count and the shared memory a block may opt into, for the
// kernels' planners: out[0], out[1].
int rls_device_limits(int* out) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(out + 1, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return static_cast<int>(e);
}

const char* rls_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
