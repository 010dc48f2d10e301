// The Kaczmarz row recurrence for a batch of problems, one problem per CTA:
// a sweep over an index list, or the whole multi-sweep solve.
//
// Replaces two TPU kernels of rls_tpu/kernels/kaczmarz_pallas.py, which
// compute the same recurrence: kaczmarz_sweep_pallas (:72, _kernel :50,
// pallas_call :81), one sweep of a dense real A, and kaczmarz_solve_pallas
// (:206, _stream_kernel :118, pallas_call :273), the whole solve. A sweep
// is the solve with one sweep of a reused index list. For each visited row
// i (an entry -1 is skipped):
//   tau    = a_i . x                     (unconjugated)
//   alpha  = d_i ((u_i - tau) - eps vl_i)
//   x     += alpha conj(a_i)             (re += ar alr + ai ali, im += ar ali - ai alr)
//   vl_i  += alpha eps
// and after each sweep Positive (x = max(x, 0)) or, for complex x, Real
// (zero the imaginary plane; Positive does both). Complex data lives as
// split re / im planes.
//
// The rows are read in place from global memory by their index: a dense
// row a_i[0..n), or a padded CSR row (vals[i][0..k_max), cols[i][..]) of
// which only its nonzero entries are used. A padding entry (val 0, col 0)
// must not write: a thread adding alpha 0 to x[0] could overwrite another
// thread's update of a genuine column-0 entry, so zero entries are
// skipped. The TPU kernel's row gather in visit order, sweep chunking and
// SMEM / HBM / VMEM gates (:38-47, :326-413, :503-587) have no
// counterpart: they exist for the TPU's block DMA and memory budgets.
//
// Numerics: each of the (one or four) real dots of a row is summed in
// double from the f32 products and rounded to f32 once; thread 0 forms tau
// and alpha with f32 ops that nvcc may not contract (rls::fmul & co.), and
// the updates are separate f32 ops. The plain PyTorch version
// (kaczmarz_solve_torch in rls_tpu_torch/kernels/kaczmarz_streamed.py)
// sums in float64 the same way, so the two differ only where two double
// sums taken in another order round to different floats.
//
// What bounds it on an H100: a row step moves the row (4 L bytes, L = n or
// 8 k_max for CSR) and does 4 L operations (8 L complex), so a solve is
// bytes-bound at 3.35 TB/s. The kernel is far from that: a row step is a
// chain of dependent phases (the row's loads, a block reduction, thread 0's
// scalar update, a barrier, the axpy) that one CTA runs alone, so a solve
// is bound by that chain's latency times the rows visited, and only P of
// the 132 SMs hold a CTA. x stays in shared memory (n <= ~56k real), the
// rows and vl in global memory (A, up to 64 MiB, is read from L2 or HBM).
#include <cuda_runtime.h>

#include "dense_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
enum { kProxNone = 0, kProxPositive = 1, kProxReal = 2 };

template <bool kCplx, bool kCsr>
__global__ void __launch_bounds__(kThreads)
kaczmarz_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                const int* __restrict__ cols, const int* __restrict__ idx,
                float* __restrict__ x_all, float* __restrict__ vl_all,
                const float* __restrict__ u_all, const float* __restrict__ denom,
                const float* __restrict__ eps, int m, int n, int L, int sweeps, int S,
                int reuse, int prox) {
    extern __shared__ float s_x[];  // x: n floats (re), then n (im)
    __shared__ double s_red[4 * kWarps];
    __shared__ float s_alpha[2];
    constexpr int nc = kCplx ? 2 : 1;  // planes of x, vl, u
    constexpr int nd = kCplx ? 4 : 1;  // real dots of a row
    const int p = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    float* xr = s_x;
    float* xi = s_x + n;
    float* x = x_all + static_cast<size_t>(p) * nc * n;
    float* vl = vl_all + static_cast<size_t>(p) * nc * m;
    const float* u = u_all + static_cast<size_t>(p) * nc * m;
    const float* dp = denom + static_cast<size_t>(p) * m;
    const float e = eps[p];
    for (int k = tid; k < nc * n; k += kThreads) s_x[k] = x[k];
    __syncthreads();

    for (int t = 0; t < sweeps; ++t) {
        const int* rows = idx + static_cast<size_t>(reuse ? 0 : t) * S;
        for (int j = 0; j < S; ++j) {
            const int i = rows[j];
            if (i < 0) continue;  // the same for every thread
            const size_t base = static_cast<size_t>(i) * L;
            // the row's dot(s), each thread over its entries, in double
            double s[4] = {0.0, 0.0, 0.0, 0.0};
            for (int k = tid; k < L; k += kThreads) {
                const int c = kCsr ? cols[base + k] : k;
                const float a = ar[base + k];
                s[0] += rls::dmul(a, xr[c]);
                if constexpr (kCplx) {
                    const float b = ai[base + k];
                    s[1] += rls::dmul(b, xi[c]);
                    s[2] += rls::dmul(a, xi[c]);
                    s[3] += rls::dmul(b, xr[c]);
                }
            }
            for (int q = 0; q < nd; ++q) {
                const double w = rls::warp_sum(s[q]);
                if (lane == 0) s_red[4 * warp + q] = w;
            }
            __syncthreads();
            if (tid == 0) {
                double tot[4] = {0.0, 0.0, 0.0, 0.0};
                for (int w = 0; w < kWarps; ++w)
                    for (int q = 0; q < nd; ++q) tot[q] += s_red[4 * w + q];
                const float d = dp[i];
                if constexpr (kCplx) {
                    const float taur = rls::fsub(static_cast<float>(tot[0]),
                                                 static_cast<float>(tot[1]));
                    const float taui = rls::fadd(static_cast<float>(tot[2]),
                                                 static_cast<float>(tot[3]));
                    const float alr = rls::fmul(d, rls::fsub(rls::fsub(u[i], taur),
                                                             rls::fmul(e, vl[i])));
                    const float ali = rls::fmul(d, rls::fsub(rls::fsub(u[m + i], taui),
                                                             rls::fmul(e, vl[m + i])));
                    vl[i] = rls::fadd(vl[i], rls::fmul(alr, e));
                    vl[m + i] = rls::fadd(vl[m + i], rls::fmul(ali, e));
                    s_alpha[0] = alr;
                    s_alpha[1] = ali;
                } else {
                    const float tau = static_cast<float>(tot[0]);
                    const float al = rls::fmul(d, rls::fsub(rls::fsub(u[i], tau),
                                                            rls::fmul(e, vl[i])));
                    vl[i] = rls::fadd(vl[i], rls::fmul(al, e));
                    s_alpha[0] = al;
                }
            }
            __syncthreads();
            const float alr = s_alpha[0];
            const float ali = kCplx ? s_alpha[1] : 0.f;
            for (int k = tid; k < L; k += kThreads) {
                const int c = kCsr ? cols[base + k] : k;
                const float a = ar[base + k];
                if constexpr (kCplx) {
                    const float b = ai[base + k];
                    if (kCsr && a == 0.f && b == 0.f) continue;  // padding
                    xr[c] = rls::fadd(rls::fadd(xr[c], rls::fmul(alr, a)), rls::fmul(ali, b));
                    xi[c] = rls::fsub(rls::fadd(xi[c], rls::fmul(ali, a)), rls::fmul(alr, b));
                } else {
                    if (kCsr && a == 0.f) continue;  // padding
                    xr[c] = rls::fadd(xr[c], rls::fmul(alr, a));
                }
            }
            // a CSR row's columns belong to no fixed thread: the next row's
            // dot must see every update
            if constexpr (kCsr) __syncthreads();
        }
        if (prox == kProxPositive)
            for (int k = tid; k < n; k += kThreads) xr[k] = fmaxf(xr[k], 0.f);
        if (kCplx && prox != kProxNone)
            for (int k = tid; k < n; k += kThreads) xi[k] = rls::fmul(xi[k], 0.f);
        __syncthreads();
    }
    for (int k = tid; k < nc * n; k += kThreads) x[k] = s_x[k];
}

template <bool kCplx, bool kCsr>
int launch(const float* ar, const float* ai, const int* cols, const int* idx, float* x,
           float* vl, const float* u, const float* denom, const float* eps, int P, int m, int n,
           int L, int sweeps, int S, int reuse, int prox, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (kCplx ? 2 : 1) * static_cast<size_t>(n);
    auto kernel = kaczmarz_kernel<kCplx, kCsr>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<P, kThreads, smem, stream>>>(ar, ai, cols, idx, x, vl, u, denom, eps, m, n, L,
                                          sweeps, S, reuse, prox);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ar (ai): (m, L) f32, the rows' real (imaginary) parts: dense rows (L = n)
// or padded CSR values (L = k_max) with cols (m, L) int32 (null if dense);
// ai null for real rows. idx: (reuse ? 1 : sweeps, S) int32, -1 = skip.
// x: (P, nc, n) and vl: (P, nc, m), updated in place; u: (P, nc, m);
// denom: (P, m); eps: (P,). prox: 0 none, 1 Positive, 2 Real.
int kaczmarz_launch(const void* ar, const void* ai, const void* cols, const void* idx, void* x,
                    void* vl, const void* u, const void* denom, const void* eps, int P, int m,
                    int n, int L, int sweeps, int S, int reuse, int prox, void* stream) {
    if (P <= 0 || sweeps <= 0 || S <= 0) return 0;
    auto f = [&](auto run) {
        return run(static_cast<const float*>(ar), static_cast<const float*>(ai),
                   static_cast<const int*>(cols), static_cast<const int*>(idx),
                   static_cast<float*>(x), static_cast<float*>(vl),
                   static_cast<const float*>(u), static_cast<const float*>(denom),
                   static_cast<const float*>(eps), P, m, n, L, sweeps, S, reuse, prox,
                   static_cast<cudaStream_t>(stream));
    };
    if (ai != nullptr)
        return cols != nullptr ? f(launch<true, true>) : f(launch<true, false>);
    return cols != nullptr ? f(launch<false, true>) : f(launch<false, false>);
}

}  // extern "C"
