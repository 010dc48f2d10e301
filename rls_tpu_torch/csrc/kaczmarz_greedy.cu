// One S-step greedy-randomized Kaczmarz sweep for a batch of problems, one
// problem per CTA.
//
// Replaces the TPU kernel rls_tpu/kernels/kaczmarz_greedy.py:_kernel
// (:53-161; launched by kaczmarz_greedy_sweep_pallas, :164, pallas_call
// :221). Per step (reference Kaczmarz.jl:393-426), on the residual r:
//   r2_k  = r_k r_k,  dn = sum_k r2_k,  mx = max_k r2_k denom_k
//   e_k   = theta (mx / dn) + (1 - theta) fnorm, or (mx / dn + fnorm) / 2
//   w_k   = r2_k >= (e_k dn) norms_k ? r2_k : 0      (dn = 0 read as 1)
//   row   = argmax_k log w_k + G_k over w_k > 0 (Gumbel-max: a draw from
//           the categorical distribution w / sum w), ties to the smallest
//           index; or the step's forced row where one is given (>= 0)
//   alpha = denom_row r_row;  x += alpha a_row;  vl_row += alpha eps;
//   r    -= r_row Gt[row]    (Gt = diag(denom) (A A^T + lam I), m x m)
// The between-sweep Positive projection and the residual refresh
// r = u - eps vl - A x stay in PyTorch (kernels/kaczmarz_greedy.py).
//
// The draw: the TPU kernel draws with pltpu.prng_* (jax.random in interpret
// mode), which neither torch nor CUDA can repeat. Here the uniform of row k
// at a step is a counter-based hash in integer arithmetic,
//   h = lowbias32(lowbias32(lowbias32(lowbias32(lowbias32(seed) + sweep)
//       + problem) + step) + k)    (all mod 2^32)
//   U = ((h >> 9) + 0.5) 2^-23     (strictly inside (0, 1), exact in f32)
// and G = -logf(-logf(U)) (the correctly rounded-to-1-ulp logf, never
// __logf). The plain PyTorch version (kaczmarz_greedy_sweep_torch in
// rls_tpu_torch/kernels/kaczmarz_greedy.py) computes the same bits, so on
// the card both draw the same rows. dn is summed in double and rounded to
// f32 once; every other scalar and update is a separate f32 op.
//
// What bounds it on an H100: a step reads r, denom and norms (3 m floats),
// a_row (n) and Gt[row] (m) and writes r (m): ~24 m bytes per step, so a
// sweep is bytes-bound at 3.35 TB/s. The kernel is far from that: a step is
// two block reductions, thread 0's scalar update and a barrier that one
// CTA runs alone (latency-bound), and only P of the 132 SMs hold a CTA.
// Gt (4 MiB at m = 1024) stays in global memory (L2); the CTA reads one row
// of it per step. The TPU kernel's VMEM gate has no counterpart.
#include <cuda_runtime.h>

#include <cmath>

#include "pgm_tv_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned lowbias32(unsigned x) {
    x ^= x >> 16;
    x *= 0x7feb352dU;
    x ^= x >> 15;
    x *= 0x846ca68bU;
    x ^= x >> 16;
    return x;
}

// (a, ia) wins over (b, ib): the larger score, ties to the smaller index
__device__ __forceinline__ bool wins(float a, int ia, float b, int ib) {
    return a > b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
kaczmarz_greedy_kernel(const float* __restrict__ A, const float* __restrict__ Gt,
                       const float* __restrict__ denom, const float* __restrict__ norms,
                       float* __restrict__ x_all, float* __restrict__ vl_all,
                       float* __restrict__ r_all, const float* __restrict__ eps,
                       const int* __restrict__ forced, int* __restrict__ rows_out, int m, int n,
                       int S, float fnorm, float theta, int use_theta, unsigned seed,
                       unsigned sweep) {
    __shared__ double s_sum[kWarps];
    __shared__ float s_max[kWarps];
    __shared__ int s_idx[kWarps];
    __shared__ float s_step[2];  // alpha, r_row
    __shared__ int s_row;
    const int p = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    float* x = x_all + static_cast<size_t>(p) * n;
    float* vl = vl_all + static_cast<size_t>(p) * m;
    float* r = r_all + static_cast<size_t>(p) * m;
    const float e = eps[p];
    const unsigned pre_p = lowbias32(lowbias32(lowbias32(seed) + sweep) + static_cast<unsigned>(p));

    for (int j = 0; j < S; ++j) {
        // dn (in double) and mx
        double dsum = 0.0;
        float mx = -INFINITY;
        for (int k = tid; k < m; k += kThreads) {
            const float r2 = rls::fmul(r[k], r[k]);
            dsum += static_cast<double>(r2);
            mx = fmaxf(mx, rls::fmul(r2, denom[k]));
        }
        for (int o = 16; o > 0; o >>= 1) {
            dsum += __shfl_down_sync(0xffffffffu, dsum, o);
            mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, o));
        }
        if (lane == 0) {
            s_sum[warp] = dsum;
            s_max[warp] = mx;
        }
        __syncthreads();
        dsum = 0.0;
        mx = -INFINITY;
        for (int w = 0; w < kWarps; ++w) {
            dsum += s_sum[w];
            mx = fmaxf(mx, s_max[w]);
        }
        const float dn = static_cast<float>(dsum);
        const float safe = dn > 0.f ? dn : 1.f;
        const float q = rls::fdiv(mx, safe);
        const float ek = use_theta ? rls::fadd(rls::fmul(theta, q),
                                               rls::fmul(rls::fsub(1.f, theta), fnorm))
                                   : rls::fmul(0.5f, rls::fadd(q, fnorm));
        const float lower = rls::fmul(ek, safe);

        // the Gumbel-max draw over the thresholded weights
        const int fj = forced != nullptr ? forced[j] : -1;
        int row = fj;
        if (fj < 0) {
            const unsigned pre = lowbias32(pre_p + static_cast<unsigned>(j));
            float best = -INFINITY;
            int best_k = 0x7fffffff;
            for (int k = tid; k < m; k += kThreads) {
                const float r2 = rls::fmul(r[k], r[k]);
                const float w = r2 >= rls::fmul(lower, norms[k]) ? r2 : 0.f;
                float score = -INFINITY;
                if (w > 0.f) {
                    const unsigned h = lowbias32(pre + static_cast<unsigned>(k));
                    const float u = rls::fmul(rls::fadd(static_cast<float>(h >> 9), 0.5f),
                                              1.1920928955078125e-07f);  // 2^-23
                    score = rls::fadd(logf(w), -logf(-logf(u)));
                }
                if (wins(score, k, best, best_k)) {
                    best = score;
                    best_k = k;
                }
            }
            for (int o = 16; o > 0; o >>= 1) {
                const float ob = __shfl_down_sync(0xffffffffu, best, o);
                const int ok = __shfl_down_sync(0xffffffffu, best_k, o);
                if (wins(ob, ok, best, best_k)) {
                    best = ob;
                    best_k = ok;
                }
            }
            __syncthreads();  // s_max / s_sum of the stats are read by all
            if (lane == 0) {
                s_max[warp] = best;
                s_idx[warp] = best_k;
            }
            __syncthreads();
            best = s_max[0];
            best_k = s_idx[0];
            for (int w = 1; w < kWarps; ++w)
                if (wins(s_max[w], s_idx[w], best, best_k)) {
                    best = s_max[w];
                    best_k = s_idx[w];
                }
            row = best_k;
        }

        // the update: thread 0 forms alpha and bumps vl
        if (tid == 0) {
            const float r_row = r[row];
            const float alpha = rls::fmul(denom[row], r_row);
            vl[row] = rls::fadd(vl[row], rls::fmul(alpha, e));
            s_step[0] = alpha;
            s_step[1] = r_row;
            s_row = row;
            rows_out[static_cast<size_t>(p) * S + j] = row;
        }
        __syncthreads();
        const float alpha = s_step[0];
        const float r_row = s_step[1];
        const float* arow = A + static_cast<size_t>(s_row) * n;
        const float* grow = Gt + static_cast<size_t>(s_row) * m;
        for (int c = tid; c < n; c += kThreads) x[c] = rls::fadd(x[c], rls::fmul(alpha, arow[c]));
        for (int k = tid; k < m; k += kThreads) r[k] = rls::fsub(r[k], rls::fmul(r_row, grow[k]));
        __syncthreads();  // r, s_step and the reductions' shared memory are reused
    }
}

}  // namespace

extern "C" {

// A: (m, n) f32; Gt: (m, m) f32, Gt[i] = denom_i (A A^T + lam I)[i]; denom,
// norms: (m,); x: (P, n), vl, r: (P, m), updated in place; eps: (P,);
// forced: (S,) int32 rows (-1: draw) or null; rows_out: (P, S) int32, the
// rows the sweep visited.
int kaczmarz_greedy_launch(const void* A, const void* Gt, const void* denom, const void* norms,
                           void* x, void* vl, void* r, const void* eps, const void* forced,
                           void* rows_out, int P, int m, int n, int S, float fnorm, float theta,
                           int use_theta, unsigned seed, unsigned sweep, void* stream) {
    if (P <= 0 || S <= 0) return 0;
    kaczmarz_greedy_kernel<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(A), static_cast<const float*>(Gt),
        static_cast<const float*>(denom), static_cast<const float*>(norms),
        static_cast<float*>(x), static_cast<float*>(vl), static_cast<float*>(r),
        static_cast<const float*>(eps), static_cast<const int*>(forced),
        static_cast<int*>(rows_out), m, n, S, fnorm, theta, use_theta, seed, sweep);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
