// The greedy-randomized Kaczmarz solve for a batch of problems, one problem
// per CTA: T sweeps of S steps, each sweep followed by the Positive
// projection (or none) and the residual refresh, on one of two routes.
//
// Replaces the TPU kernel rls_tpu/kernels/kaczmarz_greedy.py:_kernel
// (:53-161; launched by kaczmarz_greedy_sweep_pallas, :164, pallas_call
// :221) and the sweep loop of its wrapper solve_kaczmarz_greedy (:354-366).
// Per step (reference Kaczmarz.jl:393-426), on the residual r:
//   r2_k  = r_k r_k,  dn = sum_k r2_k,  mx = max_k r2_k denom_k
//   e_k   = theta (mx / dn) + (1 - theta) fnorm, or (mx / dn + fnorm) / 2
//   w_k   = r2_k >= (e_k dn) norms_k ? r2_k : 0      (dn = 0 read as 1)
//   row   = argmax_k log w_k + G_k over w_k > 0 (Gumbel-max: a draw from
//           the categorical distribution w / sum w), ties to the smallest
//           index; or the step's forced row where one is given (>= 0)
//   alpha = denom_row r_row;  x += alpha a_row;  vl_row += alpha eps;
//   r    -= r_row Gt[row]    (Gt = diag(denom) (A A^T + lam I), m x m)
// and after each sweep x = max(x, 0) (Positive) and the refresh
//   r = (u - eps vl) - A x,  each (A x)_k summed in double from the exact
//   f32 products and rounded to f32 once.
// A sweep alone (kaczmarz_greedy_sweep) is the solve with T = 1 and no
// projection or refresh: u is then the residual it starts from.
//
// The draw: the TPU kernel draws with pltpu.prng_* (jax.random in interpret
// mode), which neither torch nor CUDA can repeat. Here the uniform of row k
// at a step is a counter-based hash in integer arithmetic,
//   h = lowbias32(lowbias32(lowbias32(lowbias32(lowbias32(seed) + sweep)
//       + problem) + step) + k)    (all mod 2^32)
//   U = ((h >> 9) + 0.5) 2^-23     (strictly inside (0, 1), exact in f32)
// and G = -logf(-logf(U)) (the correctly rounded-to-1-ulp logf, never
// __logf). The plain PyTorch version (rls_tpu_torch/kernels/kaczmarz_greedy.py)
// computes the same bits, so on the card both draw the same rows. dn is
// summed in double and rounded to f32 once; every other scalar and update
// is a separate f32 op (rls::fmul & co.: no contraction).
//
// What bounds it on an H100: a step reads a_row (n floats) and Gt[row] (m)
// and does ~13 m + 2 n operations; the solve's bound is a few microseconds.
// The real floor is the step's dependent chain: the row it draws decides
// the next step's residual. The two routes (kernels/kaczmarz_greedy.py
// plan_kaczmarz_greedy picks one):
//
// * resident: the whole solve in one launch. 8 consumer warps hold the
//   problem's state for the whole solve: thread t holds r, denom, norms and
//   u of rows k = t + 256 i in registers (m <= 256 kMaxRows), x[t] in a
//   register (n <= 256; else x in shared memory), vl in shared memory (only
//   the owner of row k touches vl[k]). kProducerWarps producer warps draw
//   the Gumbel noise G of every row for the coming steps into a ring of R
//   slots of m floats in shared memory; a slot completes on its "full"
//   mbarrier (one arrival a producer warp) and is refilled after the 8
//   consumer warps have released it on its "empty" mbarrier. A forced step
//   takes no slot. The noise never depends on r, so it leaves the chain:
//   the chain keeps logf(w) and its add for the rows that survive the
//   threshold. A step on the chain: the loads of Gt[row] for the thread's
//   rows (issued as soon as the row is known; the step's noise slot is
//   waited for and read while they load), r -= r_row Gt[row] fused into
//   the stats pass, the warp's partials, barrier B1, every thread combining
//   the 8 partials in warp order, the draw (the threshold; each thread's
//   survivors scored logf(w) + G in k order, one a lane a round), the
//   warp's argmax by two warp reductions (redux: the largest order-keyed
//   score, then the smallest row that holds it), the
//   candidate {score, row, r_row, denom_row} written by the lane that owns
//   the row, barrier B2, and every warp combining the 8 candidates the same
//   way: each thread then holds row, r_row and alpha with no further
//   memory read. x += alpha a_row (the load of a_row goes out with Gt's)
//   is off the chain and runs after the next step's stats. At the end of a
//   sweep: the last step's x update, Positive, x in double into shared
//   memory, barrier B3, and the refresh: warp w forms the dots of its own
//   rows (refresh_dots: eight lanes a row along A's row, the next 128
//   columns' loads in flight while a unit is summed, each lane's sum in
//   column order, an xor tree over the eight, the dot rounded once into
//   shared memory), read by the rows' owners, lanes of the same warp, after
//   a __syncwarp. Then the next sweep, with no launch and no host work in
//   between.
//   Barriers of the consumer warps (bar.sync 1, 256; the producers take no
//   part): B1 (the dn / mx partials written -> read), B2 (the candidates
//   written -> read), B3 (x in double written -> the refresh's reads). The
//   partials and the candidates have slots of their own: a slot written in
//   step j + 1 lies past the barrier that follows every read of it in step
//   j (B2 for the partials, B1 of step j + 1 for the candidates), so no
//   third barrier in a step and no parity buffers. A wait on an mbarrier
//   past ~10 s traps.
// * block: the one-sweep kernel, one CTA of 256 threads per problem and one
//   launch per sweep, r in global memory; the projection and the refresh
//   run between its launches in PyTorch. It takes the sizes the resident
//   route cannot hold (m > 256 kMaxRows, or shared memory), and those where
//   the resident CTA's refresh, all of A on one SM a sweep, makes it slower
//   (the planner's RESIDENT_MAX_ENTRIES).
//
// Both routes give one sweep the same bits: the per-thread sums run in k
// order, the lane tree and then warps 0..7, as in the block kernel.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "mbarrier.cuh"
#include "pgm_tv_common.cuh"

namespace {

using rls::mbar_arrive;
using rls::mbar_init;
using rls::mbar_wait;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the resident route: 8 consumer warps and the producer warps of the noise
constexpr int kProducerWarps = 4;
constexpr int kResidentThreads = kThreads + 32 * kProducerWarps;
constexpr int kMaxRows = 16;  // rows of r a consumer thread holds: m <= 4096
enum { kProxNone = 0, kProxPositive = 1 };
// the phases that the timer reads (CTA 0's thread 0), summed over the solve:
// per step the stats pass with its warp tree and the scores, B1 with the
// combine and the scalars, the draw (the threshold, the warp's argmax, the
// candidate), B2 with the combine and the step's own updates, the wait for
// Gt[row] with r's update, the deferred x update; per sweep the end
// (projection, refresh); per step the issue of Gt[row]'s and a_row's loads,
// the wait on the noise slot's full mbarrier, the slot's read with its
// release; and the consumer's whole run
enum {
    kPhStats, kPhReduce1, kPhDraw, kPhReduce2, kPhRowWait, kPhAxpy, kPhRefresh, kPhRowIssue,
    kPhRingWait, kPhRingRead, kPhTotal, kGreedyPhases
};

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

// The Gumbel noise of row k at a step: the step's hash prefix `pre`
__device__ __forceinline__ float gumbel(unsigned pre, int k) {
    const unsigned h = lowbias32(pre + static_cast<unsigned>(k));
    const float u = rls::fmul(rls::fadd(static_cast<float>(h >> 9), 0.5f),
                              1.1920928955078125e-07f);  // 2^-23
    return -logf(-logf(u));
}

// ---------------------------------------------------------------------------
// The block route: the one-sweep kernel.

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
                if (w > 0.f) score = rls::fadd(logf(w), gumbel(pre, k));
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

// ---------------------------------------------------------------------------
// The resident route.

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// A warp's candidate of the draw: the winning score, its row, r and denom
struct Cand {
    float score;
    int k;
    float r, den;
};

// Byte offsets in a resident CTA's shared memory; the Python planner
// (kernels/kaczmarz_greedy.py resident_smem_bytes) counts the same. First R
// "full" and R "empty" mbarriers; the 8 warps' dn partials (double) and mx
// partials (float); the 8 candidates; the R noise slots of m floats; vl (m
// floats); the refresh's dots (m floats); x in double for the refresh (n);
// x (n floats) where it is not in registers. Each piece 16-byte aligned.
struct GreedyLayout {
    size_t part;  // the dn partials, then the mx partials
    size_t cand;
    size_t ring;  // the first noise slot
    size_t slot;  // bytes of a slot
    size_t vl, ax, xd, xs;
    size_t total;
};

__host__ __device__ inline GreedyLayout greedy_layout(int m, int n, int R, bool x_shared) {
    GreedyLayout g;
    g.part = align16(16 * static_cast<size_t>(R));
    g.cand = g.part + align16(12 * static_cast<size_t>(kWarps));
    g.ring = g.cand + align16(sizeof(Cand) * kWarps);
    g.slot = align16(4 * static_cast<size_t>(m));
    g.vl = g.ring + static_cast<size_t>(R) * g.slot;
    g.ax = g.vl + align16(4 * static_cast<size_t>(m));
    g.xd = g.ax + align16(4 * static_cast<size_t>(m));
    g.xs = g.xd + align16(8 * static_cast<size_t>(n));
    g.total = g.xs + (x_shared ? align16(4 * static_cast<size_t>(n)) : 0);
    return g;
}

struct GreedyArgs {
    const float* A;      // (m, n)
    const float* Gt;     // (m, m)
    const float* denom;  // (m,)
    const float* norms;  // (m,)
    const float* u;      // (P, m): the first residual, and u of the refresh
    const float* x_in;   // (P, n), or null: x0 = 0
    const float* vl_in;  // (P, m), or null: vl0 = 0
    const float* eps;    // (P,)
    const int* forced;   // (T, S) rows, -1 = draw; or null
    float* x;            // (P, n) out
    float* vl;           // (P, m) out
    float* r;            // (P, m) out
    int* rows;           // (T, P, S) out: the rows drawn
    long long* prof;     // (kGreedyPhases,): CTA 0's thread 0 clocks; or null
    int P, m, n, S, T;
    float fnorm, theta;
    int use_theta;
    unsigned seed, sweep0;
    int prox, refresh, R;
};

// the 256 consumer threads' barrier (named barrier 1; the producers take no part)
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ int forced_at(const GreedyArgs& a, int q) {
    return a.forced != nullptr ? __ldg(a.forced + q) : -1;
}

// The producer warps: for every step that draws, wait until its slot is
// empty, then write the noise G of every row into it (producer thread pt
// rows pt, pt + 128, ..., at most 2 kR of them, their hash and logf chains
// interleaved); each warp arrives once on the slot's full barrier.
template <int kR>
__device__ void produce(const GreedyArgs& a, const GreedyLayout& L, unsigned char* smem, int pt) {
    constexpr int kRows = kThreads * kR / (32 * kProducerWarps);
    unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
    unsigned long long* empty = full + a.R;
    const unsigned s0 = lowbias32(a.seed);
    int slot = 0;
    unsigned phase = 0;
    for (int t = 0; t < a.T; ++t) {
        const unsigned pre_p = lowbias32(lowbias32(s0 + (a.sweep0 + static_cast<unsigned>(t))) +
                                         static_cast<unsigned>(blockIdx.x));
        for (int j = 0; j < a.S; ++j) {
            if (forced_at(a, t * a.S + j) >= 0) continue;  // a forced step takes no slot
            mbar_wait(empty + slot, phase ^ 1u);
            const unsigned pre = lowbias32(pre_p + static_cast<unsigned>(j));
            float* g = reinterpret_cast<float*>(smem + L.ring + static_cast<size_t>(slot) * L.slot);
            float v[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i) v[i] = gumbel(pre, pt + 32 * kProducerWarps * i);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const int k = pt + 32 * kProducerWarps * i;
                if (k < a.m) g[k] = v[i];
            }
            __syncwarp();
            if ((pt & 31) == 0) mbar_arrive(full + slot);
            if (++slot == a.R) {
                slot = 0;
                phase ^= 1u;
            }
        }
    }
}

// The refresh's dots (A x)_k of the rows that warp `warp`'s lanes own,
// each summed in double and rounded once into ax[k]. Lane l: rows k0 =
// 256 i + 32 warp + 8 b + (l >> 3) and k1 = k0 + 4 (b = 0..3) a pair,
// columns 4 (l & 7) + 32 q + {0..3} in that order, 128 columns a unit, the
// next unit's loads in flight while a unit is summed; an xor tree over the
// eight lanes of a row. kFull: every row and column of every unit lies
// inside A (m = 256 kR, n a multiple of 128, A 16-byte aligned), so the
// loads are 16 bytes and no load or product is guarded; else each load
// and product is guarded on its own. The warp's own rows only: its lanes
// read `ax` after a __syncwarp.
template <int kR, bool kFull>
__device__ __forceinline__ void refresh_dots(const float* __restrict__ A, const double* xd,
                                             float* ax, int m, int n, int warp, int lane) {
    const int j8 = lane & 7, grp = lane >> 3;
    const int nch = (n + 127) / 128;
    const int units = 4 * kR * nch;
    auto load = [&](float4 (&va)[4], float4 (&vb)[4], int q) {
        const int pair = q / nch;
        const int c0 = 128 * (q - pair * nch);
        const int k0 = kThreads * (pair >> 2) + 32 * warp + 8 * (pair & 3) + grp;
        const int k1 = k0 + 4;
        const float* a0 = A + static_cast<size_t>(k0) * n;
        const float* a1 = A + static_cast<size_t>(k1) * n;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const int c = c0 + 32 * w + 4 * j8;
            if constexpr (kFull) {
                va[w] = __ldg(reinterpret_cast<const float4*>(a0 + c));
                vb[w] = __ldg(reinterpret_cast<const float4*>(a1 + c));
                continue;
            }
            va[w] = make_float4(0.f, 0.f, 0.f, 0.f);
            vb[w] = va[w];
            if (k0 < m) {
                if (c < n) va[w].x = __ldg(a0 + c);
                if (c + 1 < n) va[w].y = __ldg(a0 + c + 1);
                if (c + 2 < n) va[w].z = __ldg(a0 + c + 2);
                if (c + 3 < n) va[w].w = __ldg(a0 + c + 3);
            }
            if (k1 < m) {
                if (c < n) vb[w].x = __ldg(a1 + c);
                if (c + 1 < n) vb[w].y = __ldg(a1 + c + 1);
                if (c + 2 < n) vb[w].z = __ldg(a1 + c + 2);
                if (c + 3 < n) vb[w].w = __ldg(a1 + c + 3);
            }
        }
    };
    double s0 = 0.0, s1 = 0.0;
    auto sum = [&](const float4 (&va)[4], const float4 (&vb)[4], int q) {
        const int pair = q / nch;
        const int chunk = q - pair * nch;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const int c = 128 * chunk + 32 * w + 4 * j8;
            const float e0[4] = {va[w].x, va[w].y, va[w].z, va[w].w};
            const float e1[4] = {vb[w].x, vb[w].y, vb[w].z, vb[w].w};
#pragma unroll
            for (int h = 0; h < 4; ++h)
                if (kFull || c + h < n) {
                    const double xv = xd[c + h];
                    s0 += static_cast<double>(e0[h]) * xv;
                    s1 += static_cast<double>(e1[h]) * xv;
                }
        }
        if (chunk == nch - 1) {  // the pair's dots: the tree over 8 lanes
#pragma unroll
            for (int o = 4; o > 0; o >>= 1) {
                s0 += __shfl_xor_sync(0xffffffffu, s0, o);
                s1 += __shfl_xor_sync(0xffffffffu, s1, o);
            }
            const int k0 = kThreads * (pair >> 2) + 32 * warp + 8 * (pair & 3) + grp;
            if (j8 == 0) {
                if (kFull || k0 < m) ax[k0] = static_cast<float>(s0);
                if (kFull || k0 + 4 < m) ax[k0 + 4] = static_cast<float>(s1);
            }
            s0 = 0.0;
            s1 = 0.0;
        }
    };
    float4 va0[4], vb0[4], va1[4], vb1[4];
    load(va0, vb0, 0);
    for (int q = 0; q < units; q += 2) {
        if (q + 1 < units) load(va1, vb1, q + 1);
        sum(va0, vb0, q);
        if (q + 1 < units) {
            if (q + 2 < units) load(va0, vb0, q + 2);
            sum(va1, vb1, q + 1);
        }
    }
}

// The consumer warps: problem blockIdx.x, kR rows of r a thread, x in a
// register (kXReg: thread t holds x[t]) or in shared memory.
template <int kR, bool kXReg, bool kProf>
__device__ void consume(const GreedyArgs& a, const GreedyLayout& L, unsigned char* smem, int tid) {
    unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
    unsigned long long* empty = full + a.R;
    double* part_sum = reinterpret_cast<double*>(smem + L.part);
    float* part_max = reinterpret_cast<float*>(smem + L.part + 8 * kWarps);
    Cand* cand = reinterpret_cast<Cand*>(smem + L.cand);
    float* vl = reinterpret_cast<float*>(smem + L.vl);
    float* ax = reinterpret_cast<float*>(smem + L.ax);
    double* xd = reinterpret_cast<double*>(smem + L.xd);
    float* xs = reinterpret_cast<float*>(smem + L.xs);
    const int lane = tid & 31, warp = tid >> 5;
    const int p = blockIdx.x;
    const int m = a.m, n = a.n;
    const size_t pm = static_cast<size_t>(p) * m, pn = static_cast<size_t>(p) * n;
    const float e = a.eps[p];

    // rows tid + 256 i: r, denom, norms and u in registers, vl in shared memory
    float r[kR], den[kR], nrm[kR], u[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
        const int k = tid + kThreads * i;
        const bool in = k < m;
        u[i] = in ? a.u[pm + k] : 0.f;
        r[i] = u[i];
        den[i] = in ? a.denom[k] : 0.f;
        nrm[i] = in ? a.norms[k] : 0.f;
        if (in) vl[k] = a.vl_in != nullptr ? a.vl_in[pm + k] : 0.f;
    }
    float x = 0.f;
    if constexpr (kXReg) {
        if (tid < n && a.x_in != nullptr) x = a.x_in[pn + tid];
    } else {
        for (int c = tid; c < n; c += kThreads) xs[c] = a.x_in != nullptr ? a.x_in[pn + c] : 0.f;
    }

    const bool timed = kProf && blockIdx.x == 0 && tid == 0;
    long long acc[kGreedyPhases] = {};
    long long tk = 0;
    const long long t_start = timed ? clock64() : 0;
    auto mark = [&](int ph) {
        if (timed) {
            const long long now = clock64();
            acc[ph] += now - tk;
            tk = now;
        }
    };
    // x += alpha a_row of the step before (its load issued with Gt's)
    auto axpy = [&](float alpha, const float* arow, float av) {
        if constexpr (kXReg) {
            if (tid < n) x = rls::fadd(x, rls::fmul(alpha, av));
        } else {
#pragma unroll 4
            for (int c = tid; c < n; c += kThreads)
                xs[c] = rls::fadd(xs[c], rls::fmul(alpha, __ldg(arow + c)));
        }
    };

    int slot = 0;
    unsigned phase = 0;
    int prow = -1;                 // the step before: its row, r_row and alpha
    float pr = 0.f, palpha = 0.f;
    const int steps = a.T * a.S;
    int fnext = forced_at(a, 0);
    for (int t = 0; t < a.T; ++t) {
        for (int j = 0; j < a.S; ++j) {
            const int q = t * a.S + j;
            const int fj = fnext;
            if (q + 1 < steps) fnext = forced_at(a, q + 1);
            if (timed) tk = clock64();
            // step j - 1's update of r: r -= r_row Gt[row]; a_row for its axpy
            float av = 0.f, gv[kR];
            const float* arow = a.A + static_cast<size_t>(prow) * n;
            if (prow >= 0) {
                const float* g = a.Gt + static_cast<size_t>(prow) * m;
#pragma unroll
                for (int i = 0; i < kR; ++i) {
                    const int k = tid + kThreads * i;
                    gv[i] = k < m ? __ldg(g + k) : 0.f;
                }
                if (kXReg && tid < n) av = __ldg(arow + tid);
            }
            mark(kPhRowIssue);
            // while they load: this step's noise from its slot, released at once
            float nz[kR];
            if (fj < 0) {
                mbar_wait(full + slot, phase);
                mark(kPhRingWait);
                const float* g =
                    reinterpret_cast<const float*>(smem + L.ring + static_cast<size_t>(slot) * L.slot);
#pragma unroll
                for (int i = 0; i < kR; ++i) {
                    const int k = tid + kThreads * i;
                    nz[i] = k < m ? g[k] : 0.f;
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + slot);
                if (++slot == a.R) {
                    slot = 0;
                    phase ^= 1u;
                }
            }
            mark(kPhRingRead);
            if (prow >= 0) {
#pragma unroll
                for (int i = 0; i < kR; ++i)
                    if (tid + kThreads * i < m) r[i] = rls::fsub(r[i], rls::fmul(pr, gv[i]));
            }
            mark(kPhRowWait);
            // dn (in double) and mx: each thread in k order, the warp's tree
            // (mx: every r2 denom is >= +0, so its bits order as the floats
            // do and a max of the bits is the warp's max)
            double dsum = 0.0;
            float mx = 0.f;
            float r2[kR];
#pragma unroll
            for (int i = 0; i < kR; ++i) {
                r2[i] = rls::fmul(r[i], r[i]);
                if (tid + kThreads * i < m) {
                    dsum += static_cast<double>(r2[i]);
                    mx = fmaxf(mx, rls::fmul(r2[i], den[i]));
                }
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
            mx = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(mx)));
            if (lane == 0) {
                part_sum[warp] = dsum;
                part_max[warp] = mx;
            }
            mark(kPhStats);
            if (prow >= 0) axpy(palpha, arow, av);
            mark(kPhAxpy);
            consumers_sync();  // B1
            dsum = 0.0;
            mx = -INFINITY;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
                dsum += part_sum[w];
                mx = fmaxf(mx, part_max[w]);
            }
            const float dn = static_cast<float>(dsum);
            const float safe = dn > 0.f ? dn : 1.f;
            const float qq = rls::fdiv(mx, safe);
            const float ek = a.use_theta
                                 ? rls::fadd(rls::fmul(a.theta, qq),
                                             rls::fmul(rls::fsub(1.f, a.theta), a.fnorm))
                                 : rls::fmul(0.5f, rls::fadd(qq, a.fnorm));
            const float lower = rls::fmul(ek, safe);
            mark(kPhReduce1);

            if (fj < 0) {
                // the draw: each thread's best row in k order. A row that
                // does not survive scores -inf, so the best starts at the
                // thread's first row; the survivors (w = r2 > 0 past the
                // threshold) then take their logf(w) + G in k order, one a
                // lane per round
                float best = -INFINITY;
                int best_k = tid < m ? tid : INT_MAX;
                unsigned live = 0;
#pragma unroll
                for (int i = 0; i < kR; ++i)
                    if (tid + kThreads * i < m && r2[i] > 0.f &&
                        r2[i] >= rls::fmul(lower, nrm[i]))
                        live |= 1u << i;
                while (__any_sync(0xffffffffu, live != 0)) {
                    if (live != 0) {
                        const int i0 = __ffs(live) - 1;
                        live &= live - 1;
                        float w = 0.f, gz = 0.f;
#pragma unroll
                        for (int i = 0; i < kR; ++i)
                            if (i == i0) {
                                w = r2[i];
                                gz = nz[i];
                            }
                        const float score = rls::fadd(logf(w), gz);
                        const int k = tid + kThreads * i0;
                        if (wins(score, k, best, best_k)) {
                            best = score;
                            best_k = k;
                        }
                    }
                }
                // the warp's winner: the largest score (a max of order-keyed
                // bits), then the smallest row among the lanes that hold it;
                // the lane that owns it writes the candidate with its r, denom
                const unsigned bits = __float_as_uint(best);
                const unsigned key = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
                const unsigned top = __reduce_max_sync(0xffffffffu, key);
                const int wk = static_cast<int>(
                    __reduce_min_sync(0xffffffffu, key == top ? static_cast<unsigned>(best_k)
                                                              : static_cast<unsigned>(INT_MAX)));
                if (wk == INT_MAX) {
                    if (lane == 0) cand[warp] = Cand{-INFINITY, INT_MAX, 0.f, 0.f};
                } else if ((wk & 31) == lane) {
                    float rr = 0.f, dd = 0.f;
#pragma unroll
                    for (int i = 0; i < kR; ++i)
                        if (tid + kThreads * i == wk) {
                            rr = r[i];
                            dd = den[i];
                        }
                    cand[warp] = Cand{best, wk, rr, dd};
                }
            } else if ((fj & (kThreads - 1)) == tid) {
                // a forced row: its owner writes candidate 0
                float rr = 0.f, dd = 0.f;
#pragma unroll
                for (int i = 0; i < kR; ++i)
                    if (tid + kThreads * i == fj) {
                        rr = r[i];
                        dd = den[i];
                    }
                cand[0] = Cand{0.f, fj, rr, dd};
            }
            mark(kPhDraw);
            consumers_sync();  // B2
            // every warp combines the candidates: lane w < 8 holds warp w's,
            // the winner is the largest score, then the smallest row
            Cand c = cand[lane & (kWarps - 1)];
            if (fj >= 0) {
                c = cand[0];
            } else {
                const unsigned cb = __float_as_uint(c.score);
                const unsigned ck = (cb & 0x80000000u) ? ~cb : (cb | 0x80000000u);
                const unsigned ctop = __reduce_max_sync(0xffffffffu, ck);
                const int row = static_cast<int>(__reduce_min_sync(
                    0xffffffffu, ck == ctop ? static_cast<unsigned>(c.k)
                                            : static_cast<unsigned>(INT_MAX)));
                const int src = __ffs(__ballot_sync(0xffffffffu, c.k == row)) - 1;
                c.k = row;
                c.r = __shfl_sync(0xffffffffu, c.r, src);
                c.den = __shfl_sync(0xffffffffu, c.den, src);
            }
            const int row = c.k;
            const float alpha = rls::fmul(c.den, c.r);
            if ((row & (kThreads - 1)) == tid) vl[row] = rls::fadd(vl[row], rls::fmul(alpha, e));
            if (tid == 0) a.rows[(static_cast<size_t>(t) * a.P + p) * a.S + j] = row;
            prow = row;
            pr = c.r;
            palpha = alpha;
            mark(kPhReduce2);
        }

        // the sweep's end: the last step's updates, the projection, the refresh
        if (timed) tk = clock64();
        {
            const float* arow = a.A + static_cast<size_t>(prow) * n;
            const float av = kXReg && tid < n ? __ldg(arow + tid) : 0.f;
            if (!a.refresh) {  // no refresh follows: r takes the last update too
                const float* g = a.Gt + static_cast<size_t>(prow) * m;
#pragma unroll
                for (int i = 0; i < kR; ++i) {
                    const int k = tid + kThreads * i;
                    if (k < m) r[i] = rls::fsub(r[i], rls::fmul(pr, __ldg(g + k)));
                }
            }
            axpy(palpha, arow, av);
            prow = -1;
        }
        if (a.prox == kProxPositive) {
            if constexpr (kXReg) {
                x = fmaxf(x, 0.f);
            } else {
                for (int c = tid; c < n; c += kThreads) xs[c] = fmaxf(xs[c], 0.f);
            }
        }
        if (a.refresh) {
            // r = (u - eps vl) - A x, each dot in double, rounded once
            if constexpr (kXReg) {
                if (tid < n) xd[tid] = static_cast<double>(x);
            } else {
                for (int c = tid; c < n; c += kThreads) xd[c] = static_cast<double>(xs[c]);
            }
            consumers_sync();  // B3
            // the dots of the rows this warp's lanes own (see refresh_dots)
            if (m == kThreads * kR && (n & 127) == 0 &&
                (reinterpret_cast<size_t>(a.A) & 15) == 0)
                refresh_dots<kR, true>(a.A, xd, ax, m, n, warp, lane);
            else
                refresh_dots<kR, false>(a.A, xd, ax, m, n, warp, lane);
            __syncwarp();
#pragma unroll
            for (int i = 0; i < kR; ++i) {
                const int k = tid + kThreads * i;
                if (k < m) r[i] = rls::fsub(rls::fsub(u[i], rls::fmul(e, vl[k])), ax[k]);
            }
        }
        mark(kPhRefresh);
    }

    // the results
#pragma unroll
    for (int i = 0; i < kR; ++i) {
        const int k = tid + kThreads * i;
        if (k < m) {
            a.r[pm + k] = r[i];
            a.vl[pm + k] = vl[k];
        }
    }
    if constexpr (kXReg) {
        if (tid < n) a.x[pn + tid] = x;
    } else {
        for (int c = tid; c < n; c += kThreads) a.x[pn + c] = xs[c];
    }
    if (timed) {
        acc[kPhTotal] = clock64() - t_start;
        for (int k = 0; k < kGreedyPhases; ++k) a.prof[k] = acc[k];
    }
}

// the consumer warps 0..7 and the producer warps 8..; one __syncthreads,
// before the solve
template <int kR, bool kXReg, bool kProf>
__global__ void __launch_bounds__(kResidentThreads, 1)
kaczmarz_greedy_resident_kernel(GreedyArgs a, GreedyLayout L) {
    extern __shared__ __align__(16) unsigned char smem[];
    if (threadIdx.x == 0) {
        unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
        for (int s = 0; s < a.R; ++s) {
            mbar_init(full + s, kProducerWarps);  // one arrival a producer warp
            mbar_init(full + a.R + s, kWarps);    // one arrival a consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x >= kThreads)
        produce<kR>(a, L, smem, threadIdx.x - kThreads);
    else
        consume<kR, kXReg, kProf>(a, L, smem, threadIdx.x);
}

template <int kR, bool kXReg>
int resident_go(const GreedyArgs& a, const GreedyLayout& L, cudaStream_t stream) {
    auto kernel = a.prof != nullptr ? kaczmarz_greedy_resident_kernel<kR, kXReg, true>
                                    : kaczmarz_greedy_resident_kernel<kR, kXReg, false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(L.total));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<a.P, kResidentThreads, L.total, stream>>>(a, L);
    return static_cast<int>(cudaGetLastError());
}

template <bool kXReg>
int resident_dispatch(const GreedyArgs& a, const GreedyLayout& L, int rows, cudaStream_t st) {
    switch (rows) {
        case 1: return resident_go<1, kXReg>(a, L, st);
        case 2: return resident_go<2, kXReg>(a, L, st);
        case 4: return resident_go<4, kXReg>(a, L, st);
        case 8: return resident_go<8, kXReg>(a, L, st);
        case 16: return resident_go<16, kXReg>(a, L, st);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" {

// The block route, one sweep. A: (m, n) f32; Gt: (m, m) f32, Gt[i] =
// denom_i (A A^T + lam I)[i]; denom, norms: (m,); x: (P, n), vl, r: (P, m),
// updated in place; eps: (P,); forced: (S,) int32 rows (-1: draw) or null;
// rows_out: (P, S) int32, the rows the sweep visited.
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

// The resident route: the whole solve in one launch. u: (P, m), the first
// residual and u of the refresh; x_in (P, n), vl_in (P, m): the start, or
// null for zeros; forced: (T, S) int32 (-1: draw) or null; x (P, n), vl,
// r (P, m): the results; rows (T, P, S) int32; prof: null, or kGreedyPhases
// int64 that receive CTA 0's thread 0 clocks by phase. Sweep t draws with
// the counter sweep0 + t; prox 0 none, 1 Positive; refresh 0 or 1. The plan:
// a ring of R slots, `rows` rows of r a thread (a power of two up to
// kMaxRows, 256 rows >= m), x in shared memory if x_shared (else n <= 256);
// smem must equal the route's own count (greedy_layout).
int kaczmarz_greedy_solve_launch(const void* A, const void* Gt, const void* denom,
                                 const void* norms, const void* u, const void* x_in,
                                 const void* vl_in, const void* eps, const void* forced, void* x,
                                 void* vl, void* r, void* rows, void* prof, int P, int m, int n,
                                 int S, int T, float fnorm, float theta, int use_theta,
                                 unsigned seed, unsigned sweep0, int prox, int refresh, int R,
                                 int rows_per_thread, int x_shared, int smem, void* stream) {
    if (P <= 0 || S <= 0 || T <= 0) return 0;
    if (m < 1 || n < 1 || R < 1 || rows_per_thread < 1 || rows_per_thread > kMaxRows ||
        kThreads * rows_per_thread < m || (!x_shared && n > kThreads) ||
        (prox != kProxNone && prox != kProxPositive))
        return static_cast<int>(cudaErrorInvalidValue);
    const GreedyLayout L = greedy_layout(m, n, R, x_shared != 0);
    if (L.total != static_cast<size_t>(smem)) return static_cast<int>(cudaErrorInvalidValue);
    const GreedyArgs a{static_cast<const float*>(A), static_cast<const float*>(Gt),
                       static_cast<const float*>(denom), static_cast<const float*>(norms),
                       static_cast<const float*>(u), static_cast<const float*>(x_in),
                       static_cast<const float*>(vl_in), static_cast<const float*>(eps),
                       static_cast<const int*>(forced), static_cast<float*>(x),
                       static_cast<float*>(vl), static_cast<float*>(r), static_cast<int*>(rows),
                       static_cast<long long*>(prof), P, m, n, S, T, fnorm, theta, use_theta,
                       seed, sweep0, prox, refresh, R};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return x_shared ? resident_dispatch<false>(a, L, rows_per_thread, st)
                    : resident_dispatch<true>(a, L, rows_per_thread, st);
}

}  // extern "C"
