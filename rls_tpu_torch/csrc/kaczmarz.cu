// The Kaczmarz row recurrence for a batch of problems: a sweep over an index
// list, or the whole multi-sweep solve, on one of two routes.
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
// split re / im planes. Rows are dense, a_i[0..n), or padded CSR,
// (vals[i][0..k_max), cols[i][..]), of which only the nonzero entries
// write: a padding entry (val 0, col 0) adding alpha 0 to x[0] could
// overwrite another thread's update of a genuine column-0 entry. The TPU
// kernel's row gather in visit order, sweep chunking and SMEM / HBM / VMEM
// gates (:38-47, :326-413, :503-587) have no counterpart: they exist for
// the TPU's block DMA and memory budgets.
//
// Numerics, both routes: each of the (one or four) real dots of a row is
// summed in double from the f32 products (exact in double) and rounded to
// f32 once; tau, alpha and the updates are f32 ops that nvcc may not
// contract (rls::fmul & co.). The plain PyTorch version (kaczmarz_solve_torch
// in rls_tpu_torch/kernels/kaczmarz_streamed.py) sums in float64 the same
// way, so the routes and the plain version differ only where two double
// sums taken in another order round to different floats.
//
// What bounds it on an H100: a row step moves the row (4 L bytes, L = n or
// 8 k_max for CSR) and does 4 L operations (8 L complex), so a solve is
// bytes-bound at 3.35 TB/s; but the recurrence is serial in the rows, so
// the real floor is the latency of one row step's dependent chain times
// the rows visited. The two routes (kernels/kaczmarz_streamed.py
// plan_kaczmarz picks one):
//
// * warp: one warp per problem, g problems (consumer warps) per CTA and one
//   producer warp. The producer walks the index list ahead of the consumers
//   and stages each visited row (and each problem's d_i, u_i) into a ring of
//   R slots in shared memory by cp.async, each slot's copies completing on
//   its "full" mbarrier; a slot is refilled only after the g consumers have
//   arrived on its "empty" mbarrier. An entry -1 takes no slot. Rows are
//   read-only, so fetching them R steps ahead is always safe; vl is not
//   fetched ahead (a row can come back within the ring's window): it sits in
//   shared memory where it fits, else in global memory, read at the start
//   of the step. Every warp reads the index list itself, 32 entries per
//   coalesced load one chunk ahead, and takes each entry by a shuffle. A
//   consumer lane l holds x[l + 32 k] in registers (dense rows up to 32 kK
//   entries), else x is in shared memory (wider dense rows, CSR rows, which
//   gather by column). Each lane sums its products in double in k order; an
//   xor butterfly (rls::warp_allsum) leaves the same double in every lane,
//   so every lane rounds tau and forms alpha itself: a row step has no
//   __syncthreads and no broadcast through shared memory (a CSR row, whose
//   columns belong to no fixed lane, ends in a __syncwarp). Every lane
//   writes the same vl_i, so each lane's next read of vl follows its own
//   write in program order.
// * block: one CTA of 256 threads per problem, x in shared memory, the rows
//   and vl read from global memory by their index; a row step is a block
//   reduction, thread 0's scalar update and two barriers. It takes rows
//   wider than one warp should carry alone.
#include <cuda_runtime.h>

#include "dense_common.cuh"
#include "mbarrier.cuh"

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

// ---------------------------------------------------------------------------
// The warp route.

constexpr int kMaxGroups = 16;  // consumer warps (problems) of a CTA
constexpr int kWarpThreads = 32 * (kMaxGroups + 1);
// the phases that the timer reads (CTA 0's warp 0): per row step the wait
// for its slot, the dot (the slot's loads, the lane sums), the butterfly,
// alpha with the vl update, the axpy (and the slot's release); per sweep
// the projection; and the consumer's whole run
enum { kPhWait, kPhDot, kPhButterfly, kPhAlpha, kPhAxpy, kPhProject, kPhTotal, kWarpPhases };

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Byte offsets in a warp-route CTA's shared memory; the Python planner
// (kernels/kaczmarz_streamed.py warp_smem_bytes) counts the same. First R
// "full" and R "empty" mbarriers; then R slots, each the g problems' scalars
// (d_i, then u_i per plane) and the row: nc planes of `lr` floats (L
// rounded up to 4, or, where x is in registers with kx entries a lane, 32
// kx: the entries past L stay zero) and, for CSR, `lr` column indices; then
// x of the g problems where it is not in registers, vl of the g problems
// where it is in shared memory. Each piece 16-byte aligned.
struct WarpLayout {
    size_t ring;   // the first slot
    size_t row;    // the row within a slot
    size_t lr;     // entries of a row plane
    size_t slot;   // bytes of a slot
    size_t x, vl;  // x, vl of warp 0 (kx = 0, vl_shared)
    size_t total;
};

__host__ __device__ inline WarpLayout warp_layout(int m, int n, int L, int nc, bool csr, int g,
                                                  int R, int kx, bool vl_shared) {
    WarpLayout w;
    w.lr = kx > 0 ? 32 * static_cast<size_t>(kx) : (static_cast<size_t>(L) + 3) / 4 * 4;
    w.ring = align16(16 * static_cast<size_t>(R));
    w.row = align16(4 * static_cast<size_t>(g) * (1 + nc));
    w.slot = w.row + 4 * (nc + (csr ? 1 : 0)) * w.lr;
    w.x = w.ring + static_cast<size_t>(R) * w.slot;
    w.vl = w.x + (kx == 0 ? align16(4 * static_cast<size_t>(g) * nc * n) : 0);
    w.total = w.vl + (vl_shared ? align16(4 * static_cast<size_t>(g) * nc * m) : 0);
    return w;
}

struct WarpArgs {
    const float* ar;  // (m, L): the rows' real parts
    const float* ai;  // (m, L): imaginary parts, or null
    const int* cols;  // (m, L): CSR columns, or null
    const int* idx;   // (reuse ? 1 : sweeps, S)
    float* x;         // (P, nc, n)
    float* vl;        // (P, nc, m)
    const float* u;   // (P, nc, m)
    const float* denom;  // (P, m)
    const float* eps;    // (P,)
    long long* prof;     // (kWarpPhases,): CTA 0's warp 0 clocks; or null
    int P, m, n, L, sweeps, S, reuse, prox;
    int g, R, vl_shared;
};

using rls::mbar_arrive;
using rls::mbar_init;
using rls::mbar_wait;
using rls::smem_u32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

// one of `bar`'s expected arrivals, made when this thread's earlier
// cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
                 : "memory");
}

// 4 L bytes from global to shared memory by the 32 lanes of a warp: 16
// bytes a copy where both sides allow it (`vec`), else 4
__device__ __forceinline__ void stage_row(void* dst, const void* src, int L, int lane, bool vec) {
    float* d = static_cast<float*>(dst);
    const float* s = static_cast<const float*>(src);
    if (vec) {
        for (int k = 4 * lane; k < L; k += 128) cp_async16(d + k, s + k);
    } else {
        for (int k = lane; k < L; k += 32) cp_async4(d + k, s + k);
    }
}

// The visit order, one chunk of 32 entries per coalesced load: entry q of
// the flattened (sweep, position) sequence, -1 past its end.
__device__ __forceinline__ int visit_chunk(const WarpArgs& a, long long q, int lane) {
    const long long k = q + lane;
    if (k >= static_cast<long long>(a.sweeps) * a.S) return -1;
    return a.idx[a.reuse ? k % a.S : k];
}

// The producer warp: for every visited row, wait until its slot is empty,
// then stage the row and the CTA's problems' d_i, u_i into it; each lane's
// copies count one arrival on the slot's full barrier when they land.
template <bool kCplx, bool kCsr>
__device__ void produce(const WarpArgs& a, const WarpLayout& w, unsigned char* smem, int lane,
                        int G) {
    constexpr int nc = kCplx ? 2 : 1;
    unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
    unsigned long long* empty = full + a.R;
    const int L = a.L;
    const size_t p0 = static_cast<size_t>(blockIdx.x) * a.g;
    auto aligned = [](const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; };
    const bool vec = L % 4 == 0 && aligned(a.ar) && (!kCplx || aligned(a.ai)) &&
                     (!kCsr || aligned(a.cols));
    const long long total = static_cast<long long>(a.sweeps) * a.S;
    int slot = 0;
    unsigned phase = 0;
    int cur = visit_chunk(a, 0, lane), nxt = visit_chunk(a, 32, lane);
    for (long long q0 = 0; q0 < total; q0 += 32) {
        const int cnt = static_cast<int>(min(32LL, total - q0));
        for (int jj = 0; jj < cnt; ++jj) {
            const int i = __shfl_sync(0xffffffffu, cur, jj);
            if (i < 0) continue;
            mbar_wait(empty + slot, phase ^ 1u);
            unsigned char* sl = smem + w.ring + static_cast<size_t>(slot) * w.slot;
            float* sc = reinterpret_cast<float*>(sl);
            for (int q = lane; q < G * (1 + nc); q += 32) {
                const size_t pp = p0 + q / (1 + nc);
                const int c = q % (1 + nc);
                cp_async4(sc + q, c == 0 ? a.denom + pp * a.m + i
                                         : a.u + (pp * nc + c - 1) * a.m + i);
            }
            float* row = reinterpret_cast<float*>(sl + w.row);
            const size_t base = static_cast<size_t>(i) * L;
            stage_row(row, a.ar + base, L, lane, vec);
            if constexpr (kCplx) stage_row(row + w.lr, a.ai + base, L, lane, vec);
            if constexpr (kCsr) stage_row(row + nc * w.lr, a.cols + base, L, lane, vec);
            cp_async_arrive(full + slot);
            if (++slot == a.R) {
                slot = 0;
                phase ^= 1u;
            }
        }
        cur = nxt;
        nxt = visit_chunk(a, q0 + 64, lane);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// The entries of the shared-memory route that a lane takes at once: its
// row entries k, k + 32, ..., k + 32 (kBatch - 1) and their x, loaded
// before they are used (the stores to x could otherwise hold back the next
// entry's loads)
constexpr int kBatch = 8;

// A consumer warp: problem p0 + warp, x in registers (kK entries a lane) or
// in shared memory (kK = 0), its vl in shared or global memory.
template <bool kCplx, bool kCsr, int kK, bool kProf>
__device__ void consume(const WarpArgs& a, const WarpLayout& w, unsigned char* smem, int warp,
                        int lane) {
    constexpr int nc = kCplx ? 2 : 1;
    constexpr bool kReg = kK > 0;
    constexpr int kKr = kReg ? kK : 1;
    unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
    unsigned long long* empty = full + a.R;
    const int n = a.n, m = a.m, L = a.L;
    const size_t p = static_cast<size_t>(blockIdx.x) * a.g + warp;
    float* xg = a.x + p * nc * n;
    float* vlg = a.vl + p * nc * m;
    float* xs = reinterpret_cast<float*>(smem + w.x) + static_cast<size_t>(warp) * nc * n;
    float* vl = a.vl_shared
                    ? reinterpret_cast<float*>(smem + w.vl) + static_cast<size_t>(warp) * nc * m
                    : vlg;
    const float e = a.eps[p];
    // x in registers: lane l holds x[l + 32 k]; the entries past n are 0 and
    // stay 0 (their row entries in the slot are 0), so no step tests k < n
    float xr[kKr], xi[kKr];
    if constexpr (kReg) {
#pragma unroll
        for (int k = 0; k < kK; ++k) {
            const int c = lane + 32 * k;
            xr[k] = c < n ? xg[c] : 0.f;
            xi[k] = kCplx && c < n ? xg[n + c] : 0.f;
        }
    } else {
        for (int k = lane; k < nc * n; k += 32) xs[k] = xg[k];
    }
    if (a.vl_shared)
        for (int k = lane; k < nc * m; k += 32) vl[k] = vlg[k];
    __syncwarp();

    const bool timed = kProf && blockIdx.x == 0 && warp == 0;
    long long acc[kWarpPhases] = {};
    long long tk = 0;
    const long long t_start = timed ? clock64() : 0;
    auto mark = [&](int ph) {
        if (timed) {
            const long long now = clock64();
            acc[ph] += now - tk;
            tk = now;
        }
    };

    const long long total = static_cast<long long>(a.sweeps) * a.S;
    int slot = 0;
    unsigned phase = 0;
    int js = 0;  // the position in the sweep
    int cur = visit_chunk(a, 0, lane), nxt = visit_chunk(a, 32, lane);
    for (long long q0 = 0; q0 < total; q0 += 32) {
        const int cnt = static_cast<int>(min(32LL, total - q0));
        for (int jj = 0; jj < cnt; ++jj) {
            const int i = __shfl_sync(0xffffffffu, cur, jj);
            if (i >= 0) {
                if (timed) tk = clock64();
                // vl_i now: its latency overlaps the wait and the dot
                const float v0 = vl[i];
                const float v1 = kCplx ? vl[m + i] : 0.f;
                mbar_wait(full + slot, phase);
                mark(kPhWait);
                const unsigned char* sl = smem + w.ring + static_cast<size_t>(slot) * w.slot;
                const float* sc = reinterpret_cast<const float*>(sl) + warp * (1 + nc);
                const float* ra = reinterpret_cast<const float*>(sl + w.row);
                const float* rb = ra + w.lr;
                const int* rc = reinterpret_cast<const int*>(ra + nc * w.lr);
                const float d = sc[0];
                const float u0 = sc[1];
                const float u1 = kCplx ? sc[2] : 0.f;
                double s[4] = {0.0, 0.0, 0.0, 0.0};
                float va[kKr], vb[kKr];
                if constexpr (kReg) {
#pragma unroll
                    for (int k = 0; k < kK; ++k) {
                        va[k] = ra[lane + 32 * k];
                        if constexpr (kCplx) vb[k] = rb[lane + 32 * k];
                    }
#pragma unroll
                    for (int k = 0; k < kK; ++k) {
                        s[0] += rls::dmul(va[k], xr[k]);
                        if constexpr (kCplx) {
                            s[1] += rls::dmul(vb[k], xi[k]);
                            s[2] += rls::dmul(va[k], xi[k]);
                            s[3] += rls::dmul(vb[k], xr[k]);
                        }
                    }
                    // the row is in registers: release the slot
                    __syncwarp();
                    if (lane == 0) mbar_arrive(empty + slot);
                } else {
                    for (int k0 = lane; k0 < L; k0 += 32 * kBatch) {
                        float av[kBatch], bv[kBatch], xa[kBatch], xb[kBatch];
                        int cc[kBatch];
#pragma unroll
                        for (int u = 0; u < kBatch; ++u) {
                            const int k = k0 + 32 * u;
                            const bool in = k < L;
                            av[u] = in ? ra[k] : 0.f;
                            bv[u] = kCplx && in ? rb[k] : 0.f;
                            cc[u] = kCsr ? (in ? rc[k] : 0) : (in ? k : 0);
                        }
#pragma unroll
                        for (int u = 0; u < kBatch; ++u) {
                            xa[u] = xs[cc[u]];
                            xb[u] = kCplx ? xs[n + cc[u]] : 0.f;
                        }
#pragma unroll
                        for (int u = 0; u < kBatch; ++u) {
                            if (k0 + 32 * u < L) {
                                s[0] += rls::dmul(av[u], xa[u]);
                                if constexpr (kCplx) {
                                    s[1] += rls::dmul(bv[u], xb[u]);
                                    s[2] += rls::dmul(av[u], xb[u]);
                                    s[3] += rls::dmul(bv[u], xa[u]);
                                }
                            }
                        }
                    }
                }
                mark(kPhDot);
                rls::warp_allsum<kCplx ? 4 : 1>(s);
                mark(kPhButterfly);
                float alr, ali = 0.f;
                if constexpr (kCplx) {
                    const float taur =
                        rls::fsub(static_cast<float>(s[0]), static_cast<float>(s[1]));
                    const float taui =
                        rls::fadd(static_cast<float>(s[2]), static_cast<float>(s[3]));
                    alr = rls::fmul(d, rls::fsub(rls::fsub(u0, taur), rls::fmul(e, v0)));
                    ali = rls::fmul(d, rls::fsub(rls::fsub(u1, taui), rls::fmul(e, v1)));
                    vl[i] = rls::fadd(v0, rls::fmul(alr, e));
                    vl[m + i] = rls::fadd(v1, rls::fmul(ali, e));
                } else {
                    alr = rls::fmul(
                        d, rls::fsub(rls::fsub(u0, static_cast<float>(s[0])), rls::fmul(e, v0)));
                    vl[i] = rls::fadd(v0, rls::fmul(alr, e));
                }
                mark(kPhAlpha);
                if constexpr (kReg) {
#pragma unroll
                    for (int k = 0; k < kK; ++k) {
                        if constexpr (kCplx) {
                            xr[k] = rls::fadd(rls::fadd(xr[k], rls::fmul(alr, va[k])),
                                              rls::fmul(ali, vb[k]));
                            xi[k] = rls::fsub(rls::fadd(xi[k], rls::fmul(ali, va[k])),
                                              rls::fmul(alr, vb[k]));
                        } else {
                            xr[k] = rls::fadd(xr[k], rls::fmul(alr, va[k]));
                        }
                    }
                } else {
                    for (int k0 = lane; k0 < L; k0 += 32 * kBatch) {
                        float av[kBatch], bv[kBatch], xa[kBatch], xb[kBatch];
                        int cc[kBatch];
#pragma unroll
                        for (int u = 0; u < kBatch; ++u) {
                            const int k = k0 + 32 * u;
                            const bool in = k < L;
                            av[u] = in ? ra[k] : 0.f;
                            bv[u] = kCplx && in ? rb[k] : 0.f;
                            cc[u] = kCsr ? (in ? rc[k] : 0) : (in ? k : 0);
                        }
#pragma unroll
                        for (int u = 0; u < kBatch; ++u) {
                            xa[u] = xs[cc[u]];
                            xb[u] = kCplx ? xs[n + cc[u]] : 0.f;
                        }
#pragma unroll
                        for (int u = 0; u < kBatch; ++u) {
                            // past L, and a CSR row's padding, write nothing
                            const bool put = k0 + 32 * u < L &&
                                             (!kCsr || av[u] != 0.f || (kCplx && bv[u] != 0.f));
                            if (put) {
                                if constexpr (kCplx) {
                                    xs[cc[u]] = rls::fadd(rls::fadd(xa[u], rls::fmul(alr, av[u])),
                                                          rls::fmul(ali, bv[u]));
                                    xs[n + cc[u]] =
                                        rls::fsub(rls::fadd(xb[u], rls::fmul(ali, av[u])),
                                                  rls::fmul(alr, bv[u]));
                                } else {
                                    xs[cc[u]] = rls::fadd(xa[u], rls::fmul(alr, av[u]));
                                }
                            }
                        }
                    }
                    // every lane is done with the slot (and, for CSR, the next
                    // dot sees every lane's update of x)
                    __syncwarp();
                    if (lane == 0) mbar_arrive(empty + slot);
                }
                mark(kPhAxpy);
                if (++slot == a.R) {
                    slot = 0;
                    phase ^= 1u;
                }
            }
            if (++js == a.S) {  // the end of a sweep: the projection
                js = 0;
                if (timed) tk = clock64();
                if constexpr (kReg) {
#pragma unroll
                    for (int k = 0; k < kK; ++k) {
                        if (a.prox == kProxPositive) xr[k] = fmaxf(xr[k], 0.f);
                        if (kCplx && a.prox != kProxNone) xi[k] = rls::fmul(xi[k], 0.f);
                    }
                } else {
                    if (a.prox == kProxPositive)
                        for (int k = lane; k < n; k += 32) xs[k] = fmaxf(xs[k], 0.f);
                    if (kCplx && a.prox != kProxNone)
                        for (int k = lane; k < n; k += 32) xs[n + k] = rls::fmul(xs[n + k], 0.f);
                    __syncwarp();
                }
                mark(kPhProject);
            }
        }
        cur = nxt;
        nxt = visit_chunk(a, q0 + 64, lane);
    }
    if constexpr (kReg) {
#pragma unroll
        for (int k = 0; k < kK; ++k) {
            const int c = lane + 32 * k;
            if (c < n) {
                xg[c] = xr[k];
                if constexpr (kCplx) xg[n + c] = xi[k];
            }
        }
    } else {
        for (int k = lane; k < nc * n; k += 32) xg[k] = xs[k];
    }
    if (a.vl_shared) {
        __syncwarp();
        for (int k = lane; k < nc * m; k += 32) vlg[k] = vl[k];
    }
    if (timed && lane == 0) {
        acc[kPhTotal] = clock64() - t_start;
        for (int k = 0; k < kWarpPhases; ++k) a.prof[k] = acc[k];
    }
}

// g consumer warps (warps 0..g-1, problems blockIdx.x * g + warp) and the
// producer (warp g); the last CTA may hold fewer problems, and its idle
// consumer warps leave at once. The one __syncthreads is before the solve.
template <bool kCplx, bool kCsr, int kK, bool kProf>
__global__ void __launch_bounds__(kWarpThreads, 1)
kaczmarz_warp_kernel(WarpArgs a, WarpLayout w) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int G = min(a.g, a.P - static_cast<int>(blockIdx.x) * a.g);
    // x in registers: the row entries past L up to 32 kx stay 0 in every
    // slot (the copies write entries [0, L) only)
    constexpr int nc = kCplx ? 2 : 1;
    if (kK > 0 && w.lr > static_cast<size_t>(a.L))
        for (int s = 0; s < a.R; ++s)
            for (int q = 0; q < nc; ++q) {
                float* row = reinterpret_cast<float*>(smem + w.ring + s * w.slot + w.row) +
                             q * w.lr;
                for (int k = a.L + threadIdx.x; k < static_cast<int>(w.lr); k += blockDim.x)
                    row[k] = 0.f;
            }
    if (threadIdx.x == 0) {
        unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
        for (int s = 0; s < a.R; ++s) {
            mbar_init(full + s, 32);         // the producer's 32 lanes
            mbar_init(full + a.R + s, G);    // the CTA's consumer warps
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (warp == a.g)
        produce<kCplx, kCsr>(a, w, smem, lane, G);
    else if (warp < G)
        consume<kCplx, kCsr, kK, kProf>(a, w, smem, warp, lane);
}

template <bool kCplx, bool kCsr, int kK>
int warp_go(const WarpArgs& a, const WarpLayout& w, cudaStream_t stream) {
    auto kernel = a.prof != nullptr ? kaczmarz_warp_kernel<kCplx, kCsr, kK, true>
                                    : kaczmarz_warp_kernel<kCplx, kCsr, kK, false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(w.total));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(a.P + a.g - 1) / a.g, 32 * (a.g + 1), w.total, stream>>>(a, w);
    return static_cast<int>(cudaGetLastError());
}

// x in registers: kx entries a lane (1, 2, 4, 8, or 16 for real rows); in
// shared memory: kx = 0 (the only placement of CSR rows)
template <bool kCplx, bool kCsr>
int warp_dispatch(const WarpArgs& a, const WarpLayout& w, int kx, cudaStream_t stream) {
    if constexpr (kCsr) {
        return kx == 0 ? warp_go<kCplx, true, 0>(a, w, stream)
                       : static_cast<int>(cudaErrorInvalidValue);
    } else {
        switch (kx) {
            case 0: return warp_go<kCplx, false, 0>(a, w, stream);
            case 1: return warp_go<kCplx, false, 1>(a, w, stream);
            case 2: return warp_go<kCplx, false, 2>(a, w, stream);
            case 4: return warp_go<kCplx, false, 4>(a, w, stream);
            case 8: return warp_go<kCplx, false, 8>(a, w, stream);
            case 16:
                if constexpr (!kCplx) return warp_go<false, false, 16>(a, w, stream);
                [[fallthrough]];
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
}

}  // namespace

extern "C" {

// The block route. ar (ai): (m, L) f32, the rows' real (imaginary) parts:
// dense rows (L = n) or padded CSR values (L = k_max) with cols (m, L) int32
// (null if dense); ai null for real rows. idx: (reuse ? 1 : sweeps, S)
// int32, -1 = skip. x: (P, nc, n) and vl: (P, nc, m), updated in place; u:
// (P, nc, m); denom: (P, m); eps: (P,). prox: 0 none, 1 Positive, 2 Real.
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

// The warp route, on the operands of kaczmarz_launch and a plan: g problems
// a CTA (1..16), a ring of R slots, x in registers with kx entries a lane
// (kx = 0: in shared memory), vl in shared memory if vl_shared; smem must
// equal the route's own count of shared memory (warp_layout). prof: null,
// or kWarpPhases int64 that receive CTA 0's warp 0 clocks per phase.
int kaczmarz_warp_launch(const void* ar, const void* ai, const void* cols, const void* idx,
                         void* x, void* vl, const void* u, const void* denom, const void* eps,
                         void* prof, int P, int m, int n, int L, int sweeps, int S, int reuse,
                         int prox, int g, int R, int kx, int vl_shared, int smem,
                         void* stream) {
    if (P <= 0 || sweeps <= 0 || S <= 0) return 0;
    const bool cplx = ai != nullptr, csr = cols != nullptr;
    if (g < 1 || g > kMaxGroups || R < 1 || kx < 0 || (kx > 0 && n > 32 * kx))
        return static_cast<int>(cudaErrorInvalidValue);
    const WarpLayout w = warp_layout(m, n, L, cplx ? 2 : 1, csr, g, R, kx, vl_shared != 0);
    if (w.total != static_cast<size_t>(smem)) return static_cast<int>(cudaErrorInvalidValue);
    const WarpArgs a{static_cast<const float*>(ar), static_cast<const float*>(ai),
                     static_cast<const int*>(cols), static_cast<const int*>(idx),
                     static_cast<float*>(x), static_cast<float*>(vl),
                     static_cast<const float*>(u), static_cast<const float*>(denom),
                     static_cast<const float*>(eps), static_cast<long long*>(prof),
                     P, m, n, L, sweeps, S, reuse, prox, g, R, vl_shared};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (cplx) return csr ? warp_dispatch<true, true>(a, w, kx, st)
                         : warp_dispatch<true, false>(a, w, kx, st);
    return csr ? warp_dispatch<false, true>(a, w, kx, st) : warp_dispatch<false, false>(a, w, kx, st);
}

}  // extern "C"
