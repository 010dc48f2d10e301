// The whole fixed-iteration PDHG (Chambolle-Pock) solve on a separable
// convolution in one launch, on one of two routes that the host planner
// (kernels/pdhg_fused.py plan_pdhg) picks by shape:
//
// * resident: each problem runs on a thread-block cluster of c <= 16 CTAs
//   of 1024 threads, CTA q owning the image rows [q R, (q + 1) R) (the
//   last band may be shorter), with every plane that is read at another
//   pixel than its own held in shared memory for the whole solve;
// * global: one CTA per problem with its planes in global scratch, for a
//   row so wide that no band fits (about W > 5,200 for kTv8).
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
// follows op for op on both routes, is pdhg_fused_torch in
// rls_tpu_torch/kernels/pdhg_fused.py. Every product and sum is rounded on
// its own (rls::fmul & co., stencil passes with kRound), so nvcc contracts
// nothing and the kernel agrees with the plain version bit for bit.
//
// What bounds it on an H100: per pixel and iteration the four stencil
// passes (4 K - 2 operations for a K-tap kernel) and the dual/primal
// updates (~200 operations for kTv8, ~20 for kL1): 274 operations at the
// PDHG cell, so the solve is operations-bound at the card's peak. A 256^2
// plane (256 KiB) does not fit one block's shared memory. On the global
// route (the first design) x, y1, the stencil temporary and the dual planes
// (8, 2 or 1) live in global scratch, each iteration is four block-wide
// sweeps over them, and at batch 16 only 16 of the 132 SMs work, each bound
// by the latency of its L2 loads (~600 us per iteration at the cell). The
// resident route spreads a problem over a cluster of neighbouring SMs that
// read each other's shared memory (DSMEM): x, y1, t1 and the dual planes
// of a band sit in its CTA's shared memory (kTv8 at 256^2: 16 bands of 16
// rows, 11 planes of 16 KiB), u is read at its own pixel from global
// memory, and only halo rows cross between CTAs. Rows outside the band are
// read through rls::Band's row table (cluster_common.cuh), up to kHalo = 31
// rows away, so a 63-tap column pass may reach past the adjacent band; the
// kTv8 differences reach 2 rows down (x in the dual update) and 2 rows up
// (the duals in Phi^H).
//
// The resident route's iteration, four sweeps over the band:
//   (a) t1 = the column pass of A on x          reads x of other bands
//       __syncthreads()
//   (b) the dual update: y1, y2 at the pixel    reads t1 in its own row,
//       from t1's row pass, u, y1, y2 there         x up to 2 rows down
//       cluster barrier B1
//   (c) t1 = the column pass of A^H on y1       reads y1 of other bands
//       __syncthreads()
//   (d) the primal update: x at the pixel       reads t1 in its own row,
//       from t1's row pass and Phi^H y2             y2 up to 2 rows up
//       cluster barrier B2
// What orders each access to another CTA's planes, and each rewrite of a
// plane that a peer may still read:
//   x  read by peers in (a), (b); written in (d)   B2 (RAW into the next
//        (a), (b)); B1 (WAR: every (a), (b) read before any (d) write)
//   y1 read by peers in (c); written in (b)         B1 (RAW); B2 (WAR: the
//        last (c) read before the next (b) write)
//   y2 read by peers in (d); written in (b)         B1 (RAW); B2 (WAR)
//   t1 own band only: (a)|(b) and (c)|(d) by __syncthreads(); (b) before
//        (c)'s rewrite by B1, (d) before the next (a)'s by B2
// The set-up zeroes the planes and ends with a cluster barrier (every CTA
// of the cluster running, its planes zero, before any remote read); the
// last B2 orders the last remote read before any CTA exits. Then each CTA
// writes its band of x to `out`. With c = 1 the cluster barriers are
// __syncthreads().
//
// A phase timer (prof): CTA 0's thread 0 adds the SM clocks between its
// phase marks (set-up and write-back, A x pass, dual update, A^H y1 pass,
// primal update, cluster barriers); off where prof is null.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_common.cuh"
#include "pgm_tv_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTaps = 63;  // per axis; the wrapper checks it
enum { kTv8 = 0, kTviso = 1, kL1 = 2 };

// (row, column) offset of the subtracted sample per plane (_DIRS8)
__constant__ int kDr[8] = {1, 0, 1, 1, 2, 2, 1, 1};
__constant__ int kDc[8] = {0, 1, 1, -1, 1, -1, 2, -2};

// the difference x[r, c] - x[r + dr, c + dc] is defined at (r, c)
__device__ __forceinline__ bool defined_at(int dr, int dc, int r, int c, int H, int W) {
    if (r < 0 || r >= H - dr) return false;
    return dc >= 0 ? (c >= 0 && c < W - dc) : (c >= -dc && c < W);
}

// plane k of the 8-direction gradient is defined at (r, c)
__device__ __forceinline__ bool defined8(int k, int r, int c, int H, int W) {
    return defined_at(kDr[k], kDc[k], r, c, H, W);
}

// kDr[k], kDc[k] as constants of an unrolled loop
__device__ __forceinline__ constexpr int dr8(int k) {
    return k == 1 ? 0 : (k == 4 || k == 5 ? 2 : 1);
}
__device__ __forceinline__ constexpr int dc8(int k) {
    return k == 0 ? 0 : (k == 6 ? 2 : (k == 7 ? -2 : (k % 2 == 1 && k > 1 ? -1 : 1)));
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


// ---- the resident route: one problem per cluster, planes in shared memory

enum { kX, kY1, kT1, kY2 };  // the shared-memory planes; kY2 + k: dual plane k
// the phases of the timer
enum { kSetup, kAx, kDual, kAty, kPrimal, kBarrier, kPhases };

__host__ __device__ constexpr int dual_planes(int kind) {
    return kind == kTv8 ? 8 : (kind == kTviso ? 2 : 1);
}

// floats of one plane of a band of `rows` rows (16-byte multiples)
__host__ __device__ inline size_t plane_floats(int rows, int W) {
    return (static_cast<size_t>(rows) * W + 3) / 4 * 4;
}

// Shared memory of a CTA of the resident route, in this order; the Python
// planner (kernels/pdhg_fused.py cluster_smem_bytes) counts the same:
// x, y1, t1 and the dual planes of the band, the phase timer (kPhases
// int64), the DSMEM row table (rows + 2 kHalo pointers), the taps (2
// kMaxTaps floats) and the 8 plane weights.
__host__ __device__ inline size_t cluster_smem_bytes(int kind, int rows, int W) {
    return sizeof(float) * (3 + dual_planes(kind)) * plane_floats(rows, W) +
           sizeof(long long) * kPhases + sizeof(const float*) * (rows + 2 * rls::kHalo) +
           sizeof(float) * (2 * kMaxTaps + 8);
}

struct ClusterArgs {
    const float* u;        // (B, H, W)
    const float* scal;     // (B, 3) [sigma, tau, lam_eff]
    const float* taps;     // kh + kw
    const float* weights;  // 8
    float* out;            // (B, H, W)
    long long* prof;       // (kPhases,) or null
    int kh, kw, B, H, W, iterations, positive;
    int clusters, rows;  // c CTAs per problem, R rows per band
};

using Prof = rls::Prof<kPhases>;
using Band = rls::Band<true>;

template <int kKind>
__global__ void __launch_bounds__(kThreads, 1) pdhg_cluster_kernel(const ClusterArgs a) {
    constexpr int np = dual_planes(kKind);
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = a.H, W = a.W, R = a.rows, nc = a.clusters;
    const size_t pf = plane_floats(R, W);
    float* s = reinterpret_cast<float*>(smem);
    long long* pacc = reinterpret_cast<long long*>(s + (3 + np) * pf);
    const float** rowp = reinterpret_cast<const float**>(pacc + kPhases);
    float* taps = reinterpret_cast<float*>(rowp + R + 2 * rls::kHalo);
    float* wt = taps + 2 * kMaxTaps;

    cg::cluster_group cl = cg::this_cluster();
    const int rank = static_cast<int>(cl.block_rank());
    const int b = blockIdx.x / nc;
    const int r0 = rank * R;
    const Band bd{s, rowp, pf, r0, min(R, H - r0), H, W};
    const int n = bd.rows * W;  // this CTA's pixels, local index i
    const rls::Sweep<kThreads> sweep(n, W);
    const int tid = threadIdx.x;
    Prof prof{blockIdx.x == 0 && tid == 0 ? a.prof : nullptr, pacc, 0};
    prof.start();
    auto sync_cluster = [&](int phase) {
        prof.mark(phase);
        if (nc > 1)
            cl.sync();
        else
            __syncthreads();
        prof.mark(kBarrier);
    };

    for (int k = tid; k < a.kh + a.kw; k += kThreads) taps[k] = a.taps[k];
    if (tid < 8) wt[tid] = a.weights[tid];
    rls::fill_row_table(rowp, s, r0, R, H, W, cl);
    float* x = bd.plane(kX);
    float* y1 = bd.plane(kY1);
    float* t1 = bd.plane(kT1);
    float* y2[np];
#pragma unroll
    for (int k = 0; k < np; ++k) y2[k] = bd.plane(kY2 + k);
    const float* th = taps;
    const float* tw = taps + a.kh;

    // the band's pixels are contiguous in (B, H, W)
    const size_t off = static_cast<size_t>(b) * H * W + static_cast<size_t>(r0) * W;
    const float* u = a.u + off;
    const float sigma = a.scal[3 * b];
    const float tau = a.scal[3 * b + 1];
    const float lam = a.scal[3 * b + 2];
    const float inv1s = rls::fdiv(1.f, rls::fadd(1.f, sigma));
    for (int i = tid; i < n; i += kThreads) {
        const float zero = rls::fmul(u[i], 0.f);
        x[i] = zero;
        y1[i] = zero;
#pragma unroll
        for (int k = 0; k < np; ++k) y2[k][i] = zero;
    }
    sync_cluster(kSetup);

    for (int it = 0; it < a.iterations; ++it) {
        // (a) A x: the column pass into t1 (the row pass follows in (b))
        sweep([&](int i, int lr, int c) {
            t1[i] = bd.stencil_v(kX, i, lr, c, th, a.kh, false);
        });
        __syncthreads();
        prof.mark(kAx);
        // (b) the dual updates, pixel by pixel (x is not written here)
        sweep([&](int i, int lr, int c) {
            const int r = r0 + lr;
            const float ax = bd.stencil_h(kT1, i, lr, c, tw, a.kw, false);
            y1[i] = rls::fmul(rls::fadd(y1[i], rls::fmul(sigma, rls::fsub(ax, u[i]))), inv1s);
            const float xv = x[i];
            if constexpr (kKind == kTv8) {
                float p[8];
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const float g = defined_at(dr8(k), dc8(k), r, c, H, W)
                                        ? rls::fsub(xv, bd.shifted(kX, i, lr, c, dr8(k), dc8(k)))
                                        : 0.f;
                    p[k] = rls::fadd(y2[k][i], rls::fmul(sigma, g));
                }
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    float sq = rls::fmul(p[0], p[0]);
#pragma unroll
                    for (int q = 1; q < 8; ++q) sq = rls::fadd(sq, rls::fmul(p[q], p[q]));
                    const float gnorm = __fsqrt_rn(sq);
                    p[k] = rls::fmul(rls::fmul(wt[k], sign(p[k])), fminf(gnorm, lam));
                }
#pragma unroll
                for (int k = 0; k < 8; ++k) y2[k][i] = p[k];
            } else if constexpr (kKind == kTviso) {
                const float gv = r < H - 1 ? rls::fsub(bd.below(kX, i, lr, c), xv) : 0.f;
                const float gh = c < W - 1 ? rls::fsub(x[i + 1], xv) : 0.f;
                y2[0][i] = clip_conj(rls::fadd(y2[0][i], rls::fmul(sigma, gv)), lam);
                y2[1][i] = clip_conj(rls::fadd(y2[1][i], rls::fmul(sigma, gh)), lam);
            } else {
                y2[0][i] = clip_conj(rls::fadd(y2[0][i], rls::fmul(sigma, xv)), lam);
            }
        });
        sync_cluster(kDual);  // B1
        // (c) A^H y1: the column pass into t1 (the row pass follows in (d))
        sweep([&](int i, int lr, int c) {
            t1[i] = bd.stencil_v(kY1, i, lr, c, th, a.kh, true);
        });
        __syncthreads();
        prof.mark(kAty);
        // (d) the primal update (reads the duals' neighbours, writes x[i] only)
        sweep([&](int i, int lr, int c) {
            const int r = r0 + lr;
            const float aty = bd.stencil_h(kT1, i, lr, c, tw, a.kw, true);
            float d;
            if constexpr (kKind == kTv8) {
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const int dr = dr8(k);
                    const int dc = dc8(k);
                    const float q = defined_at(dr, dc, r, c, H, W) ? y2[k][i] : 0.f;
                    const float qs = defined_at(dr, dc, r - dr, c - dc, H, W)
                                         ? bd.shifted(kY2 + k, i, lr, c, -dr, -dc)
                                         : 0.f;
                    const float term = rls::fsub(q, qs);
                    d = k == 0 ? term : rls::fadd(d, term);
                }
            } else if constexpr (kKind == kTviso) {
                const float up = r > 0 ? bd.above(kY2, i, lr, c) : 0.f;
                const float left = c > 0 ? y2[1][i - 1] : 0.f;
                d = rls::fsub(rls::fadd(rls::fsub(up, y2[0][i]), left), y2[1][i]);
            } else {
                d = y2[0][i];
            }
            float xv = rls::fsub(x[i], rls::fmul(tau, rls::fadd(aty, d)));
            if (a.positive) xv = fmaxf(xv, 0.f);
            x[i] = xv;
        });
        sync_cluster(kPrimal);  // B2
    }
    float* o = a.out + off;
    for (int i = tid; i < n; i += kThreads) o[i] = x[i];
    prof.mark(kSetup);
    prof.finish();
}

using ClusterKernel = void (*)(ClusterArgs);

ClusterKernel cluster_kernel(int kind) {
    if (kind == kTv8) return &pdhg_cluster_kernel<kTv8>;
    if (kind == kTviso) return &pdhg_cluster_kernel<kTviso>;
    return &pdhg_cluster_kernel<kL1>;
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


// The resident route's shared memory per CTA for bands of `rows` rows of
// width W and dual kind `kind` (the planner's check), and how many clusters
// of `clusters` CTAs of its kernel the current device holds at once
// (cudaOccupancyMaxActiveClusters): out[0], out[1].
int pdhg_cluster_occupancy(int kind, int clusters, int rows, int W, long long* out) {
    if (kind < kTv8 || kind > kL1 || clusters < 1 || clusters > 16 || rows < 1 || W < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = cluster_smem_bytes(kind, rows, W);
    out[0] = static_cast<long long>(smem);
    out[1] = 0;
    if (smem > 0x7fffffff) return 0;
    out[1] = rls::max_active_clusters(cluster_kernel(kind), clusters, kThreads,
                                      static_cast<int>(smem));
    return 0;
}

// The resident route: as pdhg_fused_launch without scratch, with prof null
// or kPhases int64 that receive CTA 0's clocks per phase, and the plan:
// `clusters` CTAs per problem (at most 16), bands of `rows` rows, `smem`
// bytes of shared memory per CTA. Returns cudaErrorInvalidValue for a plan
// that does not cover H with no band empty or whose smem differs from
// cluster_smem_bytes, else the launch's error.
int pdhg_cluster_launch(const void* u, const void* scal, const void* taps, const void* weights,
                        int kh, int kw, void* out, void* prof, int B, int H, int W,
                        int iterations, int kind, int positive, int clusters, int rows, int smem,
                        void* stream) {
    const bool covers = kind >= kTv8 && kind <= kL1 && B > 0 && W > 0 && rows > 0 &&
                        clusters >= 1 && clusters <= 16 &&
                        static_cast<long long>(clusters - 1) * rows < H &&
                        static_cast<long long>(clusters) * rows >= H &&
                        static_cast<long long>(B) * clusters < (1LL << 31) &&
                        static_cast<long long>(rows) * W < (1LL << 31) && kh <= kMaxTaps &&
                        kw <= kMaxTaps;
    if (!covers || static_cast<size_t>(smem) != cluster_smem_bytes(kind, rows, W))
        return static_cast<int>(cudaErrorInvalidValue);
    const ClusterKernel k = cluster_kernel(kind);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t e = rls::cluster_config(k, B, clusters, kThreads, smem,
                                        static_cast<cudaStream_t>(stream), &attr, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    const ClusterArgs args{static_cast<const float*>(u),       static_cast<const float*>(scal),
                           static_cast<const float*>(taps),    static_cast<const float*>(weights),
                           static_cast<float*>(out),           static_cast<long long*>(prof),
                           kh, kw, B, H, W, iterations, positive, clusters, rows};
    e = cudaLaunchKernelEx(&cfg, k, args);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
