// The whole batched ADMM-TV solve in one launch, on one of two routes that
// the host planner (kernels/admm_tv_fused.py plan_admm_tv) picks by shape:
//
// * resident: each problem runs on a thread-block cluster of c <= 16 CTAs
//   of 1024 threads, CTA q owning the image rows [q R, (q + 1) R) (the
//   last band may be shorter), with every plane that is read at another
//   band's rows in shared memory (the fused PGM-TV kernel's band design,
//   fista_tv_fused.cu, sharing its banded Gram passes and fold FGP,
//   tv_band.cuh);
// * global: one CTA per problem with every plane in global scratch, for
//   images whose bands fit no cluster (a row wider than ~11,000 pixels).
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
// three sums are taken in double in a fixed order: each thread's pixels,
// the CTA's threads (rls::block_sum3), and on the resident route the ranks
// 0 .. c-1 through distributed shared memory (rls::cluster_sum3), rounded
// once to f32; every thread of a problem evaluates the same `active` and
// takes the same branch. The kernel also counts each problem's live CG
// steps.
//
// What bounds it on an H100. Per pixel and outer iteration the solve does
// ~1,000 f32 operations at BASELINE #3 (12 x 6 x 8), so its bound is the
// card's f32 rate (0.13 ms at the cell); what holds it far above that is
// the chain of dependent sweeps. On the global route (the first design) a
// 256^2 plane (256 KiB) exceeds a block's shared memory, so the 13 planes
// live in global scratch, a CG step is six block-wide sweeps with
// __syncthreads() between them and two block reductions, and at batch 16
// only 16 of the 132 SMs hold a CTA: each problem's chain runs at one SM's
// latency (29.4 ms at the cell). The resident route spreads each problem
// over a cluster of neighbouring SMs that read each other's shared memory
// (DSMEM): the five planes read at other bands' rows sit in shared memory
// for the whole solve, reused as they die (256^2 at c = 6: 43-row bands,
// 43 KiB per plane, 222 KB per CTA, 17 clusters resident at once, so the
// cell's 16 problems run in one wave on 96 SMs):
//   S0 the Gram's input (x at the CG start, then p), the FGP's y
//   S1 the column pass t1, the FGP's dual momentum rv
//   S2 the column adjoint t2, then the prox input xg = x + u
//   S3 the row pass t3, the FGP's dual momentum rh
//   S4 the FGP's dual pv
// and x, z, u, r, q and the dual ph (read in its own rows only) live in
// global memory, read and written at their own pixel (coalesced).
//
// The resident route's outer iteration, with its cluster barriers
// (barrier.cluster; __syncthreads() where c = 1; each also a CTA barrier):
//   Bx   S0 = x whole (the set-up's zeros, or the last z-update's copy)
//   G1   the column pass S0 -> S1, Bt, its adjoint S1 -> S2 (reads S1 at
//        other bands' rows), the row pass S2 -> S3; Bt is the Gram's
//        barrier (tv_band.cuh band_gram_passes)
//   CG start: one sweep forms beta, r = beta - (A^H A x + rho x) (the last
//        pass reads S3 in its own rows), p = r into S0, ||beta||^2 and r.r;
//        cluster sum Ss
//   each CG step: the Gram of S0 (G1), q and p.q (cluster sum Sq); alpha;
//        x += alpha p, r -= alpha q and r.r (cluster sum Sr); where
//        `active` and a step follows, p = r + beta_c p into S0, then Bp
//   the z-update: x = max(x, 0) (Positive), xg = x + u into S2; where
//        rho != 0 and tv_iterations > 0 the fold FGP (tv_band.cuh
//        band_fold_fgp): Bf0, the first dual sweep (reads S2 one row
//        down), then per later dual iteration Bf1, y into S0 (reads S1 one
//        row up), Bf2, the duals (read S0 one row down), and a last Bf3;
//        then z = xg - grad_t(pv, ph) (reads S4 one row up), u = u + x - z
//        and S0 = x (the next Bx publishes it)
// What orders each read of another CTA's shared memory (RAW), and each
// rewrite of a plane that a peer may still read (WAR):
//   S0 as x: written by the z-update / set-up, read by peers in G1's
//        column pass: Bx (RAW); as p: written at the CG start (read in the
//        next G1: Ss is a cluster barrier, RAW) and by the p update (Bp,
//        RAW); every write follows the peers' last G1 read by Bt (WAR); as
//        y: written per dual iteration after Bf1, read by peers after Bf2
//        (RAW), and Bf1 orders the previous iteration's reads (WAR); the
//        z-update's copy of x follows the last reads of y by Bf3 (WAR)
//   S1 as t1: read by peers after Bt (RAW); the next column pass writes it
//        after Sq / Ss / Bf0 (WAR); as rv: read one row up after Bf1 (RAW)
//        and rewritten after Bf2 (WAR)
//   S2 as xg: read one row down after Bf0 (RAW); the next Gram's adjoint
//        writes it after Bx and Bt (WAR)
//   S4 (pv): read one row up after Bf3 (RAW); rewritten in the next
//        z-update's first dual sweep, after Bx, Bt, Ss and Bf0 (WAR)
//   S3, ph, the global planes: own rows (or own pixel) only; CTA barriers
//   the CG sums: the two-slot rls::cluster_sum3 (Sq and Sr follow each
//        other with no other cluster barrier between them)
// Edge schedules: with 0 CG steps the CG start's p is never read and the
//   z-update follows Ss; with no dual iteration or rho = 0 the FGP and its
//   barriers Bf0-Bf3 are skipped (z = xg at the own pixel, after a CTA
//   barrier), and the next Bx orders the peers' G1 reads after every
//   write of S0; the first outer iteration's Bx follows the set-up (every
//   CTA of the cluster running, its S0 zero, before any DSMEM read). The
//   kernel ends with a cluster barrier Be, so that no CTA exits while a
//   peer still reads its shared memory (S4 in the last z-update, or a sum
//   slot). tests/test_torch_admm_plan.py runs this schedule band by band
//   and fails where any of these barriers is dropped.
//
// A phase timer (prof): CTA 0's thread 0 adds the SM clocks between its
// phase marks (set-up, Gram, CG vector sweeps, cluster sums, FGP sweeps,
// cluster barriers, the z-update); off where prof is null.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "admm_tv_common.cuh"
#include "cluster_common.cuh"
#include "tv_band.cuh"

namespace cg = cooperative_groups;

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


// ---- the resident route: one problem per cluster, planes in shared memory

using rls::kHalo;  // the farthest row a stencil tap reads
constexpr int kMaxCluster = 16;
constexpr int kPlanes = 5;
enum { kIn, kT1Rv, kT2Xg, kT3Rh, kPv };  // the shared-memory planes S0-S4
// the phases of the timer
enum { kSetup, kGram, kCgVec, kSums, kFgp, kBarrier, kZu, kPhases };

// Shared memory of a CTA of the resident route, in this order; the Python
// planner (kernels/admm_tv_fused.py cluster_smem_bytes) counts the same:
// five planes of the band, the block sums (3 x 32 doubles), this CTA's two
// slots of sums for the cluster and the cluster's (4 doubles each), the
// phase timer (kPhases int64), the DSMEM row table (rows + 2 kHalo
// pointers) and the taps (2 kMaxTaps floats).
__host__ __device__ inline size_t cluster_smem_bytes(int rows, int W) {
    return sizeof(float) * kPlanes * rls::band_plane_floats(rows, W) +
           sizeof(double) * (3 * (kThreads / 32) + 12) + sizeof(long long) * kPhases +
           sizeof(const float*) * (rows + 2 * kHalo) + sizeof(float) * 2 * kMaxTaps;
}

struct ClusterArgs {
    const float* x0hat;  // (B, H, W)
    const float* scal;   // (B, 2) [rho, lam_eff]
    const float* t2tab;  // (tv_iterations, 2)
    const float* taps;   // kh + kw
    float* out;          // (B, H, W): x
    float* scratch;      // 5 planes of (B, H, W): z, u, r, q, ph
    int* counts;         // (B,)
    long long* prof;     // (kPhases,) or null
    int kh, kw, B, H, W;
    int iterations, cg_iterations, tv_iterations, positive;
    float tol_inner;
    int clusters, rows;  // c CTAs per problem, R rows per band
};

using Prof = rls::Prof<kPhases>;
using Band = rls::Band<false>;  // nvcc may contract the taps, as on the global route
using Sweep = rls::Sweep<kThreads>;

__global__ void __launch_bounds__(kThreads, 1) admm_tv_cluster_kernel(const ClusterArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = a.H, W = a.W, R = a.rows, nc = a.clusters;
    const size_t pf = rls::band_plane_floats(R, W);
    float* s = reinterpret_cast<float*>(smem);
    double* red = reinterpret_cast<double*>(s + kPlanes * pf);
    double* mine = red + 3 * (kThreads / 32);  // two slots of 4
    double* all = mine + 8;
    long long* pacc = reinterpret_cast<long long*>(all + 4);
    const float** rowp = reinterpret_cast<const float**>(pacc + kPhases);
    float* taps = reinterpret_cast<float*>(rowp + R + 2 * kHalo);

    cg::cluster_group cl = cg::this_cluster();
    const int rank = static_cast<int>(cl.block_rank());
    const int b = blockIdx.x / nc;
    const int r0 = rank * R;
    const Band bd{s, rowp, pf, r0, min(R, H - r0), H, W};
    const int n = bd.rows * W;  // this CTA's pixels, local index i
    const Sweep sweep(n, W);
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
    int parity = 0;  // the two-slot cluster sums: Sq and Sr follow each other
    auto cluster_sum = [&](double* v, int phase) {
        prof.mark(phase);
        rls::cluster_sum3(v, red, mine, all, cl, nc, parity);
        prof.mark(kSums);
    };

    for (int k = tid; k < a.kh + a.kw; k += kThreads) taps[k] = a.taps[k];
    rls::fill_row_table(rowp, s, r0, R, H, W, cl);
    float* gin = bd.plane(kIn);  // x, then p; the FGP's y
    float* xg = bd.plane(kT2Xg);
    const float* taps_w = taps + a.kh;

    // the band's pixels are contiguous in (B, H, W)
    const size_t plane = static_cast<size_t>(a.B) * H * W;
    const size_t off = static_cast<size_t>(b) * H * W + static_cast<size_t>(r0) * W;
    const float* x0 = a.x0hat + off;
    float* x = a.out + off;
    float* z = a.scratch + off;
    float* u = z + plane;
    float* r = u + plane;
    float* q = r + plane;
    float* ph = q + plane;

    const float rho = a.scal[2 * b];
    const float lam_z = rls::prox_scale(rho, a.scal[2 * b + 1]);
    for (int i = tid; i < n; i += kThreads) {
        const float zero = x0[i] * 0.f;
        x[i] = zero;
        z[i] = zero;
        u[i] = zero;
        gin[i] = zero;
    }
    prof.mark(kSetup);

    const bool fgp = a.tv_iterations > 0 && rho != 0.f;
    int live = 0;
    double acc[3];
    for (int it = 0; it < a.iterations; ++it) {
        // Bx: x whole in S0. The CG's start: beta, r = beta - (A^H A +
        // rho I) x, p = r, with ||beta||^2 and r.r (Ss)
        sync_cluster(kZu);
        rls::band_gram_passes<kIn, kT1Rv, kT2Xg>(bd, sweep, bd.plane(kT3Rh), taps, a.kh,
                                                 a.kw, sync_cluster, kGram);
        acc[0] = acc[1] = acc[2] = 0.0;
        sweep([&](int i, int lr, int col) {
            const float beta = x0[i] + rho * (z[i] - u[i]);
            const float res =
                beta - (bd.stencil_h(kT3Rh, i, lr, col, taps_w, a.kw, true) + rho * x[i]);
            r[i] = res;
            gin[i] = res;
            acc[0] += static_cast<double>(beta * beta);
            acc[1] += static_cast<double>(res * res);
        });
        cluster_sum(acc, kGram);
        const float target = rls::fmul(a.tol_inner, __fsqrt_rn(static_cast<float>(acc[0])));
        float rz = static_cast<float>(acc[1]);

        for (int j = 0; j < a.cg_iterations; ++j) {
            // q = (A^H A + rho I) p and p.q (Sq)
            rls::band_gram_passes<kIn, kT1Rv, kT2Xg>(bd, sweep, bd.plane(kT3Rh), taps, a.kh,
                                                     a.kw, sync_cluster, kGram);
            acc[0] = acc[1] = acc[2] = 0.0;
            sweep([&](int i, int lr, int col) {
                const float pval = gin[i];
                const float qval =
                    bd.stencil_h(kT3Rh, i, lr, col, taps_w, a.kw, true) + rho * pval;
                q[i] = qval;
                acc[0] += static_cast<double>(pval * qval);
            });
            cluster_sum(acc, kGram);
            const bool active = rls::cg_active(rz, target);
            live += active ? 1 : 0;
            const float alpha = rls::cg_alpha(active, rz, static_cast<float>(acc[0]));
            // x += alpha p, r -= alpha q, and r.r (Sr)
            acc[0] = acc[1] = acc[2] = 0.0;
            for (int i = tid; i < n; i += kThreads) {
                x[i] = x[i] + alpha * gin[i];
                const float rn = r[i] - alpha * q[i];
                r[i] = rn;
                acc[0] += static_cast<double>(rn * rn);
            }
            cluster_sum(acc, kCgVec);
            const float rz_new = static_cast<float>(acc[0]);
            const float beta_c = rls::cg_beta(rz, rz_new);
            // p = active ? r + beta_c p : p (every CTA agrees on active);
            // after the last step p is not read again
            if (active && j + 1 < a.cg_iterations) {
                for (int i = tid; i < n; i += kThreads) gin[i] = r[i] + beta_c * gin[i];
                sync_cluster(kCgVec);  // Bp
            }
            rz = rz_new;
        }

        // the projection, then z = FGP(x + u), then u; S0 = x for the next
        // iteration's Gram
        for (int i = tid; i < n; i += kThreads) {
            float xv = x[i];
            if (a.positive) {
                xv = fmaxf(xv, 0.f);
                x[i] = xv;
            }
            xg[i] = xv + u[i];
        }
        if (fgp) {
            rls::band_fold_fgp<kT2Xg, kIn, kT1Rv, false>(
                bd, sweep, xg, bd.plane(kT3Rh), bd.plane(kPv), ph, lam_z, a.t2tab,
                a.tv_iterations, false, sync_cluster, kZu, kFgp);
        } else {
            __syncthreads();
        }
        sweep([&](int i, int lr, int col) {
            const float xgv = xg[i];
            const float zv = fgp ? xgv - bd.grad_t(kPv, ph, i, lr, col) : xgv;
            const float xv = x[i];
            z[i] = zv;
            u[i] = (u[i] + xv) - zv;
            gin[i] = xv;
        });
    }
    if (rank == 0 && tid == 0) a.counts[b] = live;
    // Be: no CTA leaves while another may still read its shared memory
    sync_cluster(kZu);
    prof.finish();
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

// The resident route's shared memory per CTA for bands of `rows` rows of
// width W (the planner's check), and how many clusters of `clusters` CTAs
// the current device can hold at once (cudaOccupancyMaxActiveClusters):
// out[0], out[1].
int admm_tv_cluster_occupancy(int clusters, int rows, int W, long long* out) {
    if (clusters < 1 || clusters > kMaxCluster || rows < 1 || W < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = cluster_smem_bytes(rows, W);
    out[0] = static_cast<long long>(smem);
    out[1] = 0;
    if (smem > 0x7fffffff) return 0;
    out[1] = rls::max_active_clusters(admm_tv_cluster_kernel, clusters, kThreads,
                                      static_cast<int>(smem));
    return 0;
}

// The resident route: as admm_tv_fused_launch, with scratch 5 planes of
// (B, H, W) (z, u, r, q, ph), prof null or kPhases int64 that receive CTA
// 0's clocks per phase, and the plan: `clusters` CTAs per problem, bands of
// `rows` rows, `smem` bytes of shared memory per CTA. Returns
// cudaErrorInvalidValue for a plan that does not cover H or whose smem
// differs from cluster_smem_bytes, else the launch's error.
int admm_tv_cluster_launch(const void* x0hat, const void* scal, const void* t2tab,
                           const void* taps, int kh, int kw, void* out, void* scratch,
                           void* counts, void* prof, int B, int H, int W, int iterations,
                           int cg_iterations, int tv_iterations, float tol_inner, int positive,
                           int clusters, int rows, int smem, void* stream) {
    const bool covers = B > 0 && W > 0 && rows > 0 && clusters >= 1 &&
                        clusters <= kMaxCluster &&
                        static_cast<long long>(clusters - 1) * rows < H &&
                        static_cast<long long>(clusters) * rows >= H &&
                        static_cast<long long>(B) * clusters < (1LL << 31) &&
                        static_cast<long long>(rows) * W < (1LL << 31) && kh <= kMaxTaps &&
                        kw <= kMaxTaps;
    if (!covers || static_cast<size_t>(smem) != cluster_smem_bytes(rows, W))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t e = rls::cluster_config(admm_tv_cluster_kernel, B, clusters, kThreads, smem,
                                        static_cast<cudaStream_t>(stream), &attr, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    const ClusterArgs args{static_cast<const float*>(x0hat), static_cast<const float*>(scal),
                           static_cast<const float*>(t2tab), static_cast<const float*>(taps),
                           static_cast<float*>(out), static_cast<float*>(scratch),
                           static_cast<int*>(counts), static_cast<long long*>(prof),
                           kh, kw, B, H, W, iterations, cg_iterations, tv_iterations, positive,
                           tol_inner, clusters, rows};
    e = cudaLaunchKernelEx(&cfg, admm_tv_cluster_kernel, args);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
