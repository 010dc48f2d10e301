// The resident route of the ADMM-TV kernels: the whole batched solve in one
// launch, each problem on a thread-block cluster of c <= 16 CTAs of 1024
// threads, CTA q owning the image rows [q R, (q + 1) R) (the last band may
// be shorter), with the planes that another band reads in shared memory for
// the whole solve. One body, templated on its placement: all five planes of
// a band in shared memory (kOwnShared, row 4: admm_tv_fused.cu, planned by
// kernels/admm_tv_fused.py plan_admm_tv), or the three that another band
// reads, with the planes read in the CTA's own rows in global memory (row
// 5's cluster route: admm_tv_tiled.cu, planned by kernels/admm_tv_tiled.py
// plan_admm_tv_tiled; 512^2 on c = 16). Both placements compute the same
// operations in the same order, so they give the same bits.
//
// Per outer iteration (rls_tpu/kernels/admm_tv_fused.py:_kernel, :44-153)
//   beta = x0hat + rho (z - u)
//   x    = masked CG on (A^H A + rho I) x = beta, cg_iterations steps from
//          the previous x; a step is live while ||r|| > tol_inner ||beta||
//   x    = max(x, 0)                      (with the Positive projection)
//   z    = FGP-TV(x + u, lambda / 2 rho)  (x + u where rho = 0)
//   u    = u + x - z
// on the exact stencil Gram. The FGP is the fold form (rls::fold_fgp, here
// tv_band.cuh band_fold_fgp), valid because lambda / (2 rho) is the same at
// every outer iteration. The CG's three sums are taken in double in a fixed
// order: each thread's pixels, the CTA's threads (rls::block_sum3), then
// the ranks 0 .. c-1 through distributed shared memory (the two-slot
// rls::cluster_sum3), rounded once to f32; every thread of a cluster
// evaluates the same `active` and takes the same branch. The kernel counts
// each problem's live CG steps.
//
// Planes by how they are read: at another band's rows the Gram's input gin
// (x at the CG start, then the CG direction p; its column pass), t1 (the
// column adjoint), xg (the first dual sweep, one row down), rv (one row up),
// y (one row down) and the dual p that the z-update reads one row up; in
// the CTA's own rows at a neighbouring column t2 and t3 (the row passes),
// rh and ph (one column left); at their own pixel pv, xg after the first
// dual sweep, x0hat, x, z, u, r and q, the last six in global memory
// (coalesced) but for q with three planes. The slots of the two placements
// (a slot is reused as its plane dies):
//   five planes (kOwnShared: row 4)   three planes (row 5)
//   S0 gin, then y                    S0 t2, then q (the CG's own-pixel
//                                        product), then rh
//   S1 t1, then rv                    S1 t1, then rv, and p in the last dual
//                                        iteration in place of the momentum
//   S2 t2, then xg                    S2 gin, then xg (also copied to global
//                                        memory for its own-pixel reads),
//                                        then y
//   S3 t3, then rh                    t3 in global memory
//   S4 pv (p for the z-update)        pv in global memory
//   q, ph in global memory            ph in global memory
// At 256^2 x 16 five planes hold a 43-row band (c = 6, 222,424 B a CTA,
// one wave of 16 clusters); at 512^2 a band of 32 rows (c = 16) holds three
// planes of 64 KiB (198,784 B a CTA), and five would need 320 KiB. The
// three-plane placement adds, per pixel and dual iteration, pv and ph read
// and written and xg read in global memory (from L2; rh stays on chip), and
// per Gram t3 written and read. At 16 x 512^2 the seven resident problems'
// global planes (1 MiB each) overflow the 50 MB L2, and the CG's vector
// sweeps and the dual sweeps move ~3 TB/s: the three-plane placement keeps
// q in S0 (t2 is dead after the row pass), and the vector and dual sweeps
// issue a pixel's global reads one pixel ahead (rls::Sweep::ahead, which
// row 3's three-plane FGP needed to hide its round trips:
// pgm_tv_cluster.cuh).
//
// The outer iteration, with its cluster barriers (barrier.cluster;
// __syncthreads() where c = 1; each also a CTA barrier), the same for both
// placements:
//   Bx   gin = x whole (the set-up's zeros, or the last z-update's copy)
//   Bt   the Gram: the column pass gin -> t1 (reads gin at other bands'
//        rows), Bt, its adjoint t1 -> t2 (reads t1 at other bands' rows),
//        the row pass t2 -> t3 (own rows; tv_band.cuh band_gram_passes)
//   Ss   the CG start: one sweep forms beta, r = beta - (A^H A x + rho x)
//        (the last pass reads t3 in its own rows), p = r into gin,
//        ||beta||^2 and r.r; their cluster sum
//   each CG step: the Gram of gin (p) with its Bt; q and p.q, cluster sum
//   Sq   alpha; x += alpha p, r -= alpha q and r.r, cluster sum
//   Sr   where `active` and another step follows, p = r + beta_c p into gin,
//   Bp   then a cluster barrier
//   the z-update: x = max(x, 0) (Positive), xg = x + u (plane xg, and its
//        global copy with three planes); where rho != 0 and tv_iterations >
//        0 the fold FGP (tv_band.cuh band_fold_fgp):
//   Bf0  xg whole; the first dual sweep (reads xg one row down) writes pv,
//        ph, rv, rh
//   per later dual iteration:
//   Bf1  rv whole; y = (xg - grad_t(rv, rh)) / 8 (reads rv one row up)
//   Bf2  y whole; the duals (read y one row down) write rv, rh, pv, ph
//   Bf3  p whole; z = xg - grad_t(p, ph) (reads p one row up: pv in S4, or
//        rv in S1), u = u + x - z, and gin = x for the next Bx
//   Be   at the exit: no CTA leaves while a peer still reads its shared
//        memory (p in the last z-update, or a sum slot)
// What orders each read of another CTA's shared memory (RAW), and each
// rewrite of a plane that a peer may still read (WAR), five | three planes:
//   S0 | S2  gin as x: written by the set-up or the z-update, read by peers
//        in the column pass after Bx (RAW); as p: written at the CG start
//        (read in the next column pass after Ss, RAW) and by the p update
//        (read after Bp, RAW), each write after the peers' last column-pass
//        reads by Bt (WAR). Where gin held p, its peers read it last in the
//        last CG step's column pass: Bt (and Sq, Sr; with no CG step the CG
//        start's Bt and Ss) orders the writes after it (WAR): y (five
//        planes, after Bf1) or xg (three planes, in the z-update). y: read
//        one row down after Bf2 (RAW); rewritten per dual iteration after
//        Bf1 (WAR: the last duals' reads, and with three planes the first
//        dual sweep's reads of xg); the z-update's copy of x follows the
//        peers' last reads of y by Bf3 (WAR)
//   S1 | S1  t1: written by the column pass after Bx (WAR: the peers' reads
//        of rv, or of p in the last z-update, three planes), read after Bt
//        (RAW); rewritten by the next column pass after Sq, Ss or Bf0 (WAR:
//        the adjoint's reads); rv: written by the first dual sweep after
//        Bf0 (WAR: the adjoint's reads of t1), read one row up after Bf1
//        (RAW), rewritten after Bf2 (WAR); p (three planes): read one row up
//        after Bf3 (RAW), rewritten by the next column pass after Bx (WAR)
//   S2 | S2  xg (five planes): written in the z-update, after Bx and Bt
//        (WAR: the peers' reads of the last xg were followed by Bf1), read
//        one row down after Bf0 (RAW); with three planes see gin above:
//        read one row down after Bf0 (RAW)
//   S4       pv (five planes): read one row up by the z-update after Bf3
//        (RAW); rewritten in the next first dual sweep, after Bx, Bt, Ss and
//        Bf0 (WAR)
//   S3 | S0  and the global planes: own rows (or own pixel) only; CTA
//        barriers (with three planes q is written in S0 by the q sweep
//        after the row pass's last read of t2, read at its own pixel by the
//        same thread, and overwritten by the next adjoint after Sr)
//   the CG sums: the two-slot rls::cluster_sum3 (Sq and Sr follow each
//        other with no other cluster barrier between them)
// Edge schedules: with 0 CG steps the CG start's p is never read and the
//   z-update follows Ss (its write of xg into S2, three planes, follows the
//   CG start's column pass by Bt); with no dual iteration or rho = 0 the
//   FGP and its barriers Bf0-Bf3 are skipped (z = xg at the own pixel,
//   after a CTA barrier), and the next Bx orders the peers' column-pass
//   reads after every write of gin; the first outer iteration's Bx follows
//   the set-up (every CTA of the cluster running, its gin zero, before any
//   DSMEM read). tests/test_torch_admm_plan.py and
//   tests/test_torch_admm_tiled_plan.py run this schedule band by band on
//   both placements' planes and fail where any of these barriers is
//   dropped.
//
// A phase timer (prof): CTA 0's thread 0 adds the SM clocks between its
// phase marks (set-up, Gram, CG vector sweeps, cluster sums, FGP sweeps,
// cluster barriers, the z-update); off where prof is null.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "admm_tv_common.cuh"
#include "cluster_common.cuh"
#include "tv_band.cuh"

namespace rls {
namespace admm_cluster {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kMaxTaps = 63;  // per axis; the wrapper checks it
using rls::kHalo;             // the farthest row a stencil tap reads
constexpr int kMaxCluster = 16;
// the planes of a band in shared memory: all five (kOwnShared), or the
// three that another band reads
constexpr int kAllPlanes = 5;
constexpr int kSharedPlanes = 3;
enum { kIn, kT1Rv, kT2Xg, kT3Rh, kPv };  // five planes: S0-S4
enum { kT2Rh, kT1RvP, kInXgY };          // three planes: S0-S2
// the phases of the timer
enum { kSetup, kGram, kCgVec, kSums, kFgp, kBarrier, kZu, kPhases };

// The shared-memory plane of each role in the two placements (the slot
// table of the header); a role with no plane lives in global memory.
template <bool kOwnShared>
struct Slots;
template <>
struct Slots<true> {
    static constexpr int kPlanes = kAllPlanes;
    static constexpr int kGin = kIn, kT1 = kT1Rv, kT2 = kT2Xg, kXg = kT2Xg, kRv = kT1Rv,
                         kY = kIn;
    static constexpr int kPOut = kPv;  // the plane of p that the z-update reads
};
template <>
struct Slots<false> {
    static constexpr int kPlanes = kSharedPlanes;
    static constexpr int kGin = kInXgY, kT1 = kT1RvP, kT2 = kT2Rh, kXg = kInXgY, kRv = kT1RvP,
                         kY = kInXgY;
    static constexpr int kPOut = kT1RvP;
};

// Shared memory of a CTA of the resident route, in this order; the Python
// planners (kernels/admm_tv_fused.py cluster_smem_bytes) count the same:
// five planes of the band (three where not own_shared), the block sums
// (3 x 32 doubles), this CTA's two slots of sums for the cluster and the
// cluster's (4 doubles each), the phase timer (kPhases int64), the DSMEM row
// table (rows + 2 kHalo pointers) and the taps (2 kMaxTaps floats).
__host__ __device__ inline size_t cluster_smem_bytes(int rows, int W, bool own_shared) {
    return sizeof(float) * (own_shared ? kAllPlanes : kSharedPlanes) *
               rls::band_plane_floats(rows, W) +
           sizeof(double) * (3 * (kThreads / 32) + 12) + sizeof(long long) * kPhases +
           sizeof(const float*) * (rows + 2 * kHalo) + sizeof(float) * 2 * kMaxTaps;
}

struct ClusterArgs {
    const float* x0hat;  // (B, H, W)
    const float* scal;   // (B, 2) [rho, lam_eff]
    const float* t2tab;  // (tv_iterations, 2)
    const float* taps;   // kh + kw
    float* out;          // (B, H, W): x
    float* scratch;      // planes of (B, H, W): z, u, r, ph, then q where
                         // kOwnShared, else t3, xg, pv
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

template <bool kOwnShared>
__global__ void __launch_bounds__(kThreads, 1) admm_tv_cluster_kernel(const ClusterArgs a) {
    using S = Slots<kOwnShared>;
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = a.H, W = a.W, R = a.rows, nc = a.clusters;
    const size_t pf = rls::band_plane_floats(R, W);
    float* s = reinterpret_cast<float*>(smem);
    double* red = reinterpret_cast<double*>(s + S::kPlanes * pf);
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
    float* gin = bd.plane(S::kGin);  // x, then p
    float* xg = bd.plane(S::kXg);    // the prox input, read one row down
    const float* taps_w = taps + a.kh;

    // the band's pixels are contiguous in (B, H, W)
    const size_t plane = static_cast<size_t>(a.B) * H * W;
    const size_t off = static_cast<size_t>(b) * H * W + static_cast<size_t>(r0) * W;
    const float* x0 = a.x0hat + off;
    float* x = a.out + off;
    float* z = a.scratch + off;
    float* u = z + plane;
    float* r = u + plane;
    float* ph = r + plane;
    // q (read at its own pixel) and the planes read in their own rows only:
    // with five planes q in global memory and t3 | rh, pv in shared memory;
    // with three q | rh in S0, and t3, xg's own-pixel copy and pv in global
    // memory beside ph
    float* q;
    float* t3;
    float* rh;
    float* pv;
    float* g_xg = nullptr;  // three planes: xg at its own pixel
    if constexpr (kOwnShared) {
        q = ph + plane;
        t3 = bd.plane(kT3Rh);
        rh = t3;
        pv = bd.plane(kPv);
    } else {
        q = bd.plane(kT2Rh);
        t3 = ph + plane;
        g_xg = t3 + plane;
        pv = g_xg + plane;
        rh = q;
    }
    const float* xg_own = kOwnShared ? xg : g_xg;

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
        // Bx: x whole in gin. The CG's start: beta, r = beta - (A^H A +
        // rho I) x, p = r, with ||beta||^2 and r.r (Ss)
        sync_cluster(kZu);
        rls::band_gram_passes<S::kGin, S::kT1, S::kT2>(bd, sweep, t3, taps, a.kh, a.kw,
                                                       sync_cluster, kGram);
        acc[0] = acc[1] = acc[2] = 0.0;
        sweep([&](int i, int lr, int col) {
            const float beta = x0[i] + rho * (z[i] - u[i]);
            const float res = beta - (bd.stencil_h(t3, i, lr, col, taps_w, a.kw, true) + rho * x[i]);
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
            rls::band_gram_passes<S::kGin, S::kT1, S::kT2>(bd, sweep, t3, taps, a.kh, a.kw,
                                                           sync_cluster, kGram);
            acc[0] = acc[1] = acc[2] = 0.0;
            sweep([&](int i, int lr, int col) {
                const float pval = gin[i];
                const float qval = bd.stencil_h(t3, i, lr, col, taps_w, a.kw, true) + rho * pval;
                q[i] = qval;
                acc[0] += static_cast<double>(pval * qval);
            });
            cluster_sum(acc, kGram);
            const bool active = rls::cg_active(rz, target);
            live += active ? 1 : 0;
            const float alpha = rls::cg_alpha(active, rz, static_cast<float>(acc[0]));
            // x += alpha p, r -= alpha q, and r.r (Sr)
            acc[0] = acc[1] = acc[2] = 0.0;
            sweep.ahead([&](int i) { return make_float3(x[i], r[i], q[i]); },
                        [&](int i, int, int, float3 v) {
                            x[i] = v.x + alpha * gin[i];
                            const float rn = v.y - alpha * v.z;
                            r[i] = rn;
                            acc[0] += static_cast<double>(rn * rn);
                        });
            cluster_sum(acc, kCgVec);
            const float rz_new = static_cast<float>(acc[0]);
            const float beta_c = rls::cg_beta(rz, rz_new);
            // p = active ? r + beta_c p : p (every CTA agrees on active);
            // after the last step p is not read again
            if (active && j + 1 < a.cg_iterations) {
                sweep.ahead([&](int i) { return r[i]; },
                            [&](int i, int, int, float rv) { gin[i] = rv + beta_c * gin[i]; });
                sync_cluster(kCgVec);  // Bp
            }
            rz = rz_new;
        }

        // the projection, then z = FGP(x + u), then u; gin = x for the next
        // iteration's Gram
        for (int i = tid; i < n; i += kThreads) {
            float xv = x[i];
            if (a.positive) {
                xv = fmaxf(xv, 0.f);
                x[i] = xv;
            }
            const float g = xv + u[i];
            xg[i] = g;
            if constexpr (!kOwnShared) g_xg[i] = g;
        }
        // the fold FGP on xg, Bf0-Bf3; with three planes the last dual
        // iteration leaves p in rv's plane
        if (fgp) {
            rls::band_fold_fgp<S::kXg, S::kY, S::kRv, !kOwnShared>(
                bd, sweep, xg_own, rh, pv, ph, lam_z, a.t2tab, a.tv_iterations, false,
                sync_cluster, kZu, kFgp);
        } else {
            __syncthreads();
        }
        sweep([&](int i, int lr, int col) {
            const float xgv = xg_own[i];
            const float zv = fgp ? xgv - bd.grad_t(S::kPOut, ph, i, lr, col) : xgv;
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

inline bool valid_cluster_size(int c) { return c >= 1 && c <= kMaxCluster; }

// The shared memory per CTA of the placement's kernel for bands of `rows`
// rows of width W, and how many clusters of `clusters` CTAs of it the
// current device holds at once (cudaOccupancyMaxActiveClusters): out[0],
// out[1].
template <bool kOwnShared>
int occupancy(int clusters, int rows, int W, long long* out) {
    if (!valid_cluster_size(clusters) || rows < 1 || W < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = cluster_smem_bytes(rows, W, kOwnShared);
    out[0] = static_cast<long long>(smem);
    out[1] = 0;
    if (smem > 0x7fffffff) return 0;
    out[1] = rls::max_active_clusters(admm_tv_cluster_kernel<kOwnShared>, clusters, kThreads,
                                      static_cast<int>(smem));
    return 0;
}

// One launch of the placement's kernel; the arguments as the C entry points
// (admm_tv_cluster_launch, admm_tv_tiled_cluster_launch) take them. Returns
// cudaErrorInvalidValue for a plan that does not cover H or whose smem
// differs from cluster_smem_bytes, else the launch's error.
template <bool kOwnShared>
int launch(const void* x0hat, const void* scal, const void* t2tab, const void* taps, int kh,
           int kw, void* out, void* scratch, void* counts, void* prof, int B, int H, int W,
           int iterations, int cg_iterations, int tv_iterations, float tol_inner, int positive,
           int clusters, int rows, int smem, void* stream) {
    const bool covers = B > 0 && W > 0 && rows > 0 && valid_cluster_size(clusters) &&
                        static_cast<long long>(clusters - 1) * rows < H &&
                        static_cast<long long>(clusters) * rows >= H &&
                        static_cast<long long>(B) * clusters < (1LL << 31) &&
                        static_cast<long long>(rows) * W < (1LL << 31) && kh <= kMaxTaps &&
                        kw <= kMaxTaps;
    if (!covers || static_cast<size_t>(smem) != cluster_smem_bytes(rows, W, kOwnShared))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t e = rls::cluster_config(admm_tv_cluster_kernel<kOwnShared>, B, clusters,
                                        kThreads, smem, static_cast<cudaStream_t>(stream), &attr,
                                        &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    const ClusterArgs args{static_cast<const float*>(x0hat), static_cast<const float*>(scal),
                           static_cast<const float*>(t2tab), static_cast<const float*>(taps),
                           static_cast<float*>(out), static_cast<float*>(scratch),
                           static_cast<int*>(counts), static_cast<long long*>(prof),
                           kh, kw, B, H, W, iterations, cg_iterations, tv_iterations, positive,
                           tol_inner, clusters, rows};
    e = cudaLaunchKernelEx(&cfg, admm_tv_cluster_kernel<kOwnShared>, args);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace admm_cluster
}  // namespace rls
