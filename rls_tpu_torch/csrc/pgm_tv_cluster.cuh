// The resident route of the PGM-TV kernels: the whole batched solve in one
// launch, each problem on a thread-block cluster of c <= 16 CTAs of 1024
// threads, CTA q owning the image rows [q R, (q + 1) R) (the last band may
// be shorter), with the planes that another band or a neighbouring pixel
// reads in shared memory for the whole solve. One body, templated on its
// placement: all six planes of a band in shared memory (kOwnShared, row 2:
// fista_tv_fused.cu, planned by kernels/fista_tv_fused.py plan_pgm_tv), or
// the three that another band reads, with the planes read in the CTA's own
// rows in global memory (row 3's cluster route: fista_tv_tiled.cu, planned
// by kernels/fista_tv_tiled.py plan_fista_tv_tiled; 512^2 on c = 16). The
// computation and its op order are the global route's (fista_tv_fused.cu,
// rls::pgm_iteration): both placements give the same bits.
//
// A cluster's CTAs sit on neighbouring SMs and read each other's shared
// memory (DSMEM), so a problem's planes fit in c bands of R rows (256^2 at
// c = 8: 32-row bands, 32 KiB per plane). Planes by how they are read:
//   at another band's rows: the Gram's input gin (its column pass), t1
//     (the column adjoint), xg (the first dual sweep, one row down), rv
//     (one row up), y (one row down) and the dual p that the prox output
//     reads one row up;
//   in the CTA's own rows at a neighbouring column: t2 and t3 (the row
//     passes), rh and ph (one column left);
//   at their own pixel: pv, xg after the first dual sweep, x0hat, the
//     carries x, x_prev | y, z, w and the own-pixel temporaries res, y_new
//     and x_mom (the dynamic schedules' sums, POGM's y_new, the
//     gradient-mapping restart), the last in global memory (coalesced).
// The slots of the two placements (a slot is reused as its plane dies):
//   six planes (kOwnShared: row 2) three planes (row 3)
//   A pv                           pv in global memory
//   B ph                           ph in global memory
//   C t2, then xg                  S0 t2, then rh
//   D t1, then rv                  S1 t1, then rv, and p in the last dual
//                                     iteration in place of the momentum
//   E t3, then rh                  t3 in global memory
//   F gin, then y                  S2 gin, then xg (also copied to global
//                                     memory for its own-pixel reads), then y
// Six planes hold a 32-row band of 256 (198,752 B a CTA); at 512^2 a band
// of 32 rows (c = 16) holds three planes of 64 KiB (198,752 B), and six
// would need 384 KiB. The three-plane placement adds, per pixel and dual
// iteration, pv and ph read and written and xg read in global memory (20
// bytes, from L2; rh stays on chip, the plane of the three most read),
// and t3 written and read once per iteration. Each such read is an L2
// round trip that a dual sweep's short work per pixel cannot hide, so the
// three-plane FGP issues a pixel's global reads one pixel ahead
// (rls::Sweep::ahead): at 16 x 512^2 on an H100 80GB HBM3 at 700 W, CTA 0
// spent 14.4M SM clocks in the FGP sweeps without it and 9.6M with it,
// and the solve took 25.9 ms of device time instead of 32.3.
// Global traffic falls to ~20-40 bytes per pixel and iteration (six
// planes), and the sweeps are then bound by issuing their shared-memory
// loads and index arithmetic: on an H100 80GB HBM3 at 700 W, one flagship
// iteration of CTA 0 (8 bands of 32 rows) took ~45k SM clocks in the
// Gram, ~74k in the FGP sweeps and ~28k in cluster barriers. So every
// sweep advances its (row, column) without a division, and a stencil tap
// whose rows or columns all lie in the band is read with no edge test. A
// row outside the CTA's band is read through one map, row -> (rank = row /
// R, local row = row - rank R), kept as a table of DSMEM row pointers for
// the rows within kHalo = 31 of the band, so a stencil of up to 63 taps
// may reach past the adjacent band. The image edges read zero as
// stencil_v, grad_t and the FGP mask do (fgp_common.cuh).
//
// The resident route's iteration, with its cluster barriers
// (barrier.cluster arrive / wait, cluster.sync(); __syncthreads() when
// c = 1; each also a CTA barrier), the same for both placements:
//   the momentum sweep writes gin (FISTA's momentum point, else x)
//   Bm   gin whole; the column pass gin -> t1 (reads gin at other bands'
//        rows)
//   Bt   t1 whole (tv_band.cuh band_gram_passes); its adjoint t1 -> t2
//        (reads t1 at other bands' rows), the row pass t2 -> t3 and its
//        adjoint t3 -> xg (own rows, __syncthreads() after each); the
//        last also forms res and POGM's y_new in global memory
//   the fold FGP (tv_band.cuh band_fold_fgp), where tv_iterations > 0:
//   Bf0  xg whole; the first dual sweep (reads xg one row down) writes
//        pv, ph, rv, rh (a warm start copies rv, rh from pv, ph)
//   per later dual iteration:
//   Bf1  rv whole; y = (xg - grad_t(rv, rh)) / 8 (reads rv one row up)
//   Bf2  y whole; the duals (read y one row down) write rv, rh, pv, ph
//   Bf3  p whole; the prox output x_new = xg - grad_t(p, ph) (reads p one
//        row up: pv in A, or rv in S1) and the carries
//   Bs   a dynamic schedule's sums (rls::cluster_sum3, a cluster barrier)
//   Be   at the exit: no CTA leaves while a peer still reads its shared
//        memory (p in the last prox output, or a sum slot)
// What orders each read of another CTA's shared memory (RAW), and each
// rewrite of a plane that a peer may still read (WAR), six | three planes:
//   F | S2  gin read by peers after Bm (RAW); rewritten as xg (three) in
//        the Gram's last pass, or as y (six) in the first y sweep, after
//        Bt (WAR: the column pass's reads); xg read one row down after Bf0
//        (RAW); y written after Bf1 (WAR: the first dual sweep's or the
//        last duals' reads), read one row down after Bf2 (RAW); the next
//        momentum sweep writes gin after Bf3 (WAR), or after Bt where
//        tv_iterations = 0
//   D | S1  t1 written by the column pass after Bm (WAR: the peers' last
//        reads of rv, and of p in the prox output, three planes), read
//        after Bt (RAW); rv written in the first dual sweep after Bf0
//        (WAR: the column adjoint's reads of t1), read one row up after
//        Bf1 (RAW), rewritten after Bf2 (WAR); p read one row up after Bf3
//        (RAW, three planes)
//   C       xg written in the Gram's last pass (the peers' reads of the
//        last xg were followed by Bf1 ... Bt: WAR), read one row down
//        after Bf0 (RAW)
//   A       pv read one row up by the prox output after Bf3 (RAW);
//        rewritten in the next first dual sweep after Bm, Bt, Bf0 (WAR)
//   B, E | S0 and the global planes: own rows (or own pixel) only; CTA
//        barriers
// With no dual iteration the FGP and Bf0-Bf3 are skipped (x_new = xg at
// its own pixel, after a CTA barrier). tests/test_torch_tiled_plan.py runs
// this schedule band by band on both placements' planes and fails where
// any of these barriers is dropped.
//
// A phase timer (prof): CTA 0's thread 0 adds the SM clocks between its
// phase marks (set-up, momentum, Gram, FGP sweeps, cluster barriers, prox
// and carries, sums); off where prof is null.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_common.cuh"
#include "pgm_tv_common.cuh"
#include "tv_band.cuh"

namespace rls {
namespace pgm_cluster {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kMaxTaps = 63;  // per axis; the wrapper checks it
using rls::kHalo;  // the farthest row a stencil tap reads
constexpr int kMaxCluster = 16;
// the planes of a band in shared memory: all six (kOwnShared), or the
// three that another band reads
constexpr int kAllPlanes = 6;
constexpr int kSharedPlanes = 3;
enum { kPv, kPh, kT2Xg, kT1Rv, kT3Rh, kInY };  // six planes: A-F
enum { kT2Rh, kT1RvP, kInXgY };                // three planes: S0-S2
// the phases of the timer
enum { kSetup, kMomentum, kGram, kFgp, kBarrier, kProx, kSums, kPhases };

// The shared-memory plane of each role in the two placements (the slot
// table of the header); a role with no plane lives in global memory.
template <bool kOwnShared>
struct Slots;
template <>
struct Slots<true> {
    static constexpr int kPlanes = kAllPlanes;
    static constexpr int kIn = kInY, kT1 = kT1Rv, kT2 = kT2Xg, kXg = kT2Xg, kRv = kT1Rv,
                         kY = kInY;
    static constexpr int kPOut = kPv;  // the plane of p that the prox output reads
};
template <>
struct Slots<false> {
    static constexpr int kPlanes = kSharedPlanes;
    static constexpr int kIn = kInXgY, kT1 = kT1RvP, kT2 = kT2Rh, kXg = kInXgY, kRv = kT1RvP,
                         kY = kInXgY;
    static constexpr int kPOut = kT1RvP;
};

using rls::band_plane_floats;

// Shared memory of a CTA of the resident route, in this order; the Python
// planners (kernels/fista_tv_fused.py cluster_smem_bytes) count the same:
// six planes of the band (three where not own_shared), the block sums
// (3 x 32 doubles), this CTA's sums for the cluster and the cluster's (4
// doubles each), the phase timer (kPhases int64), the DSMEM row table
// (rows + 2 kHalo pointers) and the taps (2 kMaxTaps floats).
__host__ __device__ inline size_t cluster_smem_bytes(int rows, int W, bool own_shared) {
    return sizeof(float) * (own_shared ? kAllPlanes : kSharedPlanes) *
               band_plane_floats(rows, W) +
           sizeof(double) * (3 * (kThreads / 32) + 8) + sizeof(long long) * kPhases +
           sizeof(const float*) * (rows + 2 * kHalo) + sizeof(float) * 2 * kMaxTaps;
}

struct ClusterArgs {
    const float* x0hat;  // (B, H, W)
    const float* scal;   // (B, 2) [rho, lam]
    const float* tab;    // (iterations, 4)
    const float* t2tab;  // (tv_iterations, 2)
    const float* taps;   // kh + kw
    float* out;          // (B, H, W): x, a carry
    float* scratch;      // planes of (B, H, W): x_prev | y, z, w, res, y_new, x_mom,
                         // and where not kOwnShared t3, xg, pv, ph
    int* counts;         // (B, 2)
    long long* prof;     // (kPhases,) or null
    int kh, kw, B, H, W;
    int clusters, rows;  // c CTAs per problem, R rows per band
    rls::Schedule sc;
};

// SM clocks of CTA 0's thread 0 per phase (cluster_common.cuh)
using Prof = rls::Prof<kPhases>;

using Band = rls::Band<false>;  // row 2 lets nvcc contract its taps
using Sweep = rls::Sweep<kThreads>;

template <int kMethod, bool kDynamic, bool kOwnShared>
__global__ void __launch_bounds__(kThreads, 1) fista_tv_cluster_kernel(const ClusterArgs a) {
    using S = Slots<kOwnShared>;
    extern __shared__ __align__(16) unsigned char smem[];
    const rls::Schedule& sc = a.sc;
    const int H = a.H, W = a.W, R = a.rows, nc = a.clusters;
    const size_t pf = band_plane_floats(R, W);
    float* s = reinterpret_cast<float*>(smem);
    double* red = reinterpret_cast<double*>(s + S::kPlanes * pf);
    double* mine = red + 3 * (kThreads / 32);
    double* all = mine + 4;
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

    for (int k = tid; k < a.kh + a.kw; k += kThreads) taps[k] = a.taps[k];
    rls::fill_row_table(rowp, s, r0, R, H, W, cl);
    float* y = bd.plane(S::kIn);   // the Gram's input, then (six) the FGP's y
    float* xg = bd.plane(S::kXg);  // the prox input, read one row down
    const float* taps_w = taps + a.kh;

    // the band's pixels are contiguous in (B, H, W)
    const size_t plane = static_cast<size_t>(a.B) * H * W;
    const size_t off = static_cast<size_t>(b) * H * W + static_cast<size_t>(r0) * W;
    const float* x0 = a.x0hat + off;
    float* x = a.out + off;
    float* m1 = a.scratch + off;  // x_prev | y
    float* m2 = m1 + plane;       // z
    float* wc = m2 + plane;       // POGM's w
    float* g_res = wc + plane;
    float* g_yn = g_res + plane;
    float* g_xm = g_yn + plane;
    // the planes read in their own rows only: in shared memory with six
    // planes, else in global memory (rh in S0 either way, t3 and xg's
    // own-pixel copy beside it)
    float* t3;
    float* rh;
    float* pv;
    float* ph;
    float* g_xg = nullptr;  // three planes: xg at its own pixel
    if constexpr (kOwnShared) {
        t3 = bd.plane(kT3Rh);
        rh = t3;
        pv = bd.plane(kPv);
        ph = bd.plane(kPh);
    } else {
        t3 = g_xm + plane;
        rh = bd.plane(kT2Rh);
        g_xg = t3 + plane;
        pv = g_xg + plane;
        ph = pv + plane;
    }
    const float* xg_own = kOwnShared ? xg : g_xg;

    const float rho = a.scal[2 * b];
    const float lam = a.scal[2 * b + 1];
    double acc[3] = {0.0, 0.0, 0.0};
    for (int i = tid; i < n; i += kThreads) {
        const float x0v = x0[i];
        const float z = x0v * 0.f;
        x[i] = z;
        m1[i] = z;
        m2[i] = z;
        wc[i] = z;
        if (sc.warm) {
            pv[i] = z;
            ph[i] = z;
        }
        acc[2] += static_cast<double>(x0v * x0v);
    }
    __syncthreads();
    float norm_x0 = 0.f;
    if (kDynamic && sc.early) {
        rls::cluster_sum3(acc, red, mine, all, cl, nc);
        norm_x0 = __fsqrt_rn(static_cast<float>(acc[2]));
    }
    prof.mark(kSetup);

    const int tv = sc.tv_iterations;
    const bool early = kDynamic && sc.early;
    rls::State st = rls::initial_state();
    for (int it = 0; it < sc.iterations; ++it) {
        const rls::Coeffs c = rls::coeffs(sc, st, a.tab, it, rho, lam);
        const float live = c.live;

        // the Gram's input: FISTA's momentum point, else x. FISTA's x_prev
        // carry takes x here (masked by `live` under early exit)
        for (int i = tid; i < n; i += kThreads) {
            if constexpr (kMethod == rls::kFista) {
                const float xv = x[i];
                const float xp = m1[i];
                const float xm = xv + c.a * (xv - xp);
                y[i] = xm;
                m1[i] = early ? xp + live * (xv - xp) : xv;
                if (kDynamic && sc.restart == rls::kRestartGradientMapping) g_xm[i] = xm;
            } else {
                y[i] = x[i];
            }
        }
        sync_cluster(kMomentum);  // Bm

        // res = A^H A gin - x0hat: column pass (gin -> t1), Bt, its adjoint
        // (t1 -> t2), row pass (t2 -> t3) (tv_band.cuh), its adjoint; the
        // last forms the prox input xg (and POGM's y_new), keeping res for
        // the sums
        rls::band_gram_passes<S::kIn, S::kT1, S::kT2>(bd, sweep, t3, taps, a.kh, a.kw,
                                                      sync_cluster, kGram);
        sweep([&](int i, int lr, int col) {
            const float res = bd.stencil_h(t3, i, lr, col, taps_w, a.kw, true) - x0[i];
            float g;
            if constexpr (kMethod == rls::kFista) {
                g = y[i] - c.step * res;
            } else if constexpr (kMethod == rls::kOptista) {
                g = m1[i] - c.step * res;
            } else {
                const float xv = x[i];
                const float yv = xv - c.step * res;
                g_yn[i] = yv;
                g = ((c.cy * yv - c.a * m1[i]) - c.cx * xv) + c.e * m2[i];  // x_mid
            }
            xg[i] = g;
            if constexpr (!kOwnShared) g_xg[i] = g;
            if constexpr (kDynamic) g_res[i] = res;
        });

        // the fold FGP on xg (rls::fold_fgp, tv_band.cuh), Bf0-Bf3: duals
        // pv, ph, their momentum rv, rh, y; its first barrier makes xg
        // visible to the neighbours (and ends their reads of t1). With
        // three planes the last dual iteration leaves p in rv's plane
        if (tv > 0) {
            rls::band_fold_fgp<S::kXg, S::kY, S::kRv, !kOwnShared>(
                bd, sweep, xg_own, rh, pv, ph, c.lam_tv, a.t2tab, tv, sc.warm != 0,
                sync_cluster, kGram, kFgp);
        } else {
            __syncthreads();
        }

        // x_new = prox(xg) = xg - grad_t(p, ph), then the carries
        acc[0] = acc[1] = acc[2] = 0.0;
        sweep([&](int i, int lr, int col) {
            const float xgv = xg_own[i];
            const float xn = tv > 0 ? xgv - bd.grad_t(S::kPOut, ph, i, lr, col) : xgv;
            if constexpr (kMethod == rls::kFista && !kDynamic) {
                x[i] = xn;
            } else if constexpr (kMethod == rls::kFista) {
                const float xv = x[i];
                const float res = g_res[i];
                if (sc.restart == rls::kRestartGradient)
                    acc[0] += static_cast<double>(res * (xn - xv));
                else if (sc.restart == rls::kRestartGradientMapping)
                    acc[0] += static_cast<double>((g_xm[i] - xn) * (xn - xv));
                acc[2] += static_cast<double>(res * res);
                x[i] = early ? xv + live * (xn - xv) : xn;
            } else if constexpr (kMethod == rls::kOptista) {  // xn is y_new
                const float xv = x[i];
                const float zn = xv + (xn - m1[i]) * c.e;
                x[i] = (c.cy * zn - c.a * m2[i]) - c.b * xv;
                m1[i] = xn;
                m2[i] = zn;
            } else if constexpr (!kDynamic) {  // POGM: z_new is x_mid = xg
                x[i] = xn;
                m1[i] = g_yn[i];
                m2[i] = xgv;
            } else {
                const float xv = x[i];
                const float yv = m1[i];
                const float zv = m2[i];
                const float ynv = g_yn[i];
                const float res = g_res[i];
                const float wv = wc[i];
                float wn = wv;
                if (sc.restart != rls::kRestartNone) {
                    const float d = xn - xgv;
                    const float wm = (wv + ynv) + c.r * d;
                    acc[0] += static_cast<double>(wm * d);
                    acc[1] += static_cast<double>(wm * res);
                    wn = c.r * (xgv - xn) - ynv;
                }
                acc[2] += static_cast<double>(res * res);
                x[i] = early ? xv + live * (xn - xv) : xn;
                m1[i] = early ? yv + live * (ynv - yv) : ynv;
                m2[i] = early ? zv + live * (xgv - zv) : xgv;
                wc[i] = early ? wv + live * (wn - wv) : wn;
            }
        });
        prof.mark(kProx);
        if constexpr (kDynamic) {
            rls::cluster_sum3(acc, red, mine, all, cl, nc);  // Bs
            const float sums[3] = {static_cast<float>(acc[0]), static_cast<float>(acc[1]),
                                   static_cast<float>(acc[2])};
            st = rls::epilogue(sc, st, c, sums, norm_x0);
            prof.mark(kSums);
        }
    }
    if (rank == 0 && tid == 0) {
        a.counts[2 * b] = static_cast<int>(st.fires);
        a.counts[2 * b + 1] = kDynamic ? static_cast<int>(st.live_iters) : sc.iterations;
    }
    // no CTA leaves while another may still read its shared memory
    sync_cluster(kProx);  // Be
    prof.finish();
}

using ClusterKernel = void (*)(ClusterArgs);

// the five instantiations of a placement: (method, schedule) as
// pick_launcher's (OptISTA has no dynamic schedule)
template <bool kOwnShared>
ClusterKernel cluster_kernel(int method, bool dynamic) {
    if (method == rls::kFista)
        return dynamic ? &fista_tv_cluster_kernel<rls::kFista, true, kOwnShared>
                       : &fista_tv_cluster_kernel<rls::kFista, false, kOwnShared>;
    if (method == rls::kOptista) return &fista_tv_cluster_kernel<rls::kOptista, false, kOwnShared>;
    return dynamic ? &fista_tv_cluster_kernel<rls::kPogm, true, kOwnShared>
                   : &fista_tv_cluster_kernel<rls::kPogm, false, kOwnShared>;
}

inline bool valid_cluster_size(int c) { return c >= 1 && c <= kMaxCluster; }

// The shared memory per CTA of the placement's kernel for (method,
// dynamic) for bands of `rows` rows of width W, and how many clusters of
// `clusters` CTAs of it the current device holds at once
// (cudaOccupancyMaxActiveClusters): out[0], out[1].
template <bool kOwnShared>
int occupancy(int clusters, int rows, int W, int method, int dynamic, long long* out) {
    if (!valid_cluster_size(clusters) || rows < 1 || W < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = cluster_smem_bytes(rows, W, kOwnShared);
    out[0] = static_cast<long long>(smem);
    out[1] = 0;
    if (smem > 0x7fffffff) return 0;
    out[1] = rls::max_active_clusters(cluster_kernel<kOwnShared>(method, dynamic != 0), clusters,
                                      kThreads, static_cast<int>(smem));
    return 0;
}

// One launch of the placement's kernel; the arguments as the C entry points
// (fista_tv_cluster_launch, fista_tv_tiled_cluster_launch) take them.
// Returns cudaErrorInvalidValue for a plan that does not cover H or whose
// smem differs from cluster_smem_bytes, else the launch's error.
template <bool kOwnShared>
int launch(const void* x0hat, const void* scal, const void* tab, const void* t2tab,
           const void* taps, int kh, int kw, void* out, void* scratch, void* counts, void* prof,
           int B, int H, int W, int iterations, int tv_iterations, int method, int restart,
           int early, int warm, float rel_tol, float sigma_fac, int clusters, int rows, int smem,
           void* stream) {
    const bool covers = B > 0 && W > 0 && rows > 0 && valid_cluster_size(clusters) &&
                        static_cast<long long>(clusters - 1) * rows < H &&
                        static_cast<long long>(clusters) * rows >= H &&
                        static_cast<long long>(B) * clusters < (1LL << 31) &&
                        static_cast<long long>(rows) * W < (1LL << 31) && kh <= kMaxTaps &&
                        kw <= kMaxTaps;
    if (!covers || static_cast<size_t>(smem) != cluster_smem_bytes(rows, W, kOwnShared))
        return static_cast<int>(cudaErrorInvalidValue);
    const rls::Schedule sc = {method, restart, early, warm,
                              rel_tol, sigma_fac, iterations, tv_iterations};
    const ClusterKernel k = cluster_kernel<kOwnShared>(method, sc.dynamic());
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t e = rls::cluster_config(k, B, clusters, kThreads, smem,
                                        static_cast<cudaStream_t>(stream), &attr, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    const ClusterArgs args{static_cast<const float*>(x0hat), static_cast<const float*>(scal),
                           static_cast<const float*>(tab), static_cast<const float*>(t2tab),
                           static_cast<const float*>(taps), static_cast<float*>(out),
                           static_cast<float*>(scratch), static_cast<int*>(counts),
                           static_cast<long long*>(prof), kh, kw, B, H, W, clusters, rows, sc};
    e = cudaLaunchKernelEx(&cfg, k, args);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace pgm_cluster
}  // namespace rls
