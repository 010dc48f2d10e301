// The whole batched PGM-TV solve in one launch, on one of two routes that
// the host planner (kernels/fista_tv_fused.py plan_pgm_tv) picks by shape:
//
// * resident: each problem runs on a thread-block cluster of c CTAs (c in
//   {1, 2, 4, 8, 16}), CTA q owning the image rows [q R, (q + 1) R) (the
//   last band may be shorter), with every plane that is read at
//   neighbouring pixels held in shared memory for the whole solve;
// * global: one CTA per problem with every plane in global scratch, for
//   images whose single row is too wide for a band (about W > 9,600).
//
// Replaces the TPU kernel rls_tpu/kernels/fista_tv_fused.py:_kernel (and
// _kernel_grouped / _kernel_interleaved, which compute the same function;
// launched by fista_tv_fused, :676) in all its schedules: FISTA, OptISTA
// and POGM on the f64 momentum table (_pgm_loop), FISTA and POGM with
// gradient restart and the early-exit freeze (_fista_loop_dynamic,
// _pogm_loop_dynamic), and FISTA with warm TV duals (_fista_loop_warm).
// One iteration is, per pixel, the op order of rls::pgm_iteration and
// rls::fold_fgp (pgm_tv_common.cuh):
//   FISTA:   x_mom = x + a (x - x_prev); x_new = FGP(x_mom - rho res, rho lam)
//   OptISTA: y_new = FGP(y - rho g res, rho g lam); z, x from the table
//   POGM:    y_new = x - rho res; x_mid = ...; x_new = FGP(x_mid, gamma lam)
// with res = A^H A (x_mom | x) - x0hat as four zero-padded stencil passes
// (make_sepconv_stencil_ops, the TPU kernel's exact-f32 route) and FGP the
// fold form of _fgp_unrolled_fold (rls_tpu/kernels/_fgp_common.py:733-773),
// its momentum constants [1 + t2, t2] passed in, rounded to f32 as the
// TPU kernel bakes them. The JAX dynamic and warm loops default to the
// fori FGP; the fold form is the same f32 math up to <= 1 ulp. The
// dynamic schedules' theta, sigma and gamma are per-problem scalars that
// every thread of the cluster computes alike (rls::coeffs, rls::epilogue)
// from sums taken in double in a fixed order: each thread's pixels, the
// CTA's threads (rls::block_sum3), then ranks 0 .. c-1 read through
// distributed shared memory, rounded once to f32; every CTA of the
// cluster then takes the same branch.
//
// What bounds it on an H100. A 256^2 f32 plane is 256 KiB, more than the
// 227 KB of shared memory a block may use, and an iteration is ~25 sweeps
// over the planes with a barrier after each. With the planes in global
// memory (the global route) that is ~560 bytes of L2 / HBM traffic per
// pixel and iteration at 10 dual iterations, and the kernel is bound by
// it. The resident route keeps it on chip: a cluster's CTAs sit on
// neighbouring SMs and read each other's shared memory (DSMEM), so a
// problem's planes fit in c bands of R rows (256^2 at c = 8: 32-row
// bands, 32 KiB per plane). Planes by how they are read:
//   shared memory, six planes (reused as they die):
//     A pv | B ph (the duals; with warm_tv they stay across iterations)
//     C t2, then xg         D t1, then rv         E t3, then rh
//     F the stencil input (x_mom | x), then the FGP's y
//   global memory, read and written at their own pixel once per
//   iteration (coalesced): x0hat, the carries x, x_prev | y, z, w, and
//   the own-pixel temporaries res, y_new and x_mom (the dynamic
//   schedules' sums, POGM's y_new, the gradient-mapping restart).
// Global traffic falls to ~20-40 bytes per pixel and iteration, and the
// sweeps are then bound by issuing their shared-memory loads and index
// arithmetic: on an H100 80GB HBM3 at 700 W, one flagship iteration of
// CTA 0 (8 bands of 32 rows) took ~45k SM clocks in the Gram, ~74k in the
// FGP sweeps and ~28k in cluster barriers. So every sweep advances its
// (row, column) without a division, and a stencil tap whose rows or
// columns all lie in the band is read with no edge test. A row
// outside the CTA's band is read through one map, row -> (rank = row / R,
// local row = row - rank R), kept as a table of DSMEM row pointers for the
// rows within kHalo = 31 of the band, so a stencil of up to 63 taps may
// reach past the adjacent band. The image edges read zero as stencil_v,
// grad_t and the FGP mask do (fgp_common.cuh).
//
// Barriers: a sweep that reads another band's rows follows a cluster
// barrier (barrier.cluster arrive / wait, cluster.sync(); __syncthreads()
// when c = 1), which also orders every earlier read of the plane it
// overwrites; the horizontal stencil passes read only their own rows and
// follow __syncthreads(). Per iteration: the stencil input, t1, xg (with
// a prox), two per dual iteration, the duals before the prox output, and
// one for a dynamic schedule's sums: 22 at 10 dual iterations, ~1,100 per
// flagship solve. The kernel ends with a cluster barrier, so that no CTA
// exits while another still reads its shared memory.
//
// A phase timer (prof): CTA 0's thread 0 adds the SM clocks between its
// phase marks (set-up, momentum, Gram, FGP sweeps, cluster barriers, prox
// and carries, sums); off where prof is null.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_common.cuh"
#include "pgm_tv_common.cuh"
#include "tv_band.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTaps = 63;  // per axis; the wrapper checks it

template <int kMethod, bool kDynamic>
__global__ void __launch_bounds__(kThreads)
fista_tv_fused_kernel(const float* __restrict__ x0hat,
                      const float* __restrict__ scal,
                      const float* __restrict__ tab,
                      const float* __restrict__ t2tab,
                      const float* __restrict__ taps, int kh, int kw,
                      float* __restrict__ out, float* __restrict__ scratch,
                      int* __restrict__ counts, int B, int H, int W,
                      rls::Schedule sc) {
    __shared__ float s_taps[2 * kMaxTaps];
    __shared__ double s_red[3 * (kThreads / 32)];
    for (int k = threadIdx.x; k < kh + kw; k += blockDim.x) s_taps[k] = taps[k];

    const int b = blockIdx.x;
    const int n = H * W;
    const size_t plane = static_cast<size_t>(B) * n;
    const size_t off = static_cast<size_t>(b) * n;
    auto sp = [&](int k) { return scratch + k * plane + off; };

    // the whole image is the window; the carries are updated in place
    // (the last sweep reads and writes each carry at its own pixel only)
    rls::Window w;
    w.rows = H;
    w.W = W;
    w.i0 = 0;
    w.i1 = H;
    w.x0 = x0hat + off;
    float* carry[4] = {out + off, sp(0), sp(1), sp(2)};
    for (int k = 0; k < 4; ++k) {
        w.in[k] = carry[k];
        w.out[k] = carry[k];
    }
    w.xm = sp(3);
    w.t1 = sp(4);
    w.t2 = sp(5);
    w.xg = sp(6);
    w.yn = sp(7);
    w.pv = sp(8);
    w.ph = sp(9);
    w.rv = sp(10);
    w.rh = sp(11);

    const float rho = scal[2 * b];
    const float lam = scal[2 * b + 1];
    double acc[3] = {0.0, 0.0, 0.0};
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float x0 = w.x0[i];
        const float z = x0 * 0.f;
        for (int k = 0; k < 4; ++k) carry[k][i] = z;
        if (sc.warm) {
            w.pv[i] = z;
            w.ph[i] = z;
        }
        acc[2] += static_cast<double>(x0 * x0);
    }
    __syncthreads();
    float norm_x0 = 0.f;
    if (sc.early) {
        rls::block_sum3(acc, s_red);
        norm_x0 = __fsqrt_rn(static_cast<float>(acc[2]));
    }

    rls::State s = rls::initial_state();
    for (int it = 0; it < sc.iterations; ++it) {
        const rls::Coeffs c = rls::coeffs(sc, s, tab, it, rho, lam);
        acc[0] = acc[1] = acc[2] = 0.0;
        rls::pgm_iteration<kMethod, kDynamic>(w, sc, c, s_taps, kh, kw, t2tab, acc);
        if (kDynamic) {
            rls::block_sum3(acc, s_red);
            const float sums[3] = {static_cast<float>(acc[0]), static_cast<float>(acc[1]),
                                   static_cast<float>(acc[2])};
            s = rls::epilogue(sc, s, c, sums, norm_x0);
        }
    }
    if (threadIdx.x == 0) {
        counts[2 * b] = static_cast<int>(s.fires);
        counts[2 * b + 1] = kDynamic ? static_cast<int>(s.live_iters) : sc.iterations;
    }
}

template <int kMethod, bool kDynamic>
struct Launcher {
    static void run(dim3 grid, cudaStream_t stream, const float* x0hat, const float* scal,
                    const float* tab, const float* t2tab, const float* taps, int kh,
                    int kw, float* out, float* scratch, int* counts, int B, int H, int W,
                    rls::Schedule sc) {
        fista_tv_fused_kernel<kMethod, kDynamic><<<grid, kThreads, 0, stream>>>(
            x0hat, scal, tab, t2tab, taps, kh, kw, out, scratch, counts, B, H, W, sc);
    }
};


// ---- the resident route: one problem per cluster, planes in shared memory

using rls::kHalo;  // the farthest row a stencil tap reads
constexpr int kPlanes = 6;
enum { kPv, kPh, kT2Xg, kT1Rv, kT3Rh, kInY };  // the shared-memory planes A-F
// the phases of the timer
enum { kSetup, kMomentum, kGram, kFgp, kBarrier, kProx, kSums, kPhases };

using rls::band_plane_floats;

// Shared memory of a CTA of the resident route, in this order; the Python
// planner (kernels/fista_tv_fused.py cluster_smem_bytes) counts the same:
// six planes of the band, the block sums (3 x 32 doubles), this CTA's
// sums for the cluster and the cluster's (4 doubles each), the phase
// timer (kPhases int64), the DSMEM row table (rows + 2 kHalo pointers)
// and the taps (2 kMaxTaps floats).
__host__ __device__ inline size_t cluster_smem_bytes(int rows, int W) {
    return sizeof(float) * kPlanes * band_plane_floats(rows, W) +
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
    float* scratch;      // 6 planes of (B, H, W): x_prev | y, z, w, res, y_new, x_mom
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

template <int kMethod, bool kDynamic>
__global__ void __launch_bounds__(kThreads, 1) fista_tv_cluster_kernel(const ClusterArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const rls::Schedule& sc = a.sc;
    const int H = a.H, W = a.W, R = a.rows, nc = a.clusters;
    const size_t pf = band_plane_floats(R, W);
    float* s = reinterpret_cast<float*>(smem);
    double* red = reinterpret_cast<double*>(s + kPlanes * pf);
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
    float* pv = bd.plane(kPv);
    float* ph = bd.plane(kPh);
    float* xg = bd.plane(kT2Xg);
    float* y = bd.plane(kInY);
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

        // the Gram's input in F: FISTA's momentum point, else x. FISTA's
        // x_prev carry takes x here (masked by `live` under early exit)
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
        sync_cluster(kMomentum);

        // res = A^H A gin - x0hat: column pass (F -> D), its adjoint
        // (D -> C), row pass (C -> E) (tv_band.cuh), its adjoint; the last
        // forms the prox input xg in C (and POGM's y_new), keeping res for
        // the sums
        rls::band_gram_passes<kInY, kT1Rv, kT2Xg, kT3Rh>(bd, sweep, taps, a.kh, a.kw,
                                                         sync_cluster, kGram);
        sweep([&](int i, int lr, int col) {
            const float res = bd.stencil_h(kT3Rh, i, lr, col, taps_w, a.kw, true) - x0[i];
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
            if constexpr (kDynamic) g_res[i] = res;
        });

        // the fold FGP on xg (rls::fold_fgp, tv_band.cuh): duals in A, B,
        // their momentum in D, E, y in F; its first barrier makes xg
        // visible to the neighbours (and ends their reads of D)
        if (tv > 0) {
            rls::band_fold_fgp<kT2Xg, kInY, kT1Rv, kT3Rh, kPv>(
                bd, sweep, bd.plane(kPh), c.lam_tv, a.t2tab, tv, sc.warm != 0, sync_cluster,
                kGram, kFgp);
        } else {
            __syncthreads();
        }

        // x_new = prox(xg) = xg - grad_t(pv, ph), then the carries
        acc[0] = acc[1] = acc[2] = 0.0;
        sweep([&](int i, int lr, int col) {
            const float xgv = xg[i];
            const float xn = tv > 0 ? xgv - bd.grad_t(kPv, kPh, i, lr, col) : xgv;
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
            rls::cluster_sum3(acc, red, mine, all, cl, nc);
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
    sync_cluster(kProx);
    prof.finish();
}

using ClusterKernel = void (*)(ClusterArgs);

// the five instantiations (OptISTA has no dynamic schedule)
ClusterKernel cluster_kernel(int method, bool dynamic) {
    if (method == rls::kFista)
        return dynamic ? &fista_tv_cluster_kernel<rls::kFista, true>
                       : &fista_tv_cluster_kernel<rls::kFista, false>;
    if (method == rls::kOptista) return &fista_tv_cluster_kernel<rls::kOptista, false>;
    return dynamic ? &fista_tv_cluster_kernel<rls::kPogm, true>
                   : &fista_tv_cluster_kernel<rls::kPogm, false>;
}

bool valid_cluster_size(int c) { return c == 1 || c == 2 || c == 4 || c == 8 || c == 16; }

}  // namespace

extern "C" {

// x0hat, out: (B, H, W) f32; scal: (B, 2) [rho, lam_eff]; tab:
// (iterations, 4) momentum table; t2tab: (tv_iterations, 2) [1 + t2, t2];
// taps: kh + kw floats; scratch: 12 planes of (B, H, W); counts: (B, 2)
// int32 [restarts fired, live iterations]; method 0 FISTA, 1 OptISTA,
// 2 POGM; restart 0 none, 1 gradient, 2 gradient_mapping; early: freeze a
// problem once ||res|| / ||x0hat|| < rel_tol; warm: carry the TV duals.
int fista_tv_fused_launch(const void* x0hat, const void* scal, const void* tab,
                          const void* t2tab, const void* taps, int kh, int kw,
                          void* out, void* scratch, void* counts, int B, int H,
                          int W, int iterations, int tv_iterations, int method,
                          int restart, int early, int warm, float rel_tol,
                          float sigma_fac, void* stream) {
    if (kh > kMaxTaps || kw > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
    const rls::Schedule sc = {method, restart, early, warm,
                              rel_tol, sigma_fac, iterations, tv_iterations};
    rls::pick_launcher<Launcher>(method, sc.dynamic())(
        dim3(B), static_cast<cudaStream_t>(stream), static_cast<const float*>(x0hat),
        static_cast<const float*>(scal), static_cast<const float*>(tab),
        static_cast<const float*>(t2tab), static_cast<const float*>(taps), kh, kw,
        static_cast<float*>(out), static_cast<float*>(scratch), static_cast<int*>(counts),
        B, H, W, sc);
    return static_cast<int>(cudaGetLastError());
}

// The resident route's shared memory per CTA for bands of `rows` rows of
// width W (the planner's check), and how many clusters of `clusters` CTAs
// of the kernel for (method, dynamic) can be resident at once on the
// current device (cudaOccupancyMaxActiveClusters): out[0], out[1].
int fista_tv_cluster_occupancy(int clusters, int rows, int W, int method, int dynamic,
                               long long* out) {
    if (!valid_cluster_size(clusters) || rows < 1 || W < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = cluster_smem_bytes(rows, W);
    out[0] = static_cast<long long>(smem);
    out[1] = 0;
    if (smem > 0x7fffffff) return 0;
    out[1] = rls::max_active_clusters(cluster_kernel(method, dynamic != 0), clusters, kThreads,
                                      static_cast<int>(smem));
    return 0;
}

// The resident route: as fista_tv_fused_launch, with scratch 6 planes of
// (B, H, W) (x_prev | y, z, w, res, y_new, x_mom), prof null or kPhases
// int64 that receive CTA 0's clocks per phase, and the plan: `clusters`
// CTAs per problem, bands of `rows` rows, `smem` bytes of shared memory
// per CTA. Returns cudaErrorInvalidValue for a plan that does not cover H
// or whose smem differs from cluster_smem_bytes, else the launch's error.
int fista_tv_cluster_launch(const void* x0hat, const void* scal, const void* tab,
                            const void* t2tab, const void* taps, int kh, int kw, void* out,
                            void* scratch, void* counts, void* prof, int B, int H, int W,
                            int iterations, int tv_iterations, int method, int restart,
                            int early, int warm, float rel_tol, float sigma_fac, int clusters,
                            int rows, int smem, void* stream) {
    const bool covers = B > 0 && W > 0 && rows > 0 && valid_cluster_size(clusters) &&
                        static_cast<long long>(clusters - 1) * rows < H &&
                        static_cast<long long>(clusters) * rows >= H &&
                        static_cast<long long>(B) * clusters < (1LL << 31) &&
                        static_cast<long long>(rows) * W < (1LL << 31) && kh <= kMaxTaps &&
                        kw <= kMaxTaps;
    if (!covers || static_cast<size_t>(smem) != cluster_smem_bytes(rows, W))
        return static_cast<int>(cudaErrorInvalidValue);
    const rls::Schedule sc = {method, restart, early, warm,
                              rel_tol, sigma_fac, iterations, tv_iterations};
    const ClusterKernel k = cluster_kernel(method, sc.dynamic());
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

}  // extern "C"
