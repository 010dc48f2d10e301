// Batched 2-D anisotropic TV prox by FGP (fast gradient projection on the
// TV dual), on one of three routes that the host planner
// (kernels/tv_fgp.py plan_tv_fgp) picks by shape:
//
// * resident: each problem runs on a thread-block cluster of c <= 16 CTAs
//   of 1024 threads, CTA q owning the image rows [q R, (q + 1) R) (the
//   last band may be shorter), with the planes read at another band's
//   rows or at a neighbour's column in shared memory (the band design of
//   the fused PGM-TV and ADMM-TV kernels: rls::Band, cluster_common.cuh,
//   and its plane size, tv_band.cuh);
// * windows: where no cluster holds a problem's bands (1024^2), the same
//   cluster kernel on windows of rows: each (problem, window) on its own
//   cluster, the window taken for the image (its edges read zero and mask
//   its last row, as the image's do). A window of `interior` rows is
//   widened by a halo of `halo` rows on each side (shifted inside the
//   image at its top and bottom, so that every window has the same rows)
//   and only its interior rows are written. A window edge inside the
//   image is wrong from the first dual iteration on (its last row's mask,
//   then the missing row above), and each dual iteration carries that one
//   row further in (xtmp reads rv one row up, q reads xtmp one row down;
//   the output reads p one row up): after N dual iterations the rows
//   within N of such an edge differ, so a halo of N rows makes every
//   interior row the same operations in the same order as the whole
//   image's, bit for bit (tests/test_torch_tv_fgp_windows.py, and one
//   row less differs). Each window has its own global scratch, so that
//   two clusters never write the same rows of pv and ph;
// * global: one CTA per problem with the image, xtmp and the four dual
//   planes in global scratch (the first design), for rows wider than
//   ~19,300 pixels (no band of one row fits), or than ~9,600 at 10 dual
//   iterations (16 CTAs hold fewer than 2 halo + 1 rows).
//
// Replaces the TPU kernel rls_tpu/kernels/tv_pallas.py:_kernel (launched by
// prox_tv2d_fgp_pallas, :69, pallas_call :54), which runs the fori FGP of
// rls_tpu/kernels/_fgp_common.py:939-964 with the image and four dual
// planes resident in VMEM. Both routes compute the same function in f32,
// with the same operations in the same order:
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
// What bounds it on an H100. Per pixel and dual iteration the FGP does 23
// f32 operations, so its bound is the card's f32 rate (0.015 ms at 64 x
// 256^2 with 10 dual iterations); what holds it above that is where the
// planes live and the chain of dependent sweeps. On the global route a
// 256^2 plane (256 KiB) exceeds a block's shared memory, each dual
// iteration is two block-wide sweeps with about 13 plane reads and writes
// per pixel in global memory, the live set of 64 problems exceeds the 50
// MB L2, and only B of the 132 SMs hold a CTA. The resident route spreads
// each problem over a cluster of neighbouring SMs that read each other's
// shared memory (DSMEM), so that no plane leaves the chip:
//   S0 xtmp   (read one row down and one column right: grad_v, grad_h)
//   S1 rv     (read one row up: grad_t), and in the last dual iteration p
//             itself in place of the momentum, which nothing reads again,
//             so that the output reads pv one row up from shared memory
//   S2 rh     (read one column left: grad_t)
// and the planes read at their own pixel only, x, pv and ph, in shared
// memory too (S3 pv, S4 ph, S5 the band of x) where the six planes fit a
// CTA, else x from the input and pv, ph in two planes of global scratch,
// read and written at their own pixel (coalesced): about 1.5 times the time
// of a pixel with all six planes on chip. 64 x 256^2: 8 bands of 32 rows,
// six planes, 197,360 B per CTA, 15 clusters at once (5 waves); 16 x 256^2:
// 6 bands of 43 rows, three planes, 132,936 B, 17 at once (one wave);
// 16 x 512^2: 16 bands of 32 rows, three planes, 197,360 B, 7 at once.
//
// The resident route's schedule, with its cluster barriers
// (barrier.cluster; __syncthreads() where c = 1; each also a CTA barrier):
//   B0   after the set-up: S1, S2, pv, ph zero (and S5 = x) in every CTA
//        of the cluster, every CTA running before any DSMEM read
//   per dual iteration:
//        the xtmp sweep: S0 = x - lam gt(S1, S2) (reads S1 one row up)
//   Bx   xtmp whole
//        the q sweep: q from S0 (one row down, one column right), S1 and
//        S2 at the own pixel; S1 = r (or p in the last iteration), S2 = r,
//        pv = ph = q at the own pixel
//   Bq   r whole
//   the output: out = x - lam gt(S1, ph) (reads S1 one row up)
//   Be   no CTA leaves while a peer may still read its shared memory
// What orders each read of another CTA's shared memory (RAW), and each
// rewrite of a plane that a peer may still read (WAR):
//   S1   written at the set-up (read by peers in the first xtmp sweep or
//        the output: B0, RAW) and in each q sweep (read by peers in the
//        next xtmp sweep or the output: Bq, RAW); a q sweep rewrites it
//        after the peers' reads in the xtmp sweep before it: Bx (WAR); the
//        CTA's exit follows the peers' reads in the output: Be (WAR)
//   S0   written in each xtmp sweep, read by peers in the q sweep after Bx
//        (RAW); rewritten in the next xtmp sweep after the peers' reads:
//        Bq (WAR)
//   S2, S3-S5, the global planes: own rows only; each cluster barrier is
//        also a CTA barrier
// With no dual iteration the output follows B0 and reads the zeros of S1
// and ph. The windowed route runs this schedule on each window's cluster;
// clusters share nothing (each window's scratch is its own).
// tests/test_torch_tv_fgp_plan.py runs this schedule band by band on the
// physical planes, on the image and on windows, and fails where any of
// these barriers is dropped.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "fgp_common.cuh"
#include "tv_band.cuh"

namespace cg = cooperative_groups;

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


// ---- the resident route: one problem per cluster, planes in shared memory

using rls::kHalo;
constexpr int kMaxCluster = 16;
// the shared-memory planes: S0-S2 always, S3-S5 where kOwnShared
enum { kXtmp, kRv, kRh, kPv, kPh, kX };
constexpr int kSharedPlanes = 3;
constexpr int kAllPlanes = 6;

// Shared memory of a CTA of the resident route, in this order; the Python
// planner (kernels/tv_fgp.py cluster_smem_bytes) counts the same: three
// planes of the band, or six where x, pv and ph live in shared memory too,
// and the DSMEM row table (rows + 2 kHalo pointers).
__host__ __device__ inline size_t cluster_smem_bytes(int rows, int W, bool own_shared) {
    return sizeof(float) * (own_shared ? kAllPlanes : kSharedPlanes) *
               rls::band_plane_floats(rows, W) +
           sizeof(const float*) * (rows + 2 * kHalo);
}

struct ClusterArgs {
    const float* x;    // (B, H, W)
    const float* lam;  // (B,)
    float* out;        // (B, H, W)
    float* scratch;    // 2 planes of (B windows, window_rows, W), pv and ph, where not kOwnShared
    int B, H, W, iterations;
    int clusters, rows;  // c CTAs per window, R rows per band
    // a problem's windows: `windows` of `interior` rows each (the last may
    // be shorter), each computed on window_rows = min(H, interior + 2 halo)
    // rows; 1, H, 0, H on the resident route (the window is the image)
    int windows, interior, halo, window_rows;
};

using Band = rls::Band<false>;  // nvcc may contract, as on the global route
using Sweep = rls::Sweep<kThreads>;

template <bool kOwnShared>
__global__ void __launch_bounds__(kThreads, 1) tv_fgp_cluster_kernel(const ClusterArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    // H: the rows the bands cover, the image's or a window's
    const int H = a.window_rows, W = a.W, R = a.rows, nc = a.clusters;
    const size_t pf = rls::band_plane_floats(R, W);
    float* s = reinterpret_cast<float*>(smem);
    const float** rowp =
        reinterpret_cast<const float**>(s + (kOwnShared ? kAllPlanes : kSharedPlanes) * pf);

    cg::cluster_group cl = cg::this_cluster();
    const int rank = static_cast<int>(cl.block_rank());
    const int cluster = blockIdx.x / nc;  // (problem, window)
    const int b = cluster / a.windows;
    const int top = (cluster - b * a.windows) * a.interior;  // first interior row
    const int lo = min(max(top - a.halo, 0), a.H - H);       // the window's first row
    const int r0 = rank * R;
    const Band bd{s, rowp, pf, r0, min(R, H - r0), H, W};
    const int n = bd.rows * W;  // this CTA's pixels, local index i
    const Sweep sweep(n, W);
    auto sync_cluster = [&]() {
        if (nc > 1)
            cl.sync();
        else
            __syncthreads();
    };
    rls::fill_row_table(rowp, s, r0, R, H, W, cl);

    // the band's pixels are contiguous in (B, H, W), and in the window's own
    // scratch, (B windows, window rows, W)
    const size_t off = (static_cast<size_t>(b) * a.H + lo + r0) * W;
    float* ob = a.out + off;
    float* xtmp = bd.plane(kXtmp);
    float* rv = bd.plane(kRv);
    float* rh = bd.plane(kRh);
    const float* xb;
    float* pv;
    float* ph;
    if constexpr (kOwnShared) {
        float* xs = bd.plane(kX);
        pv = bd.plane(kPv);
        ph = bd.plane(kPh);
        sweep([&](int i, int, int) { xs[i] = a.x[off + i]; });
        xb = xs;
    } else {
        xb = a.x + off;
        pv = a.scratch + (static_cast<size_t>(cluster) * H + r0) * W;
        ph = pv + static_cast<size_t>(a.B) * a.windows * H * W;
    }

    const float lam_b = a.lam[b];
    const float lam_safe = lam_b > 0.f ? lam_b : 1.f;
    const float inv8 = __fdiv_rn(1.f, __fmul_rn(8.f, lam_safe));
    sweep([&](int i, int, int) {
        pv[i] = 0.f;
        ph[i] = 0.f;
        rv[i] = 0.f;
        rh[i] = 0.f;
    });
    sync_cluster();  // B0

    float t = 1.f;
    for (int it = 0; it < a.iterations; ++it) {
        sweep([&](int i, int lr, int c) {
            xtmp[i] = xb[i] - lam_b * bd.grad_t(kRv, rh, i, lr, c);
        });
        sync_cluster();  // Bx

        const float t_new = __fdiv_rn(
            __fadd_rn(1.f, __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(__fmul_rn(4.f, t), t)))),
            2.f);
        const float t2 = __fdiv_rn(__fsub_rn(t, 1.f), t_new);
        const float c1 = __fadd_rn(1.f, t2);
        // in the last iteration S1 takes p, which the output reads one row up
        const bool last = it + 1 == a.iterations;
        sweep([&](int i, int lr, int c) {
            const float qv = r0 + lr < H - 1
                ? rls::clip(rv[i] + (bd.below(kXtmp, i, lr, c) - xtmp[i]) * inv8, -1.f, 1.f)
                : 0.f;
            const float qh = c < W - 1
                ? rls::clip(rh[i] + (xtmp[i + 1] - xtmp[i]) * inv8, -1.f, 1.f)
                : 0.f;
            rv[i] = last ? qv : c1 * qv - t2 * pv[i];
            rh[i] = c1 * qh - t2 * ph[i];
            pv[i] = qv;
            ph[i] = qh;
        });
        sync_cluster();  // Bq
        t = t_new;
    }

    // the output: the window's interior rows [top, top + interior), local
    const int out_lo = top - lo - r0, out_hi = min(a.H, top + a.interior) - lo - r0;
    sweep([&](int i, int lr, int c) {
        if (lr >= out_lo && lr < out_hi) ob[i] = xb[i] - lam_b * bd.grad_t(kRv, ph, i, lr, c);
    });
    sync_cluster();  // Be
}

template <bool kOwnShared>
cudaError_t launch_cluster(const ClusterArgs& args, int smem, cudaStream_t stream) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t e = rls::cluster_config(tv_fgp_cluster_kernel<kOwnShared>,
                                        args.B * args.windows, args.clusters, kThreads, smem,
                                        stream, &attr, &cfg);
    if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, tv_fgp_cluster_kernel<kOwnShared>, args);
    return e;
}

// A launch of the cluster kernel on windows of `interior` rows with `halo`
// rows each side (interior = H, halo = 0: the resident route). Returns
// cudaErrorInvalidValue for a plan whose bands do not cover a window, whose
// halo is short of the dual iterations (where the window is not the
// image), or whose smem differs from cluster_smem_bytes, else the launch's
// error.
int launch_windows(const void* x, const void* lam, void* out, void* scratch, int B, int H,
                   int W, int iterations, int clusters, int rows, int own_shared, int smem,
                   int interior, int halo, void* stream) {
    if (B < 1 || H < 1 || W < 1 || interior < 1 || halo < 0 || iterations < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long windows = (static_cast<long long>(H) + interior - 1) / interior;
    const long long Hw = std::min<long long>(H, interior + 2LL * halo);
    const bool covers = rows > 0 && clusters >= 1 && clusters <= kMaxCluster &&
                        static_cast<long long>(clusters - 1) * rows < Hw &&
                        static_cast<long long>(clusters) * rows >= Hw &&
                        (Hw == H || halo >= iterations) &&
                        B * windows * clusters < (1LL << 31) &&
                        static_cast<long long>(rows) * W < (1LL << 31) &&
                        (own_shared || scratch != nullptr);
    if (!covers || static_cast<size_t>(smem) != cluster_smem_bytes(rows, W, own_shared != 0))
        return static_cast<int>(cudaErrorInvalidValue);
    const ClusterArgs args{static_cast<const float*>(x), static_cast<const float*>(lam),
                           static_cast<float*>(out), static_cast<float*>(scratch),
                           B, H, W, iterations, clusters, rows,
                           static_cast<int>(windows), interior, halo, static_cast<int>(Hw)};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t e = own_shared ? launch_cluster<true>(args, smem, st)
                                     : launch_cluster<false>(args, smem, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
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

// The resident route's shared memory per CTA for bands of `rows` rows of
// width W, with x, pv and ph in shared memory where `own_shared` (the
// planner's check), and how many clusters of `clusters` CTAs the current
// device can hold at once (cudaOccupancyMaxActiveClusters): out[0], out[1].
int tv_fgp_cluster_occupancy(int clusters, int rows, int W, int own_shared, long long* out) {
    if (clusters < 1 || clusters > kMaxCluster || rows < 1 || W < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = cluster_smem_bytes(rows, W, own_shared != 0);
    out[0] = static_cast<long long>(smem);
    out[1] = 0;
    if (smem > 0x7fffffff) return 0;
    out[1] = own_shared ? rls::max_active_clusters(tv_fgp_cluster_kernel<true>, clusters,
                                                   kThreads, static_cast<int>(smem))
                        : rls::max_active_clusters(tv_fgp_cluster_kernel<false>, clusters,
                                                   kThreads, static_cast<int>(smem));
    return 0;
}

// The resident route: as tv_fgp_launch, with the plan: `clusters` CTAs per
// problem, bands of `rows` rows, x, pv and ph in shared memory where
// `own_shared` (scratch unused), else scratch 2 planes of (B, H, W) for pv
// and ph; `smem` bytes of shared memory per CTA. Returns
// cudaErrorInvalidValue for a plan that does not cover H or whose smem
// differs from cluster_smem_bytes, else the launch's error.
int tv_fgp_cluster_launch(const void* x, const void* lam, void* out, void* scratch, int B,
                          int H, int W, int iterations, int clusters, int rows,
                          int own_shared, int smem, void* stream) {
    return launch_windows(x, lam, out, scratch, B, H, W, iterations, clusters, rows, own_shared,
                          smem, H, 0, stream);
}

// The windowed route: as tv_fgp_cluster_launch on each window of a problem,
// ceil(H / interior) windows of min(H, interior + 2 halo) rows (halo >= the
// dual iterations where a window is not the image), `clusters` CTAs and
// bands of `rows` rows each; scratch 2 planes of (B windows, window rows, W)
// where not `own_shared`. Returns cudaErrorInvalidValue for a plan that
// does not cover a window, whose halo is short or whose smem differs from
// cluster_smem_bytes, else the launch's error.
int tv_fgp_windows_launch(const void* x, const void* lam, void* out, void* scratch, int B,
                          int H, int W, int iterations, int clusters, int rows,
                          int own_shared, int smem, int interior, int halo, void* stream) {
    return launch_windows(x, lam, out, scratch, B, H, W, iterations, clusters, rows, own_shared,
                          smem, interior, halo, stream);
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
