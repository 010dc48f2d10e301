// Row 3, the PGM-TV solve for images whose bands fit no cluster with six
// planes in shared memory, on one of two routes that the host planner
// (kernels/fista_tv_tiled.py plan_fista_tv_tiled) picks by shape:
//
// * cluster: the whole solve in one launch on the resident route of the
//   PGM-TV kernels (pgm_tv_cluster.cuh), each problem on a thread-block
//   cluster of c <= 16 CTAs with the three planes of its band that another
//   band reads in shared memory and the rest in global memory (512^2 x 16:
//   c = 16, 32-row bands, 198,752 B a CTA); its entry points are at the
//   end of this file (with all six planes on chip, where they fit, the
//   planner launches row 2's: fista_tv_fused.cu);
// * tiles: the row-tiled solve below, one launch per iteration, one CTA
//   per (row tile, problem), for images whose bands fit no cluster even
//   with three planes (1024^2), and for a caller's forced tile_rows.
//
// Replaces the TPU kernel rls_tpu/kernels/fista_tv_tiled.py:fista_tv_tiled
// (:704; pallas_call :870, the halo-streamed "hbm" variant, body _kernel
// :63): FISTA, OptISTA and POGM on the f64 momentum table, FISTA and POGM
// with gradient restart and the early-exit freeze. The JAX kernel tiles
// rows to get past the TPU's VMEM; on an H100 tiling spreads one problem
// over many CTAs: at 1024^2 x 8 and 64-row tiles, 128 CTAs. The cluster
// route replaces the JAX function's VMEM-carry variant (mode "vmem",
// pallas_call :832), which keeps a problem's carries on chip for the whole
// solve.
//
// CTA (t, b) computes one iteration (rls::pgm_iteration) on the window of
// image rows [t TR - halo, (t + 1) TR + halo), clamped to the image, with
// halo = (tv_iterations + 1) + 2 (kh / 2) + 1, and writes only its tile's
// rows. The carries (x, x_prev | y, z, w) are ping-pong pairs of full
// images: iteration `it` reads set it % 2 and writes set (it + 1) % 2, so
// no CTA reads a plane another CTA is writing in the same launch. The
// interior rows are exact (the halo covers the iteration's dependence
// cone), so the tiled solve is the monolithic function.
//
// The dynamic schedules need per-problem sums across tiles. Each CTA
// writes its tile's sums (double) to partial[it % 2][b][t]; at the start
// of the next launch every CTA of problem b adds the T partials in tile
// order and applies the end-of-iteration rule (rls::epilogue) to the state
// it reads from state[(it - 1) % 2][b]; tile 0 stores the new state in
// state[it % 2][b]. No float atomics: the result is the same run to run.
// A last launch (it == iterations) settles the last iteration's counts.
//
// What bounds it on an H100: every window plane lives in global scratch
// (a 104-row window of 512 f32 columns is 208 KiB), and an iteration is
// ~27 block-wide sweeps over ~9 window planes, so the kernel is bound by
// memory traffic, as the fused kernel is; the halo adds (TR + 2 halo) / TR
// of recompute (1.6x at TR = 64, tv_iterations = 10, 9 taps). Keeping the
// window in shared memory (TMA loads of the halo rows) is later work.
#include <cuda_runtime.h>

#include "pgm_tv_cluster.cuh"
#include "pgm_tv_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTaps = 63;  // per axis; the wrapper checks it
constexpr int kWindowPlanes = 9;

template <int kMethod, bool kDynamic>
__global__ void __launch_bounds__(kThreads)
fista_tv_tiled_kernel(const float* __restrict__ x0hat,
                      const float* __restrict__ scal,
                      const float* __restrict__ tab,
                      const float* __restrict__ t2tab,
                      const float* __restrict__ taps, int kh, int kw,
                      float* __restrict__ carries, float* __restrict__ window,
                      double* __restrict__ partial, double* __restrict__ norm_part,
                      float* __restrict__ state, int* __restrict__ counts, int B,
                      int H, int W, int TR, int halo, int T, int it,
                      rls::Schedule sc) {
    __shared__ float s_taps[2 * kMaxTaps];
    __shared__ double s_red[3 * (kThreads / 32)];
    for (int k = threadIdx.x; k < kh + kw; k += blockDim.x) s_taps[k] = taps[k];
    __syncthreads();

    const int t = blockIdx.x;
    const int b = blockIdx.y;
    const float rho = scal[2 * b];
    const float lam = scal[2 * b + 1];
    constexpr bool dyn = kDynamic;

    // the scalar state at the start of iteration `it`
    rls::State s = rls::initial_state();
    if (dyn && it > 0) {
        const rls::State prev =
            reinterpret_cast<const rls::State*>(state)[((it - 1) & 1) * B + b];
        const double* part = partial + ((((it - 1) & 1) * B + b) * T) * 3;
        double sum[3] = {0.0, 0.0, 0.0};
        double nx0 = 0.0;
        for (int tt = 0; tt < T; ++tt) {
            for (int k = 0; k < 3; ++k) sum[k] += part[3 * tt + k];
            nx0 += norm_part[b * T + tt];
        }
        const float sums[3] = {static_cast<float>(sum[0]), static_cast<float>(sum[1]),
                               static_cast<float>(sum[2])};
        const float norm_x0 = __fsqrt_rn(static_cast<float>(nx0));
        s = rls::epilogue(sc, prev, rls::coeffs(sc, prev, tab, it - 1, rho, lam), sums,
                          norm_x0);
    }
    if (dyn && t == 0 && threadIdx.x == 0)
        reinterpret_cast<rls::State*>(state)[(it & 1) * B + b] = s;
    if (it == sc.iterations) {
        if (t == 0 && threadIdx.x == 0) {
            counts[2 * b] = static_cast<int>(s.fires);
            counts[2 * b + 1] = static_cast<int>(s.live_iters);
        }
        return;
    }

    // this tile's window and planes
    const int r0 = t * TR;
    const int r1 = min(H, r0 + TR);
    const int lo = max(0, r0 - halo);
    const int hi = min(H, r1 + halo);
    const size_t n = static_cast<size_t>(H) * W;
    const size_t plane = static_cast<size_t>(B) * n;
    const size_t at = static_cast<size_t>(b) * n + static_cast<size_t>(lo) * W;
    rls::Window w;
    w.rows = hi - lo;
    w.W = W;
    w.i0 = r0 - lo;
    w.i1 = r1 - lo;
    w.x0 = x0hat + at;
    for (int k = 0; k < 4; ++k) {
        w.in[k] = carries + ((it & 1) * 4 + k) * plane + at;
        w.out[k] = carries + (((it + 1) & 1) * 4 + k) * plane + at;
    }
    const size_t win = static_cast<size_t>(min(H, TR + 2 * halo)) * W;
    float* base = window + (static_cast<size_t>(b) * T + t) * kWindowPlanes * win;
    float** planes[kWindowPlanes] = {&w.xm, &w.t1, &w.t2, &w.xg, &w.yn,
                                     &w.pv, &w.ph, &w.rv, &w.rh};
    for (int k = 0; k < kWindowPlanes; ++k) *planes[k] = base + k * win;

    const rls::Coeffs c = rls::coeffs(sc, s, tab, it, rho, lam);
    double acc[3] = {0.0, 0.0, 0.0};
    rls::pgm_iteration<kMethod, kDynamic>(w, sc, c, s_taps, kh, kw, t2tab, acc);
    if (!dyn) return;
    rls::block_sum3(acc, s_red);
    if (threadIdx.x == 0)
        for (int k = 0; k < 3; ++k) partial[(((it & 1) * B + b) * T + t) * 3 + k] = acc[k];
    if (it == 0 && sc.early) {
        // this tile's share of ||x0hat||^2
        double v[3] = {0.0, 0.0, 0.0};
        for (int i = w.i0 * W + threadIdx.x; i < w.i1 * W; i += blockDim.x) {
            const float x0 = w.x0[i];
            v[2] += static_cast<double>(x0 * x0);
        }
        rls::block_sum3(v, s_red);
        if (threadIdx.x == 0) norm_part[b * T + t] = v[2];
    }
}

template <int kMethod, bool kDynamic>
struct Launcher {
    static void run(dim3 grid, cudaStream_t stream, const float* x0hat, const float* scal,
                    const float* tab, const float* t2tab, const float* taps, int kh,
                    int kw, float* carries, float* window, double* partial,
                    double* norm_part, float* state, int* counts, int B, int H, int W,
                    int TR, int halo, int T, int it, rls::Schedule sc) {
        fista_tv_tiled_kernel<kMethod, kDynamic><<<grid, kThreads, 0, stream>>>(
            x0hat, scal, tab, t2tab, taps, kh, kw, carries, window, partial, norm_part,
            state, counts, B, H, W, TR, halo, T, it, sc);
    }
};

}  // namespace

extern "C" {

// x0hat: (B, H, W) f32; scal: (B, 2) [rho, lam_eff]; tab, t2tab, taps as
// for fista_tv_fused_launch; carries: (2, 4, B, H, W) f32, set 0 holding
// the start (zeros); window: (B, T, 9, min(H, TR + 2 halo), W) f32;
// partial: (2, B, T, 3) f64; norm_part: (B, T) f64; state: (2, B, 8) f32;
// counts: (B, 2) int32. Launch `it` = 0 .. iterations - 1 runs iteration
// `it`; a dynamic schedule adds launch `it` = iterations, which writes
// the counts. The solution is carries[iterations % 2][0].
int fista_tv_tiled_launch(const void* x0hat, const void* scal, const void* tab,
                          const void* t2tab, const void* taps, int kh, int kw,
                          void* carries, void* window, void* partial,
                          void* norm_part, void* state, void* counts, int B, int H,
                          int W, int tile_rows, int halo, int iterations,
                          int tv_iterations, int it, int method, int restart,
                          int early, float rel_tol, float sigma_fac, void* stream) {
    if (kh > kMaxTaps || kw > kMaxTaps || tile_rows < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const rls::Schedule sc = {method, restart, early, 0,
                              rel_tol, sigma_fac, iterations, tv_iterations};
    const int T = (H + tile_rows - 1) / tile_rows;
    const dim3 grid(it == iterations ? 1 : T, B);
    rls::pick_launcher<Launcher>(method, sc.dynamic())(
        grid, static_cast<cudaStream_t>(stream), static_cast<const float*>(x0hat),
        static_cast<const float*>(scal), static_cast<const float*>(tab),
        static_cast<const float*>(t2tab), static_cast<const float*>(taps), kh, kw,
        static_cast<float*>(carries), static_cast<float*>(window),
        static_cast<double*>(partial), static_cast<double*>(norm_part),
        static_cast<float*>(state), static_cast<int*>(counts), B, H, W, tile_rows, halo, T,
        it, sc);
    return static_cast<int>(cudaGetLastError());
}

// The cluster route (three planes of a band in shared memory): its shared
// memory per CTA for bands of `rows` rows of width W (the planner's check),
// and how many clusters of `clusters` CTAs of the kernel for (method,
// dynamic) can be resident at once on the current device
// (cudaOccupancyMaxActiveClusters): out[0], out[1].
int fista_tv_tiled_cluster_occupancy(int clusters, int rows, int W, int method, int dynamic,
                                     long long* out) {
    return rls::pgm_cluster::occupancy<false>(clusters, rows, W, method, dynamic, out);
}

// The cluster route: x0hat, scal, tab, t2tab, taps, counts as for
// fista_tv_fused_launch; out (B, H, W); scratch 10 planes of (B, H, W)
// (x_prev | y, z, w, res, y_new, x_mom, t3, xg, pv, ph); prof null or
// kPhases int64 that receive CTA 0's clocks per phase; warm 0; the plan:
// `clusters` CTAs per problem, bands of `rows` rows, `smem` bytes of
// shared memory per CTA. Returns cudaErrorInvalidValue for a plan that
// does not cover H or whose smem differs from cluster_smem_bytes, else the
// launch's error.
int fista_tv_tiled_cluster_launch(const void* x0hat, const void* scal, const void* tab,
                                  const void* t2tab, const void* taps, int kh, int kw,
                                  void* out, void* scratch, void* counts, void* prof, int B,
                                  int H, int W, int iterations, int tv_iterations, int method,
                                  int restart, int early, int warm, float rel_tol,
                                  float sigma_fac, int clusters, int rows, int smem,
                                  void* stream) {
    return rls::pgm_cluster::launch<false>(x0hat, scal, tab, t2tab, taps, kh, kw, out, scratch,
                                           counts, prof, B, H, W, iterations, tv_iterations,
                                           method, restart, early, warm, rel_tol, sigma_fac,
                                           clusters, rows, smem, stream);
}

}  // extern "C"
