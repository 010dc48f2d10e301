// The whole batched PGM-TV solve in one launch, on one of two routes that
// the host planners pick by shape:
//
// * resident: each problem runs on a thread-block cluster of c <= 16 CTAs,
//   CTA q owning the image rows [q R, (q + 1) R) (the last band may be
//   shorter), with the planes that another band or a neighbouring pixel
//   reads in shared memory for the whole solve: all six where they fit a
//   CTA (row 2, kernels/fista_tv_fused.py plan_pgm_tv, c in {1, 2, 4, 8,
//   16}), or the three that another band reads, with the rest in global
//   memory (the "cluster" route of row 3, kernels/fista_tv_tiled.py
//   plan_fista_tv_tiled: 512^2 on c = 16);
// * global: one CTA per problem with every plane in global scratch, for
//   images whose single row is too wide for a band (about W > 9,600).
//
// Replaces the TPU kernel rls_tpu/kernels/fista_tv_fused.py:_kernel (and
// _kernel_grouped / _kernel_interleaved, which compute the same function;
// launched by fista_tv_fused, :676) in all its schedules, and, on the
// resident route with three planes, the VMEM-carry variant of
// rls_tpu/kernels/fista_tv_tiled.py:fista_tv_tiled (:704, mode "vmem",
// pallas_call :832; bodies _kernel_vmem :239, _kernel_vmem_pgm :457), which
// keeps a problem's carries on chip for the whole solve: FISTA, OptISTA
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
// it. The resident route keeps it on chip (pgm_tv_cluster.cuh: its
// planes, the slots of its two placements and its barrier table). This
// file holds the global route and row 2's entry points to the resident
// route with six planes; row 3's, with three, are in fista_tv_tiled.cu.
#include <cuda_runtime.h>

#include "pgm_tv_cluster.cuh"
#include "pgm_tv_common.cuh"

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

// The resident route with six planes of a band in shared memory: its shared
// memory per CTA for bands of `rows` rows of width W (the planner's check),
// and how many clusters of `clusters` CTAs of the kernel for (method,
// dynamic) can be resident at once on the current device
// (cudaOccupancyMaxActiveClusters): out[0], out[1].
int fista_tv_cluster_occupancy(int clusters, int rows, int W, int method, int dynamic,
                               long long* out) {
    return rls::pgm_cluster::occupancy<true>(clusters, rows, W, method, dynamic, out);
}

// The resident route with six planes: as fista_tv_fused_launch, with
// scratch 6 planes of (B, H, W) (x_prev | y, z, w, res, y_new, x_mom), prof
// null or kPhases int64 that receive CTA 0's clocks per phase, and the
// plan: `clusters` CTAs per problem, bands of `rows` rows, `smem` bytes of
// shared memory per CTA. Returns cudaErrorInvalidValue for a plan that
// does not cover H or whose smem differs from cluster_smem_bytes, else the
// launch's error.
int fista_tv_cluster_launch(const void* x0hat, const void* scal, const void* tab,
                            const void* t2tab, const void* taps, int kh, int kw, void* out,
                            void* scratch, void* counts, void* prof, int B, int H, int W,
                            int iterations, int tv_iterations, int method, int restart,
                            int early, int warm, float rel_tol, float sigma_fac, int clusters,
                            int rows, int smem, void* stream) {
    return rls::pgm_cluster::launch<true>(x0hat, scal, tab, t2tab, taps, kh, kw, out, scratch,
                                          counts, prof, B, H, W, iterations, tv_iterations,
                                          method, restart, early, warm, rel_tol, sigma_fac,
                                          clusters, rows, smem, stream);
}

}  // extern "C"
