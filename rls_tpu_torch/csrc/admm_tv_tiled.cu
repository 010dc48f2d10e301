// The row-tiled batched ADMM-TV solve: one CTA per (row tile, problem), a
// fixed sequence of launches per outer iteration.
//
// Replaces the TPU kernel rls_tpu/kernels/admm_tv_tiled.py:_kernel
// (:50-160; launched by admm_tv_tiled, :183, pallas_call :226): the same
// solve as admm_tv_fused.cu (masked CG on the exact stencil Gram, the
// Positive projection, the fold FGP z-update, the dual update). The TPU
// kernel tiles the z-update to fit VMEM and keeps the CG untiled; on an
// H100 tiling is what spreads one problem over many CTAs: the fused kernel
// runs a problem in one CTA, so 16 images of 512^2 would light 16 of 132
// SMs; at 64-row tiles it is 128 CTAs here.
//
// Each CG step needs two sums over the whole image (p.q before its update,
// r.r after it), and CTAs cannot wait for each other inside a launch. So
// the host enqueues, per outer iteration k (2 cg_iterations + 2 launches):
//   A     beta = x0hat + rho (z - u); r = beta - (A^H A + rho I) x; p0 = r;
//         partials of ||beta||^2 and r.r
//   B(j)  (j > 0) p_j = active ? r + beta_c p_{j-1} : p_{j-1}, on the
//         window; then q = (A^H A + rho I) p_j and the partial of p_j.q
//   C(j)  alpha; x += alpha p_j; r -= alpha q; the partial of r.r
//   D     x' = max(x, 0) (Positive); z = FGP(x' + u) on the window; u' =
//         u + x' - z; the live CG steps go to `counts`
// Every launch reads whole planes that earlier launches finished and writes
// only its tile's rows. A and B work on a window of the tile widened by
// 2 (kh / 2) rows a side (the reach of the column pass and its adjoint), D
// on one widened by tv_iterations + 2 (the FGP's cone and a spare row); a
// window is an image of its own (zero padding and masks at its edges), and
// its interior rows are exact. Planes that a launch reads on a window and
// also updates are ping-pong pairs: x and u (written by D), p (written by
// B). Each CTA writes its tile's sums (double) to partial[L % 2][b][t] for
// launch L; every CTA of problem b adds the T partials in tile order at
// the start of launch L + 1 and applies the CG's scalar rules to the state
// it reads from state[L % 2][b]; tile 0 stores the new state in
// state[(L + 1) % 2][b]. No atomics: a result is the same run to run.
//
// What bounds it on an H100: every plane lives in global memory; a CG step
// is two launches of four stencil passes and two pointwise sweeps over
// the tile, so at 512^2 x 16 (64-row tiles, 128 CTAs) the step is short and
// the launches' fixed costs (launch latency, the tail of each wave, the
// tile sums) weigh as much as the sweeps. The z-update recomputes
// (TR + 2 (tv_iterations + 2)) / TR of the rows (1.4x at TR = 64, 10 dual
// iterations). Fewer launches (D merged into the next A) and windows in
// shared memory are later work.
#include <cuda_runtime.h>

#include <algorithm>

#include "admm_tv_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxTaps = 63;  // per axis; the wrapper checks it
constexpr int kWindowPlanes = 6;

enum { kStart = 0, kQ = 1, kStep = 2, kZ = 3 };
// plane indices in `planes`: x and u ping-pong, p ping-pong
enum { kX0 = 0, kZP = 2, kU0 = 3, kR = 5, kP0 = 6, kQP = 8 };

// the per-problem CG scalars carried from launch to launch (8 floats)
struct CgState {
    float target, rz, active, live, unused[4];
};

struct Args {
    const float* x0hat;
    const float* scal;
    const float* t2tab;
    const float* taps;
    int kh, kw;
    float* planes;
    float* window;
    double* partial;
    CgState* state;
    int* counts;
    int B, H, W, TR, T, mhalo, fhalo, win_rows;
    int cg_iterations, tv_iterations, positive;
    float tol_inner;
};

__global__ void __launch_bounds__(kThreads)
admm_tv_tiled_kernel(Args a, int phase, int k, int j, int L) {
    __shared__ float s_taps[2 * kMaxTaps];
    __shared__ double s_red[3 * (kThreads / 32)];
    for (int m = threadIdx.x; m < a.kh + a.kw; m += blockDim.x) s_taps[m] = a.taps[m];
    __syncthreads();

    const int t = blockIdx.x;
    const int b = blockIdx.y;
    const int W = a.W;
    const float rho = a.scal[2 * b];
    const size_t n = static_cast<size_t>(a.H) * W;
    const size_t plane = static_cast<size_t>(a.B) * n;
    auto P = [&](int idx) { return a.planes + idx * plane + b * n; };

    // the scalar state at the start of this launch, and the previous
    // launch's sums over the tiles
    CgState s = {0.f, 0.f, 0.f, 0.f, {0.f, 0.f, 0.f, 0.f}};
    if (L > 0) s = a.state[((L - 1) & 1) * a.B + b];
    double sum[3] = {0.0, 0.0, 0.0};
    if (L > 0) {
        const double* part = a.partial + (((L - 1) & 1) * a.B + b) * a.T * 3;
        for (int tt = 0; tt < a.T; ++tt)
            for (int m = 0; m < 3; ++m) sum[m] += part[3 * tt + m];
    }
    bool act = false;
    float beta_c = 0.f, alpha = 0.f;
    if (phase == kQ) {
        if (j == 0) {
            s.target = rls::fmul(a.tol_inner, __fsqrt_rn(static_cast<float>(sum[0])));
            s.rz = static_cast<float>(sum[1]);
        } else {
            const float rz_new = static_cast<float>(sum[0]);
            act = s.active != 0.f;
            beta_c = rls::cg_beta(s.rz, rz_new);
            s.rz = rz_new;
        }
    } else if (phase == kStep) {
        act = rls::cg_active(s.rz, s.target);
        alpha = rls::cg_alpha(act, s.rz, static_cast<float>(sum[0]));
        s.active = act ? 1.f : 0.f;
        s.live = rls::fadd(s.live, s.active);
    }
    if (t == 0 && threadIdx.x == 0) {
        a.state[(L & 1) * a.B + b] = s;
        if (phase == kZ) a.counts[b] = static_cast<int>(s.live);
    }

    // this tile's rows and its window
    const int r0 = t * a.TR;
    const int r1 = min(a.H, r0 + a.TR);
    const int halo = phase == kZ ? a.fhalo : a.mhalo;
    const int lo = max(0, r0 - halo);
    const int hi = min(a.H, r1 + halo);
    const int rows = hi - lo;
    const int first = (r0 - lo) * W;  // the interior, in window pixels
    const int last = (r1 - lo) * W;
    const size_t at = static_cast<size_t>(lo) * W;  // window row 0 in a plane
    const size_t win = static_cast<size_t>(a.win_rows) * W;
    float* wp = a.window + (static_cast<size_t>(b) * a.T + t) * kWindowPlanes * win;
    float* w[kWindowPlanes];
    for (int m = 0; m < kWindowPlanes; ++m) w[m] = wp + m * win;

    const float* x0 = a.x0hat + b * n + at;
    float* x = P(kX0 + (k & 1)) + at;
    float* u = P(kU0 + (k & 1)) + at;
    float* z = P(kZP) + at;
    float* r = P(kR) + at;
    float* q = P(kQP) + at;
    double acc[3] = {0.0, 0.0, 0.0};

    if (phase == kStart) {
        float* p0 = P(kP0) + at;
        rls::gram_passes(x, w[1], w[2], s_taps, a.kh, a.kw, rows, W);
        for (int i = first + threadIdx.x; i < last; i += blockDim.x) {
            const int row = i / W;
            const float beta = x0[i] + rho * (z[i] - u[i]);
            const float res =
                beta - (rls::gram_last(w[1], i, row, s_taps, a.kh, a.kw, W) + rho * x[i]);
            r[i] = res;
            p0[i] = res;
            acc[0] += static_cast<double>(beta * beta);
            acc[1] += static_cast<double>(res * res);
        }
    } else if (phase == kQ) {
        const float* pin = P(kP0) + at;  // p_0 = r_0
        if (j > 0) {
            const float* pold = P(kP0 + ((j - 1) & 1)) + at;
            float* pnew = P(kP0 + (j & 1)) + at;
            for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
                const float v = act ? r[i] + beta_c * pold[i] : pold[i];
                w[0][i] = v;
                if (i >= first && i < last) pnew[i] = v;
            }
            __syncthreads();
            pin = w[0];
        }
        rls::gram_passes(pin, w[1], w[2], s_taps, a.kh, a.kw, rows, W);
        for (int i = first + threadIdx.x; i < last; i += blockDim.x) {
            const int row = i / W;
            const float pval = pin[i];
            const float qval = rls::gram_last(w[1], i, row, s_taps, a.kh, a.kw, W) + rho * pval;
            q[i] = qval;
            acc[0] += static_cast<double>(pval * qval);
        }
    } else if (phase == kStep) {
        const float* pj = P(kP0 + (j & 1)) + at;
        for (int i = first + threadIdx.x; i < last; i += blockDim.x) {
            x[i] = x[i] + alpha * pj[i];
            const float rn = r[i] - alpha * q[i];
            r[i] = rn;
            acc[0] += static_cast<double>(rn * rn);
        }
    } else {  // kZ
        float* xn = P(kX0 + ((k + 1) & 1)) + at;
        float* un = P(kU0 + ((k + 1) & 1)) + at;
        float* xg = w[0];
        for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
            const float xv = a.positive ? fmaxf(x[i], 0.f) : x[i];
            xg[i] = xv + u[i];
        }
        __syncthreads();
        if (a.tv_iterations > 0 && rho != 0.f)
            rls::fold_fgp(xg, w[1], w[2], w[3], w[4], w[5],
                          rls::prox_scale(rho, a.scal[2 * b + 1]), a.t2tab,
                          a.tv_iterations, false, rows, W);
        for (int i = first + threadIdx.x; i < last; i += blockDim.x) {
            const int row = i / W;
            const float xv = a.positive ? fmaxf(x[i], 0.f) : x[i];
            const float zv = rls::z_value(xg, w[1], w[2], i, row, W, a.tv_iterations, rho);
            xn[i] = xv;
            z[i] = zv;
            un[i] = (u[i] + xv) - zv;
        }
        return;
    }
    rls::block_sum3(acc, s_red);
    if (threadIdx.x == 0)
        for (int m = 0; m < 3; ++m) a.partial[(((L & 1) * a.B + b) * a.T + t) * 3 + m] = acc[m];
}

}  // namespace

extern "C" {

// x0hat: (B, H, W) f32; scal: (B, 2) [rho, lam_eff]; t2tab:
// (tv_iterations, 2) [1 + t2, t2]; taps: kh + kw floats; planes: (9, B, H,
// W) f32 = x, x', z, u, u', r, p, p', q with x, z and u zero; window:
// (B, T, 6, min(H, TR + 2 max(2 (kh / 2), tv_iterations + 2)), W) f32;
// partial: (2, B, T, 3) f64; state: (2, B, 8) f32; counts: (B,) int32,
// the live CG steps. Enqueues the whole solve, iterations (2 cg_iterations
// + 2) launches; the solution is planes[iterations % 2].
int admm_tv_tiled_launch(const void* x0hat, const void* scal, const void* t2tab,
                         const void* taps, int kh, int kw, void* planes, void* window,
                         void* partial, void* state, void* counts, int B, int H, int W,
                         int tile_rows, int iterations, int cg_iterations,
                         int tv_iterations, float tol_inner, int positive, void* stream) {
    if (kh > kMaxTaps || kw > kMaxTaps || tile_rows < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Args a;
    a.x0hat = static_cast<const float*>(x0hat);
    a.scal = static_cast<const float*>(scal);
    a.t2tab = static_cast<const float*>(t2tab);
    a.taps = static_cast<const float*>(taps);
    a.kh = kh;
    a.kw = kw;
    a.planes = static_cast<float*>(planes);
    a.window = static_cast<float*>(window);
    a.partial = static_cast<double*>(partial);
    a.state = static_cast<CgState*>(state);
    a.counts = static_cast<int*>(counts);
    a.B = B;
    a.H = H;
    a.W = W;
    a.TR = tile_rows;
    a.T = (H + tile_rows - 1) / tile_rows;
    a.mhalo = 2 * (kh / 2);
    a.fhalo = tv_iterations + 2;
    a.win_rows = std::min(H, tile_rows + 2 * std::max(a.mhalo, a.fhalo));
    a.cg_iterations = cg_iterations;
    a.tv_iterations = tv_iterations;
    a.positive = positive;
    a.tol_inner = tol_inner;
    const dim3 grid(a.T, B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int L = 0;
    auto launch = [&](int phase, int k, int j) {
        admm_tv_tiled_kernel<<<grid, kThreads, 0, st>>>(a, phase, k, j, L++);
        return cudaGetLastError();
    };
    for (int k = 0; k < iterations; ++k) {
        cudaError_t err = launch(kStart, k, 0);
        for (int j = 0; err == cudaSuccess && j < cg_iterations; ++j) {
            err = launch(kQ, k, j);
            if (err == cudaSuccess) err = launch(kStep, k, j);
        }
        if (err == cudaSuccess) err = launch(kZ, k, 0);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

}  // extern "C"
