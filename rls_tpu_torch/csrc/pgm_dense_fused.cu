// The whole batched proximal-gradient solve (FISTA, OptISTA, POGM) on a
// dense matrix in one launch, one problem per CTA (pgm_dense_kernel, the
// per-problem route), real or on complex data as (re, im) planes: the
// route of a shape that no grid plan fits the card (the grid route, one
// cooperative grid of A-slabs x problem groups, is pgm_dense_grid.cu).
//
// Replaces the TPU kernels rls_tpu/kernels/pgm_dense_fused.py:_kernel
// (:47-129; launched by solve_pgm_dense_fused, :355, pallas_call :436) and
// _kernel_cplx (:132-262; launched by _solve_cplx, :458, pallas_call :518).
// Per problem, from x = 0 and x0hat = A^H b (computed here):
//   FISTA    a = (th_old - 1) / th, xm = x + a (x - x_prev),
//            x+ = prox(xm - rho (A^H A xm - x0hat), rho lam), the restart
//            test (gradient: res.(x+ - x) > 0; gradient mapping:
//            (xm - x+).(x+ - x) > 0) sets th = 1, th_old = th,
//            th = (1 + sqrt(1 + 4 th^2)) / 2, all in f32 per problem;
//   OptISTA  the row (a, b, g, e) of the f64 momentum table: res at x,
//   / POGM   y+ = prox(y - rho g res, rho g lam), z+ = x + (y+ - y) e,
//            x+ = (1 + a + b) z+ - a z - b x   (OptISTA); y+ = x - rho res,
//            x_mid = (1 + a + b) y+ - a y - (b + e) x + e x_mid_old,
//            x+ = prox(x_mid, rho g lam)       (POGM).
// The prox is the L1 soft threshold (the group threshold over (re, im) on
// complex data, eps added to the real plane only) or the L2 shrinkage
// x / (1 + 2 lam), then the projection (Positive clips the real plane; on
// complex data Positive and Real zero the imaginary plane). Each
// problem's restart count is written to `counts`. The plain PyTorch
// versions, which this code follows op for op, are pgm_dense_fused_torch
// and pgm_dense_fused_cplx_torch in rls_tpu_torch/kernels/pgm_dense_fused.py.
//
// The kernel is compiled per (real | complex, method, prox kind, restart):
// ten instantiations each; the prox is pgm_dense_common.cuh's. The
// projection is a run-time argument, one uniform branch per entry.
// Numerics as in cgnr_fused.cu: matvec entries and the restart dot are
// double sums in a fixed order rounded to f32, the scalar and entry
// updates separate f32 ops, so every thread takes the same restart
// decision and the kernel differs from its plain version only where two
// double sums round to different floats.
//
// What bounds it on an H100: an iteration is 4 m n f32 operations per
// problem for the matvec pair (16 m n on complex data) plus ~20 n for the
// prox and the updates, so the solve is operations-bound at the card's
// peak. In the per-problem kernel A stays in L2 and each CTA re-reads it
// twice per iteration, and one CTA per problem leaves most SMs idle at
// batch 16: the L2 traffic and the latency of one CTA's dependent passes
// set the time. Its planes (x0hat, x_prev | y, z, the Gram's input and
// result: n each, per plane; A's output: m) live in global scratch.
#include <cuda_runtime.h>

#include "dense_common.cuh"
#include "pgm_dense_common.cuh"

namespace {

constexpr int kThreads = rls::kDenseThreads;
using rls::pgm::kL1;
using rls::pgm::kL2;
using rls::pgm::kProjReal;
using rls::pgm::prox;
using rls::pgm::valid;

template <bool kCplx, int kMethod, int kKind, int kRestart>
__global__ void __launch_bounds__(kThreads)
pgm_dense_kernel(const float* __restrict__ br, const float* __restrict__ bi,
                 const float* __restrict__ ar, const float* __restrict__ ai,
                 const float* __restrict__ scal, const float* __restrict__ tab,
                 float* __restrict__ out, float* __restrict__ scratch,
                 int* __restrict__ counts, int P, int m, int n, int steps, int proj) {
    constexpr int C = kCplx ? 2 : 1;  // planes: re (, im)
    __shared__ double s_red[3 * (kThreads / 32)];
    const int pb = blockIdx.x;
    float* ws = scratch + static_cast<size_t>(pb) * C * (5 * n + m);
    float *x0[2] = {}, *m1[2] = {}, *m2[2] = {}, *xm[2] = {}, *v[2] = {}, *q[2] = {}, *x[2] = {};
    for (int c = 0; c < C; ++c) {
        x0[c] = ws + (0 * C + c) * n;
        m1[c] = ws + (1 * C + c) * n;  // x_prev | y
        m2[c] = ws + (2 * C + c) * n;  // z | x_mid
        xm[c] = ws + (3 * C + c) * n;  // FISTA's momentum point
        v[c] = ws + (4 * C + c) * n;   // A^H A of the Gram's input
        q[c] = ws + 5 * C * n + c * m;
        x[c] = out + (static_cast<size_t>(c) * P + pb) * n;
    }
    const float lam = scal[3 * pb];
    const float rho = scal[3 * pb + 1];
    float th = scal[3 * pb + 2];
    float th_old = th;

    const size_t bo = static_cast<size_t>(pb) * m;
    rls::mv_cols<kCplx>(ar, ai, br + bo, kCplx ? bi + bo : nullptr, x0[0], x0[1], m, n);
    for (int j = threadIdx.x; j < n; j += blockDim.x)
        for (int c = 0; c < C; ++c) {
            const float zero = rls::fmul(x0[c][j], 0.f);
            x[c][j] = zero;
            m1[c][j] = zero;
            m2[c][j] = zero;
        }
    __syncthreads();

    int fires = 0;
    for (int it = 0; it < steps; ++it) {
        float* const* gin = x;  // the Gram's input
        if constexpr (kMethod == rls::kFista) {
            const float a = rls::fdiv(rls::fsub(th_old, 1.f), th);
            for (int j = threadIdx.x; j < n; j += blockDim.x)
                for (int c = 0; c < C; ++c) {
                    const float xv = x[c][j];
                    xm[c][j] = rls::fadd(xv, rls::fmul(a, rls::fsub(xv, m1[c][j])));
                }
            __syncthreads();
            gin = xm;
        }
        rls::mv_rows<kCplx>(ar, ai, gin[0], gin[1], q[0], q[1], m, n);
        __syncthreads();
        rls::mv_cols<kCplx>(ar, ai, q[0], q[1], v[0], v[1], m, n);

        if constexpr (kMethod == rls::kFista) {
            const float rl = rls::fmul(rho, lam);
            double acc[3] = {0.0, 0.0, 0.0};
            for (int j = threadIdx.x; j < n; j += blockDim.x) {
                float res[2], xmv[2], xg[2] = {}, xn[2] = {};
                for (int c = 0; c < C; ++c) {
                    res[c] = rls::fsub(v[c][j], x0[c][j]);
                    xmv[c] = xm[c][j];
                    xg[c] = rls::fsub(xmv[c], rls::fmul(rho, res[c]));
                }
                prox<kCplx, kKind>(xg[0], xg[1], rl, proj, xn[0], xn[1]);
                for (int c = 0; c < C; ++c) {
                    const float xv = x[c][j];
                    const float d = rls::fsub(xn[c], xv);
                    if constexpr (kRestart == rls::kRestartGradient)
                        acc[0] += rls::dmul(res[c], d);
                    else if constexpr (kRestart == rls::kRestartGradientMapping)
                        acc[0] += rls::dmul(rls::fsub(xmv[c], xn[c]), d);
                    m1[c][j] = xv;
                    x[c][j] = xn[c];
                }
            }
            if constexpr (kRestart != rls::kRestartNone) {
                rls::block_sum3(acc, s_red);
                if (static_cast<float>(acc[0]) > 0.f) {
                    th = 1.f;
                    ++fires;
                }
            }
            th_old = th;
            th = rls::theta_next(th, 4.f);
        } else {
            const float* row = tab + 4 * it;
            const float a = row[0], bc = row[1], g = row[2], e = row[3];
            const float cy = rls::fadd(rls::fadd(1.f, a), bc);
            if constexpr (kMethod == rls::kOptista) {
                const float step = rls::fmul(rho, g);
                const float ls = rls::fmul(step, lam);
                for (int j = threadIdx.x; j < n; j += blockDim.x) {
                    float yg[2] = {}, yn[2] = {};
                    for (int c = 0; c < C; ++c)
                        yg[c] = rls::fsub(m1[c][j], rls::fmul(step, rls::fsub(v[c][j], x0[c][j])));
                    prox<kCplx, kKind>(yg[0], yg[1], ls, proj, yn[0], yn[1]);
                    for (int c = 0; c < C; ++c) {
                        const float xv = x[c][j];
                        const float zn = rls::fadd(xv, rls::fmul(rls::fsub(yn[c], m1[c][j]), e));
                        x[c][j] = rls::fsub(rls::fsub(rls::fmul(cy, zn), rls::fmul(a, m2[c][j])),
                                            rls::fmul(bc, xv));
                        m1[c][j] = yn[c];
                        m2[c][j] = zn;
                    }
                }
            } else {  // POGM
                const float cx = rls::fadd(bc, e);
                const float ls = rls::fmul(rls::fmul(rho, g), lam);
                for (int j = threadIdx.x; j < n; j += blockDim.x) {
                    float xmid[2] = {}, xn[2] = {};
                    for (int c = 0; c < C; ++c) {
                        const float xv = x[c][j];
                        const float res = rls::fsub(v[c][j], x0[c][j]);
                        const float yn = rls::fsub(xv, rls::fmul(rho, res));
                        xmid[c] = rls::fadd(
                            rls::fsub(rls::fsub(rls::fmul(cy, yn), rls::fmul(a, m1[c][j])),
                                      rls::fmul(cx, xv)),
                            rls::fmul(e, m2[c][j]));
                        m1[c][j] = yn;
                        m2[c][j] = xmid[c];
                    }
                    prox<kCplx, kKind>(xmid[0], xmid[1], ls, proj, xn[0], xn[1]);
                    for (int c = 0; c < C; ++c) x[c][j] = xn[c];
                }
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) counts[pb] = fires;
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                        const float*, float*, float*, int*, int, int, int, int, int);

template <bool kCplx, int kMethod, int kKind>
Kernel pick_restart(int restart) {
    if constexpr (kMethod != rls::kFista) {
        return &pgm_dense_kernel<kCplx, kMethod, kKind, rls::kRestartNone>;
    } else {
        if (restart == rls::kRestartGradient)
            return &pgm_dense_kernel<kCplx, kMethod, kKind, rls::kRestartGradient>;
        if (restart == rls::kRestartGradientMapping)
            return &pgm_dense_kernel<kCplx, kMethod, kKind, rls::kRestartGradientMapping>;
        return &pgm_dense_kernel<kCplx, kMethod, kKind, rls::kRestartNone>;
    }
}

template <bool kCplx, int kMethod>
Kernel pick_kind(int kind, int restart) {
    return kind == kL1 ? pick_restart<kCplx, kMethod, kL1>(restart)
                       : pick_restart<kCplx, kMethod, kL2>(restart);
}

template <bool kCplx>
Kernel pick(int method, int kind, int restart) {
    if (method == rls::kFista) return pick_kind<kCplx, rls::kFista>(kind, restart);
    if (method == rls::kOptista) return pick_kind<kCplx, rls::kOptista>(kind, restart);
    return pick_kind<kCplx, rls::kPogm>(kind, restart);
}

}  // namespace

extern "C" {

// b: (P, m) f32, one problem per row; A: (m, n) f32 row-major; scal: (P, 3)
// [lam_eff, rho, theta0]; tab: the momentum table (steps, 4) for OptISTA
// and POGM; out: (P, n); scratch: (P, 5 n + m); counts: (P,) int32, the
// restarts. Codes: method fista | optista | pogm, kind l1 | l2, restart
// none | gradient | gradient_mapping (FISTA), proj none | positive.
int pgm_dense_fused_launch(const void* b, const void* A, const void* scal, const void* tab,
                           void* out, void* scratch, void* counts, int P, int m, int n,
                           int steps, int method, int kind, int restart, int proj,
                           void* stream) {
    if (!valid(method, kind, restart, proj) || proj == kProjReal)
        return static_cast<int>(cudaErrorInvalidValue);
    if (P <= 0) return 0;
    pick<false>(method, kind, restart)<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(b), nullptr, static_cast<const float*>(A), nullptr,
        static_cast<const float*>(scal), static_cast<const float*>(tab),
        static_cast<float*>(out), static_cast<float*>(scratch), static_cast<int*>(counts), P,
        m, n, steps, proj);
    return static_cast<int>(cudaGetLastError());
}

// The same on complex data as planes: br, bi (P, m); ar, ai (m, n); out:
// (2, P, n), the re then the im plane; scratch: (P, 2 (5 n + m)); proj
// also real (zero the imaginary plane).
int pgm_dense_fused_cplx_launch(const void* br, const void* bi, const void* ar,
                                const void* ai, const void* scal, const void* tab, void* out,
                                void* scratch, void* counts, int P, int m, int n, int steps,
                                int method, int kind, int restart, int proj, void* stream) {
    if (!valid(method, kind, restart, proj)) return static_cast<int>(cudaErrorInvalidValue);
    if (P <= 0) return 0;
    pick<true>(method, kind, restart)<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(br), static_cast<const float*>(bi),
        static_cast<const float*>(ar), static_cast<const float*>(ai),
        static_cast<const float*>(scal), static_cast<const float*>(tab),
        static_cast<float*>(out), static_cast<float*>(scratch), static_cast<int*>(counts), P,
        m, n, steps, proj);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
