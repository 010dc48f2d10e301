// Device code of the PGM-TV family, shared by the fused kernel
// (fista_tv_fused.cu: one CTA per problem, all iterations in one launch)
// and the row-tiled kernel (fista_tv_tiled.cu: one CTA per row tile, one
// launch per iteration): one FISTA / OptISTA / POGM iteration on a window
// of image rows, the per-problem scalar schedule, and a block reduction.
//
// Counterparts in rls_tpu/kernels/fista_tv_fused.py: _pgm_loop (:375-416,
// the fixed schedules), _fista_loop_dynamic and _fista_dynamic_scalars
// (:247-291, :187-212), _pogm_loop_dynamic with _pogm_dynamic_coeffs and
// _pogm_restart_decision (:294-372, :215-244), _fista_loop_warm (:419-457).
// The plain PyTorch version, which this code follows op for op, is
// fista_tv_fused_torch in rls_tpu_torch/kernels/fista_tv_fused.py.
//
// A window is `rows` consecutive image rows, treated as an image of its
// own: the stencil passes read zeros past its edges and the FGP masks its
// last row, exactly as the whole-image functions do. For the fused kernel
// the window is the whole image. For a row tile the window is the tile
// widened by a halo of (tv_iterations + 1) + 2 (kh / 2) + 1 rows and
// clamped to the image (rls_tpu/kernels/fista_tv_tiled.py:9-23): at the
// image's top and bottom its edges are the image's own, and at an edge
// inside the image the wrong values stay within the halo, so the
// interior rows a CTA writes are exact.
//
// The dynamic schedules reduce over whole planes per problem (the restart
// dots, ||res||^2). Each thread sums its pixels in double, in a fixed
// order, and the block sums the threads' partials in a fixed order; the
// result is rounded to f32, where the plain version sums in f32.
#pragma once

#include <cuda_runtime.h>

#include "fgp_common.cuh"

namespace rls {

enum { kFista = 0, kOptista = 1, kPogm = 2 };
enum { kRestartNone = 0, kRestartGradient = 1, kRestartGradientMapping = 2 };

// Scalar f32 ops that nvcc must neither contract nor reorder: the
// schedule's scalars are held bit for bit to the plain version's separate
// f32 tensor ops. (Plane arithmetic may contract: ~1 ulp per op.)
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// (1 + sqrt(1 + c th th)) / 2: c = 4 the recurrence, c = 8 the
// last-iteration variant of OptISTA and of POGM with restart
__device__ __forceinline__ float theta_next(float th, float c) {
    return fdiv(fadd(1.f, __fsqrt_rn(fadd(1.f, fmul(fmul(c, th), th)))), 2.f);
}

// What a launch runs; the same for every problem.
struct Schedule {
    int method, restart, early, warm;
    float rel_tol, sigma_fac;
    int iterations, tv_iterations;
    __host__ __device__ bool dynamic() const { return restart != kRestartNone || early; }
};

// Per-problem scalars carried from one iteration to the next (the JAX
// loops' scalar carries), plus the two counts the wrappers return. Eight
// floats: the tiled kernel keeps it in global memory between launches.
struct State {
    float th_in, th_old, done, sig, gam_old, fires, live_iters, unused;
};

__device__ __forceinline__ State initial_state() {
    State s = {1.f, 1.f, 0.f, 1.f, 1.f, 0.f, 0.f, 0.f};
    return s;
}

// One iteration's coefficients, from the momentum table (fixed) or the
// state (dynamic).
struct Coeffs {
    float a, b, e;  // inertia, secondary inertia, OptISTA 1/gamma | POGM z coupling
    float cy, cx;   // (1 + a) + b and b + e
    float step;     // gradient step scale
    float lam_tv;   // prox strength
    float th, gam, r;  // dynamic POGM: theta, gamma and rho / gamma
    float live;     // 1 - done
};

__device__ __forceinline__ Coeffs coeffs(const Schedule& sc, const State& s,
                                         const float* tab, int it, float rho,
                                         float lam) {
    Coeffs c = {};
    c.live = fsub(1.f, s.done);
    const float* row = tab + 4 * it;
    if (sc.method == kFista) {
        c.a = sc.dynamic() ? fdiv(fsub(s.th_old, 1.f), s.th_in) : row[0];
        c.step = rho;
        c.lam_tv = fmul(rho, lam);
        return c;
    }
    if (sc.method == kOptista || !sc.dynamic()) {
        c.a = row[0];
        c.b = row[1];
        c.e = row[3];
        c.cy = fadd(fadd(1.f, c.a), c.b);
        c.cx = fadd(c.b, c.e);
        if (sc.method == kOptista) {
            c.step = fmul(rho, row[2]);
            c.lam_tv = fmul(c.step, lam);
        } else {
            c.step = rho;
            c.lam_tv = fmul(fmul(rho, row[2]), lam);
        }
        return c;
    }
    // dynamic POGM (_pogm_dynamic_coeffs)
    const bool restart = sc.restart != kRestartNone;
    const bool last = it == sc.iterations - 1;
    c.th = theta_next(s.th_in, restart && last ? 8.f : 4.f);
    c.a = fdiv(fsub(s.th_in, 1.f), c.th);
    c.b = fdiv(fmul(s.sig, s.th_in), c.th);
    c.gam = restart ? fmul(rho, fadd(fadd(1.f, c.a), c.b))
                    : fdiv(fmul(rho, fsub(fadd(fmul(2.f, s.th_in), c.th), 1.f)), c.th);
    c.e = fdiv(fmul(rho, c.a), s.gam_old);
    c.cy = fadd(fadd(1.f, c.a), c.b);
    c.cx = fadd(c.b, c.e);
    c.step = rho;
    c.lam_tv = fmul(c.gam, lam);
    c.r = fdiv(rho, c.gam);
    return c;
}

// The state after iteration `it` of a dynamic schedule, from its sums:
// sums[0] the FISTA restart dot, or POGM's sum w_mid (x_new - z_new);
// sums[1] POGM's sum w_mid res; sums[2] sum res^2.
__device__ __forceinline__ State epilogue(const Schedule& sc, const State& s,
                                          const Coeffs& c, const float* sums,
                                          float norm_x0) {
    State n = s;
    const bool restart = sc.restart != kRestartNone;
    n.live_iters = fadd(s.live_iters, c.live);
    if (sc.early) {
        const bool conv = fdiv(__fsqrt_rn(sums[2]), norm_x0) < sc.rel_tol;
        n.done = fmaxf(s.done, conv ? 1.f : 0.f);
    }
    bool fire = false;
    if (sc.method == kFista) {
        float th = s.th_in;
        if (restart) {
            fire = sums[0] > 0.f;
            if (fire) th = 1.f;
        }
        float th_old_new = th;
        float th_new = theta_next(th, 4.f);
        if (sc.early) {
            th_old_new = fadd(s.th_old, fmul(c.live, fsub(th_old_new, s.th_old)));
            th_new = fadd(s.th_in, fmul(c.live, fsub(th_new, s.th_in)));
        }
        n.th_in = th_new;
        n.th_old = th_old_new;
    } else {  // POGM
        float th = c.th, sig = s.sig, gam = c.gam;
        if (restart) {
            fire = fsub(fdiv(sums[0], c.gam), sums[1]) < 0.f;
            sig = fire ? 1.f : fmul(s.sig, sc.sigma_fac);
            if (fire) th = 1.f;
        }
        if (sc.early) {
            th = fadd(s.th_in, fmul(c.live, fsub(th, s.th_in)));
            sig = fadd(s.sig, fmul(c.live, fsub(sig, s.sig)));
            gam = fadd(s.gam_old, fmul(c.live, fsub(gam, s.gam_old)));
        }
        n.th_in = th;
        n.sig = sig;
        n.gam_old = gam;
    }
    if (fire && c.live > 0.f) n.fires = fadd(s.fires, 1.f);
    return n;
}

// Sum three per-thread doubles over the block in a fixed order; every
// thread gets the sums. `red` is shared memory of 3 * 32 doubles. Needs a
// block size that is a multiple of 32.
__device__ __forceinline__ void block_sum3(double* v, double* red) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int k = 0; k < 3; ++k)
        for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], o);
    if (lane == 0)
        for (int k = 0; k < 3; ++k) red[3 * warp + k] = v[k];
    __syncthreads();
    for (int k = 0; k < 3; ++k) v[k] = 0.0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
        for (int k = 0; k < 3; ++k) v[k] += red[3 * w + k];
    __syncthreads();  // `red` may be reused
}

// A window of `rows` image rows and the planes one iteration touches.
// Carries (x, x_prev) for FISTA, (x, y, z, w) for OptISTA and POGM.
struct Window {
    int rows, W;
    int i0, i1;          // interior rows (window rows) this CTA writes
    const float* x0;     // x0hat at window row 0
    const float* in[4];  // carries in, at window row 0
    float* out[4];       // carries out, at window row 0 (may be `in`)
    float *xm, *t1, *t2, *xg, *yn, *pv, *ph, *rv, *rh;  // window planes
};

// The fold FGP on xg with clip bounds +-lam (0 on the window's last row /
// column), from zero duals or, with `warm`, from the carried pv, ph. It
// leaves the final duals in pv, ph; the caller forms x = xg - gt(pv, ph).
// The momentum's two products and difference are rounded on their own, as
// the plain version rounds them (nvcc would otherwise contract them).
__device__ __forceinline__ void fold_fgp(const float* xg, float* pv,
                                         float* ph, float* rv, float* rh,
                                         float* y, float lam,
                                         const float* t2tab, int iterations,
                                         bool warm, int H, int W) {
    const int n = H * W;
    if (warm) {
        // the dual momentum restarts from the carried duals: r = p. (A
        // copy: reading r through a pointer that may be p slows every
        // sweep of the loop below by ~15%.)
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            rv[i] = pv[i];
            rh[i] = ph[i];
        }
    } else {
        // iteration 0 from zero duals: one gradient of y = xg / 8 and a clip
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int r = i / W;
            const int c = i - r * W;
            const float y0 = xg[i] * 0.125f;
            const float qv = r < H - 1 ? clip(xg[i + W] * 0.125f - y0, -lam, lam) : 0.f;
            const float qh = c < W - 1 ? clip(xg[i + 1] * 0.125f - y0, -lam, lam) : 0.f;
            pv[i] = qv;
            rv[i] = qv;
            ph[i] = qh;
            rh[i] = qh;
        }
    }
    __syncthreads();
    for (int k = warm ? 0 : 1; k < iterations; ++k) {
        const float c1 = t2tab[2 * k];
        const float c2 = t2tab[2 * k + 1];
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int r = i / W;
            const int c = i - r * W;
            y[i] = (xg[i] - grad_t(rv, rh, i, r, c, W)) * 0.125f;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int r = i / W;
            const int c = i - r * W;
            const float qv = r < H - 1 ? clip(rv[i] + grad_v(y, i, W), -lam, lam) : 0.f;
            const float qh = c < W - 1 ? clip(rh[i] + grad_h(y, i), -lam, lam) : 0.f;
            rv[i] = fsub(fmul(c1, qv), fmul(c2, pv[i]));
            rh[i] = fsub(fmul(c1, qh), fmul(c2, ph[i]));
            pv[i] = qv;
            ph[i] = qh;
        }
        __syncthreads();
    }
}

// One iteration on a window, compiled per method and per kind of schedule
// (fixed or dynamic), so that no pixel loop branches on either. Adds this
// CTA's interior sums to acc (see `epilogue`) for a dynamic schedule. Ends
// with a barrier.
template <int kMethod, bool kDynamic>
__device__ __forceinline__ void pgm_iteration(const Window& w, const Schedule& sc,
                                              const Coeffs& c, const float* taps,
                                              int kh, int kw, const float* t2tab,
                                              double* acc) {
    const int H = w.rows;
    const int W = w.W;
    const int n = H * W;
    const int first = w.i0 * W;  // the interior pixels [first, last)
    const int last = w.i1 * W;
    const float live = c.live;
    const bool early = kDynamic && sc.early;
    const float* x = w.in[0];
    const float* m1 = w.in[1];  // x_prev | y
    const float* m2 = w.in[2];  // z

    // the Gram's input: FISTA's momentum point, else x itself. FISTA's
    // x_prev carry takes x here (masked by `live` under early exit): it
    // needs nothing the iteration computes
    const float* gin = x;
    if constexpr (kMethod == kFista) {
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const float xv = x[i];
            const float xp = m1[i];
            w.xm[i] = xv + c.a * (xv - xp);
            if (i >= first && i < last) w.out[1][i] = early ? xp + live * (xv - xp) : xv;
        }
        __syncthreads();
        gin = w.xm;
    }

    // res = A^H A gin - x0hat: column pass, its adjoint, row pass, its
    // adjoint; the last pass forms the prox input xg (and POGM's y_new),
    // and keeps res in t2 for the dynamic schedules' sums
    stencil_v_pass(gin, w.t1, taps, kh, false, H, W);
    __syncthreads();
    stencil_v_pass(w.t1, w.t2, taps, kh, true, H, W);
    __syncthreads();
    stencil_h_pass(w.t2, w.t1, taps + kh, kw, false, H, W);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int r = i / W;
        const float res = stencil_h(w.t1, r, i - r * W, taps + kh, kw, true, W) - w.x0[i];
        if constexpr (kMethod == kFista) {
            w.xg[i] = w.xm[i] - c.step * res;
        } else if constexpr (kMethod == kOptista) {
            w.xg[i] = m1[i] - c.step * res;
        } else {
            const float xv = x[i];
            const float yv = xv - c.step * res;
            w.yn[i] = yv;
            w.xg[i] = ((c.cy * yv - c.a * m1[i]) - c.cx * xv) + c.e * m2[i];  // x_mid
        }
        if constexpr (kDynamic) w.t2[i] = res;
    }
    __syncthreads();

    const int tv = sc.tv_iterations;
    if (tv > 0)
        fold_fgp(w.xg, w.pv, w.ph, w.rv, w.rh, w.t1, c.lam_tv, t2tab, tv, sc.warm, H, W);

    // x_new = prox(xg), then the carries, on the interior rows only
    for (int i = first + threadIdx.x; i < last; i += blockDim.x) {
        const int r = i / W;
        const float xg = w.xg[i];
        const float xn = tv > 0 ? xg - grad_t(w.pv, w.ph, i, r, i - r * W, W) : xg;
        if constexpr (kMethod == kFista && !kDynamic) {
            w.out[0][i] = xn;
        } else if constexpr (kMethod == kFista) {
            const float xv = x[i];
            const float res = w.t2[i];
            if (sc.restart == kRestartGradient)
                acc[0] += static_cast<double>(res * (xn - xv));
            else if (sc.restart == kRestartGradientMapping)
                acc[0] += static_cast<double>((w.xm[i] - xn) * (xn - xv));
            acc[2] += static_cast<double>(res * res);
            w.out[0][i] = early ? xv + live * (xn - xv) : xn;
        } else if constexpr (kMethod == kOptista) {  // xn is y_new
            const float xv = x[i];
            const float zn = xv + (xn - m1[i]) * c.e;
            w.out[0][i] = (c.cy * zn - c.a * m2[i]) - c.b * xv;
            w.out[1][i] = xn;
            w.out[2][i] = zn;
        } else if constexpr (!kDynamic) {  // POGM: z_new is x_mid = xg
            w.out[0][i] = xn;
            w.out[1][i] = w.yn[i];
            w.out[2][i] = xg;
        } else {
            const float xv = x[i];
            const float yv = m1[i];
            const float zv = m2[i];
            const float ynv = w.yn[i];
            const float res = w.t2[i];
            const float wv = w.in[3][i];
            float wn = wv;
            if (sc.restart != kRestartNone) {
                const float d = xn - xg;
                const float wm = (wv + ynv) + c.r * d;
                acc[0] += static_cast<double>(wm * d);
                acc[1] += static_cast<double>(wm * res);
                wn = c.r * (xg - xn) - ynv;
            }
            acc[2] += static_cast<double>(res * res);
            w.out[0][i] = early ? xv + live * (xn - xv) : xn;
            w.out[1][i] = early ? yv + live * (ynv - yv) : ynv;
            w.out[2][i] = early ? zv + live * (xg - zv) : xg;
            w.out[3][i] = early ? wv + live * (wn - wv) : wn;
        }
    }
    __syncthreads();
}

// `&L<kMethod, kDynamic>::run` for a launch's method and schedule: the
// five instantiations of the family (OptISTA has no dynamic schedule).
template <template <int, bool> class L>
auto pick_launcher(int method, bool dynamic) -> decltype(&L<kFista, false>::run) {
    if (method == kFista) return dynamic ? &L<kFista, true>::run : &L<kFista, false>::run;
    if (method == kOptista) return &L<kOptista, false>::run;
    return dynamic ? &L<kPogm, true>::run : &L<kPogm, false>::run;
}

}  // namespace rls
