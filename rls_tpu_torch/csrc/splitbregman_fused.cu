// The whole batched SplitBregman (L21 + TV) multi-coil SENSE solve in one
// launch, one slice per CTA.
//
// Replaces the TPU kernel rls_tpu/kernels/splitbregman_fused.py:_kernel
// (:48-185; launched by splitbregman_l1_tv_sense_fused, :217, pallas_call
// :245). From x = 0 and beta_y = x0hat (= A^H b), per outer iteration
// z1 = z2 = x, u1 = u2 = 0, then per inner iteration
//   beta = (beta_y + rho1 (z1 - u1)) + rho2 (z2 - u2)
//   x    = masked CG on (A^H A + (rho1 + rho2) I) x = beta, cg_iterations
//          steps from the previous x; a step is live while
//          ||r|| > tol_inner ||beta||
//   z1   = group soft threshold of x + u1 over (re, im) at lam1 / rho1
//   z2   = fold FGP-TV of each plane of x + u2 at lam2 / rho2
//          (zi = x + ui where rho_i = 0)
//   ui   = (ui + x) - zi
// and after the inner iterations beta_y = (beta_y + x0hat) - A^H A x. The
// SENSE normal op is the in-kernel FFT of dft_common.cuh, coil by coil; the
// CG's sums (||beta||^2, r.r, p.q over both planes) are block sums of exact
// double products in a fixed order (rls::block_sum3), rounded once, as the
// plain version sums them in float64; every thread evaluates the same
// `active` and takes the same branch. The TV prox is the fold FGP
// (rls::fold_fgp, its momentum rounded as the plain version rounds it) once
// per plane, valid because lam2 / rho2 is the same at every call. The kernel also counts each problem's live CG steps. The
// plain PyTorch version, which this code follows op for op, is
// splitbregman_l1_tv_fused_torch in rls_tpu_torch/kernels/splitbregman_fused.py.
//
// What bounds it on an H100: at BASELINE #4 (128^2, 6 coils, 4 x 8 x 8)
// every slice runs 292 SENSE normal ops (each 6 x three passes of
// barrier-separated radix-2 stages over the spectrum in global memory) and
// 64 FGP calls, one dependent chain per CTA; with 8 slices only 8 of the 132
// SMs work, so the kernel is bound by that chain's latency, not by bytes or
// operations.
#include <cuda_runtime.h>

#include "admm_tv_common.cuh"
#include "dense_common.cuh"
#include "dft_common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
splitbregman_fused_kernel(const float* __restrict__ x0hat, const float* __restrict__ scal,
                          const float* __restrict__ t2tab, const float* __restrict__ tw,
                          const float* __restrict__ weights, const float* __restrict__ coils_r,
                          const float* __restrict__ coils_i, float* __restrict__ out,
                          float* __restrict__ scratch, int* __restrict__ counts, int B, int H,
                          int W, int C, int iterations, int iterations_inner, int cg_iterations,
                          int tv_iterations, float tol_inner) {
    __shared__ rls::FftShared s;
    __shared__ double s_red[3 * (kThreads / 32)];
    rls::load_twiddles(s, tw, H, W);

    const int b = blockIdx.x;
    const int n = H * W;
    const size_t plane = static_cast<size_t>(B) * n;
    const size_t off = static_cast<size_t>(b) * n;
    auto sp = [&](int k) { return scratch + k * plane + off; };
    const float* x0r = x0hat + 2 * off;
    const float* x0i = x0r + n;
    float* xr = out + 2 * off;
    float* xi = xr + n;
    float *byr = sp(0), *byi = sp(1), *z1r = sp(2), *z1i = sp(3), *u1r = sp(4), *u1i = sp(5);
    float *z2r = sp(6), *z2i = sp(7), *u2r = sp(8), *u2i = sp(9);
    float *br = sp(10), *bi = sp(11), *rr = sp(12), *ri = sp(13), *pr = sp(14), *pi = sp(15);
    float *qr = sp(16), *qi = sp(17), *kr = sp(18), *ki = sp(19), *accr = sp(20), *acci = sp(21);
    float *pv = sp(22), *ph = sp(23), *rv = sp(24), *rh = sp(25), *y = sp(26);

    const float rho1 = scal[4 * b], rho2 = scal[4 * b + 1];
    const float rho_sum = rls::fadd(rho1, rho2);
    const float t1 = rls::fdiv(scal[4 * b + 2], rho1 != 0.f ? rho1 : 1.f);
    const float t2 = rls::fdiv(scal[4 * b + 3], rho2 != 0.f ? rho2 : 1.f);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float zero = x0r[i] * 0.f;
        xr[i] = zero;
        xi[i] = zero;
        byr[i] = x0r[i];
        byi[i] = x0i[i];
    }
    __syncthreads();

    int live = 0;
    double acc[3];
    auto sum = [&]() {
        rls::block_sum3(acc, s_red);
        return static_cast<float>(acc[0]);
    };
    auto clear = [&]() { acc[0] = acc[1] = acc[2] = 0.0; };

    for (int outer = 0; outer < iterations; ++outer) {
        // the outer reset: z = x (identity trafos), u = 0
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const float zero = xr[i] * 0.f;
            z1r[i] = z2r[i] = xr[i];
            z1i[i] = z2i[i] = xi[i];
            u1r[i] = u1i[i] = u2r[i] = u2i[i] = zero;
        }
        __syncthreads();
        for (int inner = 0; inner < iterations_inner; ++inner) {
            // beta and ||beta||^2
            clear();
            for (int i = threadIdx.x; i < n; i += blockDim.x) {
                const float vr =
                    rls::fadd(rls::fadd(byr[i], rls::fmul(rho1, rls::fsub(z1r[i], u1r[i]))),
                              rls::fmul(rho2, rls::fsub(z2r[i], u2r[i])));
                const float vi =
                    rls::fadd(rls::fadd(byi[i], rls::fmul(rho1, rls::fsub(z1i[i], u1i[i]))),
                              rls::fmul(rho2, rls::fsub(z2i[i], u2i[i])));
                br[i] = vr;
                bi[i] = vi;
                acc[0] += rls::dmul(vr, vr) + rls::dmul(vi, vi);
            }
            const float target = rls::fmul(tol_inner, __fsqrt_rn(sum()));
            // the CG's start: r = beta - (A^H A + rho_sum I) x, p = r, r.r
            clear();
            auto start = [&](int i, float nr, float ni) {
                const float vr = rls::fsub(br[i], rls::fadd(nr, rls::fmul(rho_sum, xr[i])));
                const float vi = rls::fsub(bi[i], rls::fadd(ni, rls::fmul(rho_sum, xi[i])));
                rr[i] = pr[i] = vr;
                ri[i] = pi[i] = vi;
                acc[0] += rls::dmul(vr, vr) + rls::dmul(vi, vi);
            };
            rls::sense_normal(xr, xi, coils_r, coils_i, C, kr, ki, accr, acci, weights, start, s,
                              H, W);
            float rz = sum();

            for (int j = 0; j < cg_iterations; ++j) {
                // q = (A^H A + rho_sum I) p and p.q
                clear();
                auto matvec = [&](int i, float nr, float ni) {
                    const float vr = rls::fadd(nr, rls::fmul(rho_sum, pr[i]));
                    const float vi = rls::fadd(ni, rls::fmul(rho_sum, pi[i]));
                    qr[i] = vr;
                    qi[i] = vi;
                    acc[0] += rls::dmul(pr[i], vr) + rls::dmul(pi[i], vi);
                };
                rls::sense_normal(pr, pi, coils_r, coils_i, C, kr, ki, accr, acci, weights,
                                  matvec, s, H, W);
                const float pq = sum();
                const bool active = rls::cg_active(rz, target);
                live += active ? 1 : 0;
                const float alpha = rls::cg_alpha(active, rz, pq);
                // x += alpha p, r -= alpha q, and r.r
                clear();
                for (int i = threadIdx.x; i < n; i += blockDim.x) {
                    xr[i] = rls::fadd(xr[i], rls::fmul(alpha, pr[i]));
                    xi[i] = rls::fadd(xi[i], rls::fmul(alpha, pi[i]));
                    const float vr = rls::fsub(rr[i], rls::fmul(alpha, qr[i]));
                    const float vi = rls::fsub(ri[i], rls::fmul(alpha, qi[i]));
                    rr[i] = vr;
                    ri[i] = vi;
                    acc[0] += rls::dmul(vr, vr) + rls::dmul(vi, vi);
                }
                const float rz_new = sum();
                const float beta_c = rls::cg_beta(rz, rz_new);
                // p = active ? r + beta_c p : p (every thread agrees on active)
                if (active)
                    for (int i = threadIdx.x; i < n; i += blockDim.x) {
                        pr[i] = rls::fadd(rr[i], rls::fmul(beta_c, pr[i]));
                        pi[i] = rls::fadd(ri[i], rls::fmul(beta_c, pi[i]));
                    }
                rz = rz_new;
                __syncthreads();
            }

            // z1 and u1; the TV input v = x + u2 goes to (br, bi)
            for (int i = threadIdx.x; i < n; i += blockDim.x) {
                const float ar = rls::fadd(xr[i], u1r[i]);
                const float ai = rls::fadd(xi[i], u1i[i]);
                const float gn = __fsqrt_rn(rls::fadd(rls::fmul(ar, ar), rls::fmul(ai, ai)));
                const float sc = fmaxf(rls::fdiv(rls::fsub(gn, t1), gn == 0.f ? 1.f : gn), 0.f);
                const float zr = rho1 != 0.f ? rls::fmul(ar, sc) : ar;
                const float zi = rho1 != 0.f ? rls::fmul(ai, sc) : ai;
                z1r[i] = zr;
                z1i[i] = zi;
                u1r[i] = rls::fsub(rls::fadd(u1r[i], xr[i]), zr);
                u1i[i] = rls::fsub(rls::fadd(u1i[i], xi[i]), zi);
                br[i] = rls::fadd(xr[i], u2r[i]);
                bi[i] = rls::fadd(xi[i], u2i[i]);
            }
            __syncthreads();
            // z2 = FGP of each plane of v, then u2
            const float* vp[2] = {br, bi};
            const float* xp[2] = {xr, xi};
            float* z2p[2] = {z2r, z2i};
            float* u2p[2] = {u2r, u2i};
            const bool tv = rho2 != 0.f && tv_iterations > 0;
            for (int k = 0; k < 2; ++k) {
                if (tv)
                    rls::fold_fgp(vp[k], pv, ph, rv, rh, y, t2, t2tab, tv_iterations, false,
                                  H, W);
                for (int i = threadIdx.x; i < n; i += blockDim.x) {
                    const float zv = rls::z_value(vp[k], pv, ph, i, i / W, W, tv_iterations,
                                                  rho2);
                    z2p[k][i] = zv;
                    u2p[k][i] = rls::fsub(rls::fadd(u2p[k][i], xp[k][i]), zv);
                }
                __syncthreads();
            }
        }
        // the outer Bregman update: beta_y = (beta_y + x0hat) - A^H A x
        auto bregman = [&](int i, float nr, float ni) {
            byr[i] = rls::fsub(rls::fadd(byr[i], x0r[i]), nr);
            byi[i] = rls::fsub(rls::fadd(byi[i], x0i[i]), ni);
        };
        rls::sense_normal(xr, xi, coils_r, coils_i, C, kr, ki, accr, acci, weights, bregman, s,
                          H, W);
    }
    if (threadIdx.x == 0) counts[b] = live;
}

}  // namespace

extern "C" {

// x0hat, out: (B, 2, H, W) f32, the split [re; im] image; scal: (B, 4) [rho1,
// rho2, lam1_eff, lam2_eff] (the L21 and the TV term); t2tab: (tv_iterations,
// 2) [1 + t2, t2]; tw: H + W floats [Re_H, Im_H, Re_W, Im_W]; weights: (H, W)
// the spectral weights; coils_r, coils_i: (C, H, W); scratch: 27 planes of
// (B, H, W); counts: (B,) int32, the live CG steps. H and W powers of two,
// 2..1024.
int splitbregman_fused_launch(const void* x0hat, const void* scal, const void* t2tab,
                              const void* tw, const void* weights, const void* coils_r,
                              const void* coils_i, void* out, void* scratch, void* counts,
                              int B, int H, int W, int C, int iterations, int iterations_inner,
                              int cg_iterations, int tv_iterations, float tol_inner,
                              void* stream) {
    if (H > rls::kFftMax || W > rls::kFftMax || C < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    splitbregman_fused_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x0hat), static_cast<const float*>(scal),
        static_cast<const float*>(t2tab), static_cast<const float*>(tw),
        static_cast<const float*>(weights), static_cast<const float*>(coils_r),
        static_cast<const float*>(coils_i), static_cast<float*>(out),
        static_cast<float*>(scratch), static_cast<int*>(counts), B, H, W, C, iterations,
        iterations_inner, cg_iterations, tv_iterations, tol_inner);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
