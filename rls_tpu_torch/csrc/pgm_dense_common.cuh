// Device code that both routes of the dense PGM solve share
// (pgm_dense_fused.cu: one CTA per problem; pgm_dense_grid.cu: one
// cooperative grid of A-slabs x problem groups): the codes of the prox and
// the projection, the prox of one entry, and the check of a schedule's
// codes. The prox follows the plain PyTorch version (_prox_pair in
// rls_tpu_torch/kernels/pgm_dense_fused.py) op for op.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

#include "pgm_tv_common.cuh"

namespace rls {
namespace pgm {

enum { kL1 = 0, kL2 = 1 };
enum { kProjNone = 0, kProjPositive = 1, kProjReal = 2 };
constexpr float kEps = FLT_EPSILON;

// The prox at strength lam on one entry, then the projection; on real
// data `gi` and `pi` are unused. On complex data the L1 prox is the group
// soft threshold over (re, im) with eps on the real plane only, and
// Positive and Real zero the imaginary plane.
template <bool kCplx, int kKind>
__device__ __forceinline__ void prox(float gr, float gi, float lam, int proj, float& pr,
                                     float& pi) {
    if constexpr (kKind == kL1) {
        if constexpr (kCplx) {
            const float mag = __fsqrt_rn(fadd(fmul(gr, gr), fmul(gi, gi)));
            const float sc = fdiv(fmaxf(fsub(mag, lam), 0.f), fadd(mag, kEps));
            pr = fmul(sc, fadd(gr, kEps));
            pi = fmul(sc, gi);
        } else {
            const float mag = fabsf(gr);
            pr = fdiv(fmul(fmaxf(fsub(mag, lam), 0.f), fadd(gr, kEps)), fadd(mag, kEps));
        }
    } else {
        const float d = fadd(1.f, fmul(2.f, lam));
        pr = fdiv(gr, d);
        if constexpr (kCplx) pi = fdiv(gi, d);
    }
    if (proj == kProjPositive) pr = fmaxf(pr, 0.f);
    if constexpr (kCplx) {
        if (proj != kProjNone) pi = fmul(pi, 0.f);
    }
}

// Whether the codes name a schedule the kernels run: method fista |
// optista | pogm, kind l1 | l2, restart (FISTA only) none | gradient |
// gradient_mapping, proj none | positive | real.
inline bool valid(int method, int kind, int restart, int proj) {
    return method >= kFista && method <= kPogm && (kind == kL1 || kind == kL2) &&
           restart >= kRestartNone && restart <= kRestartGradientMapping &&
           (method == kFista || restart == kRestartNone) && proj >= kProjNone &&
           proj <= kProjReal;
}

}  // namespace pgm
}  // namespace rls
