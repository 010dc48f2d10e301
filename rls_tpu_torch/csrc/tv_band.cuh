// The banded pieces of the TV kernels that run one problem on a
// thread-block cluster, the resident routes of fista_tv_fused.cu (rows 2
// and 3: six planes of a band in shared memory, or three) and
// admm_tv_fused.cu (row 4): the first three passes of the stencil
// Gram A^H A and the fold FGP's dual loop with its cluster barriers, on a
// CTA's band of image rows (rls::Band, cluster_common.cuh). Each kernel
// keeps its own last Gram pass and prox-output sweep, which fuse the
// kernel's own updates into them.
//
// A plane read at another band's rows is named by its index in the band's
// shared memory (a template argument, so that every plane offset folds to
// a constant). A plane read only in its own rows (the Gram's t3, the FGP's
// rh, pv, ph and its own-pixel read of xg) is a pointer laid out as the
// band, in shared or in global memory: the kernels that keep three planes
// of a band in shared memory put those in global memory. The caller's
// `sync(phase)` is its cluster barrier (__syncthreads() on a cluster of one
// CTA), `phase` naming the work done since the caller's last timer mark.
#pragma once

#include "cluster_common.cuh"

namespace rls {

// floats of one plane of a band of `rows` rows (16-byte multiples)
__host__ __device__ inline size_t band_plane_floats(int rows, int W) {
    return (static_cast<size_t>(rows) * W + 3) / 4 * 4;
}

// The column pass of A^H A on plane kIn (kIn -> kT1), a cluster barrier,
// its adjoint (kT1 -> kT2; reads kT1 at other bands' rows) and the row pass
// (kT2 -> t3, own rows), each sweep closed by a barrier; the caller's last
// pass reads t3 in its own rows (stencil_h, adjoint). The caller orders
// its writes of kIn before the first pass with a cluster barrier, and
// every peer's earlier reads of kT1 and kT2.
template <int kIn, int kT1, int kT2, class Band, class Sweep, class Sync>
__device__ __forceinline__ void band_gram_passes(const Band& bd, const Sweep& sweep, float* t3,
                                                 const float* taps, int kh, int kw,
                                                 Sync&& sync, int phase) {
    float* t1 = bd.plane(kT1);
    float* t2 = bd.plane(kT2);
    sweep([&](int i, int lr, int col) {
        t1[i] = bd.stencil_v(kIn, i, lr, col, taps, kh, false);
    });
    sync(phase);
    sweep([&](int i, int lr, int col) {
        t2[i] = bd.stencil_v(kT1, i, lr, col, taps, kh, true);
    });
    __syncthreads();
    sweep([&](int i, int lr, int col) {
        t3[i] = bd.stencil_h(kT2, i, lr, col, taps + kh, kw, false);
    });
    __syncthreads();
}

// The fold FGP's dual loop on the prox input in plane kXg (rls::fold_fgp,
// the same ops in the same order), for tv >= 1 dual iterations at clip
// bound lt: the duals pv and ph (own pixel), their momentum rv (plane kRv)
// and rh (own rows), y in plane kY (which may be kXg: the first write of y
// follows the last read of xg at another band's rows by a barrier); `xg`
// is xg as the loop reads it at its own pixel (plane kXg, or a copy in
// global memory where kY is kXg); clip bounds 0 on the image's last row
// and column. With `warm` the duals start from pv, ph as they stand, else
// from zero (the first iteration then collapses to one gradient of xg / 8
// and its clip, read from plane kXg). It opens with a cluster barrier (xg
// whole; every peer's earlier reads of kRv, kY done), puts one before each
// sweep that reads another band's rows, and ends with one (p whole), after
// which the caller's prox output reads p one row up and ph one column
// left: xg - grad_t(p, ph). p is pv, which the caller then keeps in shared
// memory; or, with kOwnGlobal (pv, ph and the own-pixel xg in global
// memory), the last dual iteration writes p into rv in place of the
// momentum (which nothing reads again; a warm start copies rv from pv),
// and the loop's sweeps issue a pixel's global reads one pixel ahead
// (Sweep::ahead).
template <int kXg, int kY, int kRv, bool kOwnGlobal, class Band, class Sweep, class Sync>
__device__ __forceinline__ void band_fold_fgp(const Band& bd, const Sweep& sweep,
                                              const float* xg, float* rh, float* pv, float* ph,
                                              float lt, const float* t2tab, int tv, bool warm,
                                              Sync&& sync, int first_phase, int phase) {
    const int r0 = bd.r0, H = bd.H, W = bd.W;
    const float* xs = bd.plane(kXg);
    float* y = bd.plane(kY);
    float* rv = bd.plane(kRv);
    sync(first_phase);
    if (warm) {
        sweep([&](int i, int, int) {
            rv[i] = pv[i];
            rh[i] = ph[i];
        });
    } else {
        sweep([&](int i, int lr, int col) {
            const float y0 = xs[i] * 0.125f;
            const float qv = r0 + lr < H - 1
                ? clip(bd.below(kXg, i, lr, col) * 0.125f - y0, -lt, lt)
                : 0.f;
            const float qh = col < W - 1 ? clip(xs[i + 1] * 0.125f - y0, -lt, lt) : 0.f;
            pv[i] = qv;
            rv[i] = qv;
            ph[i] = qh;
            rh[i] = qh;
        });
    }
    for (int k = warm ? 0 : 1; k < tv; ++k) {
        const float c1 = t2tab[2 * k];
        const float c2 = t2tab[2 * k + 1];
        sync(phase);
        if constexpr (kOwnGlobal) {
            sweep.ahead([&](int i) { return xg[i]; }, [&](int i, int lr, int col, float xgv) {
                y[i] = (xgv - bd.grad_t(kRv, rh, i, lr, col)) * 0.125f;
            });
        } else {
            sweep([&](int i, int lr, int col) {
                y[i] = (xg[i] - bd.grad_t(kRv, rh, i, lr, col)) * 0.125f;
            });
        }
        sync(phase);
        // the duals at local pixel i from p = (pv, ph) there
        auto duals = [&](int i, int lr, int col, float pvv, float phv, bool p_out) {
            const float qv = r0 + lr < H - 1
                ? clip(rv[i] + (bd.below(kY, i, lr, col) - y[i]), -lt, lt)
                : 0.f;
            const float qh = col < W - 1 ? clip(rh[i] + (y[i + 1] - y[i]), -lt, lt) : 0.f;
            rv[i] = p_out ? qv : fsub(fmul(c1, qv), fmul(c2, pvv));
            rh[i] = fsub(fmul(c1, qh), fmul(c2, phv));
            pv[i] = qv;
            ph[i] = qh;
        };
        if constexpr (kOwnGlobal) {
            const bool p_out = k + 1 == tv;
            sweep.ahead([&](int i) { return make_float2(pv[i], ph[i]); },
                        [&](int i, int lr, int col, float2 p) {
                            duals(i, lr, col, p.x, p.y, p_out);
                        });
        } else {
            sweep([&](int i, int lr, int col) { duals(i, lr, col, pv[i], ph[i], false); });
        }
    }
    sync(phase);
}

}  // namespace rls
