// The SENSE normal op sum_c conj(C_c) F^H M F C_c v of one slice on a
// thread-block cluster, with each coil's spectrum split over a team of
// CTAs: the split routes of the FISTA-L21-SENSE (sense_fused.cu) and
// SplitBregman (splitbregman_fused.cu) kernels, for shapes whose padded
// spectrum, H (W + 1) complex floats, fits no CTA (192^2: 296,448 bytes).
//
// The cluster's `clusters` CTAs form clusters / team teams of `team` CTAs.
// In round ro, team t transforms coil ro (clusters / team) + t; CTA j of a
// team (rank t team + j) owns the spectrum rows [rs(j), rs(j + 1)) (its
// band, pitch W) and the columns [cs(j), cs(j + 1)) (its block: every row
// of those columns, pitch ceil(W / team) + 1), where a side of n points is
// split as n / team points a part, one more for the first n % team parts
// (Split). A coil's transform pair is row 8's three passes
// (fista_l1_dft_fused.cu's resident route) with a complex load and store:
//   (a) rows forward on the band, the image C_c v loaded from global memory
//       (the caller's v, through L2); each point (row, column k) is then
//       pushed into the block of the team's CTA that owns column k (DSMEM);
//   (b) the block's columns forward, times the spectral weights (wt, the
//       weights transposed, from global memory), back; each point (row k,
//       column) is then pushed into the band of the team's CTA that owns
//       row k;
//   (c) rows back on the band, where the coil's result stays.
// Every line runs the stages fft_resident.cuh runs (the odd stages of
// fft_mixed.cuh, the radix-2 spans >= L in shared memory, the rest in
// registers) on the same twiddle table, every operation rounded on its
// own, so the result is bit for bit the resident route's and the plain
// version's (kernels/_dft_common.py sense_normal). The fold: each CTA of
// the cluster folds the round's coils into its own fold band of image rows
// (the caller's [p0, p1), as on the resident route) in coil order, ((acc
// + a yr) + b yi, (acc + a yi) - b yr), reading coil c's result at pixel i
// from the band of the CTA of c's team that owns i's row, through DSMEM.
// The sum between rounds waits in global memory (accr, acci: the fold
// band's pixels, each read back by the thread that wrote it).
//
// Which barrier orders each access to a buffer that another CTA writes or
// reads (all cluster barriers; the team needs no barrier of its own):
//   block (kre, kim) of CTA q: pushed to by q's team in (a); read and
//     rewritten by q in (b)            S1 (RAW: every push before q's (b));
//     S2, S3 and the next round's S1 .. (WAR: q's (b) before the next
//     round's pushes into it)
//   band (bre, bim) of CTA q: written and read by q in (a) as the row
//     pass's staging, pushed to by q's team in (b), read and written by q
//     in (c), read by every CTA of the cluster in the fold
//                                      S1 (WAR: q's (a) before any push
//     of (b)); S2 (RAW: every push of (b) before q's (c)); S3 (RAW: q's
//     (c) before the fold's reads); S4 (WAR: the fold's reads before the
//     next round's (a) rewrites the band), and after the last round the
//     caller's next cluster barrier (before the next normal op's (a), and
//     before any CTA exits)
//   v (global): read by every CTA in (a); the caller orders its writes
//     before the call with a cluster barrier, and writes it again only
//     after S3 of the last round (which every CTA reaches after its last
//     load)
//   inside a pass: a __syncthreads() after each shared-memory stage that
//     another thread of the CTA reads next, as in fft_resident.cuh
// Per round: S1, S2, S3 and, but for the last round, S4: 4 rounds - 1
// cluster barriers a normal op.
//
// The Python model of these passes, barriers and the fold, which the CPU
// tests run against the plain version bit for bit and with each barrier
// dropped, is tests/test_torch_sense_split.py.
#pragma once

#include <cooperative_groups.h>

#include "cluster_common.cuh"
#include "dft_common.cuh"
#include "fft_resident.cuh"
#include "split.cuh"

namespace rls {

// One slice's cluster and this CTA's part of it on the split route.
struct SenseSplit {
    const float* coils_r;  // (C, H, W)
    const float* coils_i;
    const float* wt;       // (W, H): the spectral weights transposed
    const float* tw;       // the twiddles in shared memory
    float* bre;            // this CTA's band of a coil's spectrum (shared)
    float* bim;
    float* kre;            // this CTA's column block (shared)
    float* kim;
    float* accr;           // the coil sum between rounds (global, the slice's plane)
    float* acci;
    int H, W, C, clusters, team, rank;
    int p0, p1;            // the pixels of this CTA's fold band
};

namespace split {

namespace fr = fftr;

// (a) of coil `coil` on this CTA's band: C_c v loaded, the rows forward,
// each point pushed into its column owner's block. Not inlined, so that
// the FFT's registers are its own (as sense_cluster.cuh's coil_transform).
template <int kThreads, bool kPow2, class Prof>
static __device__ __noinline__ void rows_forward(const SenseSplit& s, int coil, const float* vr,
                                                 const float* vi, Prof* prof) {
    cg::cluster_group cl = cg::this_cluster();
    const int H = s.H, W = s.W, k = s.team;
    const int j = s.rank % k, team0 = s.rank - j;
    const Split rsp(H, k), csp(W, k);
    const int rs = rsp.start(j), R = rsp.size(j);
    const int cp = ceil_div(W, k) + 1;
    const int th = twiddle_count(H);
    const fr::Tw tw_w{s.tw + 2 * th, s.tw + 2 * th + twiddle_count(W)};
    const fr::Layout rows(W);
    const bool direct = rows.one_subline();
    const size_t n = static_cast<size_t>(H) * W;
    const float* cr = s.coils_r + coil * n;
    const float* ci = s.coils_i + coil * n;
    const int i0 = rs * W;  // the band's first pixel
    float* const bre = s.bre;
    float* const bim = s.bim;
    float* const kre = s.kre;
    float* const kim = s.kim;
    auto load = [&](int i) {
        const float ca = cr[i], cb = ci[i], vre = vr[i], vim = vi[i];
        return make_float2(fsub(fmul(ca, vre), fmul(cb, vim)), fadd(fmul(ca, vim), fmul(cb, vre)));
    };
    if (!direct) {
        for (int i = threadIdx.x; i < R * W; i += kThreads) {
            const float2 v = load(i0 + i);
            bre[i] = v.x;
            bim[i] = v.y;
        }
        prof->mark(fr::kFftLoads);
        __syncthreads();
        fr::smem_stages<false, kPow2>(bre, bim, tw_w, rows, R, W, 1, kThreads);
    }
    fr::with_points(rows.P(), [&](auto pc) {
        constexpr int kP = decltype(pc)::value;
        fr::sublines<kPow2>(rows, R, kThreads, [&](int lr, int k0, int t, bool valid) {
            float xr[kP], xi[kP];
#pragma unroll
            for (int p = 0; p < kP; ++p) {
                xr[p] = xi[p] = 0.f;
                const int i = lr * W + k0 + (p << rows.lg_t);
                if (valid && direct) {
                    const float2 v = load(i0 + i);
                    xr[p] = v.x;
                    xi[p] = v.y;
                } else if (valid) {
                    xr[p] = bre[i];
                    xi[p] = bim[i];
                }
            }
            prof->mark(fr::kFftLoads);
            fr::dif_regs<kP>(xr, xi, t, rows, tw_w);
            if (valid) {
#pragma unroll
                for (int p = 0; p < kP; ++p) {
                    const int col = k0 + (p << rows.lg_t);
                    const int q = csp.owner(col);
                    const int at = (rs + lr) * cp + col - csp.start(q);
                    cl.map_shared_rank(kre, team0 + q)[at] = xr[p];
                    cl.map_shared_rank(kim, team0 + q)[at] = xi[p];
                }
            }
            prof->mark(fr::kFftRows);
        });
    });
}

// (b) on this CTA's block: each column forward, the weights, back; each
// point then pushed into its row owner's band.
template <int kThreads, bool kPow2, class Prof>
static __device__ __noinline__ void columns(const SenseSplit& s, Prof* prof) {
    cg::cluster_group cl = cg::this_cluster();
    const int H = s.H, W = s.W, k = s.team;
    const int j = s.rank % k, team0 = s.rank - j;
    const Split rsp(H, k), csp(W, k);
    const int c0 = csp.start(j), Wc = csp.size(j);
    const int cp = ceil_div(W, k) + 1;
    const fr::Tw tw_h{s.tw, s.tw + twiddle_count(H)};
    const fr::Layout cols(H);
    const float* const wt = s.wt;
    float* const bre = s.bre;
    float* const bim = s.bim;
    float* const kre = s.kre;
    float* const kim = s.kim;
    fr::smem_stages<false, kPow2>(kre, kim, tw_h, cols, Wc, 1, cp, kThreads);
    fr::with_points(cols.P(), [&](auto pc) {
        constexpr int kP = decltype(pc)::value;
        fr::sublines<kPow2>(cols, Wc, kThreads, [&](int jc, int k0, int t, bool valid) {
            float xr[kP], xi[kP], w[kP];
#pragma unroll
            for (int p = 0; p < kP; ++p) {
                xr[p] = xi[p] = w[p] = 0.f;
                const int r = k0 + (p << cols.lg_t);
                if (valid) {
                    w[p] = wt[(c0 + jc) * H + r];
                    xr[p] = kre[r * cp + jc];
                    xi[p] = kim[r * cp + jc];
                }
            }
            fr::dif_regs<kP>(xr, xi, t, cols, tw_h);
#pragma unroll
            for (int p = 0; p < kP; ++p) {
                xr[p] = fmul(xr[p], w[p]);
                xi[p] = fmul(xi[p], w[p]);
            }
            fr::dit_regs<kP>(xr, xi, t, cols, tw_h);
            if (valid) {
#pragma unroll
                for (int p = 0; p < kP; ++p) {
                    const int r = k0 + (p << cols.lg_t);
                    kre[r * cp + jc] = xr[p];
                    kim[r * cp + jc] = xi[p];
                }
            }
        });
    });
    __syncthreads();
    fr::smem_stages<true, kPow2>(kre, kim, tw_h, cols, Wc, 1, cp, kThreads);
    __syncthreads();  // the write-back's index map differs from the passes'
    prof->mark(fr::kFftCols);
    // neighbouring threads take neighbouring columns: row-contiguous runs
    const Divisor by_wc(Wc);
    for (int u = threadIdx.x; u < H * Wc; u += kThreads) {
        const int r = by_wc.div(u), jc = u - r * Wc;
        const int q = rsp.owner(r);
        const int at = (r - rsp.start(q)) * W + c0 + jc;
        cl.map_shared_rank(bre, team0 + q)[at] = kre[r * cp + jc];
        cl.map_shared_rank(bim, team0 + q)[at] = kim[r * cp + jc];
    }
    prof->mark(fr::kFftCols);
}

// (c) on this CTA's band: the rows back; the coil's result stays there.
template <int kThreads, bool kPow2, class Prof>
static __device__ __noinline__ void rows_back(const SenseSplit& s, Prof* prof) {
    const int H = s.H, W = s.W;
    const int R = Split(H, s.team).size(s.rank % s.team);
    const int th = twiddle_count(H);
    const fr::Tw tw_w{s.tw + 2 * th, s.tw + 2 * th + twiddle_count(W)};
    const fr::Layout rows(W);
    float* const bre = s.bre;
    float* const bim = s.bim;
    fr::with_points(rows.P(), [&](auto pc) {
        constexpr int kP = decltype(pc)::value;
        fr::sublines<kPow2>(rows, R, kThreads, [&](int lr, int k0, int t, bool valid) {
            float xr[kP], xi[kP];
#pragma unroll
            for (int p = 0; p < kP; ++p) {
                xr[p] = xi[p] = 0.f;
                if (valid) {
                    const int i = lr * W + k0 + (p << rows.lg_t);
                    xr[p] = bre[i];
                    xi[p] = bim[i];
                }
            }
            fr::dit_regs<kP>(xr, xi, t, rows, tw_w);
            if (valid) {
#pragma unroll
                for (int p = 0; p < kP; ++p) {
                    const int i = lr * W + k0 + (p << rows.lg_t);
                    bre[i] = xr[p];
                    bim[i] = xi[p];
                }
            }
        });
    });
    __syncthreads();
    fr::smem_stages<true, kPow2>(bre, bim, tw_w, rows, R, W, 1, kThreads);
    prof->mark(fr::kFftRows);
}

}  // namespace split

// The SENSE normal op of (vr, vi) on the split route, handed to finish(i,
// nr, ni) at each pixel i of the fold band; sync(phase) is the caller's
// timed cluster barrier, the fold's time is marked as kFold. The caller
// orders the whole of v and every earlier remote read of the bands before
// the call (a cluster barrier), and puts a cluster barrier after it before
// the bands are written again and before the CTA exits.
template <int kThreads, int kFold, bool kPow2, class Prof, class Sync, class Finish>
__device__ __forceinline__ void sense_normal_split(const SenseSplit& s, const float* vr,
                                                   const float* vi, cg::cluster_group& cl,
                                                   Prof& prof, Sync& sync, Finish finish) {
    const int n = s.H * s.W, k = s.team;
    const int per_round = s.clusters / k;
    const int rounds = ceil_div(s.C, per_round);
    const int team_of = s.rank / k;
    const Split rsp(s.H, k);
    const Divisor by_w(s.W);
    for (int ro = 0; ro < rounds; ++ro) {
        const int c0 = ro * per_round;
        const int c1 = min(s.C, c0 + per_round);
        const int coil = c0 + team_of;
        if (coil < s.C) split::rows_forward<kThreads, kPow2>(s, coil, vr, vi, &prof);
        sync(fftr::kFftRows);  // S1
        if (coil < s.C) split::columns<kThreads, kPow2>(s, &prof);
        sync(fftr::kFftCols);  // S2
        if (coil < s.C) split::rows_back<kThreads, kPow2>(s, &prof);
        sync(fftr::kFftRows);  // S3: the round's results, visible to the cluster
        const bool last = ro + 1 == rounds;
        for (int i = s.p0 + threadIdx.x; i < s.p1; i += kThreads) {
            const int q = rsp.owner(by_w.div(i));  // the team CTA that owns i's row
            const int at = i - rsp.start(q) * s.W;
            float sr = ro == 0 ? 0.f : s.accr[i];
            float si = ro == 0 ? 0.f : s.acci[i];
            for (int c = c0; c < c1; ++c) {
                const int peer = (c - c0) * k + q;
                const float yr = cl.map_shared_rank(s.bre, peer)[at];
                const float yi = cl.map_shared_rank(s.bim, peer)[at];
                const float ca = s.coils_r[static_cast<size_t>(c) * n + i];
                const float cb = s.coils_i[static_cast<size_t>(c) * n + i];
                sr = fadd(fadd(sr, fmul(ca, yr)), fmul(cb, yi));
                si = fsub(fadd(si, fmul(ca, yi)), fmul(cb, yr));
            }
            if (last) {
                finish(i, sr, si);
            } else {
                s.accr[i] = sr;
                s.acci[i] = si;
            }
        }
        prof.mark(kFold);
        if (!last) sync(kFold);  // S4: every remote read before the next round
    }
}

}  // namespace rls
