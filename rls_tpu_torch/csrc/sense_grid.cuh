// The SENSE normal op sum_c conj(C_c) F^H M F C_c v of one slice on a team
// of CTAs that meet in L2: the grid routes of the FISTA-L21-SENSE
// (sense_fused.cu) and SplitBregman (splitbregman_fused.cu) kernels, for
// shapes whose spectrum fits no cluster of 16 CTAs, split or whole (512^2:
// a split CTA of a team of 16 needs 270,384 bytes of shared memory).
//
// One cooperative launch of team x slots CTAs, all resident at once; the
// team of slot s solves slices s, s + slots, ... in turn. CTA j of a team
// owns the image rows Split(H, team) part j (its band) and the spectrum
// columns Split(W, team) part j (its block), for every coil: a side of n
// points split as n / team points a part, one more for the first n % team
// parts (split.cuh). The coils go in rounds of `per_round`: in round ro,
// coil ro per_round + k has the slot's spectrum S_k, H x W complex in
// global memory (L2), row-major. Per round, three passes:
//   (R)  for each coil of the round, the band's rows of C_c v (v: the
//        caller's image, read in the band's rows only), row_lines at a
//        time, loaded into shared memory, the rows forward, stored to S_k;
//   team barrier T1;
//   (C)  for each coil of the round, the block's columns of S_k, col_lines
//        at a time: forward, times the spectral weights (wt), back, stored
//        to S_k;
//   team barrier T2;
//   (R') for each chunk of the band's rows and each coil of the round in
//        coil order, the rows of S_k back, folded into the sum at each
//        pixel, ((acc + a yr) + b yi, (acc + a yi) - b yr), as the other
//        routes fold; then, on the same chunk, (R) of the next round (or
//        the caller's next pass where this was the last round).
// The CTA that owns a pixel's row folds every coil of that pixel, so the
// fold reads nothing another CTA wrote: between rounds the sum waits in
// accr / acci (the band's own pixels, each read back by the thread that
// wrote it), and the last coil hands it to the caller's finish(i, nr, ni).
// Every line runs fft_resident.cuh's stages (the odd stages of
// fft_mixed.cuh, the radix-2 spans >= L in shared memory, the rest in
// registers) on the same twiddle table, every operation rounded on its
// own, so the result is bit for bit the plain version's
// (kernels/_dft_common.py sense_normal) and the other routes'.
//
// What orders each access to a buffer another CTA writes (a team shares
// its slot's spectra only; everything else a CTA reads in this op lies in
// its own band):
//   S_k, the rows of CTA q's band: written by q in (R), read by every CTA
//        in (C)                                     T1 (RAW: every (R)
//        store before any (C) load); T2 (WAR: every (C) load of the round
//        before, whose stores follow them, before q's next (R) stores,
//        which follow T2)
//   S_k, the columns of CTA q's block: written by q in (C), read by every
//        CTA in (R')                                T2 (RAW: every (C)
//        store before any (R') load); T1 (WAR: every (R') load before q's
//        next (C) stores, which follow T1)
//   the caller's next op (or the slot's next slice): its (R) writes only
//        the CTA's own rows, after the CTA's own (R'); its first T1 orders
//        them before any (C)
//   inside a pass: a __syncthreads() after each shared-memory stage that
//        another thread of the CTA reads next, and at the end of each chunk
//        (before the next chunk writes the planes)
// A team barrier is rls::grid::group_sync on the slot's counter. S is read
// through L2 (__ldcg) and written with __stcg: no CTA reads S from its L1.
// Per round two team barriers; an op of R rounds meets 2 R times. The
// Python model of these passes, barriers and the fold, which the CPU tests
// run against the plain versions bit for bit and with each team barrier
// dropped, is tests/test_torch_sense_grid.py (SenseGridModel).
#pragma once

#include <cuda_runtime.h>

#include "dft_common.cuh"
#include "fft_resident.cuh"
#include "group_sync.cuh"
#include "split.cuh"

namespace rls {
namespace sgrid {

namespace fr = fftr;

// the phases of the grid routes' timers (the SplitBregman kernel appends
// its own after kPhases)
enum {
    kSetup, kRowLoads, kRowsBack, kFold, kRowsFwd, kColLoads, kCols, kColStores, kBarrier1,
    kBarrier2, kPhases
};

// The pitch of an n-point line in a grid CTA's shared memory: odd, so that
// a column chunk's load, whose neighbouring threads write neighbouring
// lines, hits distinct banks.
__host__ __device__ inline int pitch(int n) { return n | 1; }

// Shared memory of a grid CTA at H x W whose two planes (re, im) hold
// `plane` floats each, in this order: `head` bytes of the kernel's own
// (the SplitBregman kernel's sums), the twiddles (twiddle_floats(H, W),
// rounded up to 4 floats), the two planes, and the phase timer (`phases`
// int64).
__host__ __device__ inline size_t smem_bytes(int H, int W, size_t plane, size_t head,
                                             int phases) {
    return head + sizeof(float) * (ceil4(twiddle_floats(H, W)) + 2 * plane) +
           sizeof(long long) * phases;
}

// The floats of a plane of a grid CTA of `smem` bytes (smem_bytes
// inverted; 0 where they do not hold the rest).
__host__ __device__ inline size_t plane_floats(int H, int W, size_t smem, size_t head,
                                               int phases) {
    const size_t fixed = smem_bytes(H, W, 0, head, phases);
    return smem < fixed ? 0 : (smem - fixed) / (2 * sizeof(float));
}

// A grid plan: H and W the FFT's, a team of 1 to min(H, W) CTAs, 1 to B
// slots, 1 to C coils a round, chunks of 1 to the largest band's (block's)
// lines, and `smem` bytes whose planes (a whole number of float4) hold a
// chunk of either pass.
inline bool valid_plan(int B, int H, int W, int C, int team, int slots, int per_round,
                       int row_lines, int col_lines, int smem, size_t head, int phases) {
    if (!valid_fft_size(H) || !valid_fft_size(W) || C < 1 || team < 1 || team > H ||
        team > W || slots < 1 || slots > B || per_round < 1 || per_round > C ||
        row_lines < 1 || col_lines < 1 || row_lines > ceil_div(H, team) ||
        col_lines > ceil_div(W, team) || smem < 0 ||
        static_cast<long long>(team) * slots >= (1LL << 31))
        return false;
    const size_t plane = plane_floats(H, W, smem, head, phases);
    return plane % 4 == 0 && smem_bytes(H, W, plane, head, phases) == static_cast<size_t>(smem) &&
           static_cast<size_t>(row_lines) * pitch(W) <= plane &&
           static_cast<size_t>(col_lines) * pitch(H) <= plane;
}

// The grid CTAs of kernel `fn` with `smem` bytes of shared memory that the
// current device holds at once: out[0] a SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] on all of its
// SMs.
inline int occupancy(const void* fn, int threads, int smem, long long* out) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sm = 0, dev = 0, sms = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                                             smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = per_sm;
    out[1] = static_cast<long long>(per_sm) * sms;
    return 0;
}

// One slot's team and this CTA's part of it.
struct SenseGrid {
    const float* coils_r;  // (C, H, W)
    const float* coils_i;
    const float* wt;       // (W, H): the spectral weights transposed
    const float* tw;       // the twiddles in shared memory
    float* re;             // the chunk's planes (shared)
    float* im;
    float2* spec;          // the slot's spectra: per_round of H x W complex
    float* accr;           // the coil sum between rounds (global, the slot's plane)
    float* acci;
    unsigned* ctr;         // the team's barrier counter
    int H, W, C, team, rank, per_round, row_lines, col_lines;
};

// (R) of coil `coil` into spectrum k on the image rows [g0, g0 + lines)
// of the band: C_c v loaded into shared memory (line l at re[l pitch(W)]),
// the rows forward, each point stored to S_k from the registers (a team's
// lanes hold neighbouring points of a row: coalesced).
template <int kThreads, bool kPow2, class Prof>
__device__ __forceinline__ void rows_forward(const SenseGrid& s, int coil, int k, const float* vr,
                                             const float* vi, int g0, int lines, Prof& prof) {
    const int W = s.W, pr = pitch(W);
    const size_t n = static_cast<size_t>(s.H) * W;
    const float* cr = s.coils_r + coil * n;
    const float* ci = s.coils_i + coil * n;
    const fr::Layout rows(W);
    const Divisor by_w(kPow2 ? 1 : W);
    const int th = twiddle_count(s.H);
    const fr::Tw tw_w{s.tw + 2 * th, s.tw + 2 * th + twiddle_count(W)};
    float* const re = s.re;
    float* const im = s.im;
    for (int i = threadIdx.x; i < lines * W; i += kThreads) {
        const int l = kPow2 ? i >> rows.lg_a : by_w.div(i), col = i - l * W;
        const size_t g = static_cast<size_t>(g0) * W + i;
        const float ca = __ldg(cr + g), cb = __ldg(ci + g), a = vr[g], b = vi[g];
        re[l * pr + col] = fsub(fmul(ca, a), fmul(cb, b));
        im[l * pr + col] = fadd(fmul(ca, b), fmul(cb, a));
    }
    __syncthreads();
    fr::smem_stages<false, kPow2>(re, im, tw_w, rows, lines, pr, 1, kThreads);
    float2* const spec = s.spec + k * n;
    fr::with_points(rows.P(), [&](auto pc_) {
        constexpr int kP = decltype(pc_)::value;
        fr::sublines<kPow2>(rows, lines, kThreads, [&](int l, int k0, int tl, bool valid) {
            float xr[kP], xi[kP];
#pragma unroll
            for (int j = 0; j < kP; ++j) {
                xr[j] = xi[j] = 0.f;
                if (valid) {
                    const int at = l * pr + k0 + (j << rows.lg_t);
                    xr[j] = re[at];
                    xi[j] = im[at];
                }
            }
            fr::dif_regs<kP>(xr, xi, tl, rows, tw_w);
            if (valid) {
#pragma unroll
                for (int j = 0; j < kP; ++j)
                    __stcg(spec + static_cast<size_t>(g0 + l) * W + k0 + (j << rows.lg_t),
                           make_float2(xr[j], xi[j]));
            }
        });
    });
    __syncthreads();  // the chunk's shared memory read, before the next chunk writes it
    prof.mark(kRowsFwd);
}

// (R) of round ro's coils on the rows [g0, g0 + lines) of the band.
template <int kThreads, bool kPow2, class Prof>
__device__ __forceinline__ void forward_chunk(const SenseGrid& s, int ro, const float* vr,
                                              const float* vi, int g0, int lines, Prof& prof) {
    const int c0 = ro * s.per_round, c1 = min(s.C, c0 + s.per_round);
    for (int c = c0; c < c1; ++c) rows_forward<kThreads, kPow2>(s, c, c - c0, vr, vi, g0, lines,
                                                                prof);
}

// (R) of the first round on the whole band: the start of an op whose (R)
// the caller did not fuse into its pass before.
template <int kThreads, bool kPow2, class Prof>
__device__ __forceinline__ void forward_band(const SenseGrid& s, const float* vr,
                                             const float* vi, Prof& prof) {
    const Split rsp(s.H, s.team);
    const int r0 = rsp.start(s.rank), R = rsp.size(s.rank);
    for (int l0 = 0; l0 < R; l0 += s.row_lines)
        forward_chunk<kThreads, kPow2>(s, 0, vr, vi, r0 + l0, min(s.row_lines, R - l0), prof);
}

// (C) of spectrum k on the block's columns, col_lines at a time: loaded
// from S_k (a row's segment of the chunk's columns one coalesced load),
// each column forward, times its spectral weights, back, stored to S_k.
template <int kThreads, bool kPow2, class Prof>
__device__ __forceinline__ void columns(const SenseGrid& s, int k, Prof& prof) {
    const int H = s.H, W = s.W, pc = pitch(H);
    const Split csp(W, s.team);
    const int c0 = csp.start(s.rank), Wc = csp.size(s.rank);
    const fr::Layout cols(H);
    const fr::Tw tw_h{s.tw, s.tw + twiddle_count(H)};
    float2* const spec = s.spec + k * static_cast<size_t>(H) * W;
    float* const re = s.re;
    float* const im = s.im;
    for (int j0 = 0; j0 < Wc; j0 += s.col_lines) {
        const int lines = min(s.col_lines, Wc - j0), cc = c0 + j0;
        const Divisor by_lines(lines);
        // neighbouring threads take neighbouring columns of a spectrum row
        for (int u = threadIdx.x; u < lines * H; u += kThreads) {
            const int r = by_lines.div(u), l = u - r * lines;
            const float2 v = __ldcg(spec + static_cast<size_t>(r) * W + cc + l);
            re[l * pc + r] = v.x;
            im[l * pc + r] = v.y;
        }
        __syncthreads();
        prof.mark(kColLoads);
        fr::smem_stages<false, kPow2>(re, im, tw_h, cols, lines, pc, 1, kThreads);
        fr::with_points(cols.P(), [&](auto pc_) {
            constexpr int kP = decltype(pc_)::value;
            fr::sublines<kPow2>(cols, lines, kThreads, [&](int l, int k0, int tl, bool valid) {
                float xr[kP], xi[kP], w[kP];
#pragma unroll
                for (int j = 0; j < kP; ++j) {
                    xr[j] = xi[j] = w[j] = 0.f;
                    const int r = k0 + (j << cols.lg_t);
                    if (valid) {
                        w[j] = __ldg(s.wt + static_cast<size_t>(cc + l) * H + r);
                        xr[j] = re[l * pc + r];
                        xi[j] = im[l * pc + r];
                    }
                }
                fr::dif_regs<kP>(xr, xi, tl, cols, tw_h);
#pragma unroll
                for (int j = 0; j < kP; ++j) {
                    xr[j] = fmul(xr[j], w[j]);
                    xi[j] = fmul(xi[j], w[j]);
                }
                fr::dit_regs<kP>(xr, xi, tl, cols, tw_h);
                if (valid) {
#pragma unroll
                    for (int j = 0; j < kP; ++j) {
                        const int at = l * pc + k0 + (j << cols.lg_t);
                        re[at] = xr[j];
                        im[at] = xi[j];
                    }
                }
            });
        });
        __syncthreads();
        fr::smem_stages<true, kPow2>(re, im, tw_h, cols, lines, pc, 1, kThreads);
        prof.mark(kCols);
        for (int u = threadIdx.x; u < lines * H; u += kThreads) {
            const int r = by_lines.div(u), l = u - r * lines;
            __stcg(spec + static_cast<size_t>(r) * W + cc + l,
                   make_float2(re[l * pc + r], im[l * pc + r]));
        }
        __syncthreads();  // the chunk's shared memory read, before the next chunk's
        prof.mark(kColStores);
    }
}

// (R') of spectrum k on the rows [g0, g0 + lines): loaded from S_k, the
// rows back; the result is left in shared memory (line l at re[l
// pitch(W)]), visible to every thread of the CTA.
template <int kThreads, bool kPow2, class Prof>
__device__ __forceinline__ void rows_back(const SenseGrid& s, int k, int g0, int lines,
                                          Prof& prof) {
    const int W = s.W, pr = pitch(W);
    const fr::Layout rows(W);
    const int th = twiddle_count(s.H);
    const fr::Tw tw_w{s.tw + 2 * th, s.tw + 2 * th + twiddle_count(W)};
    const float2* const spec = s.spec + k * static_cast<size_t>(s.H) * W;
    float* const re = s.re;
    float* const im = s.im;
    fr::with_points(rows.P(), [&](auto pc_) {
        constexpr int kP = decltype(pc_)::value;
        fr::sublines<kPow2>(rows, lines, kThreads, [&](int l, int k0, int tl, bool valid) {
            float xr[kP], xi[kP];
#pragma unroll
            for (int j = 0; j < kP; ++j) {
                xr[j] = xi[j] = 0.f;
                if (valid) {
                    const float2 v =
                        __ldcg(spec + static_cast<size_t>(g0 + l) * W + k0 + (j << rows.lg_t));
                    xr[j] = v.x;
                    xi[j] = v.y;
                }
            }
            prof.mark(kRowLoads);
            fr::dit_regs<kP>(xr, xi, tl, rows, tw_w);
            if (valid) {
#pragma unroll
                for (int j = 0; j < kP; ++j) {
                    const int at = l * pr + k0 + (j << rows.lg_t);
                    re[at] = xr[j];
                    im[at] = xi[j];
                }
            }
        });
    });
    __syncthreads();
    fr::smem_stages<true, kPow2>(re, im, tw_w, rows, lines, pr, 1, kThreads);
    prof.mark(kRowsBack);
}

// The SENSE normal op of v = (vr, vi) on the team, every round of coils,
// handed to finish(i, nr, ni) at each pixel i of the band. The caller has
// run (R) of the first round on its band (forward_band, or fused into its
// own pass before); after the last round's (R') of a chunk, next(g0,
// lines) runs on the same rows (the caller's next (R), or nothing).
// `target` is the CTA's count of the team's barriers so far.
template <int kThreads, bool kPow2, class Prof, class Finish, class Next>
__device__ __forceinline__ void sense_normal_grid(const SenseGrid& s, const float* vr,
                                                  const float* vi, unsigned& target, Prof& prof,
                                                  Finish finish, Next next) {
    const int H = s.H, W = s.W, pr = pitch(W);
    const size_t n = static_cast<size_t>(H) * W;
    const Split rsp(H, s.team);
    const int r0 = rsp.start(s.rank), R = rsp.size(s.rank);
    const int rounds = ceil_div(s.C, s.per_round);
    const fr::Layout rows(W);
    const Divisor by_w(kPow2 ? 1 : W);
    for (int ro = 0; ro < rounds; ++ro) {
        const int c0 = ro * s.per_round, c1 = min(s.C, c0 + s.per_round);
        grid::group_sync(s.ctr, target, s.team);  // T1
        prof.mark(kBarrier1);
        for (int c = c0; c < c1; ++c) columns<kThreads, kPow2>(s, c - c0, prof);
        grid::group_sync(s.ctr, target, s.team);  // T2
        prof.mark(kBarrier2);
        for (int l0 = 0; l0 < R; l0 += s.row_lines) {
            const int lines = min(s.row_lines, R - l0), g0 = r0 + l0;
            for (int c = c0; c < c1; ++c) {
                rows_back<kThreads, kPow2>(s, c - c0, g0, lines, prof);
                const float* cr = s.coils_r + c * n;
                const float* ci = s.coils_i + c * n;
                for (int i = threadIdx.x; i < lines * W; i += kThreads) {
                    const int l = kPow2 ? i >> rows.lg_a : by_w.div(i);
                    const int at = l * pr + i - l * W;
                    const int g = g0 * W + i;
                    const float yr = s.re[at], yi = s.im[at];
                    const float ca = __ldg(cr + g), cb = __ldg(ci + g);
                    float sr = c == 0 ? 0.f : s.accr[g];
                    float si = c == 0 ? 0.f : s.acci[g];
                    sr = fadd(fadd(sr, fmul(ca, yr)), fmul(cb, yi));
                    si = fsub(fadd(si, fmul(ca, yi)), fmul(cb, yr));
                    if (c + 1 == s.C) {
                        finish(g, sr, si);
                    } else {
                        s.accr[g] = sr;
                        s.acci[g] = si;
                    }
                }
                __syncthreads();  // the chunk's planes read, before the next pass writes them
                prof.mark(kFold);
            }
            if (ro + 1 < rounds)
                forward_chunk<kThreads, kPow2>(s, ro + 1, vr, vi, g0, lines, prof);
            else
                next(g0, lines);
        }
    }
}

}  // namespace sgrid
}  // namespace rls
