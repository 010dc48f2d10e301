// A CTA's masked normal op F^H M F of one whole complex plane kept in
// shared memory, with the FFT's stages in registers: the in-kernel FFT of
// the resident SplitBregman route (splitbregman_fused.cu). The resident
// FISTA-L1-DFT route (fista_l1_dft_fused.cu), whose spectrum is split over
// a cluster, runs its passes on the same pieces (Layout, sublines,
// dif_regs / dit_regs, smem_stage, and the butterflies dif_bfly / dit_bfly
// for the stages it fuses with its loads and stores).
//
// It computes the stages of dft_common.cuh's FFT (the odd stages of
// fft_mixed.cuh, the radix-2 DIF forward and DIT inverse butterflies, the
// same twiddle table, every product and sum rounded on its own with
// rls::fmul & co.), so every route agrees bit for bit with their plain
// PyTorch twin (rls_tpu_torch/kernels/_dft_common.py). Only where each
// butterfly runs differs: here the plane stays in shared memory, row
// major with one float of padding per row (pitch W + 1, so a column read
// by 32 lanes hits 32 banks), and a line's stages run in registers:
//
//   * a line of n = r 2^a points (r odd) runs its odd stages (fft_mixed.cuh)
//     in shared memory, a barrier after each, before the radix-2 stages of
//     the forward transform and after those of the inverse; the radix-2
//     stages then act on r runs of 2^a points;
//   * a line is cut into sub-lines of L = min(2^a, kLineMax) points; a team
//     of T = min(32, L) lanes holds one sub-line, lane t the points s L +
//     j T + t (j < P = L / T) of sub-line s;
//   * a stage of span m >= T pairs two registers of one lane; a stage of
//     span m < T pairs lane t with lane t ^ m (__shfl_xor_sync), and each
//     lane computes its own output of the butterfly (the lane of the
//     lower point the sum, the other the twiddled difference; for the
//     inverse the upper lane first forms its twiddled product, which the
//     lower lane adds);
//   * radix-2 stages of span m >= L (runs longer than kLineMax) go through
//     shared memory, a barrier after each, between the odd stages and the
//     register stages;
//   * a run shorter than 32 points gives each lane one point and a warp
//     32 / L sub-lines (an odd n: one point per lane and no register stage).
// One coil's normal op is then three passes with a barrier after each:
// rows forward (the image loaded from global memory straight into
// registers), columns forward, times the spectral weights, and back (in
// registers, without leaving them), rows back. The result stays in shared
// memory, where the caller folds the coils.
//
// The Python model of this layout, which the CPU tests run against
// _dft_common.fft_dif / ifft_dit at every power of two from 2 to 1024 and at
// sizes with odd factors, is
// tests/test_torch_splitbregman_plan.py (its line_layout mirrors kLineMax,
// and a test reads kLineMax from this file).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "fft_mixed.cuh"
#include "pgm_tv_common.cuh"

namespace rls {
namespace fftr {

constexpr int kLineMax = 128;  // the longest sub-line a team keeps in registers

// the phases a caller's timer may tell apart (mark(phase))
enum { kFftLoads = 0, kFftRows = 1, kFftCols = 2 };

__device__ __forceinline__ int log2i(int n) { return 31 - __clz(n); }

// The layout of an n-point line pass (see the header): n = r 2^lg_a,
// sub-lines of 2^lg_l points, `subs` of them per line.
//
// The passes below take kPow2 = (n is a power of two): its code divides by
// shifts, as the radix-2 FFT did before the odd stages, while sizes with
// odd factors divide by a Divisor (fft_mixed.cuh) and run the odd stages;
// a kernel is instantiated for both and the host picks one by H and W.
struct Layout {
    int n, lg_a, lg_l, lg_t;  // the rest is derived where it is used: fewer live registers
    __device__ explicit Layout(int n_) {
        n = n_;
        lg_a = __ffs(n) - 1;
        lg_l = min(lg_a, log2i(kLineMax));
        lg_t = min(lg_l, 5);
    }
    __device__ int T() const { return 1 << lg_t; }
    __device__ int t_mask() const { return (1 << lg_t) - 1; }
    __device__ int P() const { return 1 << (lg_l - lg_t); }
    __device__ int subs() const { return n >> lg_l; }
    // the twiddle stride n / (2 m) of a radix-2 stage of span m = 2^lm
    __device__ int step(int lm) const { return n >> (lm + 1); }
    // a line is one sub-line: no shared-memory stage
    __device__ bool one_subline() const { return n == 1 << lg_l; }
};

// The twiddles of an axis of n points in shared memory: re[k] = cos(2 pi k
// / n), im[k] = -sin(2 pi k / n), k < twiddle_count(n).
struct Tw {
    const float* re;
    const float* im;
};

// f(std::integral_constant<int, P>) for the layout's points per lane.
template <class F>
__device__ __forceinline__ void with_points(int P, F f) {
    if (P == 4)
        f(std::integral_constant<int, 4>{});
    else if (P == 2)
        f(std::integral_constant<int, 2>{});
    else
        f(std::integral_constant<int, 1>{});
}

// One forward butterfly (decimation in frequency) on a = (ar, ai), b = (br,
// bi) with twiddle w: a + b, (a - b) w, each operation rounded on its own.
__device__ __forceinline__ void dif_bfly(float& ar, float& ai, float& br, float& bi, float wr,
                                         float wi) {
    const float dr = fsub(ar, br), di = fsub(ai, bi);
    ar = fadd(ar, br);
    ai = fadd(ai, bi);
    br = fsub(fmul(dr, wr), fmul(di, wi));
    bi = fadd(fmul(dr, wi), fmul(di, wr));
}

// One inverse butterfly (decimation in time) with the conjugate twiddle
// (wr, wi): a + b w, a - b w.
__device__ __forceinline__ void dit_bfly(float& ar, float& ai, float& br, float& bi, float wr,
                                         float wi) {
    const float tr = fsub(fmul(br, wr), fmul(bi, wi));
    const float ti = fadd(fmul(br, wi), fmul(bi, wr));
    br = fsub(ar, tr);
    bi = fsub(ai, ti);
    ar = fadd(ar, tr);
    ai = fadd(ai, ti);
}

// The forward stages of spans L/2 .. 1 on a team's sub-line in registers:
// lane t holds points j T + t of it in re[j], im[j].
template <int kP>
__device__ __forceinline__ void dif_regs(float (&re)[kP], float (&im)[kP], int t,
                                         const Layout& ly, Tw tw) {
    const int T = ly.T();
#pragma unroll
    for (int h = kP / 2; h >= 1; h >>= 1) {  // span h T: two registers of a lane
        const int lm = log2i(h) + ly.lg_t;
        const int m = 1 << lm;
        const int step = ly.step(lm);
#pragma unroll
        for (int j = 0; j < kP; ++j) {
            if (j & h) continue;
            const int k = (j * T + t) & (m - 1);
            dif_bfly(re[j], im[j], re[j + h], im[j + h], tw.re[k * step], tw.im[k * step]);
        }
    }
    for (int lm = ly.lg_t - 1; lm >= 0; --lm) {  // span m < T: lanes t and t ^ m
        const int m = 1 << lm;
        const int k = t & (m - 1);
        const int step = ly.step(lm);
        const float wr = tw.re[k * step], wi = tw.im[k * step];
        const bool upper = t & m;
#pragma unroll
        for (int j = 0; j < kP; ++j) {
            const float pr = __shfl_xor_sync(0xffffffffu, re[j], m);
            const float pi = __shfl_xor_sync(0xffffffffu, im[j], m);
            if (upper) {  // (a - b) w, a the partner's
                const float dr = fsub(pr, re[j]), di = fsub(pi, im[j]);
                re[j] = fsub(fmul(dr, wr), fmul(di, wi));
                im[j] = fadd(fmul(dr, wi), fmul(di, wr));
            } else {  // a + b
                re[j] = fadd(re[j], pr);
                im[j] = fadd(im[j], pi);
            }
        }
    }
}

// The inverse stages of spans 1 .. L/2 (decimation in time, conjugate
// twiddles) on a team's sub-line in registers.
template <int kP>
__device__ __forceinline__ void dit_regs(float (&re)[kP], float (&im)[kP], int t,
                                         const Layout& ly, Tw tw) {
    const int T = ly.T();
    for (int lm = 0; lm < ly.lg_t; ++lm) {  // span m < T: lanes t and t ^ m
        const int m = 1 << lm;
        const int k = t & (m - 1);
        const int step = ly.step(lm);
        const float wr = tw.re[k * step], wi = -tw.im[k * step];
        const bool upper = t & m;
#pragma unroll
        for (int j = 0; j < kP; ++j) {
            // the upper lane sends b w, the lower one a
            float sr = re[j], si = im[j];
            if (upper) {
                sr = fsub(fmul(re[j], wr), fmul(im[j], wi));
                si = fadd(fmul(re[j], wi), fmul(im[j], wr));
            }
            const float pr = __shfl_xor_sync(0xffffffffu, sr, m);
            const float pi = __shfl_xor_sync(0xffffffffu, si, m);
            if (upper) {  // a - b w
                re[j] = fsub(pr, sr);
                im[j] = fsub(pi, si);
            } else {  // a + b w
                re[j] = fadd(re[j], pr);
                im[j] = fadd(im[j], pi);
            }
        }
    }
#pragma unroll
    for (int h = 1; h < kP; h <<= 1) {  // span h T: two registers of a lane
        const int lm = log2i(h) + ly.lg_t;
        const int m = 1 << lm;
        const int step = ly.step(lm);
#pragma unroll
        for (int j = 0; j < kP; ++j) {
            if (j & h) continue;
            const int k = (j * T + t) & (m - 1);
            dit_bfly(re[j], im[j], re[j + h], im[j + h], tw.re[k * step], -tw.im[k * step]);
        }
    }
}

// body(line, k0, t, valid) once per team and sub-line of `lines` lines of
// the layout's n points: k0 is the point lane t holds in register 0 (it
// holds k0 + j T in register j). Every lane of a warp makes the same
// number of calls; a lane past the last sub-line gets valid = false, must
// not touch memory, and still takes part in the shuffles.
template <bool kPow2, class Body>
__device__ __forceinline__ void sublines(const Layout& ly, int lines, int threads, Body body) {
    const int subs = ly.subs();
    const int total = lines * subs;
    const int lane = threadIdx.x & 31;
    const int per_warp = 32 >> ly.lg_t;
    const int g = lane >> ly.lg_t;
    const int t = lane & ly.t_mask();
    const int step = (threads >> 5) * per_warp;
    const int lg_sub = ly.lg_a - ly.lg_l;  // at a power of two, subs = 2^lg_sub
    const Divisor by_subs(kPow2 ? 1 : subs);  // a constant where kPow2 holds
    for (int base = (threadIdx.x >> 5) * per_warp; base < total; base += step) {
        const int u = base + g;
        const int line = kPow2 ? u >> lg_sub : by_subs.div(u);
        const int sub = kPow2 ? u & ((1 << lg_sub) - 1) : u - line * subs;
        body(line, (sub << ly.lg_l) + t, t, u < total);
    }
}

// One radix-2 stage of span m (2 m dividing n) on `lines` lines of the
// layout's n points in shared memory, point k of line l at l * ls + k * ps:
// forward (decimation in frequency) or, with kInverse, inverse (decimation
// in time on the conjugate twiddles), as the plain version's fft_dif /
// ifft_dit compute a stage. No barrier.
template <bool kInverse, bool kPow2>
__device__ __forceinline__ void smem_stage(float* re, float* im, Tw tw, const Layout& ly, int m,
                                           int lines, int ls, int ps, int threads) {
    const int lm = log2i(m);
    const int step = ly.n >> (lm + 1);
    const int hn = ly.n >> 1;
    const int half = lines * hn;
    const Divisor by_half(kPow2 ? 1 : hn);
    for (int u = threadIdx.x; u < half; u += threads) {
        const int line = kPow2 ? u >> (ly.lg_a - 1) : by_half.div(u);
        const int j = kPow2 ? u & (hn - 1) : u - line * hn;
        const int k = j & (m - 1);
        const int i0 = line * ls + (((j >> lm) << (lm + 1)) + k) * ps;
        const int i1 = i0 + m * ps;
        float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
        if (kInverse)
            dit_bfly(ar, ai, br, bi, tw.re[k * step], -tw.im[k * step]);
        else
            dif_bfly(ar, ai, br, bi, tw.re[k * step], tw.im[k * step]);
        re[i0] = ar;
        im[i0] = ai;
        re[i1] = br;
        im[i1] = bi;
    }
}

// The shared-memory stages of a pass, each followed by a barrier: forward,
// the odd stages, then the radix-2 spans 2^(a-1) down to L; inverse, the
// radix-2 spans L up to 2^(a-1), then the odd stages.
template <bool kInverse, bool kPow2>
__device__ __forceinline__ void smem_stages(float* re, float* im, Tw tw, const Layout& ly,
                                            int lines, int ls, int ps, int threads) {
    const int na = 1 << ly.lg_a, L = 1 << ly.lg_l;
    if (kInverse) {
        for (int m = L; m < na; m <<= 1) {
            smem_stage<true, kPow2>(re, im, tw, ly, m, lines, ls, ps, threads);
            __syncthreads();
        }
        if constexpr (!kPow2) odd_stages<true>(re, im, tw.re, tw.im, ly.n, lines, ls, ps, threads);
    } else {
        if constexpr (!kPow2) odd_stages<false>(re, im, tw.re, tw.im, ly.n, lines, ls, ps, threads);
        for (int m = na >> 1; m >= L; m >>= 1) {
            smem_stage<false, kPow2>(re, im, tw, ly, m, lines, ls, ps, threads);
            __syncthreads();
        }
    }
}

// The masked normal op F^H M F of one complex H x W image, pixel i = r W +
// k given by load(i) (a float2), by `threads` threads of the CTA: the
// result is left in shared memory, (re, im)[r (W + 1) + k]. tw: the
// twiddles in shared memory [Re_H, Im_H, Re_W, Im_W] (twiddle_count(H)
// and twiddle_count(W) floats each); wt: the spectral
// weights transposed, wt[k H + r] for spectrum row r, column k (global
// memory, read along a column). prof.mark(kFftLoads | kFftRows | kFftCols)
// between the parts. Starts by writing the plane (the caller orders every
// earlier read of it) and ends with a barrier.
template <bool kPow2, class Load, class Timer>
__device__ __forceinline__ void normal_resident(Load load, const float* __restrict__ wt,
                                                float* re, float* im, const float* tw, int H,
                                                int W, int threads, Timer& prof) {
    const int ld = W + 1;
    const int th = twiddle_count(H), twc = twiddle_count(W);
    const Tw tw_h{tw, tw + th};
    const Tw tw_w{tw + 2 * th, tw + 2 * th + twc};
    const Layout rows(W), cols(H);
    const bool direct = rows.one_subline();  // rows need no shared-memory stage

    // rows forward
    if (!direct) {
        const Divisor by_w(kPow2 ? 1 : W);
        for (int i = threadIdx.x; i < H * W; i += threads) {
            const float2 v = load(i);
            const int at = i + (kPow2 ? i >> rows.lg_a : by_w.div(i));  // row i / W, pitch W + 1
            re[at] = v.x;
            im[at] = v.y;
        }
        prof.mark(kFftLoads);
        __syncthreads();
        smem_stages<false, kPow2>(re, im, tw_w, rows, H, ld, 1, threads);
    }
    with_points(rows.P(), [&](auto pc) {
        constexpr int kP = decltype(pc)::value;
        sublines<kPow2>(rows, H, threads, [&](int r, int k0, int t, bool valid) {
            float vr[kP], vi[kP];
#pragma unroll
            for (int j = 0; j < kP; ++j) {
                vr[j] = vi[j] = 0.f;
                const int k = k0 + (j << rows.lg_t);
                if (valid && direct) {
                    const float2 v = load(r * W + k);
                    vr[j] = v.x;
                    vi[j] = v.y;
                } else if (valid) {
                    vr[j] = re[r * ld + k];
                    vi[j] = im[r * ld + k];
                }
            }
            prof.mark(kFftLoads);
            dif_regs<kP>(vr, vi, t, rows, tw_w);
            if (valid) {
#pragma unroll
                for (int j = 0; j < kP; ++j) {
                    const int at = r * ld + k0 + (j << rows.lg_t);
                    re[at] = vr[j];
                    im[at] = vi[j];
                }
            }
            prof.mark(kFftRows);
        });
    });
    __syncthreads();
    prof.mark(kFftRows);

    // columns: forward, the weights, back
    smem_stages<false, kPow2>(re, im, tw_h, cols, W, 1, ld, threads);
    with_points(cols.P(), [&](auto pc) {
        constexpr int kP = decltype(pc)::value;
        sublines<kPow2>(cols, W, threads, [&](int c, int k0, int t, bool valid) {
            float vr[kP], vi[kP], w[kP];
#pragma unroll
            for (int j = 0; j < kP; ++j) {
                vr[j] = vi[j] = w[j] = 0.f;
                const int k = k0 + (j << cols.lg_t);
                if (valid) {
                    w[j] = wt[c * H + k];
                    vr[j] = re[k * ld + c];
                    vi[j] = im[k * ld + c];
                }
            }
            dif_regs<kP>(vr, vi, t, cols, tw_h);
#pragma unroll
            for (int j = 0; j < kP; ++j) {
                vr[j] = fmul(vr[j], w[j]);
                vi[j] = fmul(vi[j], w[j]);
            }
            dit_regs<kP>(vr, vi, t, cols, tw_h);
            if (valid) {
#pragma unroll
                for (int j = 0; j < kP; ++j) {
                    const int at = (k0 + (j << cols.lg_t)) * ld + c;
                    re[at] = vr[j];
                    im[at] = vi[j];
                }
            }
        });
    });
    __syncthreads();
    smem_stages<true, kPow2>(re, im, tw_h, cols, W, 1, ld, threads);
    prof.mark(kFftCols);

    // rows back
    with_points(rows.P(), [&](auto pc) {
        constexpr int kP = decltype(pc)::value;
        sublines<kPow2>(rows, H, threads, [&](int r, int k0, int t, bool valid) {
            float vr[kP], vi[kP];
#pragma unroll
            for (int j = 0; j < kP; ++j) {
                vr[j] = vi[j] = 0.f;
                if (valid) {
                    const int at = r * ld + k0 + (j << rows.lg_t);
                    vr[j] = re[at];
                    vi[j] = im[at];
                }
            }
            dit_regs<kP>(vr, vi, t, rows, tw_w);
            if (valid) {
#pragma unroll
                for (int j = 0; j < kP; ++j) {
                    const int at = r * ld + k0 + (j << rows.lg_t);
                    re[at] = vr[j];
                    im[at] = vi[j];
                }
            }
        });
    });
    __syncthreads();
    smem_stages<true, kPow2>(re, im, tw_w, rows, H, ld, 1, threads);
    prof.mark(kFftRows);
}

}  // namespace fftr
}  // namespace rls
