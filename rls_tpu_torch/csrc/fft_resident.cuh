// A CTA's masked normal op F^H M F of one whole complex plane kept in
// shared memory, with the FFT's stages in registers: the in-kernel FFT of
// the resident SplitBregman route (splitbregman_fused.cu). The resident
// FISTA-L1-DFT route (fista_l1_dft_fused.cu), whose spectrum is split over
// a cluster, runs its passes on the same pieces (Layout, sublines,
// dif_regs / dit_regs, smem_stage, and the butterflies dif_bfly / dit_bfly
// for the stages it fuses with its loads and stores).
//
// It computes what dft_common.cuh computes, stage for stage and operation
// for operation (the same radix-2 DIF forward and DIT inverse butterflies,
// the same twiddle table, every product and sum rounded on its own with
// rls::fmul & co.), so both agree bit for bit with their plain PyTorch twin
// (rls_tpu_torch/kernels/_dft_common.py). Only where each butterfly runs
// differs. dft_common.cuh stages 4096 points at a time through shared
// memory and ends every stage with a barrier (140 barrier-separated phases
// per 128^2 transform pair); here the plane stays in shared memory, row
// major with one float of padding per row (pitch W + 1, so a column read
// by 32 lanes hits 32 banks), and a line's stages run in registers:
//
//   * a line of n points is cut into sub-lines of L = min(n, kLineMax)
//     points; a team of T = min(32, L) lanes holds one sub-line, lane t
//     the points s L + j T + t (j < P = L / T) of sub-line s;
//   * a stage of span m >= T pairs two registers of one lane; a stage of
//     span m < T pairs lane t with lane t ^ m (__shfl_xor_sync), and each
//     lane computes its own output of the butterfly (the lane of the
//     lower point the sum, the other the twiddled difference; for the
//     inverse the upper lane first forms its twiddled product, which the
//     lower lane adds);
//   * stages of span m >= L (lines longer than kLineMax) go through shared
//     memory, a barrier after each, before the register stages of the
//     forward transform and after those of the inverse;
//   * a line shorter than 32 points gives each lane one point and a warp
//     32 / n lines.
// One coil's normal op is then three passes with a barrier after each:
// rows forward (the image loaded from global memory straight into
// registers), columns forward, times the spectral weights, and back (in
// registers, without leaving them), rows back. The result stays in shared
// memory, where the caller folds the coils.
//
// The Python model of this layout, which the CPU tests run against
// _dft_common.fft_dif / ifft_dit for every n from 2 to 1024, is
// tests/test_torch_splitbregman_plan.py (its line_layout mirrors kLineMax,
// and a test reads kLineMax from this file).
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "pgm_tv_common.cuh"

namespace rls {
namespace fftr {

constexpr int kLineMax = 128;  // the longest sub-line a team keeps in registers

// the phases a caller's timer may tell apart (mark(phase))
enum { kFftLoads = 0, kFftRows = 1, kFftCols = 2 };

__device__ __forceinline__ int log2i(int n) { return 31 - __clz(n); }

// The layout of an n-point line pass (see the header).
struct Layout {
    int lg_n, lg_l, lg_t, t_mask, P;
    __device__ explicit Layout(int n) {
        lg_n = log2i(n);
        lg_l = min(lg_n, log2i(kLineMax));
        lg_t = min(lg_l, 5);
        t_mask = (1 << lg_t) - 1;
        P = 1 << (lg_l - lg_t);
    }
    __device__ int T() const { return 1 << lg_t; }
};

// The twiddles of an axis of n points in shared memory: re[k] = cos(2 pi k
// / n), im[k] = -sin(2 pi k / n), k < n / 2.
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
        const int step = ly.lg_n - 1 - lm;
#pragma unroll
        for (int j = 0; j < kP; ++j) {
            if (j & h) continue;
            const int k = (j * T + t) & (m - 1);
            dif_bfly(re[j], im[j], re[j + h], im[j + h], tw.re[k << step], tw.im[k << step]);
        }
    }
    for (int lm = ly.lg_t - 1; lm >= 0; --lm) {  // span m < T: lanes t and t ^ m
        const int m = 1 << lm;
        const int k = t & (m - 1);
        const int step = ly.lg_n - 1 - lm;
        const float wr = tw.re[k << step], wi = tw.im[k << step];
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
        const int step = ly.lg_n - 1 - lm;
        const float wr = tw.re[k << step], wi = -tw.im[k << step];
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
        const int step = ly.lg_n - 1 - lm;
#pragma unroll
        for (int j = 0; j < kP; ++j) {
            if (j & h) continue;
            const int k = (j * T + t) & (m - 1);
            dit_bfly(re[j], im[j], re[j + h], im[j + h], tw.re[k << step], -tw.im[k << step]);
        }
    }
}

// body(line, k0, t, valid) once per team and sub-line of `lines` lines of
// the layout's n points: k0 is the point lane t holds in register 0 (it
// holds k0 + j T in register j). Every lane of a warp makes the same
// number of calls; a lane past the last sub-line gets valid = false, must
// not touch memory, and still takes part in the shuffles.
template <class Body>
__device__ __forceinline__ void sublines(const Layout& ly, int lines, int threads, Body body) {
    const int lg_sub = ly.lg_n - ly.lg_l;
    const int total = lines << lg_sub;
    const int lane = threadIdx.x & 31;
    const int per_warp = 32 >> ly.lg_t;
    const int g = lane >> ly.lg_t;
    const int t = lane & ly.t_mask;
    const int step = (threads >> 5) * per_warp;
    for (int base = (threadIdx.x >> 5) * per_warp; base < total; base += step) {
        const int u = base + g;
        const int k0 = ((u & ((1 << lg_sub) - 1)) << ly.lg_l) + t;
        body(u >> lg_sub, k0, t, u < total);
    }
}

// One stage of span m on `lines` lines of n = 2^lg_n points in shared
// memory, point k of line l at l * ls + k * ps: forward (decimation in
// frequency) or, with kInverse, inverse (decimation in time on the
// conjugate twiddles), as dft_common.cuh's dif_stages / dit_inverse_stages
// compute a stage. No barrier.
template <bool kInverse>
__device__ __forceinline__ void smem_stage(float* re, float* im, Tw tw, int lg_n, int m,
                                           int lines, int ls, int ps, int threads) {
    const int lm = log2i(m);
    const int step = lg_n - 1 - lm;
    const int half = lines << (lg_n - 1);
    for (int u = threadIdx.x; u < half; u += threads) {
        const int line = u >> (lg_n - 1);
        const int j = u & ((1 << (lg_n - 1)) - 1);
        const int k = j & (m - 1);
        const int i0 = line * ls + (((j >> lm) << (lm + 1)) + k) * ps;
        const int i1 = i0 + m * ps;
        float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
        if (kInverse)
            dit_bfly(ar, ai, br, bi, tw.re[k << step], -tw.im[k << step]);
        else
            dif_bfly(ar, ai, br, bi, tw.re[k << step], tw.im[k << step]);
        re[i0] = ar;
        im[i0] = ai;
        re[i1] = br;
        im[i1] = bi;
    }
}

// The shared-memory stages of spans >= L of a pass, each followed by a
// barrier: forward from n/2 down to L, inverse from L up to n/2.
template <bool kInverse>
__device__ __forceinline__ void smem_stages(float* re, float* im, Tw tw, const Layout& ly,
                                            int lines, int ls, int ps, int threads) {
    const int n = 1 << ly.lg_n, L = 1 << ly.lg_l;
    if (kInverse) {
        for (int m = L; m < n; m <<= 1) {
            smem_stage<true>(re, im, tw, ly.lg_n, m, lines, ls, ps, threads);
            __syncthreads();
        }
    } else {
        for (int m = n >> 1; m >= L; m >>= 1) {
            smem_stage<false>(re, im, tw, ly.lg_n, m, lines, ls, ps, threads);
            __syncthreads();
        }
    }
}

// The masked normal op F^H M F of one complex H x W image, pixel i = r W +
// k given by load(i) (a float2), by `threads` threads of the CTA: the
// result is left in shared memory, (re, im)[r (W + 1) + k]. tw: the
// twiddles in shared memory [Re_H, Im_H, Re_W, Im_W]; wt: the spectral
// weights transposed, wt[k H + r] for spectrum row r, column k (global
// memory, read along a column). prof.mark(kFftLoads | kFftRows | kFftCols)
// between the parts. Starts by writing the plane (the caller orders every
// earlier read of it) and ends with a barrier.
template <class Load, class Timer>
__device__ __forceinline__ void normal_resident(Load load, const float* __restrict__ wt,
                                                float* re, float* im, const float* tw, int H,
                                                int W, int threads, Timer& prof) {
    const int ld = W + 1;
    const Tw tw_h{tw, tw + H / 2};
    const Tw tw_w{tw + H, tw + H + W / 2};
    const Layout rows(W), cols(H);
    const bool direct = W <= kLineMax;  // rows need no shared-memory stage

    // rows forward
    if (!direct) {
        for (int i = threadIdx.x; i < H * W; i += threads) {
            const float2 v = load(i);
            const int at = (i >> rows.lg_n) * ld + (i & (W - 1));
            re[at] = v.x;
            im[at] = v.y;
        }
        prof.mark(kFftLoads);
        __syncthreads();
        smem_stages<false>(re, im, tw_w, rows, H, ld, 1, threads);
    }
    with_points(rows.P, [&](auto pc) {
        constexpr int kP = decltype(pc)::value;
        sublines(rows, H, threads, [&](int r, int k0, int t, bool valid) {
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
    smem_stages<false>(re, im, tw_h, cols, W, 1, ld, threads);
    with_points(cols.P, [&](auto pc) {
        constexpr int kP = decltype(pc)::value;
        sublines(cols, W, threads, [&](int c, int k0, int t, bool valid) {
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
    smem_stages<true>(re, im, tw_h, cols, W, 1, ld, threads);
    prof.mark(kFftCols);

    // rows back
    with_points(rows.P, [&](auto pc) {
        constexpr int kP = decltype(pc)::value;
        sublines(rows, H, threads, [&](int r, int k0, int t, bool valid) {
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
    smem_stages<true>(re, im, tw_w, rows, H, ld, 1, threads);
    prof.mark(kFftRows);
}

}  // namespace fftr
}  // namespace rls
