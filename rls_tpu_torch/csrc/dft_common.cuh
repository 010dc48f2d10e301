// The in-kernel 2-D FFT shared by the compressed-sensing and SENSE kernels
// (fista_l1_dft_fused.cu, sense_fused.cu, splitbregman_fused.cu): the masked
// normal op F^H M F of one problem's plane, computed by one CTA.
//
// Counterpart of make_split_dft / make_split_dft3 / make_sense_normal
// (rls_tpu/kernels/_fgp_common.py:128-300). The TPU kernels evaluate the
// unitary DFT as dense matrix sandwiches F X F^T with bf16 hi/lo
// compensation (that runtime had no FFT and no complex dtype, and its matrix
// unit rounds its inputs to bf16): O(N) operations per point. Here it is a
// radix-2 FFT, O(log N) per point, whose plain PyTorch twin is
// rls_tpu_torch/kernels/_dft_common.py; the two follow the same stages with
// the same separately rounded operations (fmul / fadd / fsub: nvcc must not
// contract a butterfly into an FMA) and read the same twiddle table, so they
// agree bit for bit:
//   * rows, then columns forward by decimation in frequency (natural order
//     in, bit-reversed out, no permutation);
//   * the spectral weights: the mask in that bit-reversed order times the
//     unitary scale 1 / (H W), a power of two;
//   * columns, then rows back by decimation in time on the conjugate
//     twiddles (bit-reversed in, natural out).
// The column pass keeps a column through its forward transform, the weights
// and its inverse in shared memory, so a normal op makes three passes over
// the plane in global memory: rows forward, columns, rows back.
//
// A pass stages up to kFftChunk points (whole lines) through shared memory;
// each line is padded by one float so that a column load, where neighbouring
// threads take neighbouring lines, hits distinct banks. H and W are powers of
// two from 2 to kFftMax (the wrapper checks).
#pragma once

#include <cuda_runtime.h>

#include "pgm_tv_common.cuh"

namespace rls {

constexpr int kFftChunk = 4096;  // points of a plane staged at once
constexpr int kFftMaxLines = 256;
constexpr int kFftMax = 1024;  // the largest H or W
// floats per shared array: lines x (n + 1) at most, over every n
constexpr int kFftSmem = 4352;

// An axis the in-kernel FFT takes: a power of two from 2 to kFftMax.
inline bool valid_fft_size(int n) { return n >= 2 && n <= kFftMax && (n & (n - 1)) == 0; }

// n floats rounded up to a multiple of 4: the arrays a kernel lays out in
// its dynamic shared memory stay 16-byte aligned.
__host__ __device__ inline size_t ceil4(size_t n) { return (n + 3) / 4 * 4; }

struct FftShared {
    float re[kFftSmem];
    float im[kFftSmem];
    float tw[2 * kFftMax];  // Re, Im of the H table, then of the W table
};

__device__ __forceinline__ int ilog2(int n) { return 31 - __clz(n); }

// Twiddles of one axis: re[k] = cos(2 pi k / n), im[k] = -sin(2 pi k / n).
struct Twiddles {
    const float* re;
    const float* im;
};

// Load the (H + W)-float table [Re_H, Im_H, Re_W, Im_W] into shared memory;
// the caller synchronises.
__device__ __forceinline__ void load_twiddles(FftShared& s, const float* tw, int H, int W) {
    for (int k = threadIdx.x; k < H + W; k += blockDim.x) s.tw[k] = tw[k];
}

__device__ __forceinline__ Twiddles tw_h(const FftShared& s, int H) {
    return {s.tw, s.tw + H / 2};
}

__device__ __forceinline__ Twiddles tw_w(const FftShared& s, int H, int W) {
    return {s.tw + H, s.tw + H + W / 2};
}

// Lines of an n-point pass staged at once, out of `total` lines.
__device__ __forceinline__ int chunk_lines(int n, int total) {
    return min(min(kFftChunk / n, kFftMaxLines), total);
}

// The forward stages (decimation in frequency) on `lines` lines of n points,
// line l at re/im[l (n + 1) + k]. Ends with a barrier.
__device__ __forceinline__ void dif_stages(float* re, float* im, Twiddles tw, int n, int lines) {
    const int lg = ilog2(n);
    const int ld = n + 1;
    const int half = lines << (lg - 1);
    for (int lm = lg - 1; lm >= 0; --lm) {  // span m = 2^lm
        const int m = 1 << lm;
        const int step = lg - 1 - lm;  // twiddle stride n / (2m)
        for (int t = threadIdx.x; t < half; t += blockDim.x) {
            const int line = t >> (lg - 1);
            const int j = t & ((n >> 1) - 1);
            const int k = j & (m - 1);
            const int i0 = line * ld + ((j >> lm) << (lm + 1)) + k;
            const int i1 = i0 + m;
            const float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
            const float wr = tw.re[k << step], wi = tw.im[k << step];
            const float dr = fsub(ar, br), di = fsub(ai, bi);
            re[i0] = fadd(ar, br);
            im[i0] = fadd(ai, bi);
            re[i1] = fsub(fmul(dr, wr), fmul(di, wi));
            im[i1] = fadd(fmul(dr, wi), fmul(di, wr));
        }
        __syncthreads();
    }
}

// The inverse stages (decimation in time, conjugate twiddles, unnormalized).
// Ends with a barrier.
__device__ __forceinline__ void dit_inverse_stages(float* re, float* im, Twiddles tw, int n,
                                                   int lines) {
    const int lg = ilog2(n);
    const int ld = n + 1;
    const int half = lines << (lg - 1);
    for (int lm = 0; lm < lg; ++lm) {
        const int m = 1 << lm;
        const int step = lg - 1 - lm;
        for (int t = threadIdx.x; t < half; t += blockDim.x) {
            const int line = t >> (lg - 1);
            const int j = t & ((n >> 1) - 1);
            const int k = j & (m - 1);
            const int i0 = line * ld + ((j >> lm) << (lm + 1)) + k;
            const int i1 = i0 + m;
            const float ar = re[i0], ai = im[i0], br = re[i1], bi = im[i1];
            const float wr = tw.re[k << step], wi = -tw.im[k << step];
            const float tr = fsub(fmul(br, wr), fmul(bi, wi));
            const float ti = fadd(fmul(br, wi), fmul(bi, wr));
            re[i0] = fadd(ar, tr);
            im[i0] = fadd(ai, ti);
            re[i1] = fsub(ar, tr);
            im[i1] = fsub(ai, ti);
        }
        __syncthreads();
    }
}

// The forward row pass: pixel i's complex value comes from load(i) (a
// float2), the rows' transforms go to (kr, ki). Ends with a barrier.
template <class Load>
__device__ __forceinline__ void rows_forward(Load load, float* kr, float* ki, FftShared& s,
                                             int H, int W) {
    const int L = chunk_lines(W, H);
    const int lw = ilog2(W);
    const Twiddles tw = tw_w(s, H, W);
    for (int r0 = 0; r0 < H; r0 += L) {
        const int base = r0 * W;
        for (int t = threadIdx.x; t < L * W; t += blockDim.x) {
            const float2 v = load(base + t);
            const int at = (t >> lw) * (W + 1) + (t & (W - 1));
            s.re[at] = v.x;
            s.im[at] = v.y;
        }
        __syncthreads();
        dif_stages(s.re, s.im, tw, W, L);
        for (int t = threadIdx.x; t < L * W; t += blockDim.x) {
            const int at = (t >> lw) * (W + 1) + (t & (W - 1));
            kr[base + t] = s.re[at];
            ki[base + t] = s.im[at];
        }
        __syncthreads();
    }
}

// The column pass: each column forward, times its spectral weights (the
// bit-reversed mask times 1 / (H W)), and back, in place on (kr, ki). Ends
// with a barrier.
__device__ __forceinline__ void cols_weighted(float* kr, float* ki, const float* weights,
                                              FftShared& s, int H, int W) {
    const int L = chunk_lines(H, W);
    const int ll = ilog2(L);
    const Twiddles tw = tw_h(s, H);
    for (int c0 = 0; c0 < W; c0 += L) {
        // neighbouring threads take neighbouring columns of one row
        for (int t = threadIdx.x; t < L * H; t += blockDim.x) {
            const int line = t & (L - 1);
            const int k = t >> ll;
            const int g = k * W + c0 + line;
            s.re[line * (H + 1) + k] = kr[g];
            s.im[line * (H + 1) + k] = ki[g];
        }
        __syncthreads();
        dif_stages(s.re, s.im, tw, H, L);
        for (int t = threadIdx.x; t < L * H; t += blockDim.x) {
            const int line = t & (L - 1);
            const int k = t >> ll;
            const float w = weights[k * W + c0 + line];
            const int at = line * (H + 1) + k;
            s.re[at] = fmul(s.re[at], w);
            s.im[at] = fmul(s.im[at], w);
        }
        __syncthreads();
        dit_inverse_stages(s.re, s.im, tw, H, L);
        for (int t = threadIdx.x; t < L * H; t += blockDim.x) {
            const int line = t & (L - 1);
            const int k = t >> ll;
            const int g = k * W + c0 + line;
            kr[g] = s.re[line * (H + 1) + k];
            ki[g] = s.im[line * (H + 1) + k];
        }
        __syncthreads();
    }
}

// The inverse row pass: the rows of (kr, ki) back to the image, handed to
// store(i, re, im) pixel by pixel. Each pixel is stored by exactly one
// thread. Ends with a barrier.
template <class Store>
__device__ __forceinline__ void rows_inverse(const float* kr, const float* ki, Store store,
                                             FftShared& s, int H, int W) {
    const int L = chunk_lines(W, H);
    const int lw = ilog2(W);
    const Twiddles tw = tw_w(s, H, W);
    for (int r0 = 0; r0 < H; r0 += L) {
        const int base = r0 * W;
        for (int t = threadIdx.x; t < L * W; t += blockDim.x) {
            const int at = (t >> lw) * (W + 1) + (t & (W - 1));
            s.re[at] = kr[base + t];
            s.im[at] = ki[base + t];
        }
        __syncthreads();
        dit_inverse_stages(s.re, s.im, tw, W, L);
        for (int t = threadIdx.x; t < L * W; t += blockDim.x) {
            const int at = (t >> lw) * (W + 1) + (t & (W - 1));
            store(base + t, s.re[at], s.im[at]);
        }
        __syncthreads();
    }
}

// The masked normal op F^H M F of the complex image load(i), handed to
// store(i, re, im): three passes, (kr, ki) the spectrum's scratch planes.
template <class Load, class Store>
__device__ __forceinline__ void masked_normal(Load load, Store store, float* kr, float* ki,
                                              const float* weights, FftShared& s, int H, int W) {
    rows_forward(load, kr, ki, s, H, W);
    cols_weighted(kr, ki, weights, s, H, W);
    rows_inverse(kr, ki, store, s, H, W);
}

// The SENSE normal op sum_c conj(C_c) F^H M F C_c v of (vr, vi), coil by coil
// in order c = 0 .. C-1, accumulated as make_sense_normal sums
// ((acc + cr vr) + ci vi, (acc + cr vi) - ci vr) in (accr, acci); the last
// coil hands the sum to finish(i, nr, ni) instead of storing it.
template <class Finish>
__device__ __forceinline__ void sense_normal(const float* vr, const float* vi,
                                             const float* coils_r, const float* coils_i, int C,
                                             float* kr, float* ki, float* accr, float* acci,
                                             const float* weights, Finish finish, FftShared& s,
                                             int H, int W) {
    const int n = H * W;
    for (int c = 0; c < C; ++c) {
        const float* cr = coils_r + static_cast<size_t>(c) * n;
        const float* ci = coils_i + static_cast<size_t>(c) * n;
        auto load = [&](int i) {
            const float a = cr[i], b = ci[i], xr = vr[i], xi = vi[i];
            return make_float2(fsub(fmul(a, xr), fmul(b, xi)), fadd(fmul(a, xi), fmul(b, xr)));
        };
        auto store = [&](int i, float yr, float yi) {
            const float a = cr[i], b = ci[i];
            const float sr = fadd(fadd(c == 0 ? 0.f : accr[i], fmul(a, yr)), fmul(b, yi));
            const float si = fsub(fadd(c == 0 ? 0.f : acci[i], fmul(a, yi)), fmul(b, yr));
            if (c == C - 1) {
                finish(i, sr, si);
            } else {
                accr[i] = sr;
                acci[i] = si;
            }
        };
        masked_normal(load, store, kr, ki, weights, s, H, W);
    }
}

}  // namespace rls
