// The odd-radix stages of the in-kernel FFT, which every layout of its
// lines runs (fft_resident.cuh's, in shared memory; the grid routes' chunks
// of lines, fista_l1_dft_fused.cu and sense_grid.cuh): an axis of n points, n = p_1 ... p_k 2^a
// with the odd primes ascending, runs the stages of radix p_1, ..., p_k
// before its radix-2 stages in the forward transform (decimation in
// frequency), and after them, in reverse order, in the inverse (decimation
// in time on the conjugate twiddles). After the odd stages a line is
// n / 2^a runs of 2^a contiguous points, on which the radix-2 stages run as
// they do at a power of two, only with the twiddle stride n / (2 m).
//
// An odd stage of radix p on blocks of nb points (span m = nb / p) takes,
// for each block and k < m, the p points k + j m (j < p):
//   forward: output s = x_0 + sum_{j >= 1} x_j w_p^{js}, summed in j order,
//            then times w_nb^{ks} for s >= 1, into point k + s m;
//   inverse: each point k + s m (s >= 1) times conj(w_nb^{ks}) in place,
//            then output j = z_0 + sum_{s >= 1} z_s conj(w_p^{js}), summed in
//            s order, into point k + j m.
// Every product and sum is rounded on its own (fmul / fadd / fsub), as in
// the plain version (rls_tpu_torch/kernels/_dft_common.py _odd_stage), with
// which it agrees bit for bit. A p-point DFT costs p complex products per
// output: a large prime (97, 1021) is slow, and stays so until it is
// redesigned.
//
// The twiddles: the table of an n-point axis holds exp(-2 pi i t / n) for
// t < twiddle_count(n) (t < n / 2 at a power of two, t <= n / 2 otherwise),
// computed in float64 on the host and rounded once; an entry t > n / 2 is
// read as the conjugate of entry n - t (an exact negation), and the
// p-point constants w_p^e are the entries e n / p.
#pragma once

#include <cuda_runtime.h>

#include "pgm_tv_common.cuh"

namespace rls {

// Entries per plane (re or im) of an n-point axis's twiddle table
// (kernels/_dft_common.py twiddle_count).
__host__ __device__ inline int twiddle_count(int n) {
    return (n & (n - 1)) == 0 ? n / 2 : n / 2 + 1;
}

// Floats of the kernels' twiddle argument [Re_H, Im_H, Re_W, Im_W].
__host__ __device__ inline int twiddle_floats(int H, int W) {
    return 2 * (twiddle_count(H) + twiddle_count(W));
}

// x / d for 0 <= x < 2^31 and a fixed 1 <= d <= 2^20 by a multiply and a
// shift, with m = ceil(2^(31 + s) / d) and s = ceil(log2 d): exact, because
// x (m d - 2^(31 + s)) < 2^31 d <= 2^(31 + s); at a power of two d = 2^s it
// is x >> s. The mixed-radix index maps divide by sizes known only at run
// time, where a hardware division costs some twenty instructions.
struct Divisor {
    int d, k;
    unsigned int m;
    __device__ explicit Divisor(int d_) : d(d_) {
        const int s = d_ > 1 ? 32 - __clz(d_ - 1) : 0;
        k = 31 + s;
        m = static_cast<unsigned int>(ceil(ldexp(1.0, k) / d_));
    }
    __device__ __forceinline__ int div(int x) const {
        return static_cast<int>((static_cast<unsigned long long>(static_cast<unsigned int>(x)) * m) >>
                                k);
    }
};

// The smallest prime factor of an odd r > 1.
__device__ __forceinline__ int least_odd_prime(int r) {
    for (int d = 3; d * d <= r; d += 2)
        if (r % d == 0) return d;
    return r;
}

// exp(-2 pi i t / n), t < n, from the table (re, im) of a non-power-of-two n.
__device__ __forceinline__ float2 twiddle_at(const float* re, const float* im, int n, int t) {
    return t <= n / 2 ? make_float2(re[t], im[t]) : make_float2(re[n - t], -im[n - t]);
}

// outputs a thread holds across a wave's barrier
constexpr int kOddPerThread = 4;

// One odd stage of radix kP (3, 5 or 7) on blocks of nb points (see the
// header) of `lines` lines of n points in shared memory, point k of line l
// at l ls + k ps, by `threads` threads: a thread takes whole groups of kP
// points, holds a group in registers and writes its outputs over its
// inputs (the groups are disjoint), the kP-point constants in registers.
// Ends with a barrier.
template <bool kInverse, int kP>
__device__ __forceinline__ void odd_stage_regs(float* re, float* im, const float* twr,
                                               const float* twi, int n, int nb, int lines,
                                               int ls, int ps, int threads) {
    const int m = nb / kP;
    const int per_line = n / kP;  // groups of a line
    const int groups = lines * per_line;
    const int tstride = n / nb;  // w_nb^e = w_n^{e tstride}
    const int mps = m * ps;      // from one point of a group to the next
    const Divisor dline(per_line), dm(m);
    float cr[kP], ci[kP];  // w_p^e = w_n^{e n / p}, conjugated for the inverse
#pragma unroll
    for (int e = 0; e < kP; ++e) {
        const float2 c = twiddle_at(twr, twi, n, e * per_line);
        cr[e] = c.x;
        ci[e] = kInverse ? -c.y : c.y;
    }
    for (int g = threadIdx.x; g < groups; g += threads) {
        const int l = dline.div(g), q = g - l * per_line;
        const int blk = dm.div(q), k = q - blk * m;
        const int base = l * ls + (blk * nb + k) * ps;
        float xr[kP], xi[kP];
#pragma unroll
        for (int j = 0; j < kP; ++j) {
            xr[j] = re[base + j * mps];
            xi[j] = im[base + j * mps];
        }
        if (kInverse) {  // the conjugate twiddles first
#pragma unroll
            for (int s = 1; s < kP; ++s) {
                const float2 w = twiddle_at(twr, twi, n, k * s * tstride);
                const float wi = -w.y;
                const float tr = fsub(fmul(xr[s], w.x), fmul(xi[s], wi));
                xi[s] = fadd(fmul(xr[s], wi), fmul(xi[s], w.x));
                xr[s] = tr;
            }
        }
#pragma unroll
        for (int s = 0; s < kP; ++s) {  // output s, summed in j order
            float ar = xr[0], ai = xi[0];
#pragma unroll
            for (int j = 1; j < kP; ++j) {
                const int e = (j * s) % kP;
                ar = fadd(ar, fsub(fmul(xr[j], cr[e]), fmul(xi[j], ci[e])));
                ai = fadd(ai, fadd(fmul(xr[j], ci[e]), fmul(xi[j], cr[e])));
            }
            if (!kInverse && s > 0) {
                const float2 w = twiddle_at(twr, twi, n, k * s * tstride);
                const float tr = fsub(fmul(ar, w.x), fmul(ai, w.y));
                ai = fadd(fmul(ar, w.y), fmul(ai, w.x));
                ar = tr;
            }
            re[base + s * mps] = ar;
            im[base + s * mps] = ai;
        }
    }
    __syncthreads();
}

// One odd stage of any radix p (p <= threads * kOddPerThread), as
// odd_stage_regs computes it, for radices too large to hold in registers:
// a thread computes whole outputs, reading the group's points from shared
// memory; the outputs are taken in waves of whole groups, all of a wave's
// reads before a barrier and its writes after it, so the stage runs in
// place. The inverse's conjugate twiddles are applied in place first, each
// point by one thread, before a barrier. Ends with a barrier.
template <bool kInverse>
__device__ __forceinline__ void odd_stage_waves(float* re, float* im, const float* twr,
                                                const float* twi, int n, int nb, int p,
                                                int lines, int ls, int ps, int threads) {
    const int m = nb / p;
    const int per_line = n / p;
    const int groups = lines * per_line;
    const int tstride = n / nb;
    const int mps = m * ps;
    const Divisor dline(per_line), dm(m), dp(p);
    // the first point of group g, and its k
    auto first = [&](int g, int& k) {
        const int l = dline.div(g), q = g - l * per_line;
        const int blk = dm.div(q);
        k = q - blk * m;
        return l * ls + (blk * nb + k) * ps;
    };
    if (kInverse) {
        const Divisor dp1(p - 1);
        for (int u = threadIdx.x; u < groups * (p - 1); u += threads) {
            const int g = dp1.div(u), s = u - g * (p - 1) + 1;
            int k;
            const int at = first(g, k) + s * mps;
            const float2 w = twiddle_at(twr, twi, n, k * s * tstride);
            const float xr = re[at], xi = im[at], wi = -w.y;
            re[at] = fsub(fmul(xr, w.x), fmul(xi, wi));
            im[at] = fadd(fmul(xr, wi), fmul(xi, w.x));
        }
        __syncthreads();
    }
    const int wave = threads * kOddPerThread / p;  // groups per wave
    for (int g0 = 0; g0 < groups; g0 += wave) {
        const int outs = min(wave, groups - g0) * p;
        float vr[kOddPerThread], vi[kOddPerThread];
        int at[kOddPerThread];
#pragma unroll
        for (int q = 0; q < kOddPerThread; ++q) {
            const int v = threadIdx.x + q * threads;
            at[q] = -1;
            vr[q] = vi[q] = 0.f;
            if (v < outs) {
                const int gl = dp.div(v), s = v - gl * p;
                int k;
                const int base = first(g0 + gl, k);
                float ar = re[base], ai = im[base];
                for (int j = 1, e = 0; j < p; ++j) {
                    e += s;
                    if (e >= p) e -= p;
                    const float2 c = twiddle_at(twr, twi, n, e * per_line);
                    const float cr = c.x, ci = kInverse ? -c.y : c.y;
                    const float xr = re[base + j * mps], xi = im[base + j * mps];
                    ar = fadd(ar, fsub(fmul(xr, cr), fmul(xi, ci)));
                    ai = fadd(ai, fadd(fmul(xr, ci), fmul(xi, cr)));
                }
                if (!kInverse && s > 0) {
                    const float2 w = twiddle_at(twr, twi, n, k * s * tstride);
                    const float tr = fsub(fmul(ar, w.x), fmul(ai, w.y));
                    ai = fadd(fmul(ar, w.y), fmul(ai, w.x));
                    ar = tr;
                }
                vr[q] = ar;
                vi[q] = ai;
                at[q] = base + s * mps;
            }
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kOddPerThread; ++q) {
            if (at[q] >= 0) {
                re[at[q]] = vr[q];
                im[at[q]] = vi[q];
            }
        }
        __syncthreads();
    }
}

// One odd stage of radix p on blocks of nb points: in registers for p = 3,
// 5, 7, in waves through shared memory otherwise. Both compute each output
// with the same operations in the same order. The waves alone, for every
// p, made whole kernels 1.25-1.57x slower on an H100 at 192, 320 and 640
// points a side (chip_smoke.py --time-mixed-radix, in turns). Ends with a
// barrier.
template <bool kInverse>
__device__ __noinline__ void odd_stage(float* re, float* im, const float* twr, const float* twi,
                                       int n, int nb, int p, int lines, int ls, int ps,
                                       int threads) {
    switch (p) {
        case 3:
            odd_stage_regs<kInverse, 3>(re, im, twr, twi, n, nb, lines, ls, ps, threads);
            break;
        case 5:
            odd_stage_regs<kInverse, 5>(re, im, twr, twi, n, nb, lines, ls, ps, threads);
            break;
        case 7:
            odd_stage_regs<kInverse, 7>(re, im, twr, twi, n, nb, lines, ls, ps, threads);
            break;
        default:
            odd_stage_waves<kInverse>(re, im, twr, twi, n, nb, p, lines, ls, ps, threads);
    }
}

// Every odd stage of an n-point pass (none at a power of two): forward
// p_1 .. p_k on blocks of n, n / p_1, ...; inverse p_k .. p_1 on blocks of
// 2^a p_k, 2^a p_{k-1} p_k, ... Each ends with a barrier.
template <bool kInverse>
__device__ __forceinline__ void odd_stages(float* re, float* im, const float* twr,
                                           const float* twi, int n, int lines, int ls, int ps,
                                           int threads) {
    const int pw = n & -n;
    if (kInverse) {
        int nb = pw;
        for (int r = n / pw; r > 1;) {
            int p = r;  // the greatest prime factor of r
            for (int q = r; q > 1; q /= p) p = least_odd_prime(q);
            nb *= p;
            r /= p;
            odd_stage<true>(re, im, twr, twi, n, nb, p, lines, ls, ps, threads);
        }
    } else {
        int nb = n;
        for (int r = n / pw; r > 1;) {
            const int p = least_odd_prime(r);
            odd_stage<false>(re, im, twr, twi, n, nb, p, lines, ls, ps, threads);
            nb /= p;
            r /= p;
        }
    }
}

}  // namespace rls
