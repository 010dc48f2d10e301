// Device code of the dense kernels that run a batch's solve as one
// cooperative grid of row slabs x problem groups (cgnr_fused.cu, the dense
// PGM grid route of pgm_dense_grid.cu, real and complex): A's rows are cut
// into `slabs` slabs of `rows` rows and the batch into groups of problems,
// CTA (s, g) takes slab s for group g, and the slabs of a group meet at a
// barrier of their own.
//
// Per tile of 8 problems, q = A_slab P (in 16-row blocks) and the slab's
// partial v = A_slab^T q (in 16-column blocks) run on the FP64 tensor cores
// (mma m16n8k8 in double): every product of two f32 values is exact in
// double, each q entry is rounded to f32 once, and the partial v stays in
// double until the owner of its columns sums the slabs in slab order. On
// complex data (q_tile_cplx, v_tile_cplx) each load of a fragment of A's re
// or im plane serves two products, against the tile's re and im planes:
// the four real products of the complex pattern, each rounded or summed
// on its own as the real one is. The order of every sum is fixed (the
// tensor cores' own, then the accumulators, the warps, the slabs and the
// lanes in a fixed tree), so a kernel's result does not change from run to
// run; no float atomics.
#pragma once

#include <cuda_runtime.h>

#include "cluster_common.cuh"
#include "dense_common.cuh"
#include "group_sync.cuh"

namespace rls {
namespace grid {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;  // problems per tile

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }
__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The row stride of A's slab in shared memory: at least n rounded up to
// 16, and 8 mod 32 floats, so that the 4 rows x 8 columns of a fragment of
// A^T hit 32 banks.
__host__ __device__ constexpr int slab_ld(int n) {
    return round_up(n, 16) + (40 - round_up(n, 16) % 32) % 32;
}

// A's slab at (row i, column j) as a double: from shared memory (zero
// beyond the slab), or from global memory with zeros past R x n.
template <bool kRes>
__device__ __forceinline__ double a_at(const float* a, int ld, int i, int j, int R, int n) {
    if (kRes) return static_cast<double>(a[i * ld + j]);
    return i < R && j < n ? static_cast<double>(__ldg(a + i * n + j)) : 0.0;
}

// An entry of a tile's right-hand side as a double: from shared memory,
// or from global memory through L2 (written by other CTAs).
template <bool kRes, typename T>
__device__ __forceinline__ double p_at(const T* p, int i) {
    return kRes ? static_cast<double>(p[i]) : static_cast<double>(__ldcg(p + i));
}

// A load of data that other CTAs of the group wrote (through L2), or of
// the CTA's own shared memory where the group is one CTA.
template <typename T>
__device__ __forceinline__ T ld_group(const T* p, bool own) {
    return own ? *p : __ldcg(p);
}

// D (16 x 8) += A (16 x 8, row-major) B (8 x 8) in double on the tensor
// cores: lane l, with g = l / 4 and t = l % 4, holds A[g][t], A[g + 8][t],
// A[g][t + 4], A[g + 8][t + 4], then B[t][g], B[t + 4][g], and D[g][2 t],
// D[g][2 t + 1], D[g + 8][2 t], D[g + 8][2 t + 1].
__device__ __forceinline__ void dmma(double* d, const double* a, const double* b) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// How many warps share a block of a product: the largest power of 2 with
// every warp busy, at most kWarps.
__device__ __forceinline__ int splits_for(int blocks) {
    int s = 1;
    while (s < kWarps && 2 * s * blocks <= kWarps) s *= 2;
    return s;
}

// A 16 x 8 block product summed over K (a multiple of 8) on the tensor
// cores. The `splits` warps of a block split K: split ks takes the steps
// of 8 from 8 ks, every 8 splits, alternately into two accumulators;
// `frag(k0, a, b)` loads the lane's operands of step k0. The two
// accumulators add, then the splits in warp order through `scratch`
// (kWarps x 128 doubles); the block's first warp returns the lane's four
// entries of D in `out` (true). Every warp calls it the same number of
// times (`active` false without a block), and with splits > 1 it ends on
// a block barrier.
template <typename Frag>
__device__ __forceinline__ bool block_mma(bool active, int ks, int splits, int K, Frag frag,
                                          double* scratch, double* out) {
    double c[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
    if (active)
        for (int k0 = 8 * ks; k0 < K; k0 += 16 * splits) {
            double av[4], bv[2];
            frag(k0, av, bv);
            dmma(c[0], av, bv);
            if (k0 + 8 * splits < K) {
                frag(k0 + 8 * splits, av, bv);
                dmma(c[1], av, bv);
            }
        }
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = c[0][i] + c[1][i];
    if (splits == 1) return active;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < 4; ++i) scratch[warp * 128 + 4 * lane + i] = out[i];
    __syncthreads();
    if (active && ks == 0)
        for (int w = 1; w < splits; ++w)
#pragma unroll
            for (int i = 0; i < 4; ++i) out[i] += scratch[(warp + w) * 128 + 4 * lane + i];
    __syncthreads();
    return active && ks == 0;
}

// q = A_slab p for a tile, rounded to f32, into sq (rows x 8 doubles, in
// blocks of 16 rows; rows past R are 0 with A's zero rows). p: the tile's
// [n8][8], f32 or double, in shared memory with kPRes (else through L2).
template <bool kRes, bool kPRes = kRes, typename T = double>
__device__ void q_tile(const float* a, int ld, const T* p, double* sq, double* scratch, int R,
                       int n) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int blocks = (R + 15) / 16, splits = splits_for(blocks), per = kWarps / splits;
    for (int b0 = 0; b0 < blocks; b0 += per) {
        const int blk = b0 + warp / splits, r = 16 * blk + g;
        double d[4];
        const bool mine = block_mma(
            blk < blocks, warp % splits, splits, round_up(n, 8),
            [&](int k, double* av, double* bv) {
                av[0] = a_at<kRes>(a, ld, r, k + t, R, n);
                av[1] = a_at<kRes>(a, ld, r + 8, k + t, R, n);
                av[2] = a_at<kRes>(a, ld, r, k + t + 4, R, n);
                av[3] = a_at<kRes>(a, ld, r + 8, k + t + 4, R, n);
                bv[0] = p_at<kPRes>(p, (k + t) * kTile + g);
                bv[1] = p_at<kPRes>(p, (k + t + 4) * kTile + g);
            },
            scratch, d);
        if (mine) {
            sq[r * kTile + 2 * t] = static_cast<double>(static_cast<float>(d[0]));
            sq[r * kTile + 2 * t + 1] = static_cast<double>(static_cast<float>(d[1]));
            sq[(r + 8) * kTile + 2 * t] = static_cast<double>(static_cast<float>(d[2]));
            sq[(r + 8) * kTile + 2 * t + 1] = static_cast<double>(static_cast<float>(d[3]));
        }
    }
}

// The slab's partial v = A_slab^T q for a tile, in double, into part[j][k]
// (blocks of 16 columns; sq's rows past R are 0).
template <bool kRes>
__device__ void v_tile(const float* a, int ld, const double* sq, double* part, double* scratch,
                       int R, int n) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int blocks = (n + 15) / 16, splits = splits_for(blocks), per = kWarps / splits;
    for (int b0 = 0; b0 < blocks; b0 += per) {
        const int blk = b0 + warp / splits, c = 16 * blk + g;
        double d[4];
        const bool mine = block_mma(
            blk < blocks, warp % splits, splits, round_up(R, 8),
            [&](int k, double* av, double* bv) {
                av[0] = a_at<kRes>(a, ld, k + t, c, R, n);
                av[1] = a_at<kRes>(a, ld, k + t, c + 8, R, n);
                av[2] = a_at<kRes>(a, ld, k + t + 4, c, R, n);
                av[3] = a_at<kRes>(a, ld, k + t + 4, c + 8, R, n);
                bv[0] = sq[(k + t) * kTile + g];
                bv[1] = sq[(k + t + 4) * kTile + g];
            },
            scratch, d);
        if (mine && c < n)
            *reinterpret_cast<double2*>(part + static_cast<size_t>(c) * kTile + 2 * t) =
                make_double2(d[0], d[1]);
        if (mine && c + 8 < n)
            *reinterpret_cast<double2*>(part + static_cast<size_t>(c + 8) * kTile + 2 * t) =
                make_double2(d[2], d[3]);
    }
}

// The four real products of a complex 16 x 8 block on the tensor cores:
// d[2 a + b] (16 x 8) += A_a (16 x 8) B_b (8 x 8) summed over K (a multiple
// of 8), for A's planes a and the right-hand side's planes b (0 re, 1 im),
// so that each load of an A fragment serves two products. `frag(k0, av,
// bv)` loads the lane's operands of both planes at step k0 (av[2][4],
// bv[2][2], in dmma's layout). The `splits` warps of a block split K as
// block_mma's do, in steps of 8 from 8 ks, every 8 splits, one accumulator
// per product; the splits add in warp order through `scratch` (kWarps x
// 512 doubles), and the block's first warp returns the lane's four entries
// of each product in d (true). Every warp calls it the same number of
// times (`active` false without a block), and with splits > 1 it ends on a
// block barrier.
template <typename Frag>
__device__ __forceinline__ bool block_mma_cplx(bool active, int ks, int splits, int K, Frag frag,
                                               double* scratch, double (&d)[4][4]) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[p][i] = 0.0;
    if (active) {
#pragma unroll 2
        for (int k0 = 8 * ks; k0 < K; k0 += 8 * splits) {
            double av[2][4], bv[2][2];
            frag(k0, av, bv);
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b) dmma(d[2 * a + b], av[a], bv[b]);
        }
    }
    if (splits == 1) return active;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < 16; ++i) scratch[(warp * 16 + i) * 32 + lane] = d[i / 4][i % 4];
    __syncthreads();
    if (active && ks == 0)
        for (int w = 1; w < splits; ++w)
#pragma unroll
            for (int i = 0; i < 16; ++i)
                d[i / 4][i % 4] += scratch[((warp + w) * 16 + i) * 32 + lane];
    __syncthreads();
    return active && ks == 0;
}

// q = A_slab p for a tile on complex data: A's slab as its (re, im) planes
// ar, ai, p as f32 planes pr, pi ([n8][8], in shared memory). The four real
// products Ar pr, Ar pi, Ai pr, Ai pi are each rounded to f32 on its own
// and combined in f32, qr = Ar pr - Ai pi and qi = Ai pr + Ar pi (as
// mv_rows<true> and the plain version do), into sqr, sqi (rows x 8
// doubles each, in blocks of 16 rows; rows past R are 0 with A's zero
// rows).
template <bool kRes>
__device__ void q_tile_cplx(const float* ar, const float* ai, int ld, const float* pr,
                            const float* pi, double* sqr, double* sqi, double* scratch, int R,
                            int n) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int blocks = (R + 15) / 16, splits = splits_for(blocks), per = kWarps / splits;
    for (int b0 = 0; b0 < blocks; b0 += per) {
        const int blk = b0 + warp / splits, r = 16 * blk + g;
        double d[4][4];
        const bool mine = block_mma_cplx(
            blk < blocks, warp % splits, splits, round_up(n, 8),
            [&](int k, double (*av)[4], double (*bv)[2]) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const float* a = c == 0 ? ar : ai;
                    const float* p = c == 0 ? pr : pi;
                    av[c][0] = a_at<kRes>(a, ld, r, k + t, R, n);
                    av[c][1] = a_at<kRes>(a, ld, r + 8, k + t, R, n);
                    av[c][2] = a_at<kRes>(a, ld, r, k + t + 4, R, n);
                    av[c][3] = a_at<kRes>(a, ld, r + 8, k + t + 4, R, n);
                    bv[c][0] = static_cast<double>(p[(k + t) * kTile + g]);
                    bv[c][1] = static_cast<double>(p[(k + t + 4) * kTile + g]);
                }
            },
            scratch, d);
        // the lane's entries: (row r, problem 2t), (r, 2t + 1), (r + 8, 2t),
        // (r + 8, 2t + 1); d = Ar pr, Ar pi, Ai pr, Ai pi
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int o = (r + (i >> 1) * 8) * kTile + 2 * t + (i & 1);
            if (mine) {
                sqr[o] = static_cast<double>(
                    fsub(static_cast<float>(d[0][i]), static_cast<float>(d[3][i])));
                sqi[o] = static_cast<double>(
                    fadd(static_cast<float>(d[2][i]), static_cast<float>(d[1][i])));
            }
        }
    }
}

// The slab's partial v = A_slab^H q for a tile on complex data, as its four
// real products in double, Ar^T qr, Ai^T qi, Ar^T qi, Ai^T qr, into the
// planes part[p][j][k] in that order (blocks of 16 columns; sqr's and
// sqi's rows past R are 0), each store of a warp 512 contiguous bytes. The
// owner of column j sums each over the slabs, rounds each to f32 and forms
// vr = Ar^T qr + Ai^T qi, vi = Ar^T qi - Ai^T qr in f32 (as mv_cols<true>
// and the plain version do).
template <bool kRes>
__device__ void v_tile_cplx(const float* ar, const float* ai, int ld, const double* sqr,
                            const double* sqi, double* part, double* scratch, int R, int n) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int blocks = (n + 15) / 16, splits = splits_for(blocks), per = kWarps / splits;
    for (int b0 = 0; b0 < blocks; b0 += per) {
        const int blk = b0 + warp / splits, c = 16 * blk + g;
        double d[4][4];
        const bool mine = block_mma_cplx(
            blk < blocks, warp % splits, splits, round_up(R, 8),
            [&](int k, double (*av)[4], double (*bv)[2]) {
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    const float* a = p == 0 ? ar : ai;
                    const double* q = p == 0 ? sqr : sqi;
                    av[p][0] = a_at<kRes>(a, ld, k + t, c, R, n);
                    av[p][1] = a_at<kRes>(a, ld, k + t, c + 8, R, n);
                    av[p][2] = a_at<kRes>(a, ld, k + t + 4, c, R, n);
                    av[p][3] = a_at<kRes>(a, ld, k + t + 4, c + 8, R, n);
                    bv[p][0] = q[(k + t) * kTile + g];
                    bv[p][1] = q[(k + t + 4) * kTile + g];
                }
            },
            scratch, d);
        // the lane's entries: (column c, problems 2t, 2t + 1), then (c + 8,
        // the same); d = Ar^T qr, Ar^T qi, Ai^T qr, Ai^T qi, the planes'
        // products in the order 0, 3, 1, 2
#pragma unroll
        for (int p = 0; p < 4; ++p) {
            const double* e = d[p == 0 ? 0 : p == 1 ? 3 : p == 2 ? 1 : 2];
            double* at = part + static_cast<size_t>(p) * n * kTile + 2 * t;
            if (mine && c < n)
                *reinterpret_cast<double2*>(at + static_cast<size_t>(c) * kTile) =
                    make_double2(e[0], e[1]);
            if (mine && c + 8 < n)
                *reinterpret_cast<double2*>(at + static_cast<size_t>(c + 8) * kTile) =
                    make_double2(e[2], e[3]);
        }
    }
}

// Sum NV per-thread doubles over the block for each problem k = t % kTile
// of a tile, in a fixed tree (kWarps = 8); thread k < kTile returns the
// sums of problem k in `v`.
template <int NV>
__device__ __forceinline__ void tile_sum(double* v, double* red) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
        v[c] += __shfl_xor_sync(0xffffffffu, v[c], 8);
        v[c] += __shfl_xor_sync(0xffffffffu, v[c], 16);
        if (lane < kTile) red[(c * kWarps + warp) * kTile + lane] = v[c];
    }
    __syncthreads();
    if (warp == 0)  // lane 8 w + k adds warps w and w + 4 of problem k
#pragma unroll
        for (int c = 0; c < NV; ++c) {
            const double* r = red + (c * kWarps + (lane >> 3)) * kTile + (lane & 7);
            v[c] = r[0] + r[4 * kTile];
            v[c] += __shfl_xor_sync(0xffffffffu, v[c], 8);
            v[c] += __shfl_xor_sync(0xffffffffu, v[c], 16);
        }
    __syncthreads();
}

__device__ __forceinline__ double2 operator+(double2 a, double2 b) {
    return make_double2(a.x + b.x, a.y + b.y);
}

// Four doubles summed entry-wise: the four real products of a complex
// entry's partial v.
struct Quad {
    double v[4];
};

__device__ __forceinline__ Quad operator+(Quad a, Quad b) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a.v[i] += b.v[i];
    return a;
}

// sum_{t < count} at(t) in order, with the loads of kBatch terms in flight
// at once (`at` loads a term, a double, a double2 or a Quad summed
// entry-wise).
template <typename T, int kBatch = 16, typename F>
__device__ __forceinline__ T ordered_sum(int count, F at) {
    T sum{};
    for (int t0 = 0; t0 < count; t0 += kBatch) {
        T v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) v[u] = t0 + u < count ? at(t0 + u) : T{};
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
            if (t0 + u < count) sum = sum + v[u];
    }
    return sum;
}

}  // namespace grid
}  // namespace rls
