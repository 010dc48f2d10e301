// Device code of the dense kernels that run a batch's solve as one
// cooperative grid of row slabs x problem groups (cgnr_fused.cu,
// pgm_dense_fused.cu's grid route): A's rows are cut into `slabs` slabs of
// `rows` rows and the batch into groups of problems, CTA (s, g) takes slab
// s for group g, and the slabs of a group meet at a barrier of their own.
//
// Per tile of 8 problems, q = A_slab P (in 16-row blocks) and the slab's
// partial v = A_slab^T q (in 16-column blocks) run on the FP64 tensor cores
// (mma m16n8k8 in double): every product of two f32 values is exact in
// double, each q entry is rounded to f32 once, and the partial v stays in
// double until the owner of its columns sums the slabs in slab order. The
// order of every sum is fixed (the tensor cores' own, then the
// accumulators, the warps, the slabs and the lanes in a fixed tree), so a
// kernel's result does not change from run to run; no float atomics.
#pragma once

#include <cuda_runtime.h>

#include "cluster_common.cuh"
#include "dense_common.cuh"

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

// Wait until all `slabs` CTAs of the group have arrived: thread 0 adds 1
// to the group's counter with release semantics and polls it with
// acquire semantics; the counter counts up through the whole solve
// (target = slabs x barriers so far). A wait past ~10 s of clocks traps
// rather than hang the card.
__device__ inline void group_sync(unsigned* ctr, unsigned& target, int slabs) {
    __syncthreads();
    if (slabs == 1) return;
    target += slabs;
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(ctr), "r"(1u) : "memory");
        const long long t0 = clock64();
        for (;;) {
            unsigned seen;
            asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(ctr) : "memory");
            if (seen >= target) break;
            if (clock64() - t0 > 20000000000LL) __trap();
        }
    }
    __syncthreads();
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

// sum_{t < count} at(t) in order, with the loads of 16 terms in flight at
// once (`at` loads a term, a double or a double2 summed entry-wise).
template <typename T, typename F>
__device__ __forceinline__ T ordered_sum(int count, F at) {
    T sum{};
    for (int t0 = 0; t0 < count; t0 += 16) {
        T v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = t0 + u < count ? at(t0 + u) : T{};
#pragma unroll
        for (int u = 0; u < 16; ++u)
            if (t0 + u < count) sum = sum + v[u];
    }
    return sum;
}

}  // namespace grid
}  // namespace rls
