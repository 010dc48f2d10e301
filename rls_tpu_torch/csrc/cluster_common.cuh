// Host and device code shared by the kernels that run one problem on a
// thread-block cluster (fista_tv_fused.cu, admm_tv_fused.cu,
// splitbregman_fused.cu, sense_fused.cu, pdhg_fused.cu,
// fista_l1_dft_fused.cu): a phase timer, a CTA's band of image rows with the
// stencil passes that read other bands through distributed shared memory,
// the cluster's double sums in rank order, and the launch configuration
// with its residency query.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pgm_tv_common.cuh"

namespace rls {

namespace cg = cooperative_groups;

// SM clocks of one thread per phase (the kernels time CTA 0's thread 0),
// summed in shared memory `acc` (kPhases int64) and written to `out` at the
// end; off where `out` is null.
template <int kPhases>
struct Prof {
    long long* out;
    long long* acc;
    long long t;
    __device__ void start() {
        if (out) {
            for (int k = 0; k < kPhases; ++k) acc[k] = 0;
            t = clock64();
        }
    }
    __device__ void mark(int phase) {
        if (out) {
            const long long now = clock64();
            acc[phase] += now - t;
            t = now;
        }
    }
    __device__ void finish() {
        if (out)
            for (int k = 0; k < kPhases; ++k) out[k] = acc[k];
    }
};

// the farthest row a stencil tap of up to 63 taps reads
constexpr int kHalo = 31;

// A CTA's band of the image, rows [r0, r0 + rows), and its planes in shared
// memory, each `pf` floats (the same in every CTA of the cluster). A row
// outside the band is read through one map, row -> (rank = row / R, local
// row = row - rank R), kept as a table `rowp` of DSMEM row pointers for the
// rows within kHalo of the band (entry j: image row r0 - kHalo + j). The
// image edges read zero, as stencil_v, grad_t and the FGP mask do
// (fgp_common.cuh). With kRound every tap's product and sum are rounded on
// their own (tap_acc), as the plain PyTorch passes round them.
template <bool kRound>
struct Band {
    float* s;                 // plane 0 of this CTA's band
    const float* const* rowp;  // DSMEM row table: rows r0 - kHalo ...
    size_t pf;                // floats per plane
    int r0, rows, H, W;
    __device__ float* plane(int p) const { return s + p * pf; }
    // plane p at image row r (any), column c: this band's rows from its
    // own shared memory, another band's through DSMEM, zero past the image
    __device__ float at(int p, int r, int c) const {
        const int lr = r - r0;
        if (lr >= 0 && lr < rows) return s[p * pf + lr * W + c];
        if (r < 0 || r >= H) return 0.f;
        return rowp[lr + kHalo][p * pf + c];
    }
    // plane p at the pixel (dr, dc) away from local pixel i = (lr, c), which
    // lies in the image
    __device__ float shifted(int p, int i, int lr, int c, int dr, int dc) const {
        const int l = lr + dr;
        return l >= 0 && l < rows ? plane(p)[i + dr * W + dc] : at(p, r0 + l, c + dc);
    }
    // plane p one row above / below local pixel i = (lr, c)
    __device__ float above(int p, int i, int lr, int c) const {
        return lr > 0 ? plane(p)[i - W] : at(p, r0 + lr - 1, c);
    }
    __device__ float below(int p, int i, int lr, int c) const {
        return lr + 1 < rows ? plane(p)[i + W] : at(p, r0 + lr + 1, c);
    }
    // stencil_v of fgp_common.cuh on plane p at local pixel i = (lr, c),
    // the same taps in the same order; a pixel whose taps all lie in the
    // band reads them with no edge test
    __device__ float stencil_v(int p, int i, int lr, int c, const float* taps, int K,
                               bool adjoint) const {
        const int R = K / 2;
        float acc = 0.f;
        if (lr >= R && lr + R < rows) {
            const int step = adjoint ? -W : W;
            const float* u = plane(p) + i - R * step;
            for (int k = 0; k < K; ++k, u += step)
                acc = tap_acc<kRound>(acc, taps[k], *u, k == 0);
            return acc;
        }
        const int r = r0 + lr;
        for (int k = 0; k < K; ++k)
            acc = tap_acc<kRound>(acc, taps[k], at(p, r + (adjoint ? R - k : k - R), c),
                                  k == 0);
        return acc;
    }
    // stencil_h of fgp_common.cuh on plane p at local pixel i = (lr, c)
    __device__ float stencil_h(int p, int i, int lr, int c, const float* taps, int K,
                               bool adjoint) const {
        const int R = K / 2;
        if (c >= R && c + R < W) {
            const int step = adjoint ? -1 : 1;
            const float* u = plane(p) + i - R * step;
            float acc = 0.f;
            for (int k = 0; k < K; ++k, u += step)
                acc = tap_acc<kRound>(acc, taps[k], *u, k == 0);
            return acc;
        }
        return rls::stencil_h<kRound>(plane(p), lr, c, taps, K, adjoint, W);
    }
    // grad_t of fgp_common.cuh on the duals in plane v and `h` (read in its
    // own rows only: any plane laid out as the band) at local pixel
    // i = (lr, c)
    __device__ float grad_t(int v, const float* h, int i, int lr, int c) const {
        const float up = r0 + lr > 0 ? above(v, i, lr, c) : 0.f;
        const float left = c > 0 ? h[i - 1] : 0.f;
        return (up - plane(v)[i]) + (left - h[i]);
    }
    __device__ float grad_t(int v, int h, int i, int lr, int c) const {
        return grad_t(v, plane(h), i, lr, c);
    }
};

// Fill a band's row table (rows + 2 kHalo entries, `rows` the planned band
// height R): entry j points at image row r0 - kHalo + j in the shared memory
// `s` of the CTA that owns it, null past the image.
__device__ __forceinline__ void fill_row_table(const float** rowp, float* s, int r0, int R,
                                               int H, int W, cg::cluster_group& cl) {
    for (int j = threadIdx.x; j < R + 2 * kHalo; j += blockDim.x) {
        const int r = r0 - kHalo + j;
        const float* p = nullptr;
        if (r >= 0 && r < H) {
            const int owner = r / R;
            p = cl.map_shared_rank(s, owner) + (r - owner * R) * W;
        }
        rowp[j] = p;
    }
}

// f(i, lr, c) for each pixel i = tid + k kThreads of a band of width W
// (local row lr, column c), advancing (lr, c) without a division.
template <int kThreads>
struct Sweep {
    int n, W, lr0, c0, dq, dr;
    __device__ Sweep(int n_, int W_) : n(n_), W(W_) {
        lr0 = threadIdx.x / W;
        c0 = threadIdx.x - lr0 * W;
        dq = kThreads / W;
        dr = kThreads - dq * W;
    }
    template <class F>
    __device__ __forceinline__ void operator()(F f) const {
        int lr = lr0, c = c0;
        for (int i = threadIdx.x; i < n; i += kThreads) {
            f(i, lr, c);
            lr += dq;
            c += dr;
            if (c >= W) {
                c -= W;
                ++lr;
            }
        }
    }
};

// rls::block_sum3, then the cluster's sum in rank order: thread 0 of each
// CTA adds the ranks' sums 0 .. c-1 through DSMEM. Every thread of the
// cluster gets the same three doubles. `mine` and `all` are 3 doubles of
// shared memory each; the cluster barrier inside orders every write the
// CTAs made before it. A peer reads `mine` after that barrier, so the next
// call on the same `mine` must come after another cluster barrier; where
// sums follow each other without one, use the two-slot form below.
__device__ __forceinline__ void cluster_sum3(double* v, double* red, double* mine,
                                             double* all, cg::cluster_group& cl, int c) {
    block_sum3(v, red);
    if (c == 1) return;
    if (threadIdx.x == 0)
        for (int k = 0; k < 3; ++k) mine[k] = v[k];
    cl.sync();
    if (threadIdx.x == 0) {
        double t[3] = {0.0, 0.0, 0.0};
        for (int q = 0; q < c; ++q) {
            const double* o = cl.map_shared_rank(mine, q);
            for (int k = 0; k < 3; ++k) t[k] += o[k];
        }
        for (int k = 0; k < 3; ++k) all[k] = t[k];
    }
    __syncthreads();
    for (int k = 0; k < 3; ++k) v[k] = all[k];
}

// The same for sums that may follow each other with no cluster barrier
// between them: `mine` is two slots of 4 doubles, used in turn as `parity`
// says (every CTA of the cluster makes the same calls, so the parities stay
// in step). A slot is written again two calls later, after the middle
// call's cluster barrier, which each CTA reaches only after it has read the
// peers' slot of the call before.
__device__ __forceinline__ void cluster_sum3(double* v, double* red, double* mine,
                                             double* all, cg::cluster_group& cl, int c,
                                             int& parity) {
    cluster_sum3(v, red, mine + 4 * parity, all, cl, c);
    parity ^= 1;
}

// The attributes of cluster kernel `k` for `smem` bytes of dynamic shared
// memory, and the launch configuration of B clusters of `clusters` CTAs of
// `threads` threads; `attr` receives the cluster dimension. Sizes above 8
// take the non-portable attribute.
template <class Kernel>
cudaError_t cluster_config(Kernel k, int B, int clusters, int threads, int smem,
                           cudaStream_t stream, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess && clusters > 8)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = clusters;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(static_cast<unsigned>(B) * clusters);
    cfg->blockDim = dim3(threads);
    cfg->dynamicSmemBytes = static_cast<size_t>(smem);
    cfg->stream = stream;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return e;
}

// How many clusters of `clusters` CTAs of kernel `k` the current device
// holds at once (cudaOccupancyMaxActiveClusters); 0 where it refuses the
// configuration (the error is cleared: such a plan has no resident cluster).
template <class Kernel>
int max_active_clusters(Kernel k, int clusters, int threads, int smem) {
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t e = cluster_config(k, 1, clusters, threads, smem, 0, &attr, &cfg);
    int n = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
    if (e != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    return n;
}

}  // namespace rls
