// Host and device code shared by the kernels that run one problem on a
// thread-block cluster (fista_tv_fused.cu, splitbregman_fused.cu): a phase
// timer, the cluster's double sums in rank order through distributed shared
// memory, and the launch configuration with its residency query.
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
