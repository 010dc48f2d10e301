// The SENSE normal op sum_c conj(C_c) F^H M F C_c v of one slice on a
// thread-block cluster, as the resident routes of the FISTA-L21-SENSE
// (sense_fused.cu) and SplitBregman (splitbregman_fused.cu) kernels run it:
// in round ro, CTA `rank` transforms coil ro c + rank with its padded
// spectrum whole in its shared memory (fft_resident.cuh); after a cluster
// barrier each CTA folds the round's coils into its band of rows in coil
// order, reading coil k's result from the CTA that computed it through
// DSMEM, ((acc + a yr) + b yi, (acc + a yi) - b yr) as the plain version
// (kernels/_dft_common.py sense_normal) sums them. The sum between rounds
// waits in global memory (accr, acci: only the band's own pixels, each
// read back by the thread that wrote it).
//
// Barriers: the caller orders the whole of v and every earlier remote read
// of the spectrum before the call (a cluster barrier); inside, a cluster
// barrier follows each round's transforms (their results, for the fold)
// and each fold but the last (its remote reads, before the next round
// rewrites the spectrum). After the call the spectrum holds the last
// round's results, which peers may still be reading: the caller's next
// cluster barrier must come before the spectrum is written again, and
// before the CTA exits.
#pragma once

#include <cooperative_groups.h>

#include "cluster_common.cuh"
#include "fft_resident.cuh"

namespace rls {

// One slice's cluster and this CTA's part of it.
struct SenseCluster {
    const float* coils_r;  // (C, H, W)
    const float* coils_i;
    const float* wt;       // (W, H): the spectral weights transposed
    const float* tw;       // the twiddles in shared memory
    float* sre;            // this CTA's spectrum, H (W + 1) floats each (shared)
    float* sim;
    float* accr;           // the coil sum between rounds (global, the slice's plane)
    float* acci;
    int H, W, C, clusters, rank;
    int p0, p1;            // the pixels of this CTA's band of rows
};

// F^H M F (C_c v) of one coil into the spectrum (sre, sim), v = (vr, vi):
// not inlined, so that the FFT's registers are its own and not the solve's
// (a kernel of 1024 threads has 64 registers a thread); static, so that
// its calls need not follow the external calling convention (which spills
// more around them).
template <int kThreads, class Prof>
static __device__ __noinline__ void coil_transform(const float* cr, const float* ci, const float* vr,
                                            const float* vi, const float* wt, float* sre,
                                            float* sim, const float* tw, int H, int W,
                                            Prof* prof) {
    auto load = [&](int i) {
        const float ca = cr[i], cb = ci[i], vre = vr[i], vim = vi[i];
        return make_float2(fsub(fmul(ca, vre), fmul(cb, vim)), fadd(fmul(ca, vim), fmul(cb, vre)));
    };
    fftr::normal_resident(load, wt, sre, sim, tw, H, W, kThreads, *prof);
}

// The SENSE normal op of (vr, vi), handed to finish(i, nr, ni) at each
// pixel i of the band; sync(phase) is the caller's timed cluster barrier,
// the fold's time is marked as kFold.
template <int kThreads, int kFold, class Prof, class Sync, class Finish>
__device__ __forceinline__ void sense_normal_cluster(const SenseCluster& s, const float* vr,
                                                     const float* vi, cg::cluster_group& cl,
                                                     Prof& prof, Sync& sync, Finish finish) {
    const int n = s.H * s.W, nc = s.clusters;
    const int lg_w = fftr::log2i(s.W);
    const int rounds = (s.C + nc - 1) / nc;
    for (int ro = 0; ro < rounds; ++ro) {
        const int c0 = ro * nc;
        const int c1 = min(s.C, c0 + nc);
        const int coil = c0 + s.rank;
        if (coil < s.C)
            coil_transform<kThreads>(s.coils_r + static_cast<size_t>(coil) * n,
                                     s.coils_i + static_cast<size_t>(coil) * n, vr, vi, s.wt,
                                     s.sre, s.sim, s.tw, s.H, s.W, &prof);
        sync(fftr::kFftRows);  // the round's results, visible to the cluster
        const bool last = ro + 1 == rounds;
        for (int i = s.p0 + threadIdx.x; i < s.p1; i += kThreads) {
            const int at = (i >> lg_w) * (s.W + 1) + (i & (s.W - 1));
            float sr = ro == 0 ? 0.f : s.accr[i];
            float si = ro == 0 ? 0.f : s.acci[i];
            for (int c = c0; c < c1; ++c) {
                const float yr = cl.map_shared_rank(s.sre, c - c0)[at];
                const float yi = cl.map_shared_rank(s.sim, c - c0)[at];
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
        if (!last) sync(kFold);  // every remote read before the next round
    }
}

}  // namespace rls
