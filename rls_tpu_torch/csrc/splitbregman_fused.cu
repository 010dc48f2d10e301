// The whole batched SplitBregman (L21 + TV) multi-coil SENSE solve in one
// launch, on one of three routes that the host planner
// (kernels/splitbregman_fused.py plan_splitbregman) picks by shape:
//
// * resident: each slice runs on a thread-block cluster of c CTAs (c <= C,
//   at most 16), CTA k computing the 2-D FFTs of coils k, k + c, ... in
//   rounds, each coil's padded spectrum whole in its shared memory with the
//   FFT's stages in registers (fft_resident.cuh);
// * split: the same cluster kernel for shapes whose padded spectrum, H (W +
//   1) complex floats, fits no CTA (192^2): each coil's spectrum split over
//   a team of `team` CTAs, bands of its rows and blocks of its columns, the
//   transposes pushed through DSMEM (sense_split.cuh); the vector phases,
//   the FGP and the sums run on the cluster's bands as on the resident
//   route;
// * grid: for shapes whose spectrum fits no team of 16 (512^2, 1024^2), a
//   team of CTAs per slice that meet in L2, on row 9's grid normal op
//   (sense_grid.cuh): the CG's sums taken over the team, the vector phases
//   on each CTA's band of rows, the fold FGP of both planes swept band by
//   band with a team barrier between sweeps (the table of what each
//   barrier orders is above splitbregman_grid_kernel).
//
// Replaces the TPU kernel rls_tpu/kernels/splitbregman_fused.py:_kernel
// (:48-185; launched by splitbregman_l1_tv_sense_fused, :217, pallas_call
// :245). From x = 0 and beta_y = x0hat (= A^H b), per outer iteration
// z1 = z2 = x, u1 = u2 = 0, then per inner iteration
//   beta = (beta_y + rho1 (z1 - u1)) + rho2 (z2 - u2)
//   x    = masked CG on (A^H A + (rho1 + rho2) I) x = beta, cg_iterations
//          steps from the previous x; a step is live while
//          ||r|| > tol_inner ||beta||
//   z1   = group soft threshold of x + u1 over (re, im) at lam1 / rho1
//   z2   = fold FGP-TV of each plane of x + u2 at lam2 / rho2
//          (zi = x + ui where rho_i = 0)
//   ui   = (ui + x) - zi
// and after the inner iterations beta_y = (beta_y + x0hat) - A^H A x. The
// SENSE normal op sums conj(C_c) F^H M F C_c v over the coils in order
// c = 0 .. C-1, ((acc + a yr) + b yi, (acc + a yi) - b yr); the CG's sums
// (||beta||^2, r.r, p.q over both planes) are exact double products summed
// per thread, over the block (rls::block_sum3) and, on the cluster routes,
// over ranks 0 .. c-1 (rls::cluster_sum3; on the grid route over the team
// in rank order through global memory), rounded once, as the plain
// version sums them in float64; every thread of a slice evaluates the same
// `active` and takes the same branch. The TV prox is the fold FGP
// (rls::fold_fgp, its momentum rounded as the plain version rounds it)
// once per plane, valid because lam2 / rho2 is the same at every call. The
// kernel also counts each slice's live CG steps. The plain PyTorch
// version, which every route follows op for op, is
// splitbregman_l1_tv_fused_torch in rls_tpu_torch/kernels/splitbregman_fused.py.
//
// What bounds it on an H100: at BASELINE #4 (128^2, 6 coils, 4 x 8 x 8)
// every slice runs ~286 SENSE normal ops, one dependent chain, so the
// solve is bound by that chain's latency, not by bytes or operations. The
// resident route shortens the chain and widens it: the six coils of a normal op transform at once on
// the cluster's CTAs (48 CTAs for 8 slices), and a coil's transform pair
// is three passes over its plane in shared memory with a barrier after
// each, its 14 radix-2 stages per point in registers and shuffles.
//
// Resident route, where each buffer lives and which barrier orders each
// read of what another CTA wrote. CTA `rank` owns the image rows [r0, r1)
// of its slice (H / c rows, one more for the first H % c ranks; a band is
// empty where H < c) and writes only those rows of the global planes,
// except the FGP's own scratch:
//   shared memory: the block sums, this CTA's sums for the cluster (two
//     slots, used in turn) and the cluster's, the phase timer, the
//     twiddles, and one coil's spectrum (H (W + 1) floats each for re and
//     im), which ends a transform holding the coil's normal op
//     F^H M F (C_c v);
//   global memory, per slice (L2-resident: 8 slices x 30 planes x 64 KiB):
//     x (out), beta_y, z1, u1, z2, u2, beta | v, r, p, q, the coil sum
//     between rounds, and the FGP's pv, ph, rv, rh, y for each plane.
//   * each outer iteration starts with a cluster barrier: it orders the
//     first writes of x (x = 0) before any transform reads them, and the
//     last fold of the iteration before (with no inner iterations) the
//     next outer update's transforms rewrite the spectrum;
//   * each coil transform reads the whole of v (x or p) through L2: a
//     cluster barrier follows the last write of v (the sums after the x
//     and r updates; the barrier after p's update; the outer iteration's);
//   * the fold reads every coil's result of its round from the CTA that
//     computed it through DSMEM after a cluster barrier; the spectrum is
//     rewritten only by the next transform, after another cluster barrier
//     (the next round's, a sum's, the next outer iteration's, or the final
//     one);
//   * ranks 0 and 1 run the fold FGP of the re and the im plane (rank 0
//     both where c = 1) on the whole plane of v = x + u2, after a cluster
//     barrier; the z2 update reads their duals after another;
//   * the sums go through rls::cluster_sum3 (one cluster barrier each),
//     in its two-slot form: the p.q and r.r sums of a CG step follow each
//     other with no other barrier, as do the last r.r of an inner
//     iteration and the next ||beta||^2 where TV is off, so a CTA writes
//     its slot for one sum while a peer may still read its slot of the
//     sum before.
// Per CG step: the fold's barrier, two sums and p's barrier (none where
// the step is frozen). The kernel ends with a cluster barrier, so that no
// CTA exits while another still reads its shared memory. The split route
// runs the normal op of sense_split.cuh in the fold's place (its header
// holds the table of what its barriers order): the band and the block
// take the spectrum's place, and each barrier above that orders the
// spectrum's reads before a transform rewrites it orders the bands' alike.
//
// A phase timer (prof): CTA 0's thread 0 adds the SM clocks between its
// phase marks (coil loads, row FFTs, column FFTs, coil fold, vector
// phases, cluster sums, FGP, cluster barriers); off where prof is null.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "admm_tv_common.cuh"
#include "cluster_common.cuh"
#include "dense_common.cuh"
#include "fft_resident.cuh"
#include "sense_cluster.cuh"
#include "sense_grid.cuh"
#include "sense_split.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;

// ---- the resident route: one slice per cluster, a coil's spectrum in
// shared memory

constexpr int kMaxCluster = 16;
// the phases of the timer; the first three are fft_resident.cuh's
enum { kLoads, kRows, kCols, kFold, kVector, kSums, kFgp, kBarrier, kPhases };
static_assert(kLoads == rls::fftr::kFftLoads && kRows == rls::fftr::kFftRows &&
                  kCols == rls::fftr::kFftCols,
              "the timer's FFT phases");

// Shared memory of a CTA of the resident route, in this order; the Python
// planner (kernels/splitbregman_fused.py resident_smem_bytes) counts the
// same: the block sums (3 x 32 doubles), this CTA's sums for the cluster
// (two slots) and the cluster's (4 doubles each), the phase timer (kPhases
// int64), the twiddles (twiddle_floats(H, W) floats: H + W at powers of
// two) and one coil's padded spectrum (H (W + 1) floats for re, then as
// many for im), each float array rounded up to 4 floats.
__host__ __device__ inline size_t resident_smem_bytes(int H, int W) {
    return sizeof(double) * (3 * (kThreads / 32) + 12) + sizeof(long long) * kPhases +
           sizeof(float) *
               (rls::ceil4(rls::twiddle_floats(H, W)) +
                2 * rls::ceil4(static_cast<size_t>(H) * (W + 1)));
}

// Shared memory of a CTA of the split route on teams of `team` CTAs, in
// this order (split_smem_bytes in kernels/splitbregman_fused.py counts the
// same): the sums, the phase timer and the twiddles as above, the band
// (ceil(H / team) W floats for re, then as many for im) and the column
// block (H (ceil(W / team) + 1) floats for re, then as many for im), each
// float array rounded up to 4 floats.
__host__ __device__ inline size_t split_smem_bytes(int H, int W, int team) {
    return sizeof(double) * (3 * (kThreads / 32) + 12) + sizeof(long long) * kPhases +
           sizeof(float) * (rls::ceil4(rls::twiddle_floats(H, W)) +
                            2 * rls::split_band_floats(H, W, team) +
                            2 * rls::split_block_floats(H, W, team));
}

// The shared memory of a cluster CTA on teams of `team` (1: resident).
__host__ __device__ inline size_t cluster_smem_bytes(int H, int W, int team) {
    return team == 1 ? resident_smem_bytes(H, W) : split_smem_bytes(H, W, team);
}

// A cluster plan: `clusters` CTAs a slice in teams of `team` (1: the
// resident route), at most 16, at most one team a coil, and a team no
// larger than a side (every band and block holds a line).
bool valid_plan(int clusters, int team, int H, int W, int C) {
    return team >= 1 && clusters >= team && clusters <= kMaxCluster && clusters % team == 0 &&
           clusters / team <= C && team <= H && team <= W;
}

struct ResidentArgs {
    const float* x0hat;    // (B, 2, H, W)
    const float* scal;     // (B, 4) [rho1, rho2, lam1_eff, lam2_eff]
    const float* t2tab;    // (tv_iterations, 2)
    const float* tw;       // twiddle_floats(H, W): [Re_H, Im_H, Re_W, Im_W]
    const float* wt;       // (W, H): the spectral weights transposed
    const float* coils_r;  // (C, H, W)
    const float* coils_i;
    float* out;            // (B, 2, H, W)
    float* scratch;        // 30 planes of (B, H, W)
    int* counts;           // (B,)
    long long* prof;       // (kPhases,) or null
    int B, H, W, C, iterations, iterations_inner, cg_iterations, tv_iterations;
    float tol_inner;
    int clusters, team;
};

using Prof = rls::Prof<kPhases>;

// kSplit: the split route (teams of a.team CTAs a coil), else the
// resident one.
template <bool kPow2, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
splitbregman_cluster_kernel(const ResidentArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = a.H, W = a.W, C = a.C, nc = a.clusters;
    const int n = H * W;
    const int lg_w = rls::fftr::log2i(W);  // at powers of two
    const rls::Divisor by_w(kPow2 ? 1 : W);  // otherwise
    double* red = reinterpret_cast<double*>(smem);
    double* mine = red + 3 * (kThreads / 32);
    double* all = mine + 8;
    long long* pacc = reinterpret_cast<long long*>(all + 4);
    float* tw = reinterpret_cast<float*>(pacc + kPhases);
    // resident: one coil's padded spectrum; split: the band, then the block
    float* sre = tw + rls::ceil4(rls::twiddle_floats(H, W));
    float* sim = sre + (kSplit ? rls::split_band_floats(H, W, a.team)
                               : rls::ceil4(static_cast<size_t>(H) * (W + 1)));
    float* kre = sim + rls::split_band_floats(H, W, a.team);
    float* kim = kre + rls::split_block_floats(H, W, a.team);

    cg::cluster_group cl = cg::this_cluster();
    const int rank = static_cast<int>(cl.block_rank());
    const int b = blockIdx.x / nc;
    const int tid = threadIdx.x;
    // the band of rows this CTA owns: [r0, r1), pixels [p0, p1)
    const int r0 = rank * (H / nc) + min(rank, H % nc);
    const int r1 = r0 + H / nc + (rank < H % nc ? 1 : 0);
    const int p0 = r0 * W, p1 = r1 * W;
    Prof prof{blockIdx.x == 0 && tid == 0 ? a.prof : nullptr, pacc, 0};
    prof.start();
    auto sync_cluster = [&](int phase) {
        prof.mark(phase);
        if (nc > 1)
            cl.sync();
        else
            __syncthreads();
        prof.mark(kBarrier);
    };
    for (int k = tid; k < rls::twiddle_floats(H, W); k += kThreads) tw[k] = a.tw[k];
    __syncthreads();

    const size_t plane = static_cast<size_t>(a.B) * n;
    const size_t off = static_cast<size_t>(b) * n;
    auto sp = [&](int k) { return a.scratch + k * plane + off; };
    const float* x0r = a.x0hat + 2 * off;
    const float* x0i = x0r + n;
    float* xr = a.out + 2 * off;
    float* xi = xr + n;
    float *byr = sp(0), *byi = sp(1), *z1r = sp(2), *z1i = sp(3), *u1r = sp(4), *u1i = sp(5);
    float *z2r = sp(6), *z2i = sp(7), *u2r = sp(8), *u2i = sp(9);
    float *br = sp(10), *bi = sp(11), *rr = sp(12), *ri = sp(13), *pr = sp(14), *pi = sp(15);
    float *qr = sp(16), *qi = sp(17), *accr = sp(18), *acci = sp(19);
    // the FGP's duals, their momentum and its y, for plane k at 20 + 5 k
    auto fgp_plane = [&](int k, int j) { return sp(20 + 5 * k + j); };

    const float* scal = a.scal + 4 * b;
    const float rho1 = scal[0], rho2 = scal[1];
    const float rho_sum = rls::fadd(rho1, rho2);
    const float t1 = rls::fdiv(scal[2], rho1 != 0.f ? rho1 : 1.f);
    const float t2 = rls::fdiv(scal[3], rho2 != 0.f ? rho2 : 1.f);
    for (int i = p0 + tid; i < p1; i += kThreads) {
        const float zero = x0r[i] * 0.f;
        xr[i] = zero;
        xi[i] = zero;
        byr[i] = x0r[i];
        byi[i] = x0i[i];
    }

    int live = 0;
    int parity = 0;  // the slot of `mine` the next sum writes
    double acc[3];
    auto clear = [&]() { acc[0] = acc[1] = acc[2] = 0.0; };
    auto sum = [&]() {
        prof.mark(kVector);
        rls::cluster_sum3(acc, red, mine, all, cl, nc, parity);
        prof.mark(kSums);
        return static_cast<float>(acc[0]);
    };

    // What a normal op's result at pixel i (nr, ni) goes to: the CG's
    // start (r = beta - (A^H A + rho_sum I) x, p = r, r.r), its matvec
    // (q = (A^H A + rho_sum I) p, p.q) or the outer Bregman update
    // (beta_y = (beta_y + x0hat) - A^H A x). One switch, not a template
    // per call site: the transform's code exists once.
    enum { kStart, kMatvec, kBregman };
    auto finish = [&](int site, int i, float nr, float ni) {
        if (site == kStart) {
            const float vr = rls::fsub(br[i], rls::fadd(nr, rls::fmul(rho_sum, xr[i])));
            const float vi = rls::fsub(bi[i], rls::fadd(ni, rls::fmul(rho_sum, xi[i])));
            rr[i] = pr[i] = vr;
            ri[i] = pi[i] = vi;
            acc[0] += rls::dmul(vr, vr) + rls::dmul(vi, vi);
        } else if (site == kMatvec) {
            const float vr = rls::fadd(nr, rls::fmul(rho_sum, pr[i]));
            const float vi = rls::fadd(ni, rls::fmul(rho_sum, pi[i]));
            qr[i] = vr;
            qi[i] = vi;
            acc[0] += rls::dmul(pr[i], vr) + rls::dmul(pi[i], vi);
        } else {
            byr[i] = rls::fsub(rls::fadd(byr[i], x0r[i]), nr);
            byi[i] = rls::fsub(rls::fadd(byi[i], x0i[i]), ni);
        }
    };

    // The SENSE normal op of (vr, vi), handed to finish(site, i, nr, ni) at
    // each pixel i of the band (sense_cluster.cuh: CTA `rank` transforms
    // coils rank, rank + nc, ... in rounds, each round folded in coil
    // order; the sum between rounds waits in accr, acci).
    // On the split route the coils' spectra are split over teams
    // (sense_split.cuh).
    auto normal = [&](const float* vr, const float* vi, int site) {
        auto to = [&](int i, float nr, float ni) { finish(site, i, nr, ni); };
        if constexpr (kSplit) {
            const rls::SenseSplit sense{a.coils_r, a.coils_i, a.wt, tw, sre, sim, kre, kim,
                                        accr, acci, H, W, C, nc, a.team, rank, p0, p1};
            rls::sense_normal_split<kThreads, kFold, kPow2>(sense, vr, vi, cl, prof,
                                                            sync_cluster, to);
        } else {
            const rls::SenseCluster sense{a.coils_r, a.coils_i, a.wt, tw, sre, sim, accr, acci,
                                          H, W, C, nc, rank, p0, p1};
            rls::sense_normal_cluster<kThreads, kFold, kPow2>(sense, vr, vi, cl, prof,
                                                              sync_cluster, to);
        }
    };

    for (int outer = 0; outer < a.iterations; ++outer) {
        // x = 0 and the last fold's remote reads, before any transform
        sync_cluster(kVector);
        // the outer reset: z = x (identity trafos), u = 0
        for (int i = p0 + tid; i < p1; i += kThreads) {
            const float zero = xr[i] * 0.f;
            z1r[i] = z2r[i] = xr[i];
            z1i[i] = z2i[i] = xi[i];
            u1r[i] = u1i[i] = u2r[i] = u2i[i] = zero;
        }
        for (int inner = 0; inner < a.iterations_inner; ++inner) {
            // beta and ||beta||^2
            clear();
            for (int i = p0 + tid; i < p1; i += kThreads) {
                const float vr =
                    rls::fadd(rls::fadd(byr[i], rls::fmul(rho1, rls::fsub(z1r[i], u1r[i]))),
                              rls::fmul(rho2, rls::fsub(z2r[i], u2r[i])));
                const float vi =
                    rls::fadd(rls::fadd(byi[i], rls::fmul(rho1, rls::fsub(z1i[i], u1i[i]))),
                              rls::fmul(rho2, rls::fsub(z2i[i], u2i[i])));
                br[i] = vr;
                bi[i] = vi;
                acc[0] += rls::dmul(vr, vr) + rls::dmul(vi, vi);
            }
            const float target = rls::fmul(a.tol_inner, __fsqrt_rn(sum()));
            // the CG's start: r = beta - (A^H A + rho_sum I) x, p = r, r.r
            clear();
            normal(xr, xi, kStart);
            float rz = sum();

            for (int j = 0; j < a.cg_iterations; ++j) {
                // q = (A^H A + rho_sum I) p and p.q
                clear();
                normal(pr, pi, kMatvec);
                const float pq = sum();
                const bool active = rls::cg_active(rz, target);
                live += active ? 1 : 0;
                const float alpha = rls::cg_alpha(active, rz, pq);
                // x += alpha p, r -= alpha q, and r.r
                clear();
                for (int i = p0 + tid; i < p1; i += kThreads) {
                    xr[i] = rls::fadd(xr[i], rls::fmul(alpha, pr[i]));
                    xi[i] = rls::fadd(xi[i], rls::fmul(alpha, pi[i]));
                    const float vr = rls::fsub(rr[i], rls::fmul(alpha, qr[i]));
                    const float vi = rls::fsub(ri[i], rls::fmul(alpha, qi[i]));
                    rr[i] = vr;
                    ri[i] = vi;
                    acc[0] += rls::dmul(vr, vr) + rls::dmul(vi, vi);
                }
                const float rz_new = sum();
                const float beta_c = rls::cg_beta(rz, rz_new);
                // p = active ? r + beta_c p : p (every CTA agrees on active);
                // the whole p before the next step's coil loads
                if (active) {
                    for (int i = p0 + tid; i < p1; i += kThreads) {
                        pr[i] = rls::fadd(rr[i], rls::fmul(beta_c, pr[i]));
                        pi[i] = rls::fadd(ri[i], rls::fmul(beta_c, pi[i]));
                    }
                    sync_cluster(kVector);
                }
                rz = rz_new;
            }

            // z1 and u1; the TV input v = x + u2 goes to (br, bi)
            for (int i = p0 + tid; i < p1; i += kThreads) {
                const float ar = rls::fadd(xr[i], u1r[i]);
                const float ai = rls::fadd(xi[i], u1i[i]);
                const float gn = __fsqrt_rn(rls::fadd(rls::fmul(ar, ar), rls::fmul(ai, ai)));
                const float sc = fmaxf(rls::fdiv(rls::fsub(gn, t1), gn == 0.f ? 1.f : gn), 0.f);
                const float zr = rho1 != 0.f ? rls::fmul(ar, sc) : ar;
                const float zi = rho1 != 0.f ? rls::fmul(ai, sc) : ai;
                z1r[i] = zr;
                z1i[i] = zi;
                u1r[i] = rls::fsub(rls::fadd(u1r[i], xr[i]), zr);
                u1i[i] = rls::fsub(rls::fadd(u1i[i], xi[i]), zi);
                br[i] = rls::fadd(xr[i], u2r[i]);
                bi[i] = rls::fadd(xi[i], u2i[i]);
            }
            // z2 = FGP of each plane of v (ranks 0 and 1 at once), then u2
            const float* vp[2] = {br, bi};
            const float* xp[2] = {xr, xi};
            float* z2p[2] = {z2r, z2i};
            float* u2p[2] = {u2r, u2i};
            const bool tv = rho2 != 0.f && a.tv_iterations > 0;
            if (tv) {
                sync_cluster(kVector);  // the whole of v
                for (int k = 0; k < 2; ++k)
                    if (nc == 1 || rank == k)
                        rls::fold_fgp(vp[k], fgp_plane(k, 0), fgp_plane(k, 1), fgp_plane(k, 2),
                                      fgp_plane(k, 3), fgp_plane(k, 4), t2, a.t2tab,
                                      a.tv_iterations, false, H, W);
                sync_cluster(kFgp);  // the duals, for every band
            }
            for (int k = 0; k < 2; ++k) {
                const float* pv = fgp_plane(k, 0);
                const float* ph = fgp_plane(k, 1);
                for (int i = p0 + tid; i < p1; i += kThreads) {
                    const float zv =
                        rls::z_value(vp[k], pv, ph, i, kPow2 ? i >> lg_w : by_w.div(i), W,
                                     a.tv_iterations, rho2);
                    z2p[k][i] = zv;
                    u2p[k][i] = rls::fsub(rls::fadd(u2p[k][i], xp[k][i]), zv);
                }
            }
        }
        // the outer Bregman update: beta_y = (beta_y + x0hat) - A^H A x
        normal(xr, xi, kBregman);
        prof.mark(kVector);
    }
    if (rank == 0 && tid == 0) a.counts[b] = live;
    // no CTA leaves while another may still read its shared memory
    sync_cluster(kVector);
    prof.finish();
}

// The kernel of a cluster plan at H x W: resident (team 1) or split, with
// the radix-2 code where both sides are powers of two.
using ClusterKernel = void (*)(const ResidentArgs);
ClusterKernel cluster_kernel(int H, int W, int team) {
    if (rls::pow2_shape(H, W))
        return team == 1 ? splitbregman_cluster_kernel<true, false>
                         : splitbregman_cluster_kernel<true, true>;
    return team == 1 ? splitbregman_cluster_kernel<false, false>
                     : splitbregman_cluster_kernel<false, true>;
}


// ---- the grid route: each slice's coils over a team of CTAs that meet in
// L2

namespace sg = rls::sgrid;
// the phases of the grid route's timer: sense_grid.cuh's, then the vector
// phases, the team sums (their barriers included) and the banded FGP (its
// barriers included)
enum { kGridVector = sg::kPhases, kGridSums, kGridFgp, kGridPhases };
using GridProf = rls::Prof<kGridPhases>;
// the per-slot planes of the grid route: (re, im) of beta_y, z1, u1, z2,
// u2, beta, r, p, q, the coil sum between rounds and the TV input v = x +
// u2, then the FGP's pv, ph, rv, rh, y for each plane
constexpr int kGridPlanes = 32;
// the grid CTA's head of shared memory: the block sums (3 x 32 doubles)
// and the team's sums (4 doubles)
constexpr size_t kGridHead = sizeof(double) * (3 * (kThreads / 32) + 4);

// Shared memory of a CTA of the grid route at H x W whose two planes (re,
// im) hold `plane` floats each (sense_grid.cuh smem_bytes); the Python
// planner (kernels/splitbregman_fused.py grid_smem_bytes) counts the same:
// the sums (kGridHead), the twiddles, the two planes, and the phase timer
// (kGridPhases int64).
__host__ __device__ inline size_t grid_smem_bytes(int H, int W, size_t plane) {
    return sg::smem_bytes(H, W, plane, kGridHead, kGridPhases);
}

struct GridArgs {
    const float* x0hat;    // (B, 2, H, W)
    const float* scal;     // (B, 4) [rho1, rho2, lam1_eff, lam2_eff]
    const float* t2tab;    // (tv_iterations, 2)
    const float* tw;       // twiddle_floats(H, W): [Re_H, Im_H, Re_W, Im_W]
    const float* wt;       // (W, H): the spectral weights transposed
    const float* coils_r;  // (C, H, W)
    const float* coils_i;
    float* out;            // (B, 2, H, W)
    float2* spec;          // (slots, per_round, H, W): a slot's spectra
    float* planes;         // (slots, kGridPlanes, H, W)
    double* sums;          // (slots, 2, team, 4): the team's sums, two slots in turn
    unsigned* bar;         // (slots,): the teams' barrier counters, 0 at the launch
    int* counts;           // (B,)
    long long* prof;       // (kGridPhases,) or null
    int B, H, W, C, iterations, iterations_inner, cg_iterations, tv_iterations;
    float tol_inner;
    int team, slots, per_round, row_lines, col_lines, plane;
};

// The grid route. CTA blockIdx.x = slot team + rank is rank `rank` of the
// team of slot `slot`, which solves slices slot, slot + slots, ... in turn;
// the CTA owns the band of image rows Split(H, team) part `rank` of every
// plane. The SENSE normal op is sense_grid.cuh's, whose (R) reads its
// input in the band's rows only: no barrier orders the vector phases before
// it. What else a CTA reads that another wrote, and which team barrier
// orders it (planes a peer reads are written with __stcg and read with
// __ldcg; every other plane is the band's own, each pixel written and read
// by the CTA's threads, ordered by __syncthreads):
//   the team's sums (||beta||^2, r.r, p.q): each CTA's block sum (double,
//        rls::block_sum3) goes to its entry of the slot's sums; a team
//        barrier; every CTA adds the team's entries in rank order and
//        rounds once. Two entries a CTA, used in turn (as cluster_sum3's
//        two slots): an entry is written again two sums later, after the
//        middle sum's barrier, which each CTA reaches only after it has
//        read the peers' entries of the sum before.
//   the fold FGP (rls::fold_fgp's sweeps on the band, both planes in one
//        sweep): v = x + u2 is read one row below the band in its first
//        sweep, y one row below in the duals sweep, rv one row above in the
//        y sweep, and p (pv) one row above in the z2 update: a team barrier
//        before the first sweep (v whole), before each y sweep (rv whole),
//        before each duals sweep (y whole) and after the last (pv whole);
//        each also orders the reads before it against the next sweep's
//        writes of the same plane (WAR).
// Per CG step the normal op's 2 barriers a round and two sums; per inner
// iteration two more sums and 2 tv_iterations FGP barriers where TV is on.
template <bool kPow2>
__global__ void __launch_bounds__(kThreads, 1) splitbregman_grid_kernel(const GridArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = a.H, W = a.W, C = a.C, team = a.team;
    const int ntw = rls::twiddle_floats(H, W);
    double* red = reinterpret_cast<double*>(smem);
    double* all = red + 3 * (kThreads / 32);
    float* tw = reinterpret_cast<float*>(all + 4);
    float* re = tw + rls::ceil4(ntw);
    float* im = re + a.plane;
    long long* pacc = reinterpret_cast<long long*>(im + a.plane);

    const int slot = blockIdx.x / team, rank = blockIdx.x - slot * team;
    const int tid = threadIdx.x;
    GridProf prof{blockIdx.x == 0 && tid == 0 ? a.prof : nullptr, pacc, 0};
    prof.start();
    for (int k = tid; k < ntw; k += kThreads) tw[k] = a.tw[k];

    const int n = H * W;
    auto sp = [&](int k) { return a.planes + (static_cast<size_t>(slot) * kGridPlanes + k) * n; };
    float *byr = sp(0), *byi = sp(1), *z1r = sp(2), *z1i = sp(3), *u1r = sp(4), *u1i = sp(5);
    float *z2r = sp(6), *z2i = sp(7), *u2r = sp(8), *u2i = sp(9);
    float *br = sp(10), *bi = sp(11), *rr = sp(12), *ri = sp(13), *pr = sp(14), *pi = sp(15);
    float *qr = sp(16), *qi = sp(17);
    // the TV input v and the FGP's planes of plane k: pv, ph, rv, rh, y
    float* vp[2] = {sp(20), sp(21)};
    auto fgp_plane = [&](int k, int j) { return sp(22 + 5 * k + j); };
    const sg::SenseGrid g{a.coils_r, a.coils_i, a.wt, tw, re, im,
                          a.spec + static_cast<size_t>(slot) * a.per_round * n, sp(18), sp(19),
                          a.bar + slot, H, W, C, team, rank, a.per_round, a.row_lines,
                          a.col_lines};
    double* sums = a.sums + static_cast<size_t>(slot) * 2 * team * 4;
    const rls::Split rsp(H, team);
    const int r0 = rsp.start(rank), R = rsp.size(rank);
    const int p0 = r0 * W, p1 = p0 + R * W;  // the band's pixels
    const rls::Sweep<kThreads> sweep(R * W, W);
    unsigned target = 0;
    int parity = 0;  // the entry of the team's sums the next sum writes
    __syncthreads();  // the twiddles
    prof.mark(sg::kSetup);

    auto team_sync = [&]() { rls::grid::group_sync(g.ctr, target, team); };
    double acc[3];
    auto clear = [&]() { acc[0] = acc[1] = acc[2] = 0.0; };
    auto sum = [&]() {
        prof.mark(kGridVector);
        rls::block_sum3(acc, red);
        if (team > 1) {
            if (tid == 0)
                for (int k = 0; k < 3; ++k) __stcg(sums + (parity * team + rank) * 4 + k, acc[k]);
            team_sync();
            if (tid == 0) {
                double t[3] = {0.0, 0.0, 0.0};
                for (int q = 0; q < team; ++q)
                    for (int k = 0; k < 3; ++k) t[k] += __ldcg(sums + (parity * team + q) * 4 + k);
                for (int k = 0; k < 3; ++k) all[k] = t[k];
            }
            __syncthreads();
            for (int k = 0; k < 3; ++k) acc[k] = all[k];
            parity ^= 1;
        }
        prof.mark(kGridSums);
        return static_cast<float>(acc[0]);
    };

    for (int b = slot; b < a.B; b += a.slots) {
        const size_t off = 2 * static_cast<size_t>(b) * n;
        const float* x0r = a.x0hat + off;
        const float* x0i = x0r + n;
        float* xr = a.out + off;
        float* xi = xr + n;
        const float* scal = a.scal + 4 * b;
        const float rho1 = scal[0], rho2 = scal[1];
        const float rho_sum = rls::fadd(rho1, rho2);
        const float t1 = rls::fdiv(scal[2], rho1 != 0.f ? rho1 : 1.f);
        const float t2 = rls::fdiv(scal[3], rho2 != 0.f ? rho2 : 1.f);
        const bool tv = rho2 != 0.f && a.tv_iterations > 0;
        for (int i = p0 + tid; i < p1; i += kThreads) {
            const float zero = __ldg(x0r + i) * 0.f;
            xr[i] = zero;
            xi[i] = zero;
            byr[i] = __ldg(x0r + i);
            byi[i] = __ldg(x0i + i);
        }
        __syncthreads();
        prof.mark(sg::kSetup);
        int live = 0;

        // What a normal op's result at pixel i (nr, ni) goes to, as on the
        // cluster routes: the CG's start, its matvec or the outer Bregman
        // update.
        enum { kStart, kMatvec, kBregman };
        auto finish = [&](int site, int i, float nr, float ni) {
            if (site == kStart) {
                const float vr = rls::fsub(br[i], rls::fadd(nr, rls::fmul(rho_sum, xr[i])));
                const float vi = rls::fsub(bi[i], rls::fadd(ni, rls::fmul(rho_sum, xi[i])));
                rr[i] = pr[i] = vr;
                ri[i] = pi[i] = vi;
                acc[0] += rls::dmul(vr, vr) + rls::dmul(vi, vi);
            } else if (site == kMatvec) {
                const float vr = rls::fadd(nr, rls::fmul(rho_sum, pr[i]));
                const float vi = rls::fadd(ni, rls::fmul(rho_sum, pi[i]));
                qr[i] = vr;
                qi[i] = vi;
                acc[0] += rls::dmul(pr[i], vr) + rls::dmul(pi[i], vi);
            } else {
                byr[i] = rls::fsub(rls::fadd(byr[i], __ldg(x0r + i)), nr);
                byi[i] = rls::fsub(rls::fadd(byi[i], __ldg(x0i + i)), ni);
            }
        };
        auto normal = [&](const float* vr, const float* vi, int site) {
            sg::forward_band<kThreads, kPow2>(g, vr, vi, prof);
            sg::sense_normal_grid<kThreads, kPow2>(
                g, vr, vi, target, prof, [&](int i, float nr, float ni) { finish(site, i, nr, ni); },
                [](int, int) {});
        };

        for (int outer = 0; outer < a.iterations; ++outer) {
            // the outer reset: z = x (identity trafos), u = 0
            for (int i = p0 + tid; i < p1; i += kThreads) {
                const float zero = xr[i] * 0.f;
                z1r[i] = z2r[i] = xr[i];
                z1i[i] = z2i[i] = xi[i];
                u1r[i] = u1i[i] = u2r[i] = u2i[i] = zero;
            }
            for (int inner = 0; inner < a.iterations_inner; ++inner) {
                // beta and ||beta||^2
                clear();
                for (int i = p0 + tid; i < p1; i += kThreads) {
                    const float vr =
                        rls::fadd(rls::fadd(byr[i], rls::fmul(rho1, rls::fsub(z1r[i], u1r[i]))),
                                  rls::fmul(rho2, rls::fsub(z2r[i], u2r[i])));
                    const float vi =
                        rls::fadd(rls::fadd(byi[i], rls::fmul(rho1, rls::fsub(z1i[i], u1i[i]))),
                                  rls::fmul(rho2, rls::fsub(z2i[i], u2i[i])));
                    br[i] = vr;
                    bi[i] = vi;
                    acc[0] += rls::dmul(vr, vr) + rls::dmul(vi, vi);
                }
                const float target_r = rls::fmul(a.tol_inner, __fsqrt_rn(sum()));
                // the CG's start: r = beta - (A^H A + rho_sum I) x, p = r, r.r
                clear();
                normal(xr, xi, kStart);
                float rz = sum();

                for (int j = 0; j < a.cg_iterations; ++j) {
                    // q = (A^H A + rho_sum I) p and p.q
                    clear();
                    normal(pr, pi, kMatvec);
                    const float pq = sum();
                    const bool active = rls::cg_active(rz, target_r);
                    live += active ? 1 : 0;
                    const float alpha = rls::cg_alpha(active, rz, pq);
                    // x += alpha p, r -= alpha q, and r.r
                    clear();
                    for (int i = p0 + tid; i < p1; i += kThreads) {
                        xr[i] = rls::fadd(xr[i], rls::fmul(alpha, pr[i]));
                        xi[i] = rls::fadd(xi[i], rls::fmul(alpha, pi[i]));
                        const float vr = rls::fsub(rr[i], rls::fmul(alpha, qr[i]));
                        const float vi = rls::fsub(ri[i], rls::fmul(alpha, qi[i]));
                        rr[i] = vr;
                        ri[i] = vi;
                        acc[0] += rls::dmul(vr, vr) + rls::dmul(vi, vi);
                    }
                    const float rz_new = sum();
                    const float beta_c = rls::cg_beta(rz, rz_new);
                    // p = active ? r + beta_c p : p (every CTA agrees on
                    // active); the band's own rows, which the next normal
                    // op reads in (R) alone
                    if (active)
                        for (int i = p0 + tid; i < p1; i += kThreads) {
                            pr[i] = rls::fadd(rr[i], rls::fmul(beta_c, pr[i]));
                            pi[i] = rls::fadd(ri[i], rls::fmul(beta_c, pi[i]));
                        }
                    rz = rz_new;
                }

                // z1 and u1; the TV input v = x + u2, which peers read
                for (int i = p0 + tid; i < p1; i += kThreads) {
                    const float ar = rls::fadd(xr[i], u1r[i]);
                    const float ai = rls::fadd(xi[i], u1i[i]);
                    const float gn = __fsqrt_rn(rls::fadd(rls::fmul(ar, ar), rls::fmul(ai, ai)));
                    const float sc =
                        fmaxf(rls::fdiv(rls::fsub(gn, t1), gn == 0.f ? 1.f : gn), 0.f);
                    const float zr = rho1 != 0.f ? rls::fmul(ar, sc) : ar;
                    const float zi = rho1 != 0.f ? rls::fmul(ai, sc) : ai;
                    z1r[i] = zr;
                    z1i[i] = zi;
                    u1r[i] = rls::fsub(rls::fadd(u1r[i], xr[i]), zr);
                    u1i[i] = rls::fsub(rls::fadd(u1i[i], xi[i]), zi);
                    __stcg(vp[0] + i, rls::fadd(xr[i], u2r[i]));
                    __stcg(vp[1] + i, rls::fadd(xi[i], u2i[i]));
                }
                if (tv) {
                    // z2 = the fold FGP of each plane of v (rls::fold_fgp's
                    // operations in its order), both planes in each sweep of
                    // the band
                    prof.mark(kGridVector);
                    const float lt = t2;
                    auto fgp_sync = [&]() {
                        prof.mark(kGridFgp);
                        team_sync();
                        prof.mark(kGridFgp);
                    };
                    fgp_sync();  // v whole
                    sweep([&](int i, int lr, int c) {
                        const int gi = p0 + i, r = r0 + lr;
                        for (int k = 0; k < 2; ++k) {
                            const float* xs = vp[k];
                            const float y0 = __ldcg(xs + gi) * 0.125f;
                            const float qv = r < H - 1
                                ? rls::clip(__ldcg(xs + gi + W) * 0.125f - y0, -lt, lt)
                                : 0.f;
                            const float qh = c < W - 1
                                ? rls::clip(__ldcg(xs + gi + 1) * 0.125f - y0, -lt, lt)
                                : 0.f;
                            __stcg(fgp_plane(k, 0) + gi, qv);
                            __stcg(fgp_plane(k, 2) + gi, qv);
                            fgp_plane(k, 1)[gi] = qh;
                            fgp_plane(k, 3)[gi] = qh;
                        }
                    });
                    for (int kk = 1; kk < a.tv_iterations; ++kk) {
                        const float c1 = a.t2tab[2 * kk];
                        const float c2 = a.t2tab[2 * kk + 1];
                        fgp_sync();  // rv whole
                        sweep([&](int i, int lr, int c) {
                            const int gi = p0 + i, r = r0 + lr;
                            for (int k = 0; k < 2; ++k) {
                                const float* rv = fgp_plane(k, 2);
                                const float* rh = fgp_plane(k, 3);
                                const float up = r > 0 ? __ldcg(rv + gi - W) : 0.f;
                                const float left = c > 0 ? rh[gi - 1] : 0.f;
                                const float gt = (up - __ldcg(rv + gi)) + (left - rh[gi]);
                                __stcg(fgp_plane(k, 4) + gi, (__ldcg(vp[k] + gi) - gt) * 0.125f);
                            }
                        });
                        fgp_sync();  // y whole
                        sweep([&](int i, int lr, int c) {
                            const int gi = p0 + i, r = r0 + lr;
                            for (int k = 0; k < 2; ++k) {
                                float* pv = fgp_plane(k, 0);
                                float* ph = fgp_plane(k, 1);
                                float* rv = fgp_plane(k, 2);
                                float* rh = fgp_plane(k, 3);
                                const float* y = fgp_plane(k, 4);
                                const float yv = __ldcg(y + gi);
                                const float qv = r < H - 1
                                    ? rls::clip(__ldcg(rv + gi) + (__ldcg(y + gi + W) - yv), -lt,
                                                lt)
                                    : 0.f;
                                const float qh = c < W - 1
                                    ? rls::clip(rh[gi] + (__ldcg(y + gi + 1) - yv), -lt, lt)
                                    : 0.f;
                                __stcg(rv + gi, rls::fsub(rls::fmul(c1, qv),
                                                          rls::fmul(c2, __ldcg(pv + gi))));
                                rh[gi] = rls::fsub(rls::fmul(c1, qh), rls::fmul(c2, ph[gi]));
                                __stcg(pv + gi, qv);
                                ph[gi] = qh;
                            }
                        });
                    }
                    fgp_sync();  // pv whole
                }
                // z2 = v - grad_t(pv, ph) (v where TV is off), then u2
                float* z2p[2] = {z2r, z2i};
                float* u2p[2] = {u2r, u2i};
                const float* xp[2] = {xr, xi};
                sweep([&](int i, int lr, int c) {
                    const int gi = p0 + i, r = r0 + lr;
                    for (int k = 0; k < 2; ++k) {
                        const float v = __ldcg(vp[k] + gi);
                        float zv = v;
                        if (tv) {
                            const float* pv = fgp_plane(k, 0);
                            const float* ph = fgp_plane(k, 1);
                            const float up = r > 0 ? __ldcg(pv + gi - W) : 0.f;
                            const float left = c > 0 ? ph[gi - 1] : 0.f;
                            zv = v - ((up - __ldcg(pv + gi)) + (left - ph[gi]));
                        }
                        z2p[k][gi] = zv;
                        u2p[k][gi] = rls::fsub(rls::fadd(u2p[k][gi], xp[k][gi]), zv);
                    }
                });
                __syncthreads();
            }
            // the outer Bregman update: beta_y = (beta_y + x0hat) - A^H A x
            normal(xr, xi, kBregman);
            prof.mark(kGridVector);
        }
        if (rank == 0 && tid == 0) a.counts[b] = live;
    }
    prof.finish();
}

const void* grid_kernel(int H, int W) {
    return rls::pow2_shape(H, W)
               ? reinterpret_cast<const void*>(&splitbregman_grid_kernel<true>)
               : reinterpret_cast<const void*>(&splitbregman_grid_kernel<false>);
}

}  // namespace

extern "C" {

// A cluster route's shared memory per CTA at H x W on teams of `team` CTAs
// (1: the resident route; the planner's check), and how many clusters of
// `clusters` CTAs the current device holds at once
// (cudaOccupancyMaxActiveClusters): out[0], out[1].
int splitbregman_cluster_occupancy(int clusters, int team, int H, int W, long long* out) {
    if (clusters < 1 || clusters > kMaxCluster || team < 1 || team > kMaxCluster ||
        team > H || team > W || !rls::valid_fft_size(H) || !rls::valid_fft_size(W))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = cluster_smem_bytes(H, W, team);
    out[0] = static_cast<long long>(smem);
    out[1] = 0;
    if (smem > 0x7fffffff) return 0;
    out[1] = rls::max_active_clusters(cluster_kernel(H, W, team), clusters, kThreads,
                                      static_cast<int>(smem));
    return 0;
}

// The resident and split routes: x0hat, out: (B, 2, H, W) f32, the split
// [re; im] image; scal: (B, 4) [rho1, rho2, lam1_eff, lam2_eff] (the L21
// and the TV term); t2tab: (tv_iterations, 2) [1 + t2, t2]; tw:
// twiddle_floats(H, W) floats [Re_H, Im_H, Re_W, Im_W]; wt: the spectral
// weights transposed ((W, H)); coils_r, coils_i: (C, H, W); counts: (B,)
// int32, the live CG steps; scratch 30 planes of (B, H, W), prof
// null or kPhases int64 that receive CTA 0's clocks per phase, and the
// plan: `clusters` CTAs per slice in teams of `team` CTAs a coil (team 1:
// resident, one coil a CTA; valid_plan), `smem` bytes of shared memory per
// CTA. Returns cudaErrorInvalidValue for a plan that is not valid or whose
// smem differs from cluster_smem_bytes, else the launch's error.
int splitbregman_cluster_launch(const void* x0hat, const void* scal, const void* t2tab,
                                const void* tw, const void* wt, const void* coils_r,
                                const void* coils_i, void* out, void* scratch, void* counts,
                                void* prof, int B, int H, int W, int C, int iterations,
                                int iterations_inner, int cg_iterations, int tv_iterations,
                                float tol_inner, int clusters, int team, int smem,
                                void* stream) {
    const bool valid = B > 0 && rls::valid_fft_size(H) && rls::valid_fft_size(W) &&
                       valid_plan(clusters, team, H, W, C) &&
                       static_cast<long long>(B) * clusters < (1LL << 31);
    if (!valid || static_cast<size_t>(smem) != cluster_smem_bytes(H, W, team))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = cluster_kernel(H, W, team);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    cudaError_t e = rls::cluster_config(kernel, B, clusters, kThreads, smem,
                                        static_cast<cudaStream_t>(stream), &attr, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    const ResidentArgs args{static_cast<const float*>(x0hat), static_cast<const float*>(scal),
                            static_cast<const float*>(t2tab), static_cast<const float*>(tw),
                            static_cast<const float*>(wt), static_cast<const float*>(coils_r),
                            static_cast<const float*>(coils_i), static_cast<float*>(out),
                            static_cast<float*>(scratch), static_cast<int*>(counts),
                            static_cast<long long*>(prof), B, H, W, C, iterations,
                            iterations_inner, cg_iterations, tv_iterations, tol_inner, clusters,
                            team};
    e = cudaLaunchKernelEx(&cfg, kernel, args);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// The grid route's CTAs of `smem` bytes of shared memory (a plane of
// sg::plane_floats floats each, which must be a whole number of float4)
// that the current device holds at once: out[0] a SM, out[1] on all of its
// SMs.
int splitbregman_grid_occupancy(int H, int W, int smem, long long* out) {
    out[0] = out[1] = 0;
    if (!rls::valid_fft_size(H) || !rls::valid_fft_size(W) || smem < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t plane = sg::plane_floats(H, W, smem, kGridHead, kGridPhases);
    if (plane == 0 || plane % 4 || grid_smem_bytes(H, W, plane) != static_cast<size_t>(smem))
        return static_cast<int>(cudaErrorInvalidValue);
    return sg::occupancy(grid_kernel(H, W), kThreads, smem, out);
}

// The grid route: x0hat, scal, t2tab, tw, wt, coils_r, coils_i, out and
// counts as for the cluster routes; scratch: slots x per_round spectra (H,
// W) of complex f32 (interleaved), then slots x kGridPlanes planes (H, W)
// f32, then the team's sums (slots x 2 x team x 4 float64); bar: slots
// uint32 counters, 0 at the launch; prof null or kGridPhases int64 that
// receive CTA 0's clocks per phase; the plan as for sense_grid_launch
// (sg::valid_plan). One cooperative launch of team x slots CTAs, all
// resident at once. Returns cudaErrorInvalidValue for a plan valid_plan
// refuses, else the launch's error.
int splitbregman_grid_launch(const void* x0hat, const void* scal, const void* t2tab,
                             const void* tw, const void* wt, const void* coils_r,
                             const void* coils_i, void* out, void* scratch, void* bar,
                             void* counts, void* prof, int B, int H, int W, int C, int iterations,
                             int iterations_inner, int cg_iterations, int tv_iterations,
                             float tol_inner, int team, int slots, int per_round, int row_lines,
                             int col_lines, int smem, void* stream) {
    if (B < 1 || iterations < 0 || iterations_inner < 0 || cg_iterations < 0 ||
        tv_iterations < 0 ||
        !sg::valid_plan(B, H, W, C, team, slots, per_round, row_lines, col_lines, smem,
                        kGridHead, kGridPhases))
        return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = grid_kernel(H, W);
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t n = static_cast<size_t>(H) * W;
    float2* spec = static_cast<float2*>(scratch);
    float* planes = reinterpret_cast<float*>(spec + static_cast<size_t>(slots) * per_round * n);
    GridArgs args{static_cast<const float*>(x0hat),
                  static_cast<const float*>(scal),
                  static_cast<const float*>(t2tab),
                  static_cast<const float*>(tw),
                  static_cast<const float*>(wt),
                  static_cast<const float*>(coils_r),
                  static_cast<const float*>(coils_i),
                  static_cast<float*>(out),
                  spec,
                  planes,
                  reinterpret_cast<double*>(planes + static_cast<size_t>(slots) * kGridPlanes * n),
                  static_cast<unsigned*>(bar),
                  static_cast<int*>(counts),
                  static_cast<long long*>(prof),
                  B,
                  H,
                  W,
                  C,
                  iterations,
                  iterations_inner,
                  cg_iterations,
                  tv_iterations,
                  tol_inner,
                  team,
                  slots,
                  per_round,
                  row_lines,
                  col_lines,
                  static_cast<int>(sg::plane_floats(H, W, smem, kGridHead, kGridPhases))};
    void* kargs[] = {&args};
    e = cudaLaunchCooperativeKernel(fn, dim3(team * slots), dim3(kThreads), kargs,
                                    static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
