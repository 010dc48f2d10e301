// The whole batched FISTA-L21 multi-coil SENSE solve in one launch, on one
// of three routes that the host planner (kernels/sense_fused.py plan_sense)
// picks by shape:
//
// * resident: each slice runs on a thread-block cluster of c CTAs (c <= C,
//   at most 16), CTA k computing the 2-D FFTs of coils k, k + c, ... in
//   rounds, each coil's padded spectrum whole in its shared memory with the
//   FFT's stages in registers (fft_resident.cuh), the coils folded into
//   each CTA's band of rows through DSMEM (sense_cluster.cuh, shared with
//   the SplitBregman kernel);
// * split: the same cluster kernel for shapes whose padded spectrum, H (W +
//   1) complex floats, fits no CTA (192^2): each coil's spectrum split over
//   a team of `team` CTAs, each holding a band of its rows and a block of
//   its columns, the transposes pushed through DSMEM (sense_split.cuh, row
//   8's three passes), the coils of a round folded as on the resident route;
// * grid: for shapes whose spectrum fits no team of 16 (512^2, 1024^2), one
//   cooperative launch whose CTAs are all resident at once: each slice on a
//   team of CTAs that meet at barriers of their own in L2 (group_sync.cuh),
//   `slots` slices at once, each coil's spectrum in global scratch, CTA j
//   of a team owning a band of the image's rows and a block of the
//   spectrum's columns for every coil, per_round coils a round
//   (sense_grid.cuh, which holds the table of what its barriers order).
//
// Replaces the TPU kernel rls_tpu/kernels/sense_fused.py:_kernel (:33-82;
// launched by fista_l21_sense_fused, :85, pallas_call :107). The complex
// image x = (xr, xi), complex L1 as the group soft threshold over (re, im)
// pairs; per iteration, from x = x_prev = 0:
//   m   = x + a (x - x_prev)                  (both planes; a: table column 0)
//   g   = m - rho (sum_c conj(C_c) F^H M F C_c m - x0hat)
//   |g| = sqrt(gr^2 + gi^2)
//   x   = g max((|g| - rho lam) / (|g| == 0 ? 1 : |g|), 0)
// The SENSE normal op sums the coils in order c = 0 .. C-1, ((acc + a yr)
// + b yi, (acc + a yi) - b yr); the gradient step and the threshold are
// formed as the last coil is folded in. Every f32 operation is rounded on
// its own, as in the plain PyTorch version (fista_l21_sense_fused_torch in
// rls_tpu_torch/kernels/sense_fused.py), with which every route agrees bit
// for bit.
//
// What bounds it on an H100: per iteration C normal ops (2 C complex 2-D
// transforms at 5 n log2 n: 13.8 MFLOP at 128^2 and 6 coils), one
// dependent chain per slice, so the solve is bound by that chain's latency,
// not by bytes or operations. The resident route shortens the chain and
// widens it: the
// coils of an iteration transform at once on the cluster's CTAs (48 CTAs
// for 8 slices of 6 coils), and a coil's transform pair is three passes
// over its plane in shared memory with a barrier after each, its 14
// radix-2 stages per point in registers and shuffles.
//
// Resident route, where each buffer lives and which barrier orders each
// read of what another CTA wrote. CTA `rank` owns the image rows [r0, r1)
// of its slice (H / c rows, one more for the first H % c ranks; a band is
// empty where H < c) and writes only those rows of the global planes:
//   shared memory: the phase timer, the twiddles, and one coil's spectrum
//     (H (W + 1) floats each for re and im), which ends a transform holding
//     the coil's normal op F^H M F (C_c m);
//   global memory, per slice (L2-resident: 8 slices x 8 planes x 64 KiB):
//     x (out), x_prev, m and the coil sum between rounds; a band's x,
//     x_prev and coil sum are read back only by the thread that wrote them.
// Per iteration:
//   A. after the momentum step writes the band's m, a cluster barrier: it
//      orders the whole of m before any transform reads it (every CTA's
//      coil loads read all of m through L2), and the last iteration's
//      remote reads of every spectrum (its last fold) before the
//      transforms below rewrite it;
//   B. after each round's transforms, a cluster barrier: the fold reads
//      the round's results from the CTAs that computed them through DSMEM;
//   C. after each fold but the last round's, a cluster barrier: every
//      remote read of a spectrum before the next round rewrites it.
// A CTA writes m of the next iteration only after barrier B of the last
// round, which every CTA reaches after its last coil load of this m. The
// kernel ends with a cluster barrier, so that no CTA exits while another
// still reads its shared memory (iterations = 1 included). Per iteration
// with C <= c: two cluster barriers. The split route keeps barrier A and
// the final one, and runs the normal op of sense_split.cuh in place of B
// and C: four cluster barriers a round, three in the last (its header
// holds the table of what each orders).
//
// A phase timer (prof): CTA 0's thread 0 adds the SM clocks between its
// phase marks (coil loads, row FFTs, column FFTs, coil fold with the
// gradient step and threshold of the last round, the momentum step and set-up,
// cluster barriers); off where prof is null.
//
// Grid route, per slice: x = x_prev = 0 and m on the band, (R) of the
// first round; per iteration sense_grid.cuh's normal op of m, whose last
// fold forms the gradient step, the group threshold, x_prev and the next
// m pixel by pixel of the band (the CTA's own rows: no barrier orders them),
// and whose last (R') is followed on each chunk by the next iteration's (R):
// an iteration whose coils go in R rounds meets 2 R times. Its timer: CTA
// 0's thread 0 adds the SM clocks of set-up, row loads, rows back, the coil
// fold with the pixel update, rows forward with their stores, column
// loads, column transforms, column stores, and the waits at T1 and T2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_common.cuh"
#include "dft_common.cuh"
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
enum { kLoads, kRows, kCols, kFold, kUpdate, kBarrier, kPhases };
static_assert(kLoads == rls::fftr::kFftLoads && kRows == rls::fftr::kFftRows &&
                  kCols == rls::fftr::kFftCols,
              "the timer's FFT phases");

// Shared memory of a CTA of the resident route, in this order; the Python
// planner (kernels/sense_fused.py resident_smem_bytes) counts the same: the
// phase timer (kPhases int64), the twiddles (twiddle_floats(H, W) floats:
// H + W at powers of two) and one coil's padded spectrum (H (W + 1) floats
// for re, then as many for im), each float array rounded up to 4 floats.
__host__ __device__ inline size_t resident_smem_bytes(int H, int W) {
    return sizeof(long long) * kPhases +
           sizeof(float) *
               (rls::ceil4(rls::twiddle_floats(H, W)) +
                2 * rls::ceil4(static_cast<size_t>(H) * (W + 1)));
}

// Shared memory of a CTA of the split route on teams of `team` CTAs, in
// this order (split_smem_bytes in kernels/sense_fused.py counts the same):
// the phase timer and the twiddles as above, the band (ceil(H / team) W
// floats for re, then as many for im) and the column block (H (ceil(W /
// team) + 1) floats for re, then as many for im), each float array rounded
// up to 4 floats.
__host__ __device__ inline size_t split_smem_bytes(int H, int W, int team) {
    return sizeof(long long) * kPhases +
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

struct ClusterArgs {
    const float* x0hat;    // (B, 2, H, W)
    const float* scal;     // (B, 2) [rho, lam_eff]
    const float* tab;      // (iterations, 4): the momentum table
    const float* tw;       // twiddle_floats(H, W): [Re_H, Im_H, Re_W, Im_W]
    const float* wt;       // (W, H): the spectral weights transposed
    const float* coils_r;  // (C, H, W)
    const float* coils_i;
    float* out;            // (B, 2, H, W)
    float* scratch;        // 6 planes of (B, H, W)
    long long* prof;       // (kPhases,) or null
    int B, H, W, C, iterations, clusters, team;
};

using Prof = rls::Prof<kPhases>;

// kSplit: the split route (teams of a.team CTAs a coil), else the
// resident one.
template <bool kPow2, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
sense_cluster_kernel(const ClusterArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = a.H, W = a.W, nc = a.clusters;
    const int n = H * W;
    long long* pacc = reinterpret_cast<long long*>(smem);
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
    float *mr = sp(0), *mi = sp(1), *pr = sp(2), *pi = sp(3), *accr = sp(4), *acci = sp(5);

    const float rho = a.scal[2 * b];
    const float t = rls::fmul(rho, a.scal[2 * b + 1]);
    for (int i = p0 + tid; i < p1; i += kThreads) {
        const float zero = x0r[i] * 0.f;
        xr[i] = zero;
        xi[i] = zero;
        pr[i] = zero;
        pi[i] = zero;
    }

    // the gradient step and the group threshold at pixel i of the band, from
    // the normal op's (nr, ni)
    auto finish = [&](int i, float nr, float ni) {
        const float gr = rls::fsub(mr[i], rls::fmul(rho, rls::fsub(nr, x0r[i])));
        const float gi = rls::fsub(mi[i], rls::fmul(rho, rls::fsub(ni, x0i[i])));
        const float gn = __fsqrt_rn(rls::fadd(rls::fmul(gr, gr), rls::fmul(gi, gi)));
        const float sc = fmaxf(rls::fdiv(rls::fsub(gn, t), gn == 0.f ? 1.f : gn), 0.f);
        pr[i] = xr[i];
        pi[i] = xi[i];
        xr[i] = rls::fmul(gr, sc);
        xi[i] = rls::fmul(gi, sc);
    };

    for (int it = 0; it < a.iterations; ++it) {
        const float am = a.tab[4 * it];
        for (int i = p0 + tid; i < p1; i += kThreads) {
            const float vr = xr[i], vi = xi[i];
            mr[i] = rls::fadd(vr, rls::fmul(am, rls::fsub(vr, pr[i])));
            mi[i] = rls::fadd(vi, rls::fmul(am, rls::fsub(vi, pi[i])));
        }
        sync_cluster(kUpdate);  // A: the whole of m; the last fold's remote reads
        if constexpr (kSplit) {
            const rls::SenseSplit sense{a.coils_r, a.coils_i, a.wt, tw, sre, sim, kre, kim,
                                        accr, acci, H, W, a.C, nc, a.team, rank, p0, p1};
            rls::sense_normal_split<kThreads, kFold, kPow2>(sense, mr, mi, cl, prof,
                                                            sync_cluster, finish);
        } else {
            const rls::SenseCluster sense{a.coils_r, a.coils_i, a.wt, tw, sre, sim, accr, acci,
                                          H, W, a.C, nc, rank, p0, p1};
            rls::sense_normal_cluster<kThreads, kFold, kPow2>(sense, mr, mi, cl, prof,
                                                              sync_cluster, finish);
        }
    }
    // no CTA leaves while another may still read its shared memory
    sync_cluster(kUpdate);
    prof.finish();
}

// The kernel of a cluster plan at H x W: resident (team 1) or split, with
// the radix-2 code where both sides are powers of two.
using ClusterKernel = void (*)(const ClusterArgs);
ClusterKernel cluster_kernel(int H, int W, int team) {
    if (rls::pow2_shape(H, W))
        return team == 1 ? sense_cluster_kernel<true, false> : sense_cluster_kernel<true, true>;
    return team == 1 ? sense_cluster_kernel<false, false> : sense_cluster_kernel<false, true>;
}


// ---- the grid route: each slice's coils over a team of CTAs that meet in
// L2

namespace sg = rls::sgrid;
using GridProf = rls::Prof<sg::kPhases>;
// the per-slot planes of the grid route: m, x_prev and the coil sum between
// rounds, (re, im) each
constexpr int kGridPlanes = 6;

// Shared memory of a CTA of the grid route at H x W whose two planes (re,
// im) hold `plane` floats each (sense_grid.cuh smem_bytes: no head); the
// Python planner (kernels/sense_fused.py grid_smem_bytes) counts the same:
// the twiddles, the two planes, and the phase timer (sg::kPhases int64).
__host__ __device__ inline size_t grid_smem_bytes(int H, int W, size_t plane) {
    return sg::smem_bytes(H, W, plane, 0, sg::kPhases);
}

struct GridArgs {
    const float* x0hat;    // (B, 2, H, W)
    const float* scal;     // (B, 2) [rho, lam_eff]
    const float* tab;      // (iterations, 4): the momentum table
    const float* tw;       // twiddle_floats(H, W): [Re_H, Im_H, Re_W, Im_W]
    const float* wt;       // (W, H): the spectral weights transposed
    const float* coils_r;  // (C, H, W)
    const float* coils_i;
    float* out;            // (B, 2, H, W)
    float2* spec;          // (slots, per_round, H, W): a slot's spectra
    float* planes;         // (slots, kGridPlanes, H, W)
    unsigned* bar;         // (slots,): the teams' barrier counters, 0 at the launch
    long long* prof;       // (sg::kPhases,) or null
    int B, H, W, C, iterations, team, slots, per_round, row_lines, col_lines, plane;
};

// The grid route (sense_grid.cuh holds the table of what its barriers
// order). CTA blockIdx.x = slot team + rank is rank `rank` of the team of
// slot `slot`, which solves slices slot, slot + slots, ... in turn. Per
// slice: x = x_prev = 0 and m on the band, (R) of the first round; per
// iteration the normal op of m, whose last fold forms, pixel by pixel of
// the band, the gradient step, the group threshold, x_prev = x and the next
// iteration's m, and whose last (R') is followed on each chunk by the next
// iteration's (R) of the first round: an iteration with every coil in one
// round meets twice (T1, T2).
template <bool kPow2>
__global__ void __launch_bounds__(kThreads, 1) sense_grid_kernel(const GridArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = a.H, W = a.W, team = a.team;
    const int ntw = rls::twiddle_floats(H, W);
    float* tw = reinterpret_cast<float*>(smem);
    float* re = tw + rls::ceil4(ntw);
    float* im = re + a.plane;
    long long* pacc = reinterpret_cast<long long*>(im + a.plane);

    const int slot = blockIdx.x / team, rank = blockIdx.x - slot * team;
    const int tid = threadIdx.x;
    GridProf prof{blockIdx.x == 0 && tid == 0 ? a.prof : nullptr, pacc, 0};
    prof.start();
    for (int k = tid; k < ntw; k += kThreads) tw[k] = a.tw[k];

    const int n = H * W;
    float* sp = a.planes + static_cast<size_t>(slot) * kGridPlanes * n;
    float *mr = sp, *mi = sp + n, *pr = sp + 2 * n, *pi = sp + 3 * n;
    const sg::SenseGrid g{a.coils_r, a.coils_i, a.wt, tw, re, im,
                          a.spec + static_cast<size_t>(slot) * a.per_round * n, sp + 4 * n,
                          sp + 5 * n, a.bar + slot, H, W, a.C, team, rank, a.per_round,
                          a.row_lines, a.col_lines};
    const rls::Split rsp(H, team);
    const int p0 = rsp.start(rank) * W, p1 = p0 + rsp.size(rank) * W;  // the band's pixels
    unsigned target = 0;
    __syncthreads();  // the twiddles
    prof.mark(sg::kSetup);

    for (int b = slot; b < a.B; b += a.slots) {
        const size_t off = 2 * static_cast<size_t>(b) * n;
        const float* x0r = a.x0hat + off;
        const float* x0i = x0r + n;
        float* xr = a.out + off;
        float* xi = xr + n;
        const float rho = a.scal[2 * b];
        const float t = rls::fmul(rho, a.scal[2 * b + 1]);
        const float a0 = a.iterations > 0 ? a.tab[0] : 0.f;
        // set-up: x = x_prev = 0 and the first m on the band
        for (int i = p0 + tid; i < p1; i += kThreads) {
            const float zero = __ldg(x0r + i) * 0.f;
            xr[i] = xi[i] = pr[i] = pi[i] = zero;
            mr[i] = mi[i] = rls::fadd(zero, rls::fmul(a0, rls::fsub(zero, zero)));
        }
        __syncthreads();
        prof.mark(sg::kSetup);
        if (a.iterations > 0) sg::forward_band<kThreads, kPow2>(g, mr, mi, prof);

        for (int it = 0; it < a.iterations; ++it) {
            const bool more = it + 1 < a.iterations;
            const float an = more ? a.tab[4 * (it + 1)] : 0.f;
            // the gradient step and the group threshold at pixel i of the
            // band, from the normal op's (nr, ni); x_prev = x; the next m
            auto finish = [&](int i, float nr, float ni) {
                const float gr = rls::fsub(mr[i], rls::fmul(rho, rls::fsub(nr, __ldg(x0r + i))));
                const float gi = rls::fsub(mi[i], rls::fmul(rho, rls::fsub(ni, __ldg(x0i + i))));
                const float gn = __fsqrt_rn(rls::fadd(rls::fmul(gr, gr), rls::fmul(gi, gi)));
                const float sc = fmaxf(rls::fdiv(rls::fsub(gn, t), gn == 0.f ? 1.f : gn), 0.f);
                const float ur = xr[i], ui = xi[i];
                const float vr = rls::fmul(gr, sc), vi = rls::fmul(gi, sc);
                pr[i] = ur;
                pi[i] = ui;
                xr[i] = vr;
                xi[i] = vi;
                if (more) {
                    mr[i] = rls::fadd(vr, rls::fmul(an, rls::fsub(vr, ur)));
                    mi[i] = rls::fadd(vi, rls::fmul(an, rls::fsub(vi, ui)));
                }
            };
            // the next iteration's (R) of the first round on the same rows
            auto next = [&](int g0, int lines) {
                if (more) sg::forward_chunk<kThreads, kPow2>(g, 0, mr, mi, g0, lines, prof);
            };
            sg::sense_normal_grid<kThreads, kPow2>(g, mr, mi, target, prof, finish, next);
        }
    }
    prof.finish();
}

const void* grid_kernel(int H, int W) {
    return rls::pow2_shape(H, W) ? reinterpret_cast<const void*>(&sense_grid_kernel<true>)
                                 : reinterpret_cast<const void*>(&sense_grid_kernel<false>);
}

}  // namespace

extern "C" {

// A cluster route's shared memory per CTA at H x W on teams of `team` CTAs
// (1: the resident route; the planner's check), and how many clusters of
// `clusters` CTAs the current device holds at once
// (cudaOccupancyMaxActiveClusters): out[0], out[1].
int sense_cluster_occupancy(int clusters, int team, int H, int W, long long* out) {
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
// [re; im] image; scal: (B, 2) [rho, lam_eff]; tab: (iterations, 4), the
// momentum table; tw: twiddle_floats(H, W) floats [Re_H, Im_H, Re_W, Im_W];
// wt: the spectral weights transposed ((W, H)); coils_r, coils_i: (C, H,
// W); scratch 6 planes of (B, H, W); prof
// null or kPhases int64 that receive CTA 0's clocks per phase, and the
// plan: `clusters` CTAs per slice in teams of `team` CTAs a coil (team 1:
// resident, one coil a CTA; valid_plan), `smem` bytes of shared memory per
// CTA. Returns cudaErrorInvalidValue for a plan that is not valid or whose
// smem differs from cluster_smem_bytes, else the launch's error.
int sense_cluster_launch(const void* x0hat, const void* scal, const void* tab, const void* tw,
                         const void* wt, const void* coils_r, const void* coils_i, void* out,
                         void* scratch, void* prof, int B, int H, int W, int C, int iterations,
                         int clusters, int team, int smem, void* stream) {
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
    const ClusterArgs args{static_cast<const float*>(x0hat), static_cast<const float*>(scal),
                           static_cast<const float*>(tab), static_cast<const float*>(tw),
                           static_cast<const float*>(wt), static_cast<const float*>(coils_r),
                           static_cast<const float*>(coils_i), static_cast<float*>(out),
                           static_cast<float*>(scratch), static_cast<long long*>(prof), B, H, W,
                           C, iterations, clusters, team};
    e = cudaLaunchKernelEx(&cfg, kernel, args);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// The grid route's CTAs of `smem` bytes of shared memory (a plane of
// sg::plane_floats floats each, which must be a whole number of float4)
// that the current device holds at once: out[0] a SM, out[1] on all of its
// SMs.
int sense_grid_occupancy(int H, int W, int smem, long long* out) {
    out[0] = out[1] = 0;
    if (!rls::valid_fft_size(H) || !rls::valid_fft_size(W) || smem < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t plane = sg::plane_floats(H, W, smem, 0, sg::kPhases);
    if (plane == 0 || plane % 4 || grid_smem_bytes(H, W, plane) != static_cast<size_t>(smem))
        return static_cast<int>(cudaErrorInvalidValue);
    return sg::occupancy(grid_kernel(H, W), kThreads, smem, out);
}

// The grid route: x0hat, scal, tab, tw, wt, coils_r, coils_i and out as for
// the cluster routes; scratch: slots x per_round spectra (H, W) of complex
// f32 (interleaved), then slots x kGridPlanes planes (H, W) f32; bar: slots
// uint32 counters, 0 at the launch; prof null or sg::kPhases int64 that
// receive CTA 0's clocks per phase; the plan: a team of `team` CTAs a
// slice, `slots` slices at once, per_round coils a round, chunks of
// row_lines rows and col_lines columns, `smem` bytes of shared memory per
// CTA (sg::valid_plan). One cooperative launch of team x slots CTAs, all
// resident at once (the launch is refused otherwise). Returns
// cudaErrorInvalidValue for a plan valid_plan refuses, else the launch's
// error.
int sense_grid_launch(const void* x0hat, const void* scal, const void* tab, const void* tw,
                      const void* wt, const void* coils_r, const void* coils_i, void* out,
                      void* scratch, void* bar, void* prof, int B, int H, int W, int C,
                      int iterations, int team, int slots, int per_round, int row_lines,
                      int col_lines, int smem, void* stream) {
    if (B < 1 || iterations < 0 ||
        !sg::valid_plan(B, H, W, C, team, slots, per_round, row_lines, col_lines, smem, 0,
                        sg::kPhases))
        return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = grid_kernel(H, W);
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t n = static_cast<size_t>(H) * W;
    float2* spec = static_cast<float2*>(scratch);
    GridArgs args{static_cast<const float*>(x0hat),
                  static_cast<const float*>(scal),
                  static_cast<const float*>(tab),
                  static_cast<const float*>(tw),
                  static_cast<const float*>(wt),
                  static_cast<const float*>(coils_r),
                  static_cast<const float*>(coils_i),
                  static_cast<float*>(out),
                  spec,
                  reinterpret_cast<float*>(spec + static_cast<size_t>(slots) * per_round * n),
                  static_cast<unsigned*>(bar),
                  static_cast<long long*>(prof),
                  B,
                  H,
                  W,
                  C,
                  iterations,
                  team,
                  slots,
                  per_round,
                  row_lines,
                  col_lines,
                  static_cast<int>(sg::plane_floats(H, W, smem, 0, sg::kPhases))};
    void* kargs[] = {&args};
    e = cudaLaunchCooperativeKernel(fn, dim3(team * slots), dim3(kThreads), kargs,
                                    static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
