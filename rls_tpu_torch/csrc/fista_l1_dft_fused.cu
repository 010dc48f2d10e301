// The whole batched FISTA-L1 compressed-sensing solve on a subsampled 2-D
// DFT in one launch, on one of two routes that the host planner
// (kernels/fista_l1_dft_fused.py plan_fista_l1_dft) picks by shape:
//
// * resident: each problem runs on a thread-block cluster of c CTAs (c at
//   most 16 and at most H and W; a power of two that divides both where H
//   and W are powers of two) of 1024 threads; the rows of the image and the
//   columns of the spectrum are split over the cluster as evenly as
//   possible (split.cuh Split: n / c points a part, one more for the first
//   n % c parts), and CTA r owns the image rows [rs(r), rs(r + 1)) (its
//   band, R(r) rows) and the spectrum's columns [cs(r), cs(r + 1)) (its
//   block, Wc(r) columns), and keeps its band of x and x_prev, its band of
//   the spectrum and its block of columns in shared memory for the whole
//   solve; every CTA lays its buffers out alike, for the largest band,
//   ceil(H / c) rows, and the largest block, at the pitch ceil(W / c) + 1;
// * grid: where no cluster of 16 holds a band and a block (every square
//   side from 385: 448^2, 512^2, 640^2, 1024^2; 1024 x 256), one
//   cooperative launch whose CTAs are all resident at once: each problem
//   runs on a team of `team` CTAs of 1024 threads that meet at a barrier
//   of their own on a counter in global memory (group_sync.cuh), `slots`
//   problems at once (the team of slot s solves problems s, s + slots, ...
//   in turn); the rows and columns are split over the team by Split as on
//   the resident route, the spectrum of each slot's problem lives in
//   global scratch (L2: 2 MiB at 512^2), and a CTA transforms whole lines
//   of its band and of its block in shared memory, a chunk of lines at a
//   time.
//
// Replaces the TPU kernel rls_tpu/kernels/fista_l1_dft_fused.py:_kernel
// (:32-107; launched by fista_l1_dft_fused, :110, pallas_call :129). Per
// iteration, from x = x_prev = 0:
//   x_mom = x + a (x - x_prev)                 (a: momentum table, column 0)
//   xg    = x_mom - rho (Re(F^H M F x_mom) - x0hat)
//   x     = max(|xg| - rho lam, 0) (xg + eps) / (|xg| + eps)
// The normal op is the in-kernel FFT of the real image (im = 0 in, the
// real part out): rows then columns forward by decimation in frequency,
// the spectral weights (the mask in digit-reversed order times 1 / (H W)),
// columns then rows back by decimation in time. The momentum is formed as
// the forward row pass loads x_mom, and the gradient step and the soft
// threshold as the inverse row pass stores each pixel (x_mom recomputed
// there by the same rounded expression). Every f32 operation is rounded on
// its own (rls::fmul & co.), as in the plain PyTorch version
// (rls_tpu_torch/kernels/fista_l1_dft_fused.py), with which both routes
// agree bit for bit: the resident route runs the same mixed-radix stages
// (fft_mixed.cuh's odd stages, then radix 2) on the same twiddle table, only
// elsewhere (fft_resident.cuh's layout); how the lines are split over the
// cluster moves where a line is stored, not what is computed on it. H and
// W are any sizes from 2 to 1024.
//
// What bounds it on an H100: a 256^2 problem is 10.5 MFLOP of FFT per
// iteration (two complex 2-D transforms at 5 n log2 n), where the TPU
// kernel's dense matrix sandwiches take ~400 MFLOP; the solve is a chain of
// 60 dependent normal ops, bound by that chain's latency, not by bytes or
// operations. The resident route spreads a problem over a cluster of
// neighbouring SMs that write each other's shared memory (DSMEM) and keeps
// the whole solve's state on chip. At the CS cell (256^2 x 16) the planner
// takes c = 16: 16-row bands, 16-column blocks, 102,472 bytes per CTA. A
// line of n points runs its stages in registers (fft_resident.cuh:
// sub-lines of <= 128 points, spans >= 128 through shared memory): a
// 256-point line has one shared-memory stage, which the forward passes fuse
// with their loads and the inverse passes with their stores. A line with
// an odd factor (320 = 5 x 64) instead loads into shared memory plainly,
// runs its odd stages there (fft_mixed.cuh) and then its radix-2 stages,
// and the inverse runs all of its shared-memory stages before a plain
// store or push. A 512^2 band fits no cluster of 16, so there the grid
// route spreads a problem over a team of up to 132 CTAs (33 a problem at
// batch 4): its spectrum (2 MiB) crosses L2 twice an iteration (rows
// forward out, the column pass in and out, rows back in: ~8 MiB of L2
// traffic a problem an iteration), and a team meets twice an iteration;
// the chain of 60 normal ops with two team barriers each bounds it, and
// the L2 traffic where the slots' spectra outgrow the 50 MB of L2.
//
// The kernel is built twice (kPow2): where H and W are powers of two, c is
// a power of two that divides both, every band has H / c rows and every
// block W / c columns, and the index maps shift (log2 of the part sizes);
// otherwise the parts may differ by one (97 x 128 on c = 3: bands of 33,
// 32 and 32 rows, blocks of 43, 43 and 42 columns), and a point's owner is
// Split::owner (a multiply and a shift) and its place in the owner's band
// or block its offset from the owner's first row or column.
//
// Resident route, one iteration:
//   (a) rows forward on the CTA's own band: x_mom from x and x_prev, the
//       first stage (span W / 2) fused with the loads into the band's
//       spectrum (W a power of two > 128; with an odd factor, a plain load
//       and the odd stages), the remaining stages in registers; each point
//       (row, column k) is then stored into the column block of the CTA
//       that owns column k through DSMEM (the transpose, pushed by its
//       writer);
//   cluster barrier A;
//   (b) the column pass on the CTA's own block: each column forward, times
//       its spectral weights (wt, the weights transposed, from global
//       memory), and back into the block; the write-back then stores each
//       point (row k, column) into the band of the CTA that owns row k
//       through DSMEM, with the last inverse stage (span H / 2, H a power
//       of two > 128) fused into it;
//   cluster barrier B;
//   (c) rows back on the own band, the last stage (span W / 2, or a plain
//       pass after the odd stages) fused with
//       the pixel update: x_mom recomputed, the gradient step, the soft
//       threshold, x_prev = x and x = the new value, in shared memory.
// What orders each access to a buffer another CTA writes (no CTA ever
// reads another's shared memory; DSMEM carries stores only). Uneven parts
// change none of it: a CTA with a shorter band or block does less work
// between the same two barriers, and every CTA, whatever its part, meets
// every barrier once an iteration:
//   block (re, im) of CTA q: written by every CTA in (a), each into the
//        rows of its own band (so every row of q's block, by exactly one
//        writer)                                              A (RAW: every
//        push before q's column pass); B (WAR: q's column pass of the
//        iteration before, with its last reads in the write-back, before
//        any push of the next (a), which follows B)
//   band spectrum (re, im) of CTA q: written by q in (a) as the row pass's
//        staging, by every CTA in (b)'s write-back, each into the columns
//        of its own block; read by q in (a) and (c)          A (WAR: q's
//        reads and writes of (a) before any write-back); B (RAW: every
//        write-back before q's (c))
//   x, x_prev: q's own, each pixel loaded in (a) and stored in (c) by the
//        same thread (the same index map in both passes), so no barrier
//        orders (c) before the next (a); a __syncthreads() orders the last
//        (c) before the write-out, whose index map differs
//   inside a pass: a __syncthreads() after each shared-memory stage that
//        another thread of the CTA reads next
// The set-up (twiddles, x = x_prev = 0) ends with a cluster barrier: every
// CTA of the cluster is running before any DSMEM store. The last DSMEM
// store of the solve precedes the last barrier B, so a CTA may exit after
// its own (c) and write-out. With c = 1 the cluster barriers are
// __syncthreads(). The Python model of these passes and barriers at even
// and uneven splits, which the CPU tests run against the plain version bit
// for bit and with each barrier dropped, is tests/test_torch_dft_plan.py
// (ClusterModel).
//
// A phase timer (prof): CTA 0's thread 0 adds the SM clocks between its
// phase marks (set-up and write-out, loads, rows forward, the push to the
// column blocks, barrier A, column transforms, write-back, barrier B, rows
// back and store); off where prof is null.
//
// Grid route, one iteration of a slot's problem (a CTA's band and block are
// those of the resident route's rank; the spectrum S of the slot, H x W
// complex, row-major, in global memory):
//   (C) the block's columns, col_lines at a time: loaded from S (a row's
//       segment of the chunk's columns one coalesced load, through L2:
//       __ldcg), each column forward, times its spectral weights (wt), and
//       back in shared memory, stored to S;
//   team barrier T2;
//   (R') the band's rows, row_lines at a time: loaded from S (__ldcg), rows
//       back, the pixel update (x_mom recomputed from x and x_prev, the
//       gradient step, the soft threshold; x and x_prev in global memory,
//       the CTA's own rows), and in the same pass (R) of the next
//       iteration: x_mom of the new x in the chunk's place, rows forward,
//       stored to S;
//   team barrier T1 (before the next iteration's (C)).
// The set-up (x = x_prev = 0 on the band, then (R) of the first iteration)
// ends at the first T1. What orders each access to a buffer another CTA
// writes (the CTAs of a team share S only; x, x_prev and x0hat of a band
// are its CTA's alone, a pixel written and read by one CTA, ordered by
// __syncthreads; teams share nothing):
//   S, the rows of CTA q's band: written by q in (R), read by every CTA in
//        (C)                                               T1 (RAW: every
//        (R) store before any (C) load); T2 (WAR: every (C) load of the
//        iteration before, whose stores follow them, before q's next (R)
//        stores, which follow T2)
//   S, the columns of CTA q's block: written by q in (C), read by every
//        CTA in (R')                                        T2 (RAW: every
//        (C) store before any (R') load); T1 (WAR: every (R') load before
//        q's next (C) stores, which follow T1)
//   S of the slot's next problem: its (R) writes only the CTA's own rows,
//        after the CTA's own (R') of the problem before; the next problem's
//        first T1 orders it before any (C)
//   inside a pass: a __syncthreads() after each shared-memory stage that
//        another thread of the CTA reads next, and at the end of each chunk
//        (before the next chunk writes the planes)
// A team barrier is group_sync: __syncthreads(), thread 0's release add
// to the slot's counter and its acquire poll until the team has arrived,
// __syncthreads(). S is read through L2 (__ldcg) and written with __stcg:
// no CTA reads S from its L1. The Python model of these passes and
// barriers, which the CPU tests run against the plain version bit for bit
// and with each team barrier dropped, is tests/test_torch_dft_grid.py
// (GridModel). The grid route's timer (prof): CTA 0's thread 0 adds the SM
// clocks of set-up, row loads, rows back, the pixel update, rows forward
// with their stores, column loads, column transforms, column stores, and
// the waits at T1 and T2.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cluster_common.cuh"
#include "dft_common.cuh"
#include "fft_resident.cuh"
#include "group_sync.cuh"
#include "split.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;

// ---- the resident route: one problem per cluster, its state in shared
// memory

constexpr int kMaxCluster = 16;
// the phases of the timer
enum {
    kSetup, kLoads, kRowsFwd, kScatter, kBarrierA, kCols, kWriteBack, kBarrierB, kRowsBack,
    kPhases
};

// Shared memory of a CTA of the resident route at H x W on clusters of
// `clusters` CTAs, in this order; the Python planner
// (kernels/fista_l1_dft_fused.py resident_smem_bytes) counts the same: the
// twiddles (twiddle_floats(H, W): H + W at powers of two), x, x_prev and
// the band's spectrum (re, im), ceil(H / clusters) W floats each, the
// column block (re, im), H (ceil(W / clusters) + 1) floats each
// (split.cuh), every float array rounded up to 4 floats, and the phase
// timer (kPhases int64).
__host__ __device__ inline size_t resident_smem_bytes(int H, int W, int clusters) {
    const size_t band = rls::split_band_floats(H, W, clusters);
    const size_t block = rls::split_block_floats(H, W, clusters);
    return sizeof(float) * (rls::ceil4(rls::twiddle_floats(H, W)) + 4 * band + 2 * block) +
           sizeof(long long) * kPhases;
}

struct ResidentArgs {
    const float* x0hat;  // (B, H, W)
    const float* scal;   // (B, 2) [rho, lam_eff]
    const float* tab;    // (iterations, 4), the momentum table
    const float* tw;     // twiddle_floats(H, W): [Re_H, Im_H, Re_W, Im_W]
    const float* wt;     // (W, H): the spectral weights transposed
    float* out;          // (B, H, W)
    long long* prof;     // (kPhases,) or null
    int B, H, W, iterations, clusters;
};

using Prof = rls::Prof<kPhases>;
namespace fr = rls::fftr;

// The parts of a side of n points over a cluster of c CTAs: where CTA j's
// part starts, how many points it holds, which CTA holds point i and at
// which offset there. At powers of two (kPow2) c divides n and the maps
// shift by log2(n / c); otherwise Split's parts, which may differ by one.
template <bool kPow2>
struct Parts;

template <>
struct Parts<true> {
    int lg;  // log2(n / c)
    __device__ Parts(int n, int c) : lg(fr::log2i(n / c)) {}
    __device__ __forceinline__ int start(int j) const { return j << lg; }
    __device__ __forceinline__ int size(int) const { return 1 << lg; }
    __device__ __forceinline__ int owner(int i) const { return i >> lg; }
    __device__ __forceinline__ int offset(int i, int) const { return i & ((1 << lg) - 1); }
};

template <>
struct Parts<false> : rls::Split {
    __device__ Parts(int n, int c) : rls::Split(n, c) {}
    __device__ __forceinline__ int offset(int i, int q) const { return i - start(q); }
};

// where kPow2 holds, the block's rows and columns come from shifts
struct NoDivisor {
    __device__ explicit NoDivisor(int) {}
};

// kPow2: H and W both powers of two, the radix-2 code with shifts for its
// index maps and the outermost stage fused with the loads and stores;
// otherwise the mixed-radix code (fft_resident.cuh's Layout) and uneven
// parts (Split).
template <bool kPow2>
__global__ void __launch_bounds__(kThreads, 1)
fista_l1_dft_cluster_kernel(const ResidentArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = a.H, W = a.W, nc = a.clusters;
    // the band's rows and the block's columns of CTA `rank` (below); every
    // CTA's buffers are laid out for the largest band and block
    const Parts<kPow2> rsp(H, nc), csp(W, nc);
    const int cp = rls::ceil_div(W, nc) + 1;  // the block's pitch: column k of row r at r cp + k
    const size_t nb = rls::split_band_floats(H, W, nc);
    const size_t nk = rls::split_block_floats(H, W, nc);
    const int ntw = rls::twiddle_floats(H, W);
    float* tw = reinterpret_cast<float*>(smem);
    float* x = tw + rls::ceil4(ntw);
    float* xp = x + nb;
    float* bre = xp + nb;  // the band's spectrum, row r at r W
    float* bim = bre + nb;
    float* kre = bim + nb;  // the column block, spectrum row k at k cp
    float* kim = kre + nk;
    long long* pacc = reinterpret_cast<long long*>(kim + nk);

    cg::cluster_group cl = cg::this_cluster();
    const int rank = static_cast<int>(cl.block_rank());
    const int b = blockIdx.x / nc;
    const int R = rsp.size(rank), Wc = csp.size(rank);  // band rows, block columns
    const int r0 = rsp.start(rank), c0 = csp.start(rank);
    const int tid = threadIdx.x;
    Prof prof{blockIdx.x == 0 && tid == 0 ? a.prof : nullptr, pacc, 0};
    prof.start();
    auto sync_cluster = [&](int phase, int wait) {
        prof.mark(phase);
        if (nc > 1)
            cl.sync();
        else
            __syncthreads();
        prof.mark(wait);
    };

    for (int k = tid; k < ntw; k += kThreads) tw[k] = a.tw[k];
    // the band's pixels are contiguous in (B, H, W)
    const size_t off = static_cast<size_t>(b) * H * W + static_cast<size_t>(r0) * W;
    const float* x0 = a.x0hat + off;
    const int n = R * W;  // this CTA's pixels, local index i = lr W + k
    for (int i = tid; i < n; i += kThreads) {
        const float zero = x0[i] * 0.f;
        x[i] = zero;
        xp[i] = zero;
    }
    const float rho = a.scal[2 * b];
    const float t = rls::fmul(rho, a.scal[2 * b + 1]);
    const float eps = 1.1920928955078125e-07f;  // 2^-23, float32's eps
    const int th = rls::twiddle_count(H);
    const fr::Tw tw_h{tw, tw + th};
    const fr::Tw tw_w{tw + 2 * th, tw + 2 * th + rls::twiddle_count(W)};
    const fr::Layout rows(W), cols(H);
    const int lrow = 1 << rows.lg_l, lcol = 1 << cols.lg_l;  // sub-line lengths
    const bool row_direct = rows.one_subline(), col_direct = cols.one_subline();
    // the write-back's row and column of the block (kPow2: by shifts)
    const std::conditional_t<kPow2, NoDivisor, rls::Divisor> by_wc(Wc);

    // point (image row r0 + lr, spectrum column k) into the block of the
    // CTA that owns column k
    auto push_row = [&](int lr, int k, float re, float im) {
        const int q = csp.owner(k);
        const int at = (r0 + lr) * cp + csp.offset(k, q);
        cl.map_shared_rank(kre, q)[at] = re;
        cl.map_shared_rank(kim, q)[at] = im;
    };
    // point (spectrum row k, block column jc) into the band of the CTA that
    // owns row k
    auto push_col = [&](int k, int jc, float re, float im) {
        const int q = rsp.owner(k);
        const int at = rsp.offset(k, q) * W + c0 + jc;
        cl.map_shared_rank(bre, q)[at] = re;
        cl.map_shared_rank(bim, q)[at] = im;
    };
    sync_cluster(kSetup, kSetup);  // every CTA running, its twiddles and planes set

    for (int it = 0; it < a.iterations; ++it) {
        const float am = a.tab[4 * it];
        auto mom = [&](int i) {
            const float xv = x[i];
            return rls::fadd(xv, rls::fmul(am, rls::fsub(xv, xp[i])));
        };
        auto store = [&](int i, float nr) {
            const float m = mom(i);
            const float xg = rls::fsub(m, rls::fmul(rho, rls::fsub(nr, x0[i])));
            const float mag = fabsf(xg);
            const float shrink = fmaxf(rls::fsub(mag, t), 0.f);
            xp[i] = x[i];
            x[i] = rls::fdiv(rls::fmul(shrink, rls::fadd(xg, eps)), rls::fadd(mag, eps));
        };

        // (a) rows forward: the first stage with the loads (a size with an
        // odd factor: a plain load and every shared-memory stage), the rest
        // in registers, each point pushed to its column's block
        if (!row_direct) {
            if constexpr (kPow2) {
                const int hw = W >> 1, lg_w = rows.lg_a;
                for (int u = tid; u < R * hw; u += kThreads) {
                    const int j = u & (hw - 1);
                    const int i0 = (u >> (lg_w - 1)) * W + j, i1 = i0 + hw;
                    float ar = mom(i0), ai = 0.f, br = mom(i1), bi = 0.f;
                    fr::dif_bfly(ar, ai, br, bi, tw_w.re[j], tw_w.im[j]);
                    bre[i0] = ar;
                    bim[i0] = ai;
                    bre[i1] = br;
                    bim[i1] = bi;
                }
                prof.mark(kLoads);
                __syncthreads();
                for (int m = W >> 2; m >= lrow; m >>= 1) {
                    fr::smem_stage<false, true>(bre, bim, tw_w, rows, m, R, W, 1, kThreads);
                    __syncthreads();
                }
            } else {
                for (int i = tid; i < R * W; i += kThreads) {
                    bre[i] = mom(i);
                    bim[i] = 0.f;
                }
                prof.mark(kLoads);
                __syncthreads();
                fr::smem_stages<false, false>(bre, bim, tw_w, rows, R, W, 1, kThreads);
            }
        }
        fr::with_points(rows.P(), [&](auto pc) {
            constexpr int kP = decltype(pc)::value;
            fr::sublines<kPow2>(rows, R, kThreads, [&](int lr, int k0, int tl, bool valid) {
                float vr[kP], vi[kP];
#pragma unroll
                for (int j = 0; j < kP; ++j) {
                    vr[j] = vi[j] = 0.f;
                    const int i = lr * W + k0 + (j << rows.lg_t);
                    if (valid && row_direct) {
                        vr[j] = mom(i);
                    } else if (valid) {
                        vr[j] = bre[i];
                        vi[j] = bim[i];
                    }
                }
                prof.mark(kLoads);
                fr::dif_regs<kP>(vr, vi, tl, rows, tw_w);
                prof.mark(kRowsFwd);
                if (valid) {
#pragma unroll
                    for (int j = 0; j < kP; ++j) push_row(lr, k0 + (j << rows.lg_t), vr[j], vi[j]);
                }
                prof.mark(kScatter);
            });
        });
        sync_cluster(kScatter, kBarrierA);  // A

        // (b) the column pass on the own block: forward, the weights, back;
        // then the write-back to the rows' bands
        if (!col_direct) fr::smem_stages<false, kPow2>(kre, kim, tw_h, cols, Wc, 1, cp, kThreads);
        fr::with_points(cols.P(), [&](auto pc) {
            constexpr int kP = decltype(pc)::value;
            fr::sublines<kPow2>(cols, Wc, kThreads, [&](int jc, int k0, int tl, bool valid) {
                float vr[kP], vi[kP], w[kP];
#pragma unroll
                for (int j = 0; j < kP; ++j) {
                    vr[j] = vi[j] = w[j] = 0.f;
                    const int k = k0 + (j << cols.lg_t);
                    if (valid) {
                        w[j] = a.wt[(c0 + jc) * H + k];
                        vr[j] = kre[k * cp + jc];
                        vi[j] = kim[k * cp + jc];
                    }
                }
                fr::dif_regs<kP>(vr, vi, tl, cols, tw_h);
#pragma unroll
                for (int j = 0; j < kP; ++j) {
                    vr[j] = rls::fmul(vr[j], w[j]);
                    vi[j] = rls::fmul(vi[j], w[j]);
                }
                fr::dit_regs<kP>(vr, vi, tl, cols, tw_h);
                if (valid) {
#pragma unroll
                    for (int j = 0; j < kP; ++j) {
                        const int k = k0 + (j << cols.lg_t);
                        kre[k * cp + jc] = vr[j];
                        kim[k * cp + jc] = vi[j];
                    }
                }
            });
        });
        __syncthreads();
        if constexpr (kPow2) {  // all but the last stage (span H / 2)
            for (int m = lcol; m < (H >> 1); m <<= 1) {
                fr::smem_stage<true, true>(kre, kim, tw_h, cols, m, Wc, 1, cp, kThreads);
                __syncthreads();
            }
        } else if (!col_direct) {
            fr::smem_stages<true, false>(kre, kim, tw_h, cols, Wc, 1, cp, kThreads);
        }
        prof.mark(kCols);
        // the write-back from the block, not from the registers, whose lanes
        // hold one column's rows (a store each to another row of a band, W
        // floats apart: one bank); here neighbouring threads take
        // neighbouring columns and push row-contiguous runs
        if constexpr (kPow2) {
            const int lg_wc = csp.lg, hh = H >> 1;
            if (!col_direct) {
                for (int u = tid; u < hh * Wc; u += kThreads) {
                    const int jc = u & (Wc - 1), k = u >> lg_wc;
                    const int i0 = k * cp + jc, i1 = i0 + hh * cp;
                    float ar = kre[i0], ai = kim[i0], br = kre[i1], bi = kim[i1];
                    fr::dit_bfly(ar, ai, br, bi, tw_h.re[k], -tw_h.im[k]);
                    push_col(k, jc, ar, ai);
                    push_col(k + hh, jc, br, bi);
                }
            } else {
                for (int u = tid; u < H * Wc; u += kThreads) {
                    const int k = u >> lg_wc, jc = u - k * Wc;
                    push_col(k, jc, kre[k * cp + jc], kim[k * cp + jc]);
                }
            }
        } else {
            for (int u = tid; u < H * Wc; u += kThreads) {
                const int k = by_wc.div(u), jc = u - k * Wc;
                push_col(k, jc, kre[k * cp + jc], kim[k * cp + jc]);
            }
        }
        sync_cluster(kWriteBack, kBarrierB);  // B

        // (c) rows back, the last stage with the pixel update (a size with an
        // odd factor: every shared-memory stage, then a plain update)
        fr::with_points(rows.P(), [&](auto pc) {
            constexpr int kP = decltype(pc)::value;
            fr::sublines<kPow2>(rows, R, kThreads, [&](int lr, int k0, int tl, bool valid) {
                float vr[kP], vi[kP];
#pragma unroll
                for (int j = 0; j < kP; ++j) {
                    vr[j] = vi[j] = 0.f;
                    if (valid) {
                        const int i = lr * W + k0 + (j << rows.lg_t);
                        vr[j] = bre[i];
                        vi[j] = bim[i];
                    }
                }
                fr::dit_regs<kP>(vr, vi, tl, rows, tw_w);
                if (valid) {
#pragma unroll
                    for (int j = 0; j < kP; ++j) {
                        const int i = lr * W + k0 + (j << rows.lg_t);
                        if (row_direct) {
                            store(i, vr[j]);
                        } else {
                            bre[i] = vr[j];
                            bim[i] = vi[j];
                        }
                    }
                }
            });
        });
        if (!row_direct) {
            __syncthreads();
            if constexpr (kPow2) {
                const int hw = W >> 1, lg_w = rows.lg_a;
                for (int m = lrow; m < hw; m <<= 1) {
                    fr::smem_stage<true, true>(bre, bim, tw_w, rows, m, R, W, 1, kThreads);
                    __syncthreads();
                }
                // the real part of the last stage's outputs (the index map of (a))
                for (int u = tid; u < R * hw; u += kThreads) {
                    const int j = u & (hw - 1);
                    const int i0 = (u >> (lg_w - 1)) * W + j, i1 = i0 + hw;
                    const float wr = tw_w.re[j], wi = -tw_w.im[j];
                    const float ar = bre[i0];
                    const float tr = rls::fsub(rls::fmul(bre[i1], wr), rls::fmul(bim[i1], wi));
                    store(i0, rls::fadd(ar, tr));
                    store(i1, rls::fsub(ar, tr));
                }
            } else {
                fr::smem_stages<true, false>(bre, bim, tw_w, rows, R, W, 1, kThreads);
                // the real part (the index map of (a)'s plain load)
                for (int i = tid; i < R * W; i += kThreads) store(i, bre[i]);
            }
        }
        prof.mark(kRowsBack);
    }
    __syncthreads();  // the last pixel updates, before another index map reads x
    float* o = a.out + off;
    for (int i = tid; i < n; i += kThreads) o[i] = x[i];
    prof.mark(kSetup);
    prof.finish();
}

// clusters: up to kMaxCluster and at most H and W; at a power-of-two shape
// (the kPow2 kernel) a power of two, which then divides H and W
bool valid_cluster(int clusters, int H, int W) {
    if (clusters < 1 || clusters > kMaxCluster || clusters > H || clusters > W) return false;
    return !rls::pow2_shape(H, W) || (clusters & (clusters - 1)) == 0;
}

// ---- the grid route: each problem's lines over a team of CTAs that meet
// in L2

// the phases of the grid route's timer
enum {
    kGridSetup, kGridRowLoads, kGridRowsBack, kGridUpdate, kGridRowsFwd, kGridColLoads,
    kGridCols, kGridColStores, kGridBarrier1, kGridBarrier2, kGridPhases
};

// The pitch of an n-point line in the grid route's shared memory: odd, so
// that a column chunk's load, whose neighbouring threads write
// neighbouring lines, hits distinct banks.
__host__ __device__ inline int grid_pitch(int n) { return n | 1; }

// Shared memory of a CTA of the grid route at H x W whose two planes (re,
// im) hold `plane` floats each, in this order; the Python planner
// (kernels/fista_l1_dft_fused.py grid_smem_bytes) counts the same: the
// twiddles (twiddle_floats(H, W), rounded up to 4 floats), the two planes,
// and the phase timer (kGridPhases int64).
__host__ __device__ inline size_t grid_smem_bytes(int H, int W, size_t plane) {
    return sizeof(float) * (rls::ceil4(rls::twiddle_floats(H, W)) + 2 * plane) +
           sizeof(long long) * kGridPhases;
}

// The floats of a plane of a grid CTA of `smem` bytes (grid_smem_bytes
// inverted; 0 where they do not hold the twiddles and the timer).
__host__ __device__ inline size_t grid_plane_floats(int H, int W, size_t smem) {
    const size_t fixed = grid_smem_bytes(H, W, 0);
    return smem < fixed ? 0 : (smem - fixed) / (2 * sizeof(float));
}

struct GridArgs {
    const float* x0hat;  // (B, H, W)
    const float* scal;   // (B, 2) [rho, lam_eff]
    const float* tab;    // (iterations, 4), the momentum table
    const float* tw;     // twiddle_floats(H, W): [Re_H, Im_H, Re_W, Im_W]
    const float* wt;     // (W, H): the spectral weights transposed
    float* out;          // (B, H, W): x
    float2* spec;        // (slots, H, W): a slot's spectrum
    float* xprev;        // (slots, H, W): a slot's x_prev
    unsigned* bar;       // (slots,): the teams' barrier counters, 0 at the launch
    long long* prof;     // (kGridPhases,) or null
    int B, H, W, iterations, team, slots, row_lines, col_lines, plane;
};

using GridProf = rls::Prof<kGridPhases>;

// The grid route (its barrier table is in the file's header). CTA
// blockIdx.x = slot team + rank is rank `rank` of the team of slot
// `slot`, which solves problems slot, slot + slots, ... in turn; a
// problem's rows and columns are split over the team by split.cuh's
// Split, and a CTA transforms its band of rows, row_lines at a time, and
// its block of columns, col_lines at a time, each chunk's lines in shared
// memory at the pitch grid_pitch.
template <bool kPow2>
__global__ void __launch_bounds__(kThreads, 1) fista_l1_dft_grid_kernel(const GridArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int H = a.H, W = a.W, team = a.team;
    const int ntw = rls::twiddle_floats(H, W);
    const int pr = grid_pitch(W), pc = grid_pitch(H);  // row and column lines' pitches
    float* tw = reinterpret_cast<float*>(smem);
    float* re = tw + rls::ceil4(ntw);
    float* im = re + a.plane;
    long long* pacc = reinterpret_cast<long long*>(im + a.plane);

    const int slot = blockIdx.x / team, rank = blockIdx.x - slot * team;
    const int tid = threadIdx.x;
    GridProf prof{blockIdx.x == 0 && tid == 0 ? a.prof : nullptr, pacc, 0};
    prof.start();
    for (int k = tid; k < ntw; k += kThreads) tw[k] = a.tw[k];

    const rls::Split rsp(H, team), csp(W, team);
    const int r0 = rsp.start(rank), R = rsp.size(rank);    // the band: rows [r0, r0 + R)
    const int c0 = csp.start(rank), Wc = csp.size(rank);  // the block: columns [c0, c0 + Wc)
    const size_t n = static_cast<size_t>(H) * W;
    float2* spec = a.spec + slot * n;
    float* xp = a.xprev + slot * n;
    unsigned* ctr = a.bar + slot;
    unsigned target = 0;
    const int th = rls::twiddle_count(H);
    const fr::Tw tw_h{tw, tw + th};
    const fr::Tw tw_w{tw + 2 * th, tw + 2 * th + rls::twiddle_count(W)};
    const fr::Layout rows(W), cols(H);
    const rls::Divisor by_w(kPow2 ? 1 : W);
    const float eps = 1.1920928955078125e-07f;  // 2^-23, float32's eps
    __syncthreads();  // the twiddles
    prof.mark(kGridSetup);

    // local index i of a row chunk -> its line (i - line W is the point)
    auto row_of = [&](int i) { return kPow2 ? i >> rows.lg_a : by_w.div(i); };
    // the forward transforms of a chunk of `lines` rows from image row g0,
    // loaded into shared memory (point k of line l at re[l pr + k]), each
    // point stored to the slot's spectrum from the registers (a team's
    // lanes hold neighbouring points of a row: coalesced)
    auto rows_forward = [&](int g0, int lines) {
        fr::smem_stages<false, kPow2>(re, im, tw_w, rows, lines, pr, 1, kThreads);
        fr::with_points(rows.P(), [&](auto pc_) {
            constexpr int kP = decltype(pc_)::value;
            fr::sublines<kPow2>(rows, lines, kThreads, [&](int l, int k0, int tl, bool valid) {
                float vr[kP], vi[kP];
#pragma unroll
                for (int j = 0; j < kP; ++j) {
                    vr[j] = vi[j] = 0.f;
                    if (valid) {
                        const int at = l * pr + k0 + (j << rows.lg_t);
                        vr[j] = re[at];
                        vi[j] = im[at];
                    }
                }
                fr::dif_regs<kP>(vr, vi, tl, rows, tw_w);
                if (valid) {
#pragma unroll
                    for (int j = 0; j < kP; ++j)
                        __stcg(spec + static_cast<size_t>(g0 + l) * W + k0 + (j << rows.lg_t),
                               make_float2(vr[j], vi[j]));
                }
            });
        });
        __syncthreads();  // the chunk's shared memory read, before the next chunk writes it
        prof.mark(kGridRowsFwd);
    };

    for (int b = slot; b < a.B; b += a.slots) {
        const size_t off = static_cast<size_t>(b) * n;
        const float* x0 = a.x0hat + off;
        float* x = a.out + off;
        const float rho = a.scal[2 * b];
        const float t = rls::fmul(rho, a.scal[2 * b + 1]);
        // set-up: x = x_prev = 0 on the band, then (R) of the first
        // iteration
        for (int i = tid; i < R * W; i += kThreads) {
            const size_t g = static_cast<size_t>(r0) * W + i;
            const float zero = __ldg(x0 + g) * 0.f;
            x[g] = zero;
            xp[g] = zero;
        }
        __syncthreads();
        prof.mark(kGridSetup);
        if (a.iterations > 0) {
            const float am = a.tab[0];
            for (int l0 = 0; l0 < R; l0 += a.row_lines) {
                const int lines = min(a.row_lines, R - l0), g0 = r0 + l0;
                for (int i = tid; i < lines * W; i += kThreads) {
                    const int l = row_of(i), k = i - l * W;
                    const size_t g = static_cast<size_t>(g0) * W + i;
                    const float xv = x[g];
                    re[l * pr + k] = rls::fadd(xv, rls::fmul(am, rls::fsub(xv, xp[g])));
                    im[l * pr + k] = 0.f;
                }
                __syncthreads();
                prof.mark(kGridUpdate);
                rows_forward(g0, lines);
            }
        }

        for (int it = 0; it < a.iterations; ++it) {
            rls::grid::group_sync(ctr, target, team);  // T1
            prof.mark(kGridBarrier1);

            // (C) the block's columns, col_lines at a time: each column
            // forward, times its spectral weights, back
            for (int j0 = 0; j0 < Wc; j0 += a.col_lines) {
                const int lines = min(a.col_lines, Wc - j0), cc = c0 + j0;
                const rls::Divisor by_lines(lines);
                // neighbouring threads take neighbouring columns of a
                // spectrum row: a row's segment is one coalesced load
                for (int u = tid; u < lines * H; u += kThreads) {
                    const int k = by_lines.div(u), l = u - k * lines;
                    const float2 v = __ldcg(spec + static_cast<size_t>(k) * W + cc + l);
                    re[l * pc + k] = v.x;
                    im[l * pc + k] = v.y;
                }
                __syncthreads();
                prof.mark(kGridColLoads);
                fr::smem_stages<false, kPow2>(re, im, tw_h, cols, lines, pc, 1, kThreads);
                fr::with_points(cols.P(), [&](auto pc_) {
                    constexpr int kP = decltype(pc_)::value;
                    fr::sublines<kPow2>(cols, lines, kThreads,
                                        [&](int l, int k0, int tl, bool valid) {
                        float vr[kP], vi[kP], w[kP];
#pragma unroll
                        for (int j = 0; j < kP; ++j) {
                            vr[j] = vi[j] = w[j] = 0.f;
                            const int k = k0 + (j << cols.lg_t);
                            if (valid) {
                                w[j] = __ldg(a.wt + static_cast<size_t>(cc + l) * H + k);
                                vr[j] = re[l * pc + k];
                                vi[j] = im[l * pc + k];
                            }
                        }
                        fr::dif_regs<kP>(vr, vi, tl, cols, tw_h);
#pragma unroll
                        for (int j = 0; j < kP; ++j) {
                            vr[j] = rls::fmul(vr[j], w[j]);
                            vi[j] = rls::fmul(vi[j], w[j]);
                        }
                        fr::dit_regs<kP>(vr, vi, tl, cols, tw_h);
                        if (valid) {
#pragma unroll
                            for (int j = 0; j < kP; ++j) {
                                const int at = l * pc + k0 + (j << cols.lg_t);
                                re[at] = vr[j];
                                im[at] = vi[j];
                            }
                        }
                    });
                });
                __syncthreads();
                fr::smem_stages<true, kPow2>(re, im, tw_h, cols, lines, pc, 1, kThreads);
                prof.mark(kGridCols);
                for (int u = tid; u < lines * H; u += kThreads) {
                    const int k = by_lines.div(u), l = u - k * lines;
                    __stcg(spec + static_cast<size_t>(k) * W + cc + l,
                           make_float2(re[l * pc + k], im[l * pc + k]));
                }
                __syncthreads();  // the chunk's shared memory read, before the next chunk's
                prof.mark(kGridColStores);
            }
            rls::grid::group_sync(ctr, target, team);  // T2
            prof.mark(kGridBarrier2);

            // (R') the band's rows back and the pixel update, then (R) of
            // the next iteration on the same rows, row_lines at a time
            const float am = a.tab[4 * it];
            const bool next = it + 1 < a.iterations;
            const float an = next ? a.tab[4 * (it + 1)] : 0.f;
            for (int l0 = 0; l0 < R; l0 += a.row_lines) {
                const int lines = min(a.row_lines, R - l0), g0 = r0 + l0;
                fr::with_points(rows.P(), [&](auto pc_) {
                    constexpr int kP = decltype(pc_)::value;
                    fr::sublines<kPow2>(rows, lines, kThreads,
                                        [&](int l, int k0, int tl, bool valid) {
                        float vr[kP], vi[kP];
#pragma unroll
                        for (int j = 0; j < kP; ++j) {
                            vr[j] = vi[j] = 0.f;
                            if (valid) {
                                const float2 v = __ldcg(spec + static_cast<size_t>(g0 + l) * W +
                                                        k0 + (j << rows.lg_t));
                                vr[j] = v.x;
                                vi[j] = v.y;
                            }
                        }
                        prof.mark(kGridRowLoads);
                        fr::dit_regs<kP>(vr, vi, tl, rows, tw_w);
                        if (valid) {
#pragma unroll
                            for (int j = 0; j < kP; ++j) {
                                const int at = l * pr + k0 + (j << rows.lg_t);
                                re[at] = vr[j];
                                im[at] = vi[j];
                            }
                        }
                    });
                });
                __syncthreads();
                fr::smem_stages<true, kPow2>(re, im, tw_w, rows, lines, pr, 1, kThreads);
                prof.mark(kGridRowsBack);
                // the real part: the gradient step and the soft threshold,
                // x_mom recomputed by the rounded expression of (R); the
                // next iteration's x_mom in the point's place
                for (int i = tid; i < lines * W; i += kThreads) {
                    const int l = row_of(i), k = i - l * W;
                    const size_t g = static_cast<size_t>(g0) * W + i;
                    const float xv = x[g];
                    const float m = rls::fadd(xv, rls::fmul(am, rls::fsub(xv, xp[g])));
                    const float nr = re[l * pr + k];
                    const float xg = rls::fsub(m, rls::fmul(rho, rls::fsub(nr, __ldg(x0 + g))));
                    const float mag = fabsf(xg);
                    const float shrink = fmaxf(rls::fsub(mag, t), 0.f);
                    const float xn =
                        rls::fdiv(rls::fmul(shrink, rls::fadd(xg, eps)), rls::fadd(mag, eps));
                    xp[g] = xv;
                    x[g] = xn;
                    if (next) {
                        re[l * pr + k] = rls::fadd(xn, rls::fmul(an, rls::fsub(xn, xv)));
                        im[l * pr + k] = 0.f;
                    }
                }
                __syncthreads();
                prof.mark(kGridUpdate);
                if (next) rows_forward(g0, lines);
            }
        }
    }
    prof.finish();
}

// A grid plan: H and W the FFT's, a team of 1 to min(H, W) CTAs, 1 to B
// slots, chunks of 1 to the largest band's (block's) lines, and `smem`
// bytes whose planes hold a chunk of either pass.
bool valid_grid(int B, int H, int W, int team, int slots, int row_lines, int col_lines,
                int smem) {
    if (!rls::valid_fft_size(H) || !rls::valid_fft_size(W) || team < 1 || team > H ||
        team > W || slots < 1 || slots > B || row_lines < 1 || col_lines < 1 ||
        row_lines > rls::ceil_div(H, team) || col_lines > rls::ceil_div(W, team) || smem < 0 ||
        static_cast<long long>(team) * slots >= (1LL << 31))
        return false;
    const size_t plane = grid_plane_floats(H, W, smem);
    return plane % 4 == 0 && grid_smem_bytes(H, W, plane) == static_cast<size_t>(smem) &&
           static_cast<size_t>(row_lines) * grid_pitch(W) <= plane &&
           static_cast<size_t>(col_lines) * grid_pitch(H) <= plane;
}

const void* grid_kernel(int H, int W) {
    return rls::pow2_shape(H, W) ? reinterpret_cast<const void*>(&fista_l1_dft_grid_kernel<true>)
                                 : reinterpret_cast<const void*>(&fista_l1_dft_grid_kernel<false>);
}

}  // namespace

extern "C" {

// The resident route's shared memory per CTA at H x W on clusters of
// `clusters` CTAs (the planner's check), and how many such clusters the
// current device holds at once (cudaOccupancyMaxActiveClusters): out[0],
// out[1].
int fista_l1_dft_cluster_occupancy(int clusters, int H, int W, long long* out) {
    if (!rls::valid_fft_size(H) || !rls::valid_fft_size(W) || !valid_cluster(clusters, H, W))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = resident_smem_bytes(H, W, clusters);
    out[0] = static_cast<long long>(smem);
    out[1] = 0;
    if (smem > 0x7fffffff) return 0;
    out[1] = rls::max_active_clusters(rls::pow2_shape(H, W) ? fista_l1_dft_cluster_kernel<true>
                                                            : fista_l1_dft_cluster_kernel<false>,
                                      clusters, kThreads, static_cast<int>(smem));
    return 0;
}

// The resident route: x0hat, out: (B, H, W) f32; scal: (B, 2) [rho,
// lam_eff]; tab: (iterations, 4), the momentum table; tw:
// twiddle_floats(H, W) floats [Re_H, Im_H, Re_W, Im_W] (the first
// twiddle_count(H) and twiddle_count(W) twiddles of each axis); wt the
// spectral weights transposed ((W, H)); prof null or kPhases int64 that
// receive CTA 0's clocks per phase, and the plan: `clusters` CTAs per
// problem (valid_cluster: at most 16, H and W; a power of two at a
// power-of-two shape), `smem` bytes of shared memory per CTA. Returns
// cudaErrorInvalidValue for a plan whose smem differs from
// resident_smem_bytes, else the launch's error.
int fista_l1_dft_cluster_launch(const void* x0hat, const void* scal, const void* tab,
                                const void* tw, const void* wt, void* out, void* prof, int B,
                                int H, int W, int iterations, int clusters, int smem,
                                void* stream) {
    const bool valid = B > 0 && iterations >= 0 && rls::valid_fft_size(H) &&
                       rls::valid_fft_size(W) && valid_cluster(clusters, H, W) &&
                       static_cast<long long>(B) * clusters < (1LL << 31);
    if (!valid || static_cast<size_t>(smem) != resident_smem_bytes(H, W, clusters))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg;
    const auto kernel = rls::pow2_shape(H, W) ? fista_l1_dft_cluster_kernel<true>
                                              : fista_l1_dft_cluster_kernel<false>;
    cudaError_t e = rls::cluster_config(kernel, B, clusters, kThreads, smem,
                                        static_cast<cudaStream_t>(stream), &attr, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    const ResidentArgs args{static_cast<const float*>(x0hat), static_cast<const float*>(scal),
                            static_cast<const float*>(tab),   static_cast<const float*>(tw),
                            static_cast<const float*>(wt),    static_cast<float*>(out),
                            static_cast<long long*>(prof),    B,
                            H,                                W,
                            iterations,                       clusters};
    e = cudaLaunchKernelEx(&cfg, kernel, args);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// The grid route's CTAs of `smem` bytes of shared memory (a plane of
// grid_plane_floats(H, W, smem) floats each, which must be a whole number
// of float4) that the current device holds at once: out[0] a SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] on all of its SMs.
int fista_l1_dft_grid_occupancy(int H, int W, int smem, long long* out) {
    out[0] = out[1] = 0;
    if (!rls::valid_fft_size(H) || !rls::valid_fft_size(W) || smem < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t plane = grid_plane_floats(H, W, smem);
    if (plane == 0 || plane % 4 || grid_smem_bytes(H, W, plane) != static_cast<size_t>(smem))
        return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = grid_kernel(H, W);
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0, dev = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    out[0] = per_sm;
    out[1] = static_cast<long long>(per_sm) * sms;
    return 0;
}

// The grid route: x0hat, scal, tab, tw and wt as for the resident route;
// scratch: slots spectra (H, W) of complex f32 (interleaved), then slots
// planes x_prev (H, W) f32; bar: slots uint32 counters, 0 at the launch;
// prof null or kGridPhases int64 that receive CTA 0's clocks per phase;
// the plan: a team of `team` CTAs per problem, `slots` problems at once
// (the team of slot s solves problems s, s + slots, ...), chunks of
// row_lines rows and col_lines columns, `smem` bytes of shared memory per
// CTA (valid_grid). One cooperative launch of team x slots CTAs, all
// resident at once (the launch is refused otherwise). Returns
// cudaErrorInvalidValue for a plan valid_grid refuses, else the launch's
// error.
int fista_l1_dft_grid_launch(const void* x0hat, const void* scal, const void* tab,
                             const void* tw, const void* wt, void* out, void* scratch, void* bar,
                             void* prof, int B, int H, int W, int iterations, int team,
                             int slots, int row_lines, int col_lines, int smem, void* stream) {
    if (B < 1 || iterations < 0 ||
        !valid_grid(B, H, W, team, slots, row_lines, col_lines, smem))
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
                  static_cast<float*>(out),
                  spec,
                  reinterpret_cast<float*>(spec + slots * n),
                  static_cast<unsigned*>(bar),
                  static_cast<long long*>(prof),
                  B,
                  H,
                  W,
                  iterations,
                  team,
                  slots,
                  row_lines,
                  col_lines,
                  static_cast<int>(grid_plane_floats(H, W, smem))};
    void* kargs[] = {&args};
    e = cudaLaunchCooperativeKernel(fn, dim3(team * slots), dim3(kThreads), kargs,
                                    static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
