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
// * global: one CTA per problem (the first design), the spectrum staged
//   through shared memory chunk by chunk from global scratch
//   (dft_common.cuh), for spectra whose band fits no cluster of 16 (385^2,
//   512^2 and larger).
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
// operations. A 256^2 complex spectrum (512 KiB) is larger than a block's
// shared memory, so the global route makes three passes over the spectrum
// in global memory per normal op, each staging 4096 points at a time with
// a barrier after every radix-2 stage (~600 per iteration), on one CTA per
// problem: 16 of 132 SMs at batch 16. The resident route spreads a problem
// over a cluster of neighbouring SMs that write each other's shared memory
// (DSMEM) and keeps the whole solve's state on chip. At the CS cell (256^2
// x 16) the planner takes c = 16: 16-row bands, 16-column blocks, 102,472
// bytes per CTA. A line of n points runs its stages in registers
// (fft_resident.cuh: sub-lines of <= 128 points, spans >= 128 through
// shared memory): a 256-point line has one shared-memory stage, which the
// forward passes fuse with their loads and the inverse passes with their
// stores. A line with an odd factor (320 = 5 x 64) instead loads into
// shared memory plainly, runs its odd stages there (fft_mixed.cuh) and
// then its radix-2 stages, and the inverse runs all of its shared-memory
// stages before a plain store or push.
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cluster_common.cuh"
#include "dft_common.cuh"
#include "fft_resident.cuh"
#include "split.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;

template <bool kPow2>
__global__ void __launch_bounds__(kThreads)
fista_l1_dft_fused_kernel(const float* __restrict__ x0hat, const float* __restrict__ scal,
                          const float* __restrict__ tab, const float* __restrict__ tw,
                          const float* __restrict__ weights, float* __restrict__ out,
                          float* __restrict__ scratch, int B, int H, int W, int iterations) {
    __shared__ rls::FftShared s;
    rls::load_twiddles(s, tw, H, W);

    const int b = blockIdx.x;
    const int n = H * W;
    const size_t plane = static_cast<size_t>(B) * n;
    const size_t off = static_cast<size_t>(b) * n;
    const float* x0 = x0hat + off;
    float* x = out + off;
    float* xp = scratch + off;
    float* xm = scratch + plane + off;
    float* kr = scratch + 2 * plane + off;
    float* ki = scratch + 3 * plane + off;

    const float rho = scal[2 * b];
    const float t = rls::fmul(rho, scal[2 * b + 1]);
    const float eps = 1.1920928955078125e-07f;  // 2^-23, float32's eps
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const float zero = x0[i] * 0.f;
        x[i] = zero;
        xp[i] = zero;
    }
    __syncthreads();

    for (int it = 0; it < iterations; ++it) {
        const float a = tab[4 * it];
        auto load = [&](int i) {
            const float xv = x[i];
            const float m = rls::fadd(xv, rls::fmul(a, rls::fsub(xv, xp[i])));
            xm[i] = m;
            return make_float2(m, 0.f);
        };
        auto store = [&](int i, float nr, float) {
            const float m = xm[i];
            const float xg = rls::fsub(m, rls::fmul(rho, rls::fsub(nr, x0[i])));
            const float mag = fabsf(xg);
            const float shrink = fmaxf(rls::fsub(mag, t), 0.f);
            xp[i] = x[i];
            x[i] = rls::fdiv(rls::fmul(shrink, rls::fadd(xg, eps)), rls::fadd(mag, eps));
        };
        rls::masked_normal<kPow2>(load, store, kr, ki, weights, s, H, W);
    }
}


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

}  // namespace

extern "C" {

// x0hat, out: (B, H, W) f32; scal: (B, 2) [rho, lam_eff]; tab: (iterations,
// 4), the momentum table; tw: twiddle_floats(H, W) floats [Re_H, Im_H, Re_W,
// Im_W] (the first twiddle_count(H) and twiddle_count(W) twiddles of each
// axis); weights: (H, W) the spectral weights; scratch: 4 planes of (B, H,
// W). H and W from 2 to 1024.
int fista_l1_dft_fused_launch(const void* x0hat, const void* scal, const void* tab,
                              const void* tw, const void* weights, void* out, void* scratch,
                              int B, int H, int W, int iterations, void* stream) {
    if (!rls::valid_fft_size(H) || !rls::valid_fft_size(W))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel =
        rls::pow2_shape(H, W) ? fista_l1_dft_fused_kernel<true> : fista_l1_dft_fused_kernel<false>;
    kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x0hat), static_cast<const float*>(scal),
        static_cast<const float*>(tab), static_cast<const float*>(tw),
        static_cast<const float*>(weights), static_cast<float*>(out),
        static_cast<float*>(scratch), B, H, W, iterations);
    return static_cast<int>(cudaGetLastError());
}

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

// The resident route: as fista_l1_dft_fused_launch without scratch, with wt
// the spectral weights transposed ((W, H)), prof null or kPhases int64 that
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

}  // extern "C"
