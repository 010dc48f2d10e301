// The whole batched proximal-gradient solve (FISTA, OptISTA, POGM) on a
// dense matrix in one launch: on real data the batch as one cooperative
// grid of A-slabs x problem groups (the grid route, pgm_dense_grid_kernel
// below), or one problem per CTA (pgm_dense_kernel, the per-problem route,
// where no grid plan fits the card); on complex data as (re, im) planes,
// one problem per CTA.
//
// Replaces the TPU kernels rls_tpu/kernels/pgm_dense_fused.py:_kernel
// (:47-129; launched by solve_pgm_dense_fused, :355, pallas_call :436) and
// _kernel_cplx (:132-262; launched by _solve_cplx, :458, pallas_call :518).
// Per problem, from x = 0 and x0hat = A^H b (computed here):
//   FISTA    a = (th_old - 1) / th, xm = x + a (x - x_prev),
//            x+ = prox(xm - rho (A^H A xm - x0hat), rho lam), the restart
//            test (gradient: res.(x+ - x) > 0; gradient mapping:
//            (xm - x+).(x+ - x) > 0) sets th = 1, th_old = th,
//            th = (1 + sqrt(1 + 4 th^2)) / 2, all in f32 per problem;
//   OptISTA  the row (a, b, g, e) of the f64 momentum table: res at x,
//   / POGM   y+ = prox(y - rho g res, rho g lam), z+ = x + (y+ - y) e,
//            x+ = (1 + a + b) z+ - a z - b x   (OptISTA); y+ = x - rho res,
//            x_mid = (1 + a + b) y+ - a y - (b + e) x + e x_mid_old,
//            x+ = prox(x_mid, rho g lam)       (POGM).
// The prox is the L1 soft threshold (the group threshold over (re, im) on
// complex data, eps added to the real plane only) or the L2 shrinkage
// x / (1 + 2 lam), then the projection (Positive clips the real plane; on
// complex data Positive and Real zero the imaginary plane). Each
// problem's restart count is written to `counts`. The plain PyTorch
// versions, which this code follows op for op, are pgm_dense_fused_torch
// and pgm_dense_fused_cplx_torch in rls_tpu_torch/kernels/pgm_dense_fused.py.
//
// The kernel is compiled per (real | complex, method, prox kind, restart):
// ten instantiations each. The projection is a run-time argument, one
// uniform branch per entry. Numerics as in cgnr_fused.cu: matvec entries
// and the restart dot are double sums in a fixed order rounded to f32,
// the scalar and entry updates separate f32 ops, so every thread takes
// the same restart decision and the kernel differs from its plain version
// only where two double sums round to different floats.
//
// What bounds it on an H100: an iteration is 4 m n f32 operations per
// problem for the matvec pair (16 m n on complex data) plus ~20 n for the
// prox and the updates, so the solve is operations-bound at the card's
// peak. In the per-problem kernel A stays in L2 and each CTA re-reads it
// twice per iteration, and one CTA per problem leaves most SMs idle at
// batch 16: the L2 traffic and the latency of one CTA's dependent passes
// set the time. Its planes (x0hat, x_prev | y, z, the Gram's input and
// result: n each, per plane; A's output: m) live in global scratch.
#include <cfloat>
#include <cuda_runtime.h>

#include "dense_common.cuh"
#include "dense_grid.cuh"

namespace {

constexpr int kThreads = rls::kDenseThreads;
enum { kL1 = 0, kL2 = 1 };
enum { kProjNone = 0, kProjPositive = 1, kProjReal = 2 };
constexpr float kEps = FLT_EPSILON;

// The prox at strength lam on one entry, then the projection; on real
// data `gi` and `pi` are unused.
template <bool kCplx, int kKind>
__device__ __forceinline__ void prox(float gr, float gi, float lam, int proj, float& pr,
                                     float& pi) {
    if constexpr (kKind == kL1) {
        if constexpr (kCplx) {
            const float mag = __fsqrt_rn(rls::fadd(rls::fmul(gr, gr), rls::fmul(gi, gi)));
            const float sc = rls::fdiv(fmaxf(rls::fsub(mag, lam), 0.f), rls::fadd(mag, kEps));
            pr = rls::fmul(sc, rls::fadd(gr, kEps));
            pi = rls::fmul(sc, gi);
        } else {
            const float mag = fabsf(gr);
            pr = rls::fdiv(rls::fmul(fmaxf(rls::fsub(mag, lam), 0.f), rls::fadd(gr, kEps)),
                           rls::fadd(mag, kEps));
        }
    } else {
        const float d = rls::fadd(1.f, rls::fmul(2.f, lam));
        pr = rls::fdiv(gr, d);
        if constexpr (kCplx) pi = rls::fdiv(gi, d);
    }
    if (proj == kProjPositive) pr = fmaxf(pr, 0.f);
    if constexpr (kCplx) {
        if (proj != kProjNone) pi = rls::fmul(pi, 0.f);
    }
}

template <bool kCplx, int kMethod, int kKind, int kRestart>
__global__ void __launch_bounds__(kThreads)
pgm_dense_kernel(const float* __restrict__ br, const float* __restrict__ bi,
                 const float* __restrict__ ar, const float* __restrict__ ai,
                 const float* __restrict__ scal, const float* __restrict__ tab,
                 float* __restrict__ out, float* __restrict__ scratch,
                 int* __restrict__ counts, int P, int m, int n, int steps, int proj) {
    constexpr int C = kCplx ? 2 : 1;  // planes: re (, im)
    __shared__ double s_red[3 * (kThreads / 32)];
    const int pb = blockIdx.x;
    float* ws = scratch + static_cast<size_t>(pb) * C * (5 * n + m);
    float *x0[2] = {}, *m1[2] = {}, *m2[2] = {}, *xm[2] = {}, *v[2] = {}, *q[2] = {}, *x[2] = {};
    for (int c = 0; c < C; ++c) {
        x0[c] = ws + (0 * C + c) * n;
        m1[c] = ws + (1 * C + c) * n;  // x_prev | y
        m2[c] = ws + (2 * C + c) * n;  // z | x_mid
        xm[c] = ws + (3 * C + c) * n;  // FISTA's momentum point
        v[c] = ws + (4 * C + c) * n;   // A^H A of the Gram's input
        q[c] = ws + 5 * C * n + c * m;
        x[c] = out + (static_cast<size_t>(c) * P + pb) * n;
    }
    const float lam = scal[3 * pb];
    const float rho = scal[3 * pb + 1];
    float th = scal[3 * pb + 2];
    float th_old = th;

    const size_t bo = static_cast<size_t>(pb) * m;
    rls::mv_cols<kCplx>(ar, ai, br + bo, kCplx ? bi + bo : nullptr, x0[0], x0[1], m, n);
    for (int j = threadIdx.x; j < n; j += blockDim.x)
        for (int c = 0; c < C; ++c) {
            const float zero = rls::fmul(x0[c][j], 0.f);
            x[c][j] = zero;
            m1[c][j] = zero;
            m2[c][j] = zero;
        }
    __syncthreads();

    int fires = 0;
    for (int it = 0; it < steps; ++it) {
        float* const* gin = x;  // the Gram's input
        if constexpr (kMethod == rls::kFista) {
            const float a = rls::fdiv(rls::fsub(th_old, 1.f), th);
            for (int j = threadIdx.x; j < n; j += blockDim.x)
                for (int c = 0; c < C; ++c) {
                    const float xv = x[c][j];
                    xm[c][j] = rls::fadd(xv, rls::fmul(a, rls::fsub(xv, m1[c][j])));
                }
            __syncthreads();
            gin = xm;
        }
        rls::mv_rows<kCplx>(ar, ai, gin[0], gin[1], q[0], q[1], m, n);
        __syncthreads();
        rls::mv_cols<kCplx>(ar, ai, q[0], q[1], v[0], v[1], m, n);

        if constexpr (kMethod == rls::kFista) {
            const float rl = rls::fmul(rho, lam);
            double acc[3] = {0.0, 0.0, 0.0};
            for (int j = threadIdx.x; j < n; j += blockDim.x) {
                float res[2], xmv[2], xg[2] = {}, xn[2] = {};
                for (int c = 0; c < C; ++c) {
                    res[c] = rls::fsub(v[c][j], x0[c][j]);
                    xmv[c] = xm[c][j];
                    xg[c] = rls::fsub(xmv[c], rls::fmul(rho, res[c]));
                }
                prox<kCplx, kKind>(xg[0], xg[1], rl, proj, xn[0], xn[1]);
                for (int c = 0; c < C; ++c) {
                    const float xv = x[c][j];
                    const float d = rls::fsub(xn[c], xv);
                    if constexpr (kRestart == rls::kRestartGradient)
                        acc[0] += rls::dmul(res[c], d);
                    else if constexpr (kRestart == rls::kRestartGradientMapping)
                        acc[0] += rls::dmul(rls::fsub(xmv[c], xn[c]), d);
                    m1[c][j] = xv;
                    x[c][j] = xn[c];
                }
            }
            if constexpr (kRestart != rls::kRestartNone) {
                rls::block_sum3(acc, s_red);
                if (static_cast<float>(acc[0]) > 0.f) {
                    th = 1.f;
                    ++fires;
                }
            }
            th_old = th;
            th = rls::theta_next(th, 4.f);
        } else {
            const float* row = tab + 4 * it;
            const float a = row[0], bc = row[1], g = row[2], e = row[3];
            const float cy = rls::fadd(rls::fadd(1.f, a), bc);
            if constexpr (kMethod == rls::kOptista) {
                const float step = rls::fmul(rho, g);
                const float ls = rls::fmul(step, lam);
                for (int j = threadIdx.x; j < n; j += blockDim.x) {
                    float yg[2] = {}, yn[2] = {};
                    for (int c = 0; c < C; ++c)
                        yg[c] = rls::fsub(m1[c][j], rls::fmul(step, rls::fsub(v[c][j], x0[c][j])));
                    prox<kCplx, kKind>(yg[0], yg[1], ls, proj, yn[0], yn[1]);
                    for (int c = 0; c < C; ++c) {
                        const float xv = x[c][j];
                        const float zn = rls::fadd(xv, rls::fmul(rls::fsub(yn[c], m1[c][j]), e));
                        x[c][j] = rls::fsub(rls::fsub(rls::fmul(cy, zn), rls::fmul(a, m2[c][j])),
                                            rls::fmul(bc, xv));
                        m1[c][j] = yn[c];
                        m2[c][j] = zn;
                    }
                }
            } else {  // POGM
                const float cx = rls::fadd(bc, e);
                const float ls = rls::fmul(rls::fmul(rho, g), lam);
                for (int j = threadIdx.x; j < n; j += blockDim.x) {
                    float xmid[2] = {}, xn[2] = {};
                    for (int c = 0; c < C; ++c) {
                        const float xv = x[c][j];
                        const float res = rls::fsub(v[c][j], x0[c][j]);
                        const float yn = rls::fsub(xv, rls::fmul(rho, res));
                        xmid[c] = rls::fadd(
                            rls::fsub(rls::fsub(rls::fmul(cy, yn), rls::fmul(a, m1[c][j])),
                                      rls::fmul(cx, xv)),
                            rls::fmul(e, m2[c][j]));
                        m1[c][j] = yn;
                        m2[c][j] = xmid[c];
                    }
                    prox<kCplx, kKind>(xmid[0], xmid[1], ls, proj, xn[0], xn[1]);
                    for (int c = 0; c < C; ++c) x[c][j] = xn[c];
                }
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) counts[pb] = fires;
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                        const float*, float*, float*, int*, int, int, int, int, int);

template <bool kCplx, int kMethod, int kKind>
Kernel pick_restart(int restart) {
    if constexpr (kMethod != rls::kFista) {
        return &pgm_dense_kernel<kCplx, kMethod, kKind, rls::kRestartNone>;
    } else {
        if (restart == rls::kRestartGradient)
            return &pgm_dense_kernel<kCplx, kMethod, kKind, rls::kRestartGradient>;
        if (restart == rls::kRestartGradientMapping)
            return &pgm_dense_kernel<kCplx, kMethod, kKind, rls::kRestartGradientMapping>;
        return &pgm_dense_kernel<kCplx, kMethod, kKind, rls::kRestartNone>;
    }
}

template <bool kCplx, int kMethod>
Kernel pick_kind(int kind, int restart) {
    return kind == kL1 ? pick_restart<kCplx, kMethod, kL1>(restart)
                       : pick_restart<kCplx, kMethod, kL2>(restart);
}

template <bool kCplx>
Kernel pick(int method, int kind, int restart) {
    if (method == rls::kFista) return pick_kind<kCplx, rls::kFista>(kind, restart);
    if (method == rls::kOptista) return pick_kind<kCplx, rls::kOptista>(kind, restart);
    return pick_kind<kCplx, rls::kPogm>(kind, restart);
}

bool valid(int method, int kind, int restart, int proj) {
    return method >= rls::kFista && method <= rls::kPogm && (kind == kL1 || kind == kL2) &&
           restart >= rls::kRestartNone && restart <= rls::kRestartGradientMapping &&
           (method == rls::kFista || restart == rls::kRestartNone) && proj >= kProjNone &&
           proj <= kProjReal;
}

// ---- The grid route (pgm_dense_grid_kernel, real data): the batch's
// solve as one cooperative grid of A-slabs x problem groups, on row 6's
// machinery (dense_grid.cuh). CTA (s, g) takes slab s of `rows` rows of A
// for group g of `group_size` problems. With `resident` it copies the slab
// into shared memory once and keeps it for the whole solve; without, it
// reads the slab from L2 for every tile. It keeps its group's Gram input
// gin (f32, tiles x n8 x 8: x for OptISTA and POGM, the momentum point for
// FISTA) and, for FISTA, x (tiles x n x 8) in shared memory. The slab's
// CTA s also owns the column chunk [s chunk, (s + 1) chunk): it keeps
// x0hat and the planes read only at their own column (y | x_prev's place
// m1, z | x_mid m2) for those columns. Per iteration:
//   (a) per tile of 8 problems, q = A_slab gin on the tensor cores, then
//       the slab's partial v = A_slab^T q in double, to `part` (L2);
//   B1
//   (b) the owner: v = the slabs' partials summed in slab order, rounded
//       to f32 once; the entry update and the prox of its columns, op for
//       op as the per-problem kernel above; the new x of its columns to
//       `xpub` (and to `out` in the last iteration), and for FISTA with a
//       restart its per-problem partial of the restart dot to `rdots`;
//   B2
//   (c) every CTA: for FISTA the restart partials summed in slab order
//       (the same sums in the same order in every CTA, so every CTA takes
//       the same f32 decision) and theta; then its group's new x from
//       `xpub`, and the next gin.
// The set-up runs the same two barriers on x0hat = A^T b: the slabs'
// partial sums with q = b's rows, the owner's x0hat and x = m1 = m2 =
// x0hat * 0 published to `xpub`.
//
// Barrier table (group_sync over the group's slabs; the cooperative
// launch makes every CTA of the grid resident, so the barriers cannot
// deadlock):
//   B1  publishes `part`, written in (a); read by the owners in (b).
//   B2  publishes `xpub` and `rdots`, written in (b); read by every CTA
//       in (c).
// Each buffer is written only between the other pair of barriers: `part`
// in (a) of the next iteration, after B2, when every owner has read it;
// `xpub` and `rdots` in (b) of the next iteration, after B1, when every
// CTA has read them. So two barriers per iteration suffice, with a
// restart or without.
//
// What bounds it on an H100: the same operations as the per-problem
// kernel; per iteration each CTA multiplies its slab by `tiles` tiles on
// the FP64 tensor cores, and two group barriers (an atomic and a poll of
// L2 each) and two L2 round trips (the partial v to its owner, the new x
// back to every CTA) take a fixed few microseconds.

namespace grid = rls::grid;

// the phases that Prof times (CTA 0's thread 0)
enum { kSetup, kQ, kPartialV, kBarrier1, kUpdate, kBarrier2, kReload, kGridPhases };

struct GridArgs {
    const float* b;     // (P, m)
    const float* A;     // (m, n)
    const float* scal;  // (P, 3): lam_eff, rho, theta0
    const float* tab;   // (steps, 4): the momentum table (OptISTA, POGM)
    float* out;         // (P, n): x
    int* counts;        // (P,): the restarts
    double* part;       // (groups, slabs, tiles, n, 8): the slabs' partial v
    double* rdots;      // (groups, slabs, group_size): restart partials (FISTA)
    float* xpub;        // (groups, tiles, n, 8): the owners' new x
    unsigned* bar;      // (groups, 32): barrier counters, zero at launch
    long long* prof;    // (kGridPhases,): CTA 0's clocks per phase; or null
    int P, m, n, steps, restart, proj;
    int slabs, rows, groups, group_size;
};

// Shared memory of a CTA of the grid route; the Python planner
// (kernels/pgm_dense_fused.py grid_smem_bytes) counts the same: q of a
// tile (float64, rows rounded up to 16), five 4-byte scalars per problem,
// the block reduction, the phase timer, the warps' split sums, with
// `resident` the slab of A (f32, zero rows and columns up to 16 rows and
// slab_ld), gin (f32, tiles x n rounded up to 8 x 8), x (f32, tiles x n x
// 8) and the owner's x0hat, m1, m2 (f32, tiles x chunk x 8); each piece
// 16-byte aligned.
__host__ __device__ size_t grid_smem_bytes(int n, int slabs, int rows, int group_size,
                                           bool resident) {
    using grid::align16;
    using grid::kTile;
    const size_t chunk = (n + slabs - 1) / slabs, tiles = (group_size + kTile - 1) / kTile;
    const size_t rows16 = grid::round_up(rows, 16);
    size_t b = align16(sizeof(double) * kTile * rows16) + align16(5 * 4 * group_size) +
               align16(sizeof(double) * grid::kWarps * kTile) +
               align16(sizeof(long long) * kGridPhases) +
               align16(sizeof(double) * grid::kWarps * 128) +
               align16(sizeof(float) * kTile * tiles * grid::round_up(n, 8)) +
               align16(sizeof(float) * kTile * tiles * n) +
               align16(3 * sizeof(float) * kTile * tiles * chunk);
    if (resident) b += align16(sizeof(float) * rows16 * grid::slab_ld(n));
    return b;
}

template <bool kRes, int kMethod, int kKind>
__global__ void __launch_bounds__(grid::kThreads, 1) pgm_dense_grid_kernel(GridArgs a) {
    using grid::kTile;
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = a.slabs, n = a.n, tid = threadIdx.x, gs = a.group_size;
    const int s = blockIdx.x % S, g = blockIdx.x / S;
    const int row0 = s * a.rows, R = min(a.rows, a.m - row0), R16 = grid::round_up(a.rows, 16);
    const int p0 = g * gs, G = min(gs, a.P - p0);
    const int tiles = (G + kTile - 1) / kTile, tmax = (gs + kTile - 1) / kTile;
    const int chunk = (n + S - 1) / S, n8 = grid::round_up(n, 8), ld = grid::slab_ld(n);
    const int c0 = min(n, s * chunk), c1 = min(n, c0 + chunk);
    const bool one = S == 1;  // the group is this CTA: its own writes, no L2 round trip
    const bool restart = kMethod == rls::kFista && a.restart != rls::kRestartNone;

    // shared memory, in grid_smem_bytes' order
    unsigned char* sp = smem;
    auto take = [&sp](size_t nbytes) {
        unsigned char* q = sp;
        sp += grid::align16(nbytes);
        return q;
    };
    double* sq = reinterpret_cast<double*>(take(sizeof(double) * kTile * R16));
    float* s_lam = reinterpret_cast<float*>(take(5 * 4 * gs));
    float* s_rho = s_lam + gs;
    float* s_th = s_rho + gs;
    float* s_mom = s_th + gs;  // FISTA's (th_old - 1) / th
    int* s_fires = reinterpret_cast<int*>(s_mom + gs);
    double* red = reinterpret_cast<double*>(take(sizeof(double) * grid::kWarps * kTile));
    long long* s_prof = reinterpret_cast<long long*>(take(sizeof(long long) * kGridPhases));
    double* scratch = reinterpret_cast<double*>(take(sizeof(double) * grid::kWarps * 128));
    float* sa = kRes ? reinterpret_cast<float*>(take(sizeof(float) * R16 * ld)) : nullptr;
    float* gin = reinterpret_cast<float*>(take(sizeof(float) * kTile * tmax * n8));
    float* sx = reinterpret_cast<float*>(take(sizeof(float) * kTile * tmax * n));
    float* x0 = reinterpret_cast<float*>(take(3 * sizeof(float) * kTile * tmax * chunk));
    float* m1 = x0 + kTile * tmax * chunk;
    float* m2 = m1 + kTile * tmax * chunk;

    double* part_g = a.part + static_cast<size_t>(g) * S * tmax * n * kTile;
    double* part = part_g + static_cast<size_t>(s) * tmax * n * kTile;
    double* rd_g = a.rdots + static_cast<size_t>(g) * S * gs;
    float* xp = a.xpub + static_cast<size_t>(g) * tmax * n * kTile;
    const float* as = kRes ? sa : a.A + static_cast<size_t>(row0) * n;
    unsigned* ctr = a.bar + 32 * g;
    unsigned target = 0;
    // the owner's elements: problem ko of a tile, columns jo, then every
    // kStride; its planes x0hat, m1, m2 as [tile][j - c0][ko]
    const int ko = tid % kTile, jo = c0 + tid / kTile;
    constexpr int kStride = grid::kThreads / kTile;
    auto oi = [&](int kt, int j) { return (kt * chunk + j - c0) * kTile + ko; };
    rls::Prof<kGridPhases> prof{blockIdx.x == 0 && tid == 0 ? a.prof : nullptr, s_prof, 0};
    prof.start();

    // (a): the slab's partial v of every tile, q from `fill_q`; then B1
    auto partial_v = [&](auto fill_q) {
        for (int kt = 0; kt < tiles; ++kt) {
            fill_q(kt);
            __syncthreads();
            prof.mark(kQ);
            grid::v_tile<kRes>(as, ld, sq, part + static_cast<size_t>(kt) * n * kTile, scratch,
                               R, n);
            __syncthreads();
            prof.mark(kPartialV);
        }
        grid::group_sync(ctr, target, S);  // B1
        prof.mark(kBarrier1);
    };
    // v of problem ko of tile kt at column j: the slabs' partials in order
    auto slab_sum = [&](int kt, int j) {
        const double* at = part_g + (static_cast<size_t>(kt) * n + j) * kTile + ko;
        const size_t stride = static_cast<size_t>(tmax) * n * kTile;
        return static_cast<float>(grid::ordered_sum<double>(
            S, [&](int t) { return grid::ld_group(at + t * stride, one); }));
    };
    // (c): gin (and FISTA's x) from the group's new x in `xpub`, 8 float4
    // loads of a thread in flight; entries of no problem read as 0
    auto reload = [&](bool first) {
        const int total = tiles * n * kTile / 4;
        const float4* src = reinterpret_cast<const float4*>(xp);
        for (int i0 = tid; i0 < total; i0 += 8 * grid::kThreads) {
            float4 v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int i = i0 + u * grid::kThreads;
                if (i < total) v[u] = grid::ld_group(src + i, one);
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int i = i0 + u * grid::kThreads;
                if (i >= total) break;
                const int e = 4 * i, kt = e / (n * kTile), j = e / kTile - kt * n;
                const int k0 = e % kTile;
                const float xn[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
                float gv[4];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int l = kt * kTile + k0 + c;
                    gv[c] = 0.f;
                    if (l >= G) continue;
                    gv[c] = xn[c];
                    if constexpr (kMethod == rls::kFista) {
                        const float xo = first ? xn[c] : sx[e + c];
                        sx[e + c] = xn[c];
                        gv[c] = rls::fadd(xn[c], rls::fmul(s_mom[l], rls::fsub(xn[c], xo)));
                    }
                }
                *reinterpret_cast<float4*>(gin + (kt * n8 + j) * kTile + k0) =
                    make_float4(gv[0], gv[1], gv[2], gv[3]);
            }
        }
        __syncthreads();
    };

    for (int l = tid; l < G; l += grid::kThreads) {
        const float* sc = a.scal + 3 * (p0 + l);
        s_lam[l] = sc[0];
        s_rho[l] = sc[1];
        s_th[l] = sc[2];
        s_mom[l] = rls::fdiv(rls::fsub(sc[2], 1.f), sc[2]);
        s_fires[l] = 0;
    }
    if (kRes) {
        // A's slab with zero rows and columns up to R16 x ld
        const float* src = a.A + static_cast<size_t>(row0) * n;
        for (int i = tid; i < R16 * ld; i += grid::kThreads) {
            const int r = i / ld, j = i - r * ld;
            sa[i] = r < R && j < n ? __ldg(src + r * n + j) : 0.f;
        }
    }
    for (int i = tid; i < kTile * tmax * n8; i += grid::kThreads) gin[i] = 0.f;
    // x0hat = A^T b: the slabs' partial sums with q = b's rows
    partial_v([&](int kt) {
        const int l0 = kt * kTile, gk = min(kTile, G - l0);
        for (int i = tid; i < R16 * kTile; i += grid::kThreads) {
            const int r = i / kTile, k = i % kTile;
            sq[i] = r < R && k < gk ? static_cast<double>(__ldg(
                                          a.b + static_cast<size_t>(p0 + l0 + k) * a.m + row0 + r))
                                    : 0.0;
        }
    });
    // the owner: x0hat, and x = m1 = m2 = x0hat * 0 (also the result of no
    // iteration), published
    for (int kt = 0; kt < tiles; ++kt)
        if (ko < min(kTile, G - kt * kTile))
            for (int j = jo; j < c1; j += kStride) {
                const float x0v = slab_sum(kt, j), zero = rls::fmul(x0v, 0.f);
                const int o = oi(kt, j);
                x0[o] = x0v;
                m1[o] = zero;
                m2[o] = zero;
                xp[(kt * n + j) * kTile + ko] = zero;
                a.out[static_cast<size_t>(p0 + kt * kTile + ko) * n + j] = zero;
            }
    grid::group_sync(ctr, target, S);  // B2
    reload(true);
    prof.mark(kSetup);

    for (int it = 0; it < a.steps; ++it) {
        // (a) q = A_slab gin and the slab's partial v, tile by tile; B1
        partial_v([&](int kt) {
            grid::q_tile<kRes, true>(as, ld, gin + static_cast<size_t>(kt) * n8 * kTile, sq,
                                     scratch, R, n);
        });
        // (b) the owner's columns
        const bool last = it + 1 == a.steps;
        const float* row = a.tab + 4 * it;
        for (int kt = 0; kt < tiles; ++kt) {
            const int gk = min(kTile, G - kt * kTile), l = kt * kTile + ko;
            double acc[1] = {0.0};
            if (ko < gk) {
                const float lam = s_lam[l], rho = s_rho[l];
                for (int j = jo; j < c1; j += kStride) {
                    const int o = oi(kt, j), e = (kt * n + j) * kTile + ko;
                    const float res = rls::fsub(slab_sum(kt, j), x0[o]);
                    const float gv = gin[(kt * n8 + j) * kTile + ko];  // xm (FISTA) | x
                    float xn, unused;
                    if constexpr (kMethod == rls::kFista) {
                        const float xv = sx[e];
                        prox<false, kKind>(rls::fsub(gv, rls::fmul(rho, res)), 0.f,
                                           rls::fmul(rho, lam), a.proj, xn, unused);
                        const float d = rls::fsub(xn, xv);
                        if (a.restart == rls::kRestartGradient)
                            acc[0] += rls::dmul(res, d);
                        else if (a.restart == rls::kRestartGradientMapping)
                            acc[0] += rls::dmul(rls::fsub(gv, xn), d);
                    } else {
                        const float am = row[0], bc = row[1], gm = row[2], ec = row[3];
                        const float cy = rls::fadd(rls::fadd(1.f, am), bc);
                        if constexpr (kMethod == rls::kOptista) {
                            const float step = rls::fmul(rho, gm);
                            const float y = m1[o];
                            float yn;
                            prox<false, kKind>(rls::fsub(y, rls::fmul(step, res)), 0.f,
                                               rls::fmul(step, lam), a.proj, yn, unused);
                            const float zn = rls::fadd(gv, rls::fmul(rls::fsub(yn, y), ec));
                            xn = rls::fsub(rls::fsub(rls::fmul(cy, zn), rls::fmul(am, m2[o])),
                                           rls::fmul(bc, gv));
                            m1[o] = yn;
                            m2[o] = zn;
                        } else {  // POGM
                            const float cx = rls::fadd(bc, ec);
                            const float yn = rls::fsub(gv, rls::fmul(rho, res));
                            const float xmid = rls::fadd(
                                rls::fsub(rls::fsub(rls::fmul(cy, yn), rls::fmul(am, m1[o])),
                                          rls::fmul(cx, gv)),
                                rls::fmul(ec, m2[o]));
                            m1[o] = yn;
                            m2[o] = xmid;
                            prox<false, kKind>(xmid, 0.f, rls::fmul(rls::fmul(rho, gm), lam),
                                               a.proj, xn, unused);
                        }
                    }
                    xp[e] = xn;
                    if (last) a.out[static_cast<size_t>(p0 + l) * n + j] = xn;
                }
            }
            if (restart) {
                grid::tile_sum<1>(acc, red);
                if (tid < gk) rd_g[s * gs + kt * kTile + tid] = acc[0];
            }
        }
        prof.mark(kUpdate);
        grid::group_sync(ctr, target, S);  // B2
        prof.mark(kBarrier2);
        // (c) theta, after the restart test over all columns; then the
        // group's new x
        if constexpr (kMethod == rls::kFista) {
            for (int l = tid; l < G; l += grid::kThreads) {
                float th = s_th[l];
                if (restart) {
                    const double d = grid::ordered_sum<double>(
                        S, [&](int t) { return grid::ld_group(rd_g + t * gs + l, one); });
                    if (static_cast<float>(d) > 0.f) {
                        th = 1.f;
                        ++s_fires[l];
                    }
                }
                const float th_new = rls::theta_next(th, 4.f);
                s_th[l] = th_new;
                s_mom[l] = rls::fdiv(rls::fsub(th, 1.f), th_new);
            }
            __syncthreads();
        }
        if (!last) reload(false);
        prof.mark(kReload);
    }
    if (s == 0)
        for (int l = tid; l < G; l += grid::kThreads)
            a.counts[p0 + l] = kMethod == rls::kFista ? s_fires[l] : 0;
    prof.finish();
}

using GridKernel = void (*)(GridArgs);

template <bool kRes, int kMethod>
GridKernel pick_grid_kind(int kind) {
    return kind == kL1 ? &pgm_dense_grid_kernel<kRes, kMethod, kL1>
                       : &pgm_dense_grid_kernel<kRes, kMethod, kL2>;
}

template <bool kRes>
GridKernel pick_grid(int method, int kind) {
    if (method == rls::kFista) return pick_grid_kind<kRes, rls::kFista>(kind);
    if (method == rls::kOptista) return pick_grid_kind<kRes, rls::kOptista>(kind);
    return pick_grid_kind<kRes, rls::kPogm>(kind);
}

}  // namespace

extern "C" {

// b: (P, m) f32, one problem per row; A: (m, n) f32 row-major; scal: (P, 3)
// [lam_eff, rho, theta0]; tab: the momentum table (steps, 4) for OptISTA
// and POGM; out: (P, n); scratch: (P, 5 n + m); counts: (P,) int32, the
// restarts. Codes: method fista | optista | pogm, kind l1 | l2, restart
// none | gradient | gradient_mapping (FISTA), proj none | positive.
int pgm_dense_fused_launch(const void* b, const void* A, const void* scal, const void* tab,
                           void* out, void* scratch, void* counts, int P, int m, int n,
                           int steps, int method, int kind, int restart, int proj,
                           void* stream) {
    if (!valid(method, kind, restart, proj) || proj == kProjReal)
        return static_cast<int>(cudaErrorInvalidValue);
    if (P <= 0) return 0;
    pick<false>(method, kind, restart)<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(b), nullptr, static_cast<const float*>(A), nullptr,
        static_cast<const float*>(scal), static_cast<const float*>(tab),
        static_cast<float*>(out), static_cast<float*>(scratch), static_cast<int*>(counts), P,
        m, n, steps, proj);
    return static_cast<int>(cudaGetLastError());
}

// The same on complex data as planes: br, bi (P, m); ar, ai (m, n); out:
// (2, P, n), the re then the im plane; scratch: (P, 2 (5 n + m)); proj
// also real (zero the imaginary plane).
int pgm_dense_fused_cplx_launch(const void* br, const void* bi, const void* ar,
                                const void* ai, const void* scal, const void* tab, void* out,
                                void* scratch, void* counts, int P, int m, int n, int steps,
                                int method, int kind, int restart, int proj, void* stream) {
    if (!valid(method, kind, restart, proj)) return static_cast<int>(cudaErrorInvalidValue);
    if (P <= 0) return 0;
    pick<true>(method, kind, restart)<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(br), static_cast<const float*>(bi),
        static_cast<const float*>(ar), static_cast<const float*>(ai),
        static_cast<const float*>(scal), static_cast<const float*>(tab),
        static_cast<float*>(out), static_cast<float*>(scratch), static_cast<int*>(counts), P,
        m, n, steps, proj);
    return static_cast<int>(cudaGetLastError());
}

// The grid route on real data (pgm_dense_grid_kernel above): b, A, scal,
// tab, out and counts as pgm_dense_fused_launch takes them. The plan
// (planned in Python by plan_pgm_dense): `slabs` slabs of `rows` rows,
// `groups` groups of `group_size` problems, A's slab in shared memory with
// `resident`, `smem` bytes of shared memory per CTA. Scratch: part
// (groups, slabs, ceil(group_size / 8), n, 8) and rdots (groups, slabs,
// group_size) float64, xpub (groups, ceil(group_size / 8), n, 8) f32
// (16-byte aligned), bar (groups, 32) uint32 zeros; prof: null, or
// kGridPhases int64 that receive CTA 0's clocks per phase. Returns
// cudaErrorInvalidValue for a schedule or a plan that does not cover the
// shapes or whose smem differs from grid_smem_bytes,
// cudaErrorCooperativeLaunchTooLarge for a grid that cannot be resident at
// once (the cooperative launch's own check), else the launch's error.
int pgm_dense_grid_launch(const void* b, const void* A, const void* scal, const void* tab,
                          void* out, void* counts, void* part, void* rdots, void* xpub,
                          void* bar, void* prof, int P, int m, int n, int steps, int method,
                          int kind, int restart, int proj, int slabs, int rows, int groups,
                          int group_size, int resident, int smem, void* stream) {
    if (!valid(method, kind, restart, proj) || proj == kProjReal)
        return static_cast<int>(cudaErrorInvalidValue);
    if (P <= 0) return 0;
    const bool covers = m > 0 && n > 0 && steps >= 0 && slabs > 0 && rows > 0 && groups > 0 &&
                        group_size > 0 && static_cast<long long>(slabs - 1) * rows < m &&
                        static_cast<long long>(slabs) * rows >= m &&
                        static_cast<long long>(groups - 1) * group_size < P &&
                        static_cast<long long>(groups) * group_size >= P &&
                        static_cast<long long>(m) * n < (1LL << 31) &&
                        static_cast<long long>(P + grid::kTile) * (n + 40) < (1LL << 31) &&
                        static_cast<long long>(slabs) * groups < (1LL << 31);
    if (!covers ||
        static_cast<size_t>(smem) != grid_smem_bytes(n, slabs, rows, group_size, resident != 0))
        return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = reinterpret_cast<const void*>(resident ? pick_grid<true>(method, kind)
                                                            : pick_grid<false>(method, kind));
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    GridArgs args{static_cast<const float*>(b), static_cast<const float*>(A),
                  static_cast<const float*>(scal), static_cast<const float*>(tab),
                  static_cast<float*>(out), static_cast<int*>(counts),
                  static_cast<double*>(part), static_cast<double*>(rdots),
                  static_cast<float*>(xpub), static_cast<unsigned*>(bar),
                  static_cast<long long*>(prof), P, m, n, steps, restart, proj, slabs, rows,
                  groups, group_size};
    void* kargs[] = {&args};
    e = cudaLaunchCooperativeKernel(fn, dim3(slabs * groups), dim3(grid::kThreads), kargs,
                                    static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
