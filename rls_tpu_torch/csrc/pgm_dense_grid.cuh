// The whole batched proximal-gradient solve (FISTA, OptISTA, POGM) on a
// dense matrix as ONE cooperative grid of A-slabs x problem groups (the
// grid route; pgm_dense_fused.cu holds the per-problem route, one CTA per
// problem, for shapes no grid plan fits), on real data or on complex data
// as (re, im) planes, on row 6's machinery (dense_grid.cuh).
//
// Replaces the TPU kernels rls_tpu/kernels/pgm_dense_fused.py:_kernel
// (:47-129; launched by solve_pgm_dense_fused, :355, pallas_call :436) and
// _kernel_cplx (:132-262; launched by _solve_cplx, :458, pallas_call :518).
// The iteration, the prox and the projections are pgm_dense_fused.cu's,
// op for op, and so those of the plain PyTorch versions
// pgm_dense_fused_torch and pgm_dense_fused_cplx_torch
// (rls_tpu_torch/kernels/pgm_dense_fused.py).
//
// CTA (s, g) takes slab s of `rows` rows of A for group g of `group_size`
// problems. With `resident` it copies the slab (both planes of it on
// complex data) into shared memory once and keeps it for the whole solve;
// without, it reads the slab from L2 for every tile. It keeps its group's
// Gram input gin (f32, tiles x n8 x 8 per plane: x for OptISTA and POGM,
// the momentum point for FISTA) and, for FISTA, x (tiles x n x 8 per
// plane) in shared memory. The slab's CTA s also owns the column chunk
// [s chunk, (s + 1) chunk): it keeps x0hat and the planes read only at
// their own column (y | x_prev's place m1, z | x_mid m2) for those
// columns, both planes of each on complex data. Per iteration:
//   (a) per tile of 8 problems, q = A_slab gin on the tensor cores, then
//       the slab's partial v = A_slab^H q in double, to `part` (L2). On
//       complex data each load of a fragment of Ar or Ai serves two
//       products, against the tile's re and im columns: q's four real
//       products are each rounded to f32 and combined in f32 (qr = Ar xr -
//       Ai xi, qi = Ai xr + Ar xi), and the partial v is kept as its four
//       real products Ar^T qr, Ai^T qi, Ar^T qi, Ai^T qr, each in double
//       (four planes of `part`);
//   B1
//   (b) the owner: v = the slabs' partials summed in slab order, rounded
//       to f32 once (complex: each of the four, then vr = Ar^T qr + Ai^T
//       qi and vi = Ar^T qi - Ai^T qr in f32, as mv_cols<true>; never
//       added in double before rounding, which would be another function
//       than the plain version's); the entry update and the prox of its
//       columns (on complex data the group prox over (re, im)), op for op
//       as the per-problem kernel; the new x of its columns to `xpub`
//       (and to `out` in the last iteration), and for FISTA with a restart
//       its per-problem partial of the restart dot (both planes) to
//       `rdots`;
//   B2
//   (c) every CTA: the first loads of its group's new x from `xpub`; for
//       FISTA the restart partials summed in slab order (the same sums in
//       the same order in every CTA, so every CTA takes the same f32
//       decision) and theta, while those loads are in flight; then the
//       group's new x and the next gin.
// The set-up runs the same two barriers on x0hat = A^H b: the slabs'
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
// The kernel is compiled per (real | complex, resident, method, prox
// kind): 12 instantiations in each of the two sources; the restart and the projection are run-time
// arguments, one uniform branch per entry.
//
// The kernel and its launch live in this header; pgm_dense_grid.cu
// instantiates it on real data and pgm_dense_grid_cplx.cu on complex data,
// so that the two compile in parallel.
//
// What bounds it on an H100: an iteration is 4 m n f32 operations per
// problem for the matvec pair (16 m n on complex data) plus ~20 n for the
// prox and the updates, so the solve is operations-bound at the card's
// peak. Per iteration each CTA multiplies its slab by `tiles` tiles on the
// FP64 tensor cores (four products per tile on complex data), and two
// group barriers (an atomic and a poll of L2 each) and two L2 round trips
// (the partial v to its owner, four times the bytes on complex data; the
// new x back to every CTA) take a fixed few microseconds.
#pragma once

#include <cuda_runtime.h>

#include "dense_common.cuh"
#include "dense_grid.cuh"
#include "pgm_dense_common.cuh"

namespace {

namespace grid = rls::grid;
using rls::pgm::kL1;
using rls::pgm::kL2;
using rls::pgm::kProjReal;
using rls::pgm::prox;
using rls::pgm::valid;

// the phases that Prof times (CTA 0's thread 0)
enum { kSetup, kQ, kPartialV, kBarrier1, kUpdate, kBarrier2, kReload, kGridPhases };

struct GridArgs {
    const float* b;     // (P, m): b, or its re plane
    const float* bi;    // (P, m): b's im plane on complex data, else null
    const float* A;     // (m, n): A, or its re plane
    const float* ai;    // (m, n): A's im plane on complex data, else null
    const float* scal;  // (P, 3): lam_eff, rho, theta0
    const float* tab;   // (steps, 4): the momentum table (OptISTA, POGM)
    float* out;         // (P, n): x; on complex data (2, P, n), re then im
    int* counts;        // (P,): the restarts
    double* part;       // (groups, slabs, tiles[, 4], n, 8): the slabs' partial v
    double* rdots;      // (groups, slabs, group_size): restart partials (FISTA)
    float* xpub;        // (groups[, 2], tiles, n, 8): the owners' new x
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
// 8) and the owner's x0hat, m1, m2 (f32, tiles x chunk x 8); on complex
// data (`cplx`) two planes of q, A's slab, gin, x and the owner's planes,
// and four products' split sums; each piece 16-byte aligned.
__host__ __device__ size_t grid_smem_bytes(int n, int slabs, int rows, int group_size,
                                           bool resident, bool cplx) {
    using grid::align16;
    using grid::kTile;
    const size_t C = cplx ? 2 : 1;  // planes
    const size_t chunk = (n + slabs - 1) / slabs, tiles = (group_size + kTile - 1) / kTile;
    const size_t rows16 = grid::round_up(rows, 16);
    size_t b = align16(C * sizeof(double) * kTile * rows16) + align16(5 * 4 * group_size) +
               align16(sizeof(double) * grid::kWarps * kTile) +
               align16(sizeof(long long) * kGridPhases) +
               align16(C * C * sizeof(double) * grid::kWarps * 128) +
               align16(C * sizeof(float) * kTile * tiles * grid::round_up(n, 8)) +
               align16(C * sizeof(float) * kTile * tiles * n) +
               align16(3 * C * sizeof(float) * kTile * tiles * chunk);
    if (resident) b += align16(C * sizeof(float) * rows16 * grid::slab_ld(n));
    return b;
}

template <bool kCplx, bool kRes, int kMethod, int kKind>
__global__ void __launch_bounds__(grid::kThreads, 1) pgm_dense_grid_kernel(GridArgs a) {
    using grid::kTile;
    constexpr int C = kCplx ? 2 : 1;    // planes: re (, im)
    constexpr int kPV = kCplx ? 4 : 1;  // partials of v per entry
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = a.slabs, n = a.n, tid = threadIdx.x, gs = a.group_size;
    const int s = blockIdx.x % S, g = blockIdx.x / S;
    const int row0 = s * a.rows, R = min(a.rows, a.m - row0), R16 = grid::round_up(a.rows, 16);
    const int p0 = g * gs, G = min(gs, a.P - p0);
    const int tiles = (G + kTile - 1) / kTile, tmax = (gs + kTile - 1) / kTile;
    const int chunk = (n + S - 1) / S, n8 = grid::round_up(n, 8), ld = grid::slab_ld(n);
    const int c0 = min(n, s * chunk), c1 = min(n, c0 + chunk);
    // the planes' strides: gin, x (and xpub), the owner's x0hat, m1, m2
    const int gplane = kTile * tmax * n8, xplane = kTile * tmax * n, oplane = kTile * tmax * chunk;
    const bool one = S == 1;  // the group is this CTA: its own writes, no L2 round trip
    const bool restart = kMethod == rls::kFista && a.restart != rls::kRestartNone;

    // shared memory, in grid_smem_bytes' order
    unsigned char* sp = smem;
    auto take = [&sp](size_t nbytes) {
        unsigned char* q = sp;
        sp += grid::align16(nbytes);
        return q;
    };
    double* sq = reinterpret_cast<double*>(take(C * sizeof(double) * kTile * R16));
    float* s_lam = reinterpret_cast<float*>(take(5 * 4 * gs));
    float* s_rho = s_lam + gs;
    float* s_th = s_rho + gs;
    float* s_mom = s_th + gs;  // FISTA's (th_old - 1) / th
    int* s_fires = reinterpret_cast<int*>(s_mom + gs);
    double* red = reinterpret_cast<double*>(take(sizeof(double) * grid::kWarps * kTile));
    long long* s_prof = reinterpret_cast<long long*>(take(sizeof(long long) * kGridPhases));
    double* scratch = reinterpret_cast<double*>(take(C * C * sizeof(double) * grid::kWarps * 128));
    float* sa = kRes ? reinterpret_cast<float*>(take(C * sizeof(float) * R16 * ld)) : nullptr;
    float* gin = reinterpret_cast<float*>(take(C * sizeof(float) * gplane));
    float* sx = reinterpret_cast<float*>(take(C * sizeof(float) * xplane));
    float* x0 = reinterpret_cast<float*>(take(3 * C * sizeof(float) * oplane));
    float* m1 = x0 + C * oplane;
    float* m2 = m1 + C * oplane;

    const size_t slab_part = static_cast<size_t>(tmax) * n * kTile * kPV;
    double* part_g = a.part + static_cast<size_t>(g) * S * slab_part;
    double* part = part_g + static_cast<size_t>(s) * slab_part;
    double* rd_g = a.rdots + static_cast<size_t>(g) * S * gs;
    float* xp = a.xpub + static_cast<size_t>(g) * C * xplane;
    const float* as = kRes ? sa : a.A + static_cast<size_t>(row0) * n;
    const float* asi = !kCplx ? nullptr
                       : kRes ? sa + R16 * ld
                              : a.ai + static_cast<size_t>(row0) * n;
    unsigned* ctr = a.bar + 32 * g;
    unsigned target = 0;
    // the owner's elements: problem ko of a tile, columns jo, then every
    // kStride; its planes x0hat, m1, m2 as [plane][tile][j - c0][ko]
    const int ko = tid % kTile, jo = c0 + tid / kTile;
    constexpr int kStride = grid::kThreads / kTile;
    auto oi = [&](int c, int kt, int j) { return c * oplane + (kt * chunk + j - c0) * kTile + ko; };
    rls::Prof<kGridPhases> prof{blockIdx.x == 0 && tid == 0 ? a.prof : nullptr, s_prof, 0};
    prof.start();

    // (a): the slab's partial v of every tile, q from `fill_q`; then B1
    auto partial_v = [&](auto fill_q) {
        for (int kt = 0; kt < tiles; ++kt) {
            fill_q(kt);
            __syncthreads();
            prof.mark(kQ);
            double* pt = part + static_cast<size_t>(kt) * n * kTile * kPV;
            if constexpr (kCplx)
                grid::v_tile_cplx<kRes>(as, asi, ld, sq, sq + kTile * R16, pt, scratch, R, n);
            else
                grid::v_tile<kRes>(as, ld, sq, pt, scratch, R, n);
            __syncthreads();
            prof.mark(kPartialV);
        }
        grid::group_sync(ctr, target, S);  // B1
        prof.mark(kBarrier1);
    };
    // v of problem ko of tile kt at column j: the slabs' partials in
    // order, each rounded to f32 once; on complex data the four real
    // products each (planes of `part`, summed in one pass), then combined
    // in f32 into v[0] = vr, v[1] = vi
    auto slab_sum = [&](int kt, int j, float* v) {
        const double* at = part_g + (static_cast<size_t>(kt) * kPV * n + j) * kTile + ko;
        if constexpr (kCplx) {
            const size_t plane = static_cast<size_t>(n) * kTile;
            const grid::Quad sum = grid::ordered_sum<grid::Quad, 8>(S, [&](int t) {
                const double* p = at + t * slab_part;
                return grid::Quad{{grid::ld_group(p, one), grid::ld_group(p + plane, one),
                                   grid::ld_group(p + 2 * plane, one),
                                   grid::ld_group(p + 3 * plane, one)}};
            });
            v[0] = rls::fadd(static_cast<float>(sum.v[0]), static_cast<float>(sum.v[1]));
            v[1] = rls::fsub(static_cast<float>(sum.v[2]), static_cast<float>(sum.v[3]));
        } else {
            v[0] = static_cast<float>(grid::ordered_sum<double>(
                S, [&](int t) { return grid::ld_group(at + t * slab_part, one); }));
        }
    };
    // the group's new x in `xpub`, plane by plane: one round of 8 float4
    // loads of a thread, from float4 i0 on
    const int total = tiles * n * kTile / 4;  // float4s of a plane
    auto fetch = [&](int i0, float4* v) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int i = i0 + u * grid::kThreads;
            const int c = kCplx ? i / total : 0;
            if (i < C * total)
                v[u] = grid::ld_group(
                    reinterpret_cast<const float4*>(xp + c * xplane) + (i - c * total), one);
        }
    };
    // (c): gin (and FISTA's x) from the group's new x, 8 float4 loads of a
    // thread in flight, `v` the first round's (fetched by the caller);
    // entries of no problem read as 0
    auto reload = [&](bool first, float4* v) {
        for (int i0 = tid; i0 < C * total; i0 += 8 * grid::kThreads) {
            if (i0 != tid) fetch(i0, v);
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                const int i = i0 + u * grid::kThreads;
                if (i >= C * total) break;
                const int c = kCplx ? i / total : 0;
                const int e = 4 * (i - c * total), kt = e / (n * kTile), j = e / kTile - kt * n;
                const int k0 = e % kTile;
                const float xn[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
                float xo[4] = {xn[0], xn[1], xn[2], xn[3]};
                if constexpr (kMethod == rls::kFista) {
                    // x_prev, then x (entries of no problem hold what xpub
                    // held there, and nothing reads them)
                    float4* sxe = reinterpret_cast<float4*>(sx + c * xplane + e);
                    if (!first) {
                        const float4 o = *sxe;
                        xo[0] = o.x, xo[1] = o.y, xo[2] = o.z, xo[3] = o.w;
                    }
                    *sxe = v[u];
                }
                float gv[4];
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
                    const int l = kt * kTile + k0 + cc;
                    gv[cc] = 0.f;
                    if (l >= G) continue;
                    gv[cc] = xn[cc];
                    if constexpr (kMethod == rls::kFista)
                        gv[cc] = rls::fadd(xn[cc], rls::fmul(s_mom[l], rls::fsub(xn[cc], xo[cc])));
                }
                *reinterpret_cast<float4*>(gin + c * gplane + (kt * n8 + j) * kTile + k0) =
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
        // A's slab (each plane) with zero rows and columns up to R16 x ld
        for (int c = 0; c < C; ++c) {
            const float* src = (c == 0 ? a.A : a.ai) + static_cast<size_t>(row0) * n;
            float* dst = sa + c * R16 * ld;
            for (int i = tid; i < R16 * ld; i += grid::kThreads) {
                const int r = i / ld, j = i - r * ld;
                dst[i] = r < R && j < n ? __ldg(src + r * n + j) : 0.f;
            }
        }
    }
    for (int i = tid; i < C * gplane; i += grid::kThreads) gin[i] = 0.f;
    // x0hat = A^H b: the slabs' partial sums with q = b's rows (each plane)
    partial_v([&](int kt) {
        const int l0 = kt * kTile, gk = min(kTile, G - l0);
        for (int i = tid; i < C * R16 * kTile; i += grid::kThreads) {
            const int c = kCplx ? i / (R16 * kTile) : 0, ic = i - c * R16 * kTile;
            const int r = ic / kTile, k = ic % kTile;
            const float* bc = c == 0 ? a.b : a.bi;
            sq[i] = r < R && k < gk ? static_cast<double>(__ldg(
                                          bc + static_cast<size_t>(p0 + l0 + k) * a.m + row0 + r))
                                    : 0.0;
        }
    });
    // the owner: x0hat, and x = m1 = m2 = x0hat * 0 (also the result of no
    // iteration), published
    for (int kt = 0; kt < tiles; ++kt)
        if (ko < min(kTile, G - kt * kTile))
            for (int j = jo; j < c1; j += kStride) {
                float x0v[2];
                slab_sum(kt, j, x0v);
                for (int c = 0; c < C; ++c) {
                    const float zero = rls::fmul(x0v[c], 0.f);
                    const int o = oi(c, kt, j);
                    x0[o] = x0v[c];
                    m1[o] = zero;
                    m2[o] = zero;
                    xp[c * xplane + (kt * n + j) * kTile + ko] = zero;
                    a.out[(static_cast<size_t>(c) * a.P + p0 + kt * kTile + ko) * n + j] = zero;
                }
            }
    grid::group_sync(ctr, target, S);  // B2
    float4 xv[8];
    fetch(tid, xv);
    reload(true, xv);
    prof.mark(kSetup);

    for (int it = 0; it < a.steps; ++it) {
        // (a) q = A_slab gin and the slab's partial v, tile by tile; B1
        partial_v([&](int kt) {
            const float* gt = gin + static_cast<size_t>(kt) * n8 * kTile;
            if constexpr (kCplx)
                grid::q_tile_cplx<kRes>(as, asi, ld, gt, gt + gplane, sq, sq + kTile * R16,
                                        scratch, R, n);
            else
                grid::q_tile<kRes, true>(as, ld, gt, sq, scratch, R, n);
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
                    const int e = (kt * n + j) * kTile + ko;
                    float v[2], res[2] = {}, gv[2] = {}, xn[2] = {};
                    slab_sum(kt, j, v);
                    for (int c = 0; c < C; ++c) {
                        res[c] = rls::fsub(v[c], x0[oi(c, kt, j)]);
                        gv[c] = gin[c * gplane + (kt * n8 + j) * kTile + ko];  // xm (FISTA) | x
                    }
                    if constexpr (kMethod == rls::kFista) {
                        float xg[2] = {};
                        for (int c = 0; c < C; ++c)
                            xg[c] = rls::fsub(gv[c], rls::fmul(rho, res[c]));
                        prox<kCplx, kKind>(xg[0], xg[1], rls::fmul(rho, lam), a.proj, xn[0],
                                           xn[1]);
                        for (int c = 0; c < C; ++c) {
                            const float d = rls::fsub(xn[c], sx[c * xplane + e]);
                            if (a.restart == rls::kRestartGradient)
                                acc[0] += rls::dmul(res[c], d);
                            else if (a.restart == rls::kRestartGradientMapping)
                                acc[0] += rls::dmul(rls::fsub(gv[c], xn[c]), d);
                        }
                    } else {
                        const float am = row[0], bc = row[1], gm = row[2], ec = row[3];
                        const float cy = rls::fadd(rls::fadd(1.f, am), bc);
                        if constexpr (kMethod == rls::kOptista) {
                            const float step = rls::fmul(rho, gm);
                            float yg[2] = {}, yn[2] = {};
                            for (int c = 0; c < C; ++c)
                                yg[c] = rls::fsub(m1[oi(c, kt, j)], rls::fmul(step, res[c]));
                            prox<kCplx, kKind>(yg[0], yg[1], rls::fmul(step, lam), a.proj, yn[0],
                                               yn[1]);
                            for (int c = 0; c < C; ++c) {
                                const int o = oi(c, kt, j);
                                const float zn =
                                    rls::fadd(gv[c], rls::fmul(rls::fsub(yn[c], m1[o]), ec));
                                xn[c] = rls::fsub(
                                    rls::fsub(rls::fmul(cy, zn), rls::fmul(am, m2[o])),
                                    rls::fmul(bc, gv[c]));
                                m1[o] = yn[c];
                                m2[o] = zn;
                            }
                        } else {  // POGM
                            const float cx = rls::fadd(bc, ec);
                            float xmid[2] = {};
                            for (int c = 0; c < C; ++c) {
                                const int o = oi(c, kt, j);
                                const float yn = rls::fsub(gv[c], rls::fmul(rho, res[c]));
                                xmid[c] = rls::fadd(
                                    rls::fsub(rls::fsub(rls::fmul(cy, yn), rls::fmul(am, m1[o])),
                                              rls::fmul(cx, gv[c])),
                                    rls::fmul(ec, m2[o]));
                                m1[o] = yn;
                                m2[o] = xmid[c];
                            }
                            prox<kCplx, kKind>(xmid[0], xmid[1], rls::fmul(rls::fmul(rho, gm), lam),
                                               a.proj, xn[0], xn[1]);
                        }
                    }
                    for (int c = 0; c < C; ++c) {
                        xp[c * xplane + e] = xn[c];
                        if (last) a.out[(static_cast<size_t>(c) * a.P + p0 + l) * n + j] = xn[c];
                    }
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
        // (c) the first loads of the group's new x; theta, after the
        // restart test over all columns; then the group's new x
        if (!last) fetch(tid, xv);
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
        if (!last) reload(false, xv);
        prof.mark(kReload);
    }
    if (s == 0)
        for (int l = tid; l < G; l += grid::kThreads)
            a.counts[p0 + l] = kMethod == rls::kFista ? s_fires[l] : 0;
    prof.finish();
}

using GridKernel = void (*)(GridArgs);

template <bool kCplx, bool kRes, int kMethod>
GridKernel pick_kind(int kind) {
    return kind == kL1 ? &pgm_dense_grid_kernel<kCplx, kRes, kMethod, kL1>
                       : &pgm_dense_grid_kernel<kCplx, kRes, kMethod, kL2>;
}

template <bool kCplx, bool kRes>
GridKernel pick_method(int method, int kind) {
    if (method == rls::kFista) return pick_kind<kCplx, kRes, rls::kFista>(kind);
    if (method == rls::kOptista) return pick_kind<kCplx, kRes, rls::kOptista>(kind);
    return pick_kind<kCplx, kRes, rls::kPogm>(kind);
}

template <bool kCplx>
GridKernel pick(int method, int kind, bool resident) {
    return resident ? pick_method<kCplx, true>(method, kind)
                    : pick_method<kCplx, false>(method, kind);
}

// The launch of an entry point (pgm_dense_grid.cu on real data,
// pgm_dense_grid_cplx.cu on complex data): the checks, then the cooperative
// grid of slabs x groups.
template <bool kCplx>
int launch(const GridArgs& args, int method, int kind, int resident, int smem, void* stream) {
    if (!valid(method, kind, args.restart, args.proj) || (!kCplx && args.proj == kProjReal))
        return static_cast<int>(cudaErrorInvalidValue);
    if (args.P <= 0) return 0;
    const int m = args.m, n = args.n, P = args.P, slabs = args.slabs, rows = args.rows;
    const int groups = args.groups, group_size = args.group_size;
    const long long words = kCplx ? 8 : 1;  // the partials' and the planes' index range
    const bool covers = m > 0 && n > 0 && args.steps >= 0 && slabs > 0 && rows > 0 &&
                        groups > 0 && group_size > 0 &&
                        static_cast<long long>(slabs - 1) * rows < m &&
                        static_cast<long long>(slabs) * rows >= m &&
                        static_cast<long long>(groups - 1) * group_size < P &&
                        static_cast<long long>(groups) * group_size >= P &&
                        static_cast<long long>(m) * n < (1LL << 31) &&
                        static_cast<long long>(P + grid::kTile) * (n + 40) * words < (1LL << 31) &&
                        static_cast<long long>(slabs) * groups < (1LL << 31);
    if (!covers || static_cast<size_t>(smem) !=
                       grid_smem_bytes(n, slabs, rows, group_size, resident != 0, kCplx))
        return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = reinterpret_cast<const void*>(pick<kCplx>(method, kind, resident != 0));
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    GridArgs copy = args;
    void* kargs[] = {&copy};
    e = cudaLaunchCooperativeKernel(fn, dim3(slabs * groups), dim3(grid::kThreads), kargs,
                                    static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace
