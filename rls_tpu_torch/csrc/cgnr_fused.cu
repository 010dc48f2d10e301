// The whole batched CGNR solve on a dense matrix in one launch: a
// batch-wide CG step over every SM, each load of A shared by all problems
// of a group.
//
// Replaces the TPU kernel rls_tpu/kernels/cgnr_fused.py:_kernel (:86-130;
// launched by solve_cgnr_fused, :174, pallas_call :260). Per problem, from
// x = 0 and r = p = A^T b, `steps` times
//   q = A p, v = A^T q, zeta = r.r, denom = p.v + lam p.p
//   alpha = zeta > 0 ? zeta / (denom == 0 ? 1 : denom) : 0
//   x += alpha p, r = (r - alpha v) - (lam alpha) p
//   beta = r.r / (zeta > 0 ? zeta : 1), p = r + beta p
// then x = max(x, 0) with the Positive projection. The guards make a step
// past convergence (r = p = 0) the identity. The plain PyTorch version,
// which this code follows op for op, is cgnr_fused_torch in
// rls_tpu_torch/kernels/cgnr_fused.py.
//
// Design. Every problem multiplies by the same A, so a step of the whole
// batch is two thin products, Q = A P^T and V = A^T Q. The grid is
// slabs x groups CTAs: A's rows are cut into `slabs` slabs of `rows` rows,
// the batch into `groups` groups of `group_size` problems, and CTA (s, g)
// takes slab s for group g. With `resident` the CTA copies its slab into
// shared memory once and keeps it, with a full copy of its group's p, for
// the whole solve; without, it reads both from global memory each step
// (shapes whose p rows do not fit, e.g. 16 x 36000). Per step and tile of
// 8 problems, the warps compute q = A_slab p in 16-row blocks and the
// slab's partial v = A_slab^T q in 16-column blocks on the FP64 tensor
// cores (mma m16n8k8 in double): q stays in the CTA. The `slabs` CTAs of a
// group then sum their partial v in slab order, each for its share of the
// columns ("owner" below), and meet at a barrier three times per step (v,
// then p.v and p.p, then r.r; four without `resident`, to publish p). The
// C entry point takes the plan (planned in Python by plan_cgnr), checks
// it and launches cooperatively, so every CTA of the grid is resident and
// the barriers cannot deadlock. The grid's pieces (the group barrier, the
// tensor-core block products, the slab layout, the ordered sums) are in
// dense_grid.cuh, shared with pgm_dense_fused.cu's grid route.
//
// Numerics, as before: every q and v entry and every dot is a double sum
// of exact f32 products, rounded to f32 once; the order of a sum is fixed
// (the tensor cores' own, then the accumulators, the warps, the slabs and
// the lanes in a fixed tree), so the result does not change from run to
// run; no float atomics. Every CTA derives alpha and beta from the same
// f32 scalars with f32 ops that nvcc may not contract (rls::fmul & co),
// and the updates are separate f32 ops, so the kernel differs from its
// plain version only where two double sums in another order round to
// different floats.
//
// What bounds it on an H100: a step is 4 m n + 10 n f32 operations per
// problem, so by the f32 peak the solve is operations-bound; with the
// double sums it does 2 m n double FMAs per problem and step (up to 128
// per SM and clock on the FP64 tensor cores, against 64 on the FP64
// units), and the three barriers per step (an atomic and a poll of L2
// each) and the L2 round trips of the partial sums take a fixed few
// microseconds.
#include <cuda_runtime.h>

#include "dense_grid.cuh"

namespace {

using namespace rls::grid;
// the phases that `Prof` times: set-up, q, partial v, barrier 1, slab sums
// and dots, barrier 2, x and r, barrier 3, p, x out
constexpr int kPhases = 10;

struct Args {
    const float* b;    // (P, m)
    const float* A;    // (m, n)
    const float* lam;  // (P,)
    float* out;        // (P, n): x
    double* part;      // (groups, slabs, tiles, n, kTile): partial v, with slabs > 1
    double* dots;      // (groups, slabs, group_size, 2): p.v and p.p partials, with slabs > 1
    float* r;          // (P, n)
    float* v;          // (P, n), without `resident`
    double* p;         // (groups, tiles, n8, kTile) zeros, without `resident`
    unsigned* bar;     // (groups, 32): barrier counters, zero at launch
    long long* prof;   // (kPhases,): CTA 0's clocks per phase; or null
    int P, m, n, steps, positive;
    int slabs, rows, groups, group_size;
};

// Shared memory of a CTA; the Python planner (kernels/cgnr_fused.py
// smem_bytes) counts the same. Always: q of a tile (float64, rows rounded
// up to 16), five f32 scalars per problem, the block reductions, the phase
// timer, the warps' split sums. With `resident`: the slab of A (f32, zero
// rows and columns up to 16 rows and slab_ld), the group's p (float64,
// tiles x n rounded up to 8 x 8), the owner's x, r and
// v (f32, tiles x chunk x 8) and, with several slabs, the group's whole r
// (f32, tiles x n x 8). With one slab: the partial v of every tile
// (float64).
__host__ __device__ size_t smem_bytes(int n, int slabs, int rows, int group_size,
                                      bool resident) {
    const size_t chunk = (n + slabs - 1) / slabs, tiles = (group_size + kTile - 1) / kTile;
    size_t b = sizeof(double) * kTile * round_up(rows, 16) +
               align16(5 * sizeof(float) * group_size) + sizeof(double) * 2 * kWarps * kTile +
               sizeof(long long) * kPhases + sizeof(double) * kWarps * 128;
    if (resident)
        b += align16(sizeof(float) * round_up(rows, 16) * slab_ld(n)) +
             sizeof(double) * kTile * tiles * round_up(n, 8) +
             align16(3 * sizeof(float) * kTile * tiles * chunk) +
             (slabs > 1 ? align16(sizeof(float) * kTile * tiles * n) : 0);
    if (slabs == 1) b += sizeof(double) * kTile * tiles * n;
    return b;
}

using Prof = rls::Prof<kPhases>;

// kOne: the group is this CTA (slabs == 1): no barrier, no L2 round trip,
// and the step's sums and updates in fewer phases.
template <bool kRes, bool kOne>
__global__ void __launch_bounds__(kThreads, 1) cgnr_fused_kernel(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = kOne ? 1 : a.slabs, n = a.n, tid = threadIdx.x;
    const int s = blockIdx.x % S, g = blockIdx.x / S;
    const int row0 = s * a.rows, R = min(a.rows, a.m - row0), R16 = round_up(a.rows, 16);
    const int p0 = g * a.group_size, G = min(a.group_size, a.P - p0);
    const int tiles = (G + kTile - 1) / kTile, tmax = (a.group_size + kTile - 1) / kTile;
    const int chunk = (n + S - 1) / S, n8 = round_up(n, 8), ld = slab_ld(n);
    const int c0 = min(n, s * chunk), c1 = min(n, c0 + chunk);

    // shared memory, in smem_bytes' order
    unsigned char* sp = smem;
    auto take = [&sp](size_t nbytes) {
        unsigned char* q = sp;
        sp += align16(nbytes);
        return q;
    };
    double* sq = reinterpret_cast<double*>(take(sizeof(double) * kTile * R16));
    float* s_lam = reinterpret_cast<float*>(take(5 * sizeof(float) * a.group_size));
    float* s_zeta = s_lam + a.group_size;
    float* s_alpha = s_zeta + a.group_size;
    float* s_la = s_alpha + a.group_size;
    float* s_beta = s_la + a.group_size;
    double* red = reinterpret_cast<double*>(take(sizeof(double) * 2 * kWarps * kTile));
    long long* s_prof = reinterpret_cast<long long*>(take(sizeof(long long) * kPhases));
    double* scratch = reinterpret_cast<double*>(take(sizeof(double) * kWarps * 128));
    float* sa = nullptr;
    double* sP = nullptr;
    float* s_own = nullptr;
    float* s_rf = nullptr;
    if (kRes) {
        sa = reinterpret_cast<float*>(take(sizeof(float) * R16 * ld));
        sP = reinterpret_cast<double*>(take(sizeof(double) * kTile * tmax * n8));
        s_own = reinterpret_cast<float*>(take(3 * sizeof(float) * kTile * tmax * chunk));
        if (!kOne) s_rf = reinterpret_cast<float*>(take(sizeof(float) * kTile * tmax * n));
    }
    double* part_g = kOne ? reinterpret_cast<double*>(take(sizeof(double) * kTile * tmax * n))
                          : a.part + static_cast<size_t>(g) * S * tmax * n * kTile;
    double* dots_g = kOne ? nullptr : a.dots + static_cast<size_t>(g) * S * a.group_size * 2;
    double* part = part_g + static_cast<size_t>(s) * tmax * n * kTile;
    double* dots = dots_g + static_cast<size_t>(s) * a.group_size * 2;

    const float* as = kRes ? sa : a.A + static_cast<size_t>(row0) * n;
    // p of problem l at column j: [l / 8][j][l % 8], tiles of n8 x 8
    double* ps = kRes ? sP : a.p + static_cast<size_t>(g) * tmax * n8 * kTile;
    auto pi = [n8](int l, int j) { return ((l / kTile) * n8 + j) * kTile + l % kTile; };
    // the owner's x, r, v at (l, j): with `resident` in shared memory as
    // [l / 8][j - c0][l % 8], else in global memory as out, r, v [l][j]
    float* xo = kRes ? s_own : a.out + static_cast<size_t>(p0) * n;
    float* ro = kRes ? s_own + kTile * tmax * chunk : a.r + static_cast<size_t>(p0) * n;
    float* vo = kRes ? s_own + 2 * kTile * tmax * chunk : a.v + static_cast<size_t>(p0) * n;
    auto oi = [&](int l, int j) {
        return kRes ? ((l / kTile) * chunk + j - c0) * kTile + l % kTile : l * n + j;
    };
    // the group's whole r at (l, j): with `resident` as [l / 8][j][l % 8]
    // (the owner's own with one slab, staged from L2 with several), else
    // in global memory as r [l][j]
    const float* rf = kRes ? (kOne ? ro : s_rf) : a.r + static_cast<size_t>(p0) * n;
    auto fi = [&](int l, int j) {
        return kRes ? ((l / kTile) * n + j) * kTile + l % kTile : l * n + j;
    };
    unsigned* ctr = a.bar + 32 * g;
    unsigned target = 0;
    // the owner's elements: problem k = tid % kTile of a tile, columns
    // c0 + tid / kTile, then every kThreads / kTile
    const int ko = tid % kTile, jo = c0 + tid / kTile;
    constexpr int kStride = kThreads / kTile;
    Prof prof{blockIdx.x == 0 && tid == 0 ? a.prof : nullptr, s_prof, 0};
    prof.start();

    // the slab's partial v of every tile, q from `fill_q`; then the group's
    // barrier
    auto partial_v = [&](auto fill_q) {
        for (int kt = 0; kt < tiles; ++kt) {
            fill_q(kt);
            __syncthreads();
            prof.mark(1);
            v_tile<kRes>(as, ld, sq, part + static_cast<size_t>(kt) * n * kTile, scratch, R, n);
            __syncthreads();
            prof.mark(2);
        }
        group_sync(ctr, target, S);
        prof.mark(3);
    };
    auto slab_sum = [&](int kt, int j) {
        const double* at = part_g + (static_cast<size_t>(kt) * n + j) * kTile + ko;
        const size_t stride = static_cast<size_t>(tmax) * n * kTile;
        return static_cast<float>(
            ordered_sum<double>(S, [&](int t) { return ld_group(at + t * stride, kOne); }));
    };
    // alpha and (lam alpha) of problem l from its p.v and p.p sums
    auto alpha_of = [&](int l, double pv, double pp) {
        const float lm = s_lam[l];
        const float zeta = s_zeta[l];
        const float denom =
            rls::fadd(static_cast<float>(pv), rls::fmul(lm, static_cast<float>(pp)));
        const float alpha = zeta > 0.f ? rls::fdiv(zeta, denom == 0.f ? 1.f : denom) : 0.f;
        s_alpha[l] = alpha;
        s_la[l] = rls::fmul(lm, alpha);
    };
    // beta of problem l from its new r.r sum, which becomes its zeta
    auto beta_of = [&](int l, double rr, bool first) {
        const float rrf = static_cast<float>(rr);
        const float zeta = s_zeta[l];
        s_beta[l] = first ? 0.f : rls::fdiv(rrf, zeta > 0.f ? zeta : 1.f);
        s_zeta[l] = rrf;
    };
    // beta from r.r over the group's whole r (every CTA the same sums,
    // staging r from L2 into shared memory with `resident` and several
    // slabs)
    auto rr_beta = [&](bool first) {
        const bool stage = kRes && !kOne;
        const float* rg = a.r + static_cast<size_t>(p0) * n;
        for (int kt = 0; kt < tiles; ++kt) {
            const int l0 = kt * kTile, gk = min(kTile, G - l0);
            double rr[1] = {0.0};
            if (ko < gk) {
                // 16 loads in flight, then their squares in column order
                const int l = l0 + ko;
                for (int j0 = tid / kTile; j0 < n; j0 += 16 * kStride) {
                    float rv[16];
#pragma unroll
                    for (int u = 0; u < 16; ++u) {
                        const int j = j0 + u * kStride;
                        rv[u] = j >= n  ? 0.f
                                : stage ? __ldcg(rg + l * n + j)
                                        : ld_group(rf + fi(l, j), kRes);
                    }
#pragma unroll
                    for (int u = 0; u < 16; ++u)
                        if (j0 + u * kStride < n) {
                            if (stage) s_rf[fi(l, j0 + u * kStride)] = rv[u];
                            rr[0] += rls::dmul(rv[u], rv[u]);
                        }
                }
            }
            tile_sum<1>(rr, red);
            if (tid < gk) beta_of(l0 + tid, rr[0], first);
        }
        __syncthreads();
    };
    // p = r + beta p (p = r with `first`): every CTA the whole p with
    // `resident`, else the owner its columns, published to the group
    auto new_p = [&](bool first) {
        if (kRes) {
            for (int kt = 0; kt < tiles; ++kt)
                for (int e = tid; e < n * kTile; e += kThreads) {
                    const int j = e / kTile, l = kt * kTile + e % kTile;
                    if (l < G) {
                        const float r = rf[(kt * n + j) * kTile + e % kTile];
                        double& pj = sP[(kt * n8 + j) * kTile + e % kTile];
                        pj = static_cast<double>(
                            first ? r : rls::fadd(r, rls::fmul(s_beta[l], static_cast<float>(pj))));
                    }
                }
            __syncthreads();
        } else {
            for (int kt = 0; kt < tiles; ++kt)
                if (ko < min(kTile, G - kt * kTile))
                    for (int j = jo; j < c1; j += kStride) {
                        const int l = kt * kTile + ko;
                        const float r = ro[oi(l, j)];
                        double& pj = ps[pi(l, j)];
                        pj = static_cast<double>(
                            first ? r : rls::fadd(r, rls::fmul(s_beta[l], static_cast<float>(pj))));
                    }
            group_sync(ctr, target, S);
        }
    };

    for (int l = tid; l < G; l += kThreads) s_lam[l] = __ldg(a.lam + p0 + l);
    if (kRes) {
        // A's slab with zero rows and columns up to R16 x ld; p zero where
        // no problem or column is
        const float* src = a.A + static_cast<size_t>(row0) * n;
        for (int i = tid; i < R16 * ld; i += kThreads) {
            const int r = i / ld, j = i - r * ld;
            sa[i] = r < R && j < n ? __ldg(src + r * n + j) : 0.f;
        }
        for (int i = tid; i < kTile * tmax * n8; i += kThreads) sP[i] = 0.0;
    }
    // r = A^T b: the slabs' partial sums with q = b's rows; x = r * 0
    partial_v([&](int kt) {
        const int l0 = kt * kTile, gk = min(kTile, G - l0);
        for (int i = tid; i < R16 * kTile; i += kThreads) {
            const int r = i / kTile, k = i % kTile;
            sq[i] = r < R && k < gk ? static_cast<double>(__ldg(
                                          a.b + static_cast<size_t>(p0 + l0 + k) * a.m + row0 + r))
                                    : 0.0;
        }
    });
    for (int kt = 0; kt < tiles; ++kt)
        if (ko < min(kTile, G - kt * kTile))
            for (int j = jo; j < c1; j += kStride) {
                const int l = kt * kTile + ko;
                const float rj = slab_sum(kt, j);
                ro[oi(l, j)] = rj;
                xo[oi(l, j)] = rls::fmul(rj, 0.f);
                if (kRes && !kOne) a.r[static_cast<size_t>(p0 + l) * n + j] = rj;
            }
    group_sync(ctr, target, S);
    rr_beta(true);
    new_p(true);
    prof.mark(0);

    for (int it = 0; it < a.steps; ++it) {
        // q = A_slab p and the slab's partial v, tile by tile
        partial_v([&](int kt) {
            q_tile<kRes>(as, ld, ps + static_cast<size_t>(kt) * n8 * kTile, sq, scratch, R, n);
        });
        if constexpr (kOne) {
            // one slab: v is the CTA's own sum; p.v and p.p give alpha, and
            // the update's r.r gives beta, without a round trip
            for (int kt = 0; kt < tiles; ++kt) {
                const int l0 = kt * kTile, gk = min(kTile, G - l0);
                double d[2] = {0.0, 0.0};
                if (ko < gk)
                    for (int j = jo; j < c1; j += kStride) {
                        const size_t e = (static_cast<size_t>(kt) * n + j) * kTile + ko;
                        const float vj = static_cast<float>(part[e]);
                        vo[oi(l0 + ko, j)] = vj;
                        const double pj = p_at<kRes>(ps, pi(l0 + ko, j));
                        d[0] += pj * static_cast<double>(vj);
                        d[1] += pj * pj;
                    }
                tile_sum<2>(d, red);
                if (tid < gk) alpha_of(l0 + tid, d[0], d[1]);
            }
            __syncthreads();
            prof.mark(4);
            for (int kt = 0; kt < tiles; ++kt) {
                const int l0 = kt * kTile, gk = min(kTile, G - l0);
                double rr[1] = {0.0};
                if (ko < gk) {
                    const int l = l0 + ko;
                    const float alpha = s_alpha[l], la = s_la[l];
                    for (int j = jo; j < c1; j += kStride) {
                        const int o = oi(l, j);
                        const float pj = static_cast<float>(p_at<kRes>(ps, pi(l, j)));
                        xo[o] = rls::fadd(xo[o], rls::fmul(alpha, pj));
                        const float rn = rls::fsub(rls::fsub(ro[o], rls::fmul(alpha, vo[o])),
                                                   rls::fmul(la, pj));
                        ro[o] = rn;
                        rr[0] += rls::dmul(rn, rn);
                    }
                }
                tile_sum<1>(rr, red);
                if (tid < gk) beta_of(l0 + tid, rr[0], false);
            }
            prof.mark(6);
            if (it + 1 == a.steps) break;
            __syncthreads();
            new_p(false);
            prof.mark(8);
            continue;
        }
        // the owner: v = the slabs' partials in order, and p.v, p.p
        for (int kt = 0; kt < tiles; ++kt) {
            const int l0 = kt * kTile, gk = min(kTile, G - l0);
            double d[2] = {0.0, 0.0};
            if (ko < gk)
                for (int j = jo; j < c1; j += kStride) {
                    const float vj = slab_sum(kt, j);
                    vo[oi(l0 + ko, j)] = vj;
                    const double pj = p_at<kRes>(ps, pi(l0 + ko, j));
                    d[0] += pj * static_cast<double>(vj);
                    d[1] += pj * pj;
                }
            tile_sum<2>(d, red);
            if (tid < gk)
                *reinterpret_cast<double2*>(dots + (l0 + tid) * 2) = make_double2(d[0], d[1]);
        }
        prof.mark(4);
        group_sync(ctr, target, S);
        prof.mark(5);
        // alpha (every CTA the same), then the owner's x and r
        for (int l = tid; l < G; l += kThreads) {
            const double2* at = reinterpret_cast<const double2*>(dots_g) + l;
            const double2 d = ordered_sum<double2>(
                S, [&](int t) { return ld_group(at + t * a.group_size, kOne); });
            alpha_of(l, d.x, d.y);
        }
        __syncthreads();
        for (int kt = 0; kt < tiles; ++kt)
            if (ko < min(kTile, G - kt * kTile)) {
                const int l = kt * kTile + ko;
                const float alpha = s_alpha[l], la = s_la[l];
                for (int j = jo; j < c1; j += kStride) {
                    const int o = oi(l, j);
                    const float pj = static_cast<float>(p_at<kRes>(ps, pi(l, j)));
                    xo[o] = rls::fadd(xo[o], rls::fmul(alpha, pj));
                    const float rn =
                        rls::fsub(rls::fsub(ro[o], rls::fmul(alpha, vo[o])), rls::fmul(la, pj));
                    ro[o] = rn;
                    if (kRes) a.r[static_cast<size_t>(p0 + l) * n + j] = rn;
                }
            }
        prof.mark(6);
        if (it + 1 == a.steps) break;
        group_sync(ctr, target, S);
        prof.mark(7);
        rr_beta(false);
        new_p(false);
        prof.mark(8);
    }
    __syncthreads();
    for (int kt = 0; kt < tiles; ++kt)
        if (ko < min(kTile, G - kt * kTile))
            for (int j = jo; j < c1; j += kStride) {
                const int l = kt * kTile + ko;
                const float x = xo[oi(l, j)];
                a.out[static_cast<size_t>(p0 + l) * n + j] = a.positive ? fmaxf(x, 0.f) : x;
            }
    __syncthreads();
    prof.mark(9);
    prof.finish();
}

}  // namespace

extern "C" {

// b: (P, m) f32, one problem per row; A: (m, n) f32 row-major; lam: (P,);
// out: (P, n). The plan: `slabs` slabs of `rows` rows, `groups` groups of
// `group_size` problems, A's slab and p in shared memory with `resident`,
// `smem` bytes of shared memory per CTA. Scratch: with slabs > 1, part
// (groups, slabs, ceil(group_size / 8), n, 8) and dots (groups, slabs,
// group_size, 2) float64; r (P, n) f32; without `resident`, v (P, n) f32
// and p (groups, ceil(group_size / 8), 8 ceil(n / 8), 8) float64 zeros;
// bar (groups, 32) uint32 zeros (a pointer that is not used may be null);
// prof: null, or kPhases int64 that receive CTA 0's clocks per phase.
// Returns cudaErrorInvalidValue for a plan that does not cover the shapes
// or whose smem differs from smem_bytes, cudaErrorCooperativeLaunchTooLarge
// for a grid that cannot be resident at once (the cooperative launch's own
// check), else the launch's error.
int cgnr_fused_launch(const void* b, const void* A, const void* lam, void* out, void* part,
                      void* dots, void* r, void* v, void* p, void* bar, void* prof, int P,
                      int m, int n, int steps, int positive, int slabs, int rows, int groups,
                      int group_size, int resident, int smem, void* stream) {
    if (P <= 0) return 0;
    const bool covers = m > 0 && n > 0 && steps >= 0 && slabs > 0 && rows > 0 && groups > 0 &&
                        group_size > 0 && static_cast<long long>(slabs - 1) * rows < m &&
                        static_cast<long long>(slabs) * rows >= m &&
                        static_cast<long long>(groups - 1) * group_size < P &&
                        static_cast<long long>(groups) * group_size >= P &&
                        static_cast<long long>(m) * n < (1LL << 31) &&
                        static_cast<long long>(P + kTile) * (n + 40) < (1LL << 31) &&
                        static_cast<long long>(slabs) * groups < (1LL << 31);
    if (!covers ||
        static_cast<size_t>(smem) != smem_bytes(n, slabs, rows, group_size, resident != 0))
        return static_cast<int>(cudaErrorInvalidValue);
    static const void* const kernels[4] = {
        reinterpret_cast<const void*>(&cgnr_fused_kernel<false, false>),
        reinterpret_cast<const void*>(&cgnr_fused_kernel<false, true>),
        reinterpret_cast<const void*>(&cgnr_fused_kernel<true, false>),
        reinterpret_cast<const void*>(&cgnr_fused_kernel<true, true>)};
    const int which = 2 * (resident != 0) + (slabs == 1);
    const void* fn = kernels[which];
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    // the cooperative launch refuses (cudaErrorCooperativeLaunchTooLarge)
    // a grid whose CTAs cannot all be resident at once
    const int grid = slabs * groups;
    Args args{static_cast<const float*>(b), static_cast<const float*>(A),
              static_cast<const float*>(lam), static_cast<float*>(out),
              static_cast<double*>(part), static_cast<double*>(dots), static_cast<float*>(r),
              static_cast<float*>(v), static_cast<double*>(p), static_cast<unsigned*>(bar),
              static_cast<long long*>(prof), P, m, n, steps, positive, slabs, rows, groups,
              group_size};
    void* kargs[] = {&args};
    e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), kargs,
                                    static_cast<size_t>(smem), static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
