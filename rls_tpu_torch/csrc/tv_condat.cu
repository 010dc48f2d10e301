// Exact 1-D total-variation denoising of many lines at once, by Condat's
// direct algorithm (Condat 2013, "A direct algorithm for 1D total variation
// denoising"): out = argmin_u 1/2 ||u - c||^2 + lam TV(u) for each line c.
//
// Replaces no Pallas kernel. The JAX package runs this prox as a vmapped
// lax.while_loop (rls_tpu/models/tv_condat.py:25, tv_denoise_1d_condat),
// whose every event rewrites the whole line with masked stores: O(N) work
// per event, a design for the TPU's vector unit. Here the same state
// machine takes the same events with the same operations; only which
// thread computes which event changes.
//
// What bounds it on an H100. The function moves each element twice (read
// once, written once) and does a handful of operations per element, so its
// bound is the memory's rate: 2 * 4 B a float element over 3.35 TB/s. A
// line's walk is a dependent chain of events (~1-2 an entry), each a few
// dozen instructions and branches: a lone walker on shared memory takes
// ~200-250 SM clocks an entry (measured; control flow, not memory). One
// thread per line (the first version of this kernel) took a line's whole
// chain: 0.34 ms at 4,096 lines of 256, 56 ms at 16 lines of 65,536,
// 130-22,000x the bound. The design cuts the chain into chunks; what is
// left is the distance from a chunk's start to the true walk's next
// restart, which no walker can stitch before: on rows with long flat
// stretches (an image's background) a CTA lasts as long as its longest
// stretch.
//
// Lines. The input is viewed as (outer, N, inner): line t = o * inner + i
// holds the elements (o, k, i), k = 0 .. N - 1, at stride `inner`. lam is
// read once per line, lam[t / group].
//
// Chunks and walkers. A line is cut into chunks of C entries, region j =
// [j C, e_j = (j + 1) C), and walker j (one thread) walks from the start of
// its chunk: walker 0 in the line's own initial state, walker j > 0 in the
// state the machine has right after a negative jump restarts it at j C.
// After a mid-line jump to kn the state is fixed by (kn, the jump's sign,
// lam), so two walks that restart at the same (kn, sign) take the same
// events from there on: a walker that meets a restart of the true walk is
// the true walk from there. Restart indices strictly increase along a walk.
//
// Tags. Each line has a byte per entry: 0, or the start of a segment: 1 / 2
// a restart after a negative / positive mid-line jump (the walks match on
// these), 3 any other start (a line's first, a restart at the line's end).
// A segment's value is written at its start when it closes; the output
// fills forward from the tagged starts (the plain version's cummax).
//
// Phases (the barrier table):
//   1 walk   walker j walks from its start, tagging its restarts in its own
//            region and writing their values; it stops at its first restart
//            at or past e_j (kept pending) or at the line's end (done).
//   -- barrier (the global route: the launch ends): every region's own
//      tags are complete and stay so --
//   2 stitch walker j walks on from its pending restart, reading tags and
//            writing none: a restart whose index another walker tagged with
//            the same sign stitches it there (X); any other restart goes into
//            its private log (index, tag, and its segment's value when it
//            closes). It stops stitched, done, or long where the log of
//            kLog entries is full (that restart kept pending). (Waiting on
//            the owner's progress instead of the barrier measured 7-15%
//            slower on an H100: a spinning lane stalls the walker it waits
//            for in its own warp.)
//   -- barrier --
//   3 chain  one thread a line follows the true walk from walker 0, marking
//            the walkers on it in a bitmask: a run of walkers each stitched
//            into the next chunk is taken whole, to the next walker whose
//            "irregular" bit phase 2 set (a bit scan); a stitched walker
//            hands on to the owner of its X (the global route stages these
//            next steps in shared memory, a CTA a line); a long one goes on
//            from its saved state, sequentially,
//            clearing the tags between its restarts and tagging its own,
//            until a restart matches a tag (whose owner it then follows) or
//            the line ends. A line that matches nowhere is walked to its end
//            here: the worst case is the sequential walk, never a wrong
//            value (a missed match costs time; a match is exact).
//   -- barrier --
//   3b apply each marked walker clears the tags of [e_j, its stop) and
//            writes its log there: the stops are the next marked walker's
//            entries, so the ranges are disjoint.
//   -- barrier --
//   4 fill   each walker finds the last start in its chunk; -- barrier --;
//            it takes the last start before its chunk as its carry and
//            fills its chunk forward.
//
// Routes. resident: a CTA of L lines x G walkers stages its lines in shared
// memory by cp.async (coalesced along whichever axis is contiguous; along a
// strided axis the tile is transposed on the way in), keeps the values,
// tags and logs there, runs the phases between __syncthreads, writes the
// filled lines back into the staged copy and stores the tile coalesced.
// global: lines that no CTA holds (65,536 float32 entries are 256 KiB) keep
// the values, tags, walkers and logs in global scratch and read c from the
// input; each phase is a launch of its own (walk, stitch, chain, apply, last
// start, fill). kernels/tv_condat.py plan_tv_condat picks the route, C and
// L.
//
// Arithmetic. The events are those of tv_condat.py:25-117 in the same
// order, with the same operations: sums and differences, one division per
// segment update, and 2 * lam (exact). No product is contracted into an FMA
// but 2 * lam + v, whose product is exact, and nvcc's default division is
// correctly rounded; so the kernel is bit for bit its plain PyTorch
// version (kernels/tv_condat.py, tv_condat_lines_torch).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;  // a resident CTA: L * G threads
constexpr int kGlobalThreads = 128;
constexpr int kChainWalkers = 8192;  // the global route's most walkers a line
constexpr int kLog = 16;  // a walker's log of restarts past its region
constexpr int kPhases = 5;  // staging, walking, stitching, assembly and store, total

// the events that end a walk's advance
constexpr int kNeg = 1, kPos = 2, kBoundary = 3, kDone = 4;
// tags
constexpr int kTagNeg = 1, kTagPos = 2, kTagStart = 3;
// a walker's state after phases 1 and 2
constexpr int kStDone = 0, kStLong = 1, kStPending = 2, kStStitched = 3;
// the run's counts (where asked): walkers stitched, their stitch distances
// (past their chunk's end: sum and largest), walkers long, walkers done,
// the segments the chain closed itself
constexpr int kStats = 6;

// A walk's state and bookkeeping; its saved form too (56 bytes in float,
// 72 in double: kernels/tv_condat.py WALKER_BYTES).
template <typename T>
struct Walker {
    T vmin, vmax, umin, umax;
    int k, k0, km, kp;
    int status, n;   // n: its log's entries
    int pk, ptag;    // a pending restart
    int stop;        // the end of its log's range: X, N, or past its last entry
    int lastp;       // its chunk's last start (phase 4)
};

// A walker's log: kLog (index, tag, value) of its restarts past its region.
template <typename T>
struct Log {
    int* pos;
    unsigned char* tag;
    T* val;
};

// Entry k's place in a resident row: a pad word after every 32 entries, so
// that walkers in step, a chunk of 32 (or 16, 64) apart, read distinct banks.
__host__ __device__ __forceinline__ int slot(int k) { return k + (k >> 5); }

// One line: c, its values and its tags. Resident (kGlobal false): rows in
// shared memory, entry k at slot(k); global: c at stride `stride` in the
// input, the values and tags at unit stride in scratch.
template <typename T, bool kGlobal>
struct LineView {
    const T* c;
    long long stride;
    T* val_;
    unsigned char* tag_;
    __device__ __forceinline__ int at_(int k) const { return kGlobal ? k : slot(k); }
    __device__ __forceinline__ T at(int k) const {
        return kGlobal ? c[static_cast<long long>(k) * stride] : c[slot(k)];
    }
    __device__ __forceinline__ T& val(int k) const { return val_[at_(k)]; }
    __device__ __forceinline__ unsigned char& tag(int k) const { return tag_[at_(k)]; }
};

// The walk from w's state to its next event that is not an advance: a jump
// or a restart at the line's end (its closing segment comes back as (seg,
// v) and w.k0 is the restart's index), or the end of the line (kDone). The
// machine of tv_condat.py, with the same operations in the same order; the
// entries a jump would read (c[km + 1], c[kp + 1]) and the next one (c[k +
// 1]) are kept in registers and read ahead, and the advance computes both
// updates and selects, so that a warp's lanes in different events do not
// diverge on the divisions.
template <typename T, class V>
__device__ __forceinline__ int next_event(Walker<T>& w, const V& ln, T l, T two_l, int last,
                                          int& seg, T& v) {
    int k = w.k, k0 = w.k0, km = w.km, kp = w.kp;
    T vmin = w.vmin, vmax = w.vmax, umin = w.umin, umax = w.umax;
    T cm = ln.at(min(km + 1, last)), cp = ln.at(min(kp + 1, last));
    T c1 = ln.at(min(k + 1, last));
    int ev;
    for (;;) {
        if (k == last) {  // the boundary events
            seg = k0;
            if (umin < T(0)) {
                v = vmin;
                k = k0 = km = min(km + 1, last);
                vmin = cm;
                umin = l;
                umax = (vmin + umin) - vmax;
                ev = kBoundary;
            } else if (umax > T(0)) {
                v = vmax;
                k = k0 = kp = min(kp + 1, last);
                vmax = cp;
                umax = -l;
                umin = (vmax + umax) - vmin;
                ev = kBoundary;
            } else {
                v = vmin + umin / static_cast<T>(k - k0 + 1);
                ev = kDone;
            }
            break;
        }
        const T umin_n = (umin + c1) - vmin;
        const T umax_n = (umax + c1) - vmax;
        if (umin_n < -l) {  // a negative jump: the run at vmin closes
            seg = k0;
            v = vmin;
            k = k0 = km = kp = km + 1;
            vmin = cm;
            vmax = vmin + two_l;
            umin = l;
            umax = -l;
            ev = kNeg;
            break;
        }
        if (umax_n > l) {  // a positive jump: the run at vmax closes
            seg = k0;
            v = vmax;
            k = k0 = km = kp = kp + 1;
            vmax = cp;
            vmin = vmax - two_l;
            umin = l;
            umax = -l;
            ev = kPos;
            break;
        }
        // advance: both updates computed, each taken where its test holds
        const int kn = k + 1;
        const T c2 = ln.at(min(kn + 1, last));
        const bool do_min = umin_n >= l, do_max = umax_n <= -l;
        const T vmin_a = vmin + (umin_n - l) / static_cast<T>(kn - k0 + 1);
        const T vmax_a = vmax + (umax_n + l) / static_cast<T>(kn - k0 + 1);
        vmin = do_min ? vmin_a : vmin;
        umin = do_min ? l : umin_n;
        km = do_min ? kn : km;
        cm = do_min ? c2 : cm;
        vmax = do_max ? vmax_a : vmax;
        umax = do_max ? -l : umax_n;
        kp = do_max ? kn : kp;
        cp = do_max ? c2 : cp;
        k = kn;
        c1 = c2;
    }
    w.k = k;
    w.k0 = k0;
    w.km = km;
    w.kp = kp;
    w.vmin = vmin;
    w.vmax = vmax;
    w.umin = umin;
    w.umax = umax;
    return ev;
}

__device__ __forceinline__ int tag_of(int ev) { return ev == kBoundary ? kTagStart : ev; }

// Does a restart with tag tg at an index tagged `at` join the walk that
// tagged it? Only after a mid-line jump, and only with the same sign.
__device__ __forceinline__ bool joins(int at, int tg) { return tg != kTagStart && at == tg; }

// Walker j's start at s = j C: the line's initial state (s = 0) or the state
// after a negative jump to s; a line of one entry is its own output.
template <typename T, class V>
__device__ __forceinline__ void start(Walker<T>& w, const V& ln, T l, T two_l, int s, int N) {
    w.k = w.k0 = w.km = w.kp = s;
    w.umin = l;
    w.umax = -l;
    w.status = kStPending;
    w.n = 0;
    if (s == 0) {
        const T c0 = ln.at(0);
        w.vmin = c0 - l;
        w.vmax = c0 + l;
        ln.tag(0) = kTagStart;
        if (N == 1) {
            ln.val(0) = c0;
            w.status = kStDone;
        }
    } else {
        w.vmin = ln.at(s);
        w.vmax = w.vmin + two_l;
        ln.tag(s) = kTagNeg;
    }
}

// Phase 1: walk from the start, tagging the restarts of the own region.
template <typename T, class V>
__device__ void walk_own(Walker<T>& w, const V& ln, T l, T two_l, int last, int e) {
    if (w.status == kStDone) {  // a line of one entry
        w.stop = last + 1;
        return;
    }
    for (;;) {
        int seg;
        T v;
        const int ev = next_event(w, ln, l, two_l, last, seg, v);
        ln.val(seg) = v;
        if (ev == kDone) {  // no start past the own region
            w.status = kStDone;
            w.stop = last + 1;
            return;
        }
        if (w.k0 >= e) {
            w.status = kStPending;
            w.pk = w.k0;
            w.ptag = tag_of(ev);
            return;
        }
        ln.tag(w.k0) = static_cast<unsigned char>(tag_of(ev));
    }
}

// Phase 2: walk on from the pending restart, reading the tags only. Returns
// the stitch's distance past e, or -1.
template <typename T, class V>
__device__ int extend(Walker<T>& w, const V& ln, const Log<T>& lg, T l, T two_l, int last,
                      int e) {
    if (w.status != kStPending) return -1;
    for (;;) {
        // the pending restart
        if (joins(ln.tag(w.pk), w.ptag)) {
            w.status = kStStitched;
            w.stop = w.pk;
            return w.pk - e;
        }
        if (w.n == kLog) {
            w.status = kStLong;
            w.stop = lg.pos[w.n - 1] + 1;
            return -1;
        }
        lg.pos[w.n] = w.pk;
        lg.tag[w.n] = static_cast<unsigned char>(w.ptag);
        ++w.n;
        int seg;
        T v;
        const int ev = next_event(w, ln, l, two_l, last, seg, v);
        lg.val[w.n - 1] = v;  // seg is the last entry's index
        if (ev == kDone) {
            w.status = kStDone;
            w.stop = last + 1;
            return -1;
        }
        w.pk = w.k0;
        w.ptag = tag_of(ev);
    }
}

__host__ __device__ constexpr long long align16(long long n) { return (n + 15) / 16 * 16; }

// a resident line's row in shared memory: its slots, odd, so that a strided
// axis's transposed staging writes (and lines in step) hit distinct banks
__host__ __device__ constexpr int padded(int N) { return (N + (N >> 5)) | 1; }

// W walkers' logs, each piece 16-byte aligned: indices, values, tags
template <typename T>
__host__ __device__ constexpr long long log_bytes(long long W) {
    return align16(W * kLog * 4) + align16(W * kLog * static_cast<long long>(sizeof(T))) +
           align16(W * kLog);
}

// carve W walkers' logs out of `p`
template <typename T>
__device__ __forceinline__ Log<T> log_of(unsigned char* p, long long W, long long i) {
    int* pos = reinterpret_cast<int*>(p);
    T* val = reinterpret_cast<T*>(p + align16(W * kLog * 4));
    unsigned char* tag = p + align16(W * kLog * 4) + align16(W * kLog * static_cast<long long>(sizeof(T)));
    return Log<T>{pos + i * kLog, tag + i * kLog, val + i * kLog};
}

template <class V>
__device__ __forceinline__ void clear_tags(const V& ln, int from, int to) {
    for (int p = from; p < to; ++p) ln.tag(p) = 0;
}

// Is walker j regular: stitched into the next walker's chunk?
template <typename T>
__device__ __forceinline__ bool regular(const Walker<T>& w, int j, int C) {
    return w.status == kStStitched && w.stop / C == j + 1;
}

__device__ __forceinline__ bool bit(const unsigned* mask, int j) {
    return (mask[j >> 5] >> (j & 31)) & 1u;
}

// Set bits j .. r of `mask`, a word at a time.
__device__ __forceinline__ void set_bits(unsigned* mask, int j, int r) {
    for (int q = j; q <= r;) {
        const int hi = min(r, q | 31);
        const int n = hi - q + 1;
        mask[q >> 5] |= (n == 32 ? ~0u : ((1u << n) - 1u)) << (q & 31);
        q = hi + 1;
    }
}

// Walker r's next step on a chain: the walker it hands on to (stitched),
// -1 (done) or -2 (long).
template <typename T>
__device__ __forceinline__ int next_of(const Walker<T>& w, int C) {
    return w.status == kStStitched ? w.stop / C : w.status == kStDone ? -1 : -2;
}

// Phase 3: follow the true walk through the line's walkers `ws` (chunks of
// C), setting their bits in `chained`. A run of regular walkers (`irregular`
// has their bits clear) is on it as a whole, to the first irregular walker
// r, whose next step (`nxt[r]` where the caller staged them, else read from
// ws) decides what follows. Returns the segments it closed itself.
template <typename T, class V>
__device__ long long chain(Walker<T>* ws, const int* nxt, const unsigned* irregular,
                           unsigned* chained, unsigned char* logs, long long W, long long first,
                           const V& ln, T l, T two_l, int last, int C) {
    long long events = 0;
    int j = 0;
    for (;;) {
        int wd = j >> 5;
        unsigned bits = irregular[wd] & (~0u << (j & 31));
        while (!bits) bits = irregular[++wd];  // the last walker is irregular (done)
        const int r = (wd << 5) + __ffs(bits) - 1;
        set_bits(chained, j, r);
        const int nx = nxt ? nxt[r] : next_of(ws[r], C);
        if (nx == -1) return events;
        if (nx >= 0) {
            j = nx;
            continue;
        }
        // long: go on from its saved state, its pending restart first
        Walker<T> w = ws[r];
        int last_pos = log_of<T>(logs, W, first + r).pos[w.n - 1];
        int kn = w.pk, tg = w.ptag;
        for (;;) {
            clear_tags(ln, last_pos + 1, kn);
            if (joins(ln.tag(kn), tg)) {
                j = kn / C;
                break;
            }
            ln.tag(kn) = static_cast<unsigned char>(tg);
            last_pos = kn;
            int seg;
            T v;
            const int ev = next_event(w, ln, l, two_l, last, seg, v);
            ++events;
            ln.val(seg) = v;
            if (ev == kDone) {
                clear_tags(ln, last_pos + 1, last + 1);
                return events;
            }
            kn = w.k0;
            tg = tag_of(ev);
        }
    }
}

// Phase 3b: a chained walker's log into the line, over [e, its stop).
template <typename T, class V>
__device__ __forceinline__ void apply(const Walker<T>& w, bool chained, const Log<T>& lg,
                                      const V& ln, int e) {
    if (!chained) return;
    clear_tags(ln, e, w.stop);
    for (int i = 0; i < w.n; ++i) {
        ln.tag(lg.pos[i]) = lg.tag[i];
        ln.val(lg.pos[i]) = lg.val[i];
    }
}

// Phase 4a: the last start in chunk [s, e), or -1.
template <class V>
__device__ __forceinline__ int last_start(const V& ln, int s, int e) {
    for (int p = e - 1; p >= s; --p)
        if (ln.tag(p)) return p;
    return -1;
}

// Phase 4b: the carry of walker j (the last start before its chunk).
template <typename T>
__device__ __forceinline__ int carry_of(const Walker<T>* ws, int j) {
    for (int q = j - 1; q >= 0; --q)
        if (ws[q].lastp >= 0) return ws[q].lastp;
    return 0;
}

__device__ __forceinline__ void cp_async(void* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async(void* dst, const double* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src)
                 : "memory");
}

// words of a line's walker bitmask
__host__ __device__ constexpr int mask_words(int G) { return (G + 31) / 32; }

// two bitmasks (irregular, chained) of `lines` lines
__host__ __device__ constexpr long long mask_bytes(long long lines, int G) {
    return align16(2 * lines * mask_words(G) * 4);
}

// shared memory of a resident CTA of L lines of N entries and G walkers a
// line: c and the values (T), the tags (bytes), the bitmasks, the walkers,
// their logs
template <typename T>
__host__ __device__ constexpr long long resident_bytes(int L, int N, int G) {
    return 2 * align16(static_cast<long long>(L) * padded(N) * sizeof(T)) +
           align16(static_cast<long long>(L) * padded(N)) + mask_bytes(L, G) +
           align16(static_cast<long long>(L) * G * sizeof(Walker<T>)) +
           log_bytes<T>(static_cast<long long>(L) * G);
}

// global scratch of `lines` lines of N entries, G walkers a line: the
// tags, the bitmasks (zeroed together), the values, the walkers, their
// logs
template <typename T>
__host__ __device__ constexpr long long global_bytes(long long lines, int N, int G) {
    return align16(lines * N) + mask_bytes(lines, G) +
           align16(lines * N * static_cast<long long>(sizeof(T))) +
           align16(lines * G * static_cast<long long>(sizeof(Walker<T>))) +
           log_bytes<T>(lines * G);
}

// element (l, k) of a tile of lines t0 .. t0 + nl - 1: the e-th copy, ordered
// so that consecutive threads read consecutive addresses
__device__ __forceinline__ void tile_index(int e, int nl, int N, long long inner, int& l, int& k) {
    if (inner == 1) {
        l = e / N;
        k = e - l * N;
    } else {
        k = e / nl;
        l = e - k * nl;
    }
}

__device__ __forceinline__ long long elem(long long t, int k, int N, long long inner) {
    const long long o = t / inner;
    return (o * N + k) * inner + (t - o * inner);
}

__device__ __forceinline__ void stamp(long long* prof, long long& t, int phase) {
    if (prof) {
        const long long now = clock64();
        prof[phase] += now - t;
        t = now;
    }
}

__device__ __forceinline__ void count_walker(unsigned long long* stats, int status, int dist) {
    if (!stats) return;
    if (status == kStStitched) {
        atomicAdd(stats + 0, 1ULL);
        atomicAdd(stats + 1, static_cast<unsigned long long>(dist));
        atomicMax(stats + 2, static_cast<unsigned long long>(dist));
    } else if (status == kStLong) {
        atomicAdd(stats + 3, 1ULL);
    } else if (status == kStDone) {
        atomicAdd(stats + 4, 1ULL);
    }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1) tv_condat_resident(
    const T* __restrict__ x, const T* __restrict__ lam, T* __restrict__ out, long long lines, int N,
    long long inner, long long group, int C, int G, int L, long long* prof,
    unsigned long long* stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int Np = padded(N);
    const long long row_bytes = align16(static_cast<long long>(L) * Np * sizeof(T));
    T* cs = reinterpret_cast<T*>(smem);
    T* vs = reinterpret_cast<T*>(smem + row_bytes);
    unsigned char* ts = smem + 2 * row_bytes;
    const int MW = mask_words(G);
    unsigned* irr = reinterpret_cast<unsigned*>(ts + align16(static_cast<long long>(L) * Np));
    unsigned* chn = irr + L * MW;
    Walker<T>* ws = reinterpret_cast<Walker<T>*>(reinterpret_cast<unsigned char*>(irr) +
                                                 mask_bytes(L, G));
    unsigned char* logs = reinterpret_cast<unsigned char*>(ws) +
                          align16(static_cast<long long>(L) * G * sizeof(Walker<T>));
    long long* tp = blockIdx.x == 0 && threadIdx.x == 0 ? prof : nullptr;
    long long clk = clock64();
    const long long clk0 = clk;

    const long long t0 = static_cast<long long>(blockIdx.x) * L;
    const int nl = static_cast<int>(min(static_cast<long long>(L), lines - t0));
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    for (int i = tid; i < L * Np; i += nthreads) ts[i] = 0;
    for (int i = tid; i < 2 * L * MW; i += nthreads) irr[i] = 0;
    for (int e = tid; e < nl * N; e += nthreads) {
        int l, k;
        tile_index(e, nl, N, inner, l, k);
        cp_async(cs + l * Np + slot(k), x + elem(t0 + l, k, N, inner));
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    stamp(tp, clk, 0);

    const int l = tid / G;
    const int j = tid - l * G;
    const bool live = l < nl;
    const int s = j * C, e = min(s + C, N), last = N - 1;
    const LineView<T, false> ln{cs + l * Np, 1, vs + l * Np, ts + l * Np};
    const Log<T> lg = log_of<T>(logs, static_cast<long long>(L) * G, tid);
    T lv = T(0), two_l = T(0);
    Walker<T> w;
    if (live) {
        lv = lam[(t0 + l) / group];
        two_l = T(2) * lv;
        start(w, ln, lv, two_l, s, N);
        walk_own(w, ln, lv, two_l, last, e);
    }
    __syncthreads();
    if (live) {
        const int dist = extend(w, ln, lg, lv, two_l, last, e);
        count_walker(stats, w.status, dist);
        if (!regular(w, j, C)) atomicOr(irr + l * MW + (j >> 5), 1u << (j & 31));
        ws[tid] = w;
    }
    __syncthreads();
    stamp(tp, clk, 1);
    if (live && j == 0) {
        const long long events =
            chain(ws + l * G, static_cast<const int*>(nullptr), irr + l * MW, chn + l * MW, logs,
                  static_cast<long long>(L) * G, l * G, ln, lv, two_l, last, C);
        if (stats && events) atomicAdd(stats + 5, static_cast<unsigned long long>(events));
    }
    __syncthreads();
    if (live) apply(ws[tid], bit(chn + l * MW, j), lg, ln, e);
    __syncthreads();
    stamp(tp, clk, 2);

    if (live) ws[tid].lastp = last_start(ln, s, e);
    __syncthreads();
    if (live) {
        int cur = carry_of(ws + l * G, j);
        for (int p = s; p < e; ++p) {
            if (ln.tag(p)) cur = p;
            cs[l * Np + slot(p)] = ln.val(cur);
        }
    }
    __syncthreads();
    for (int i = tid; i < nl * N; i += nthreads) {
        int tl, k;
        tile_index(i, nl, N, inner, tl, k);
        out[elem(t0 + tl, k, N, inner)] = cs[tl * Np + slot(k)];
    }
    if (tp) {
        stamp(tp, clk, 3);
        tp[4] += clk - clk0;
    }
}
// The global route: one thread a walker (phases 1, 2, 3b, 4a, 4b; the
// template's `phase` 0, 1, 3, 4, 5) or a CTA a line (3:
// tv_condat_global_chain), one launch a phase.
template <typename T>
struct GlobalLines {
    const T* x;
    const T* lam;
    T* out;
    long long lines, inner, group;
    int N, C, G;
    unsigned char* tag;
    unsigned* irr;  // then the chained bitmasks, lines * mask_words(G) words on
    T* val;
    Walker<T>* ws;
    unsigned char* logs;

    __device__ LineView<T, true> line(long long t) const {
        const long long o = t / inner;
        return LineView<T, true>{x + o * N * inner + (t - o * inner), inner,
                                 val + t * static_cast<long long>(N),
                                 tag + t * static_cast<long long>(N)};
    }
};

template <typename T, int phase>
__global__ void __launch_bounds__(kGlobalThreads, 4) tv_condat_global(GlobalLines<T> g,
                                                                   unsigned long long* stats) {
    const long long id = static_cast<long long>(blockIdx.x) * kGlobalThreads + threadIdx.x;
    if (id >= g.lines * g.G) return;
    const long long t = id / g.G;
    const int j = static_cast<int>(id - t * g.G);
    const auto ln = g.line(t);
    const T lv = g.lam[t / g.group];
    const T two_l = T(2) * lv;
    const int N = g.N, s = j * g.C, e = min(s + g.C, N), last = N - 1;
    const long long W = g.lines * g.G;
    const Log<T> lg = log_of<T>(g.logs, W, id);
    const int MW = mask_words(g.G);
    unsigned* irr = g.irr + t * MW;
    unsigned* chn = g.irr + g.lines * MW + t * MW;
    if constexpr (phase == 0) {
        Walker<T> w;
        start(w, ln, lv, two_l, s, N);
        walk_own(w, ln, lv, two_l, last, e);
        g.ws[id] = w;
    } else if constexpr (phase == 1) {
        Walker<T> w = g.ws[id];
        const int dist = extend(w, ln, lg, lv, two_l, last, e);
        count_walker(stats, w.status, dist);
        if (!regular(w, j, g.C)) atomicOr(irr + (j >> 5), 1u << (j & 31));
        g.ws[id] = w;
    } else if constexpr (phase == 3) {
        apply(g.ws[id], bit(chn, j), lg, ln, e);
    } else if constexpr (phase == 4) {
        g.ws[id].lastp = last_start(ln, s, e);
    } else {
        int cur = carry_of(g.ws + t * g.G, j);
        T* y = g.out + (ln.c - g.x);
        for (int p = s; p < e; ++p) {
            if (ln.tag(p)) cur = p;
            y[static_cast<long long>(p) * g.inner] = ln.val(cur);
        }
    }
}

// Phase 3 of the global route: a CTA a line stages its walkers' next steps
// in shared memory, then one thread follows the chain.
template <typename T>
__global__ void __launch_bounds__(kGlobalThreads) tv_condat_global_chain(
    GlobalLines<T> g, unsigned long long* stats) {
    __shared__ int nxt[kChainWalkers];
    const long long t = blockIdx.x;
    Walker<T>* ws = g.ws + t * g.G;
    for (int i = threadIdx.x; i < g.G; i += kGlobalThreads) nxt[i] = next_of(ws[i], g.C);
    __syncthreads();
    if (threadIdx.x != 0) return;
    const int MW = mask_words(g.G);
    const T lv = g.lam[t / g.group];
    const long long events =
        chain(ws, nxt, g.irr + t * MW, g.irr + g.lines * MW + t * MW, g.logs, g.lines * g.G,
              t * g.G, g.line(t), lv, T(2) * lv, g.N - 1, g.C);
    if (stats && events) atomicAdd(stats + 5, static_cast<unsigned long long>(events));
}

template <typename T>
int launch_resident(const void* x, const void* lam, void* out, long long lines, int N,
                    long long inner, long long group, int C, int G, int L, long long smem,
                    void* prof, void* stats, cudaStream_t stream) {
    if (L < 1 || static_cast<long long>(L) * G > kMaxThreads || smem != resident_bytes<T>(L, N, G))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (lines + L - 1) / L;
    if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(tv_condat_resident<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    tv_condat_resident<T><<<static_cast<unsigned>(blocks), L * G, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(lam), static_cast<T*>(out), lines, N,
        inner, group, C, G, L, static_cast<long long*>(prof),
        static_cast<unsigned long long*>(stats));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_global(const void* x, const void* lam, void* out, long long lines, int N,
                  long long inner, long long group, int C, int G, void* scratch,
                  long long scratch_bytes, void* stats, cudaStream_t stream) {
    if (scratch_bytes != global_bytes<T>(lines, N, G) || G > kChainWalkers)
        return static_cast<int>(cudaErrorInvalidValue);
    unsigned char* base = static_cast<unsigned char*>(scratch);
    const long long walkers = lines * G;
    const long long zeroed = align16(lines * N) + mask_bytes(lines, G);
    const long long val_bytes = align16(lines * N * static_cast<long long>(sizeof(T)));
    GlobalLines<T> g{static_cast<const T*>(x), static_cast<const T*>(lam), static_cast<T*>(out),
                     lines, inner, group, N, C, G, base,
                     reinterpret_cast<unsigned*>(base + align16(lines * N)),
                     reinterpret_cast<T*>(base + zeroed),
                     reinterpret_cast<Walker<T>*>(base + zeroed + val_bytes),
                     base + zeroed + val_bytes +
                         align16(walkers * static_cast<long long>(sizeof(Walker<T>)))};
    cudaError_t err = cudaMemsetAsync(base, 0, static_cast<size_t>(zeroed), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((walkers + kGlobalThreads - 1) / kGlobalThreads >= (1LL << 31) || lines >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const unsigned per_walker = static_cast<unsigned>((walkers + kGlobalThreads - 1) / kGlobalThreads);
    unsigned long long* st = static_cast<unsigned long long*>(stats);
    tv_condat_global<T, 0><<<per_walker, kGlobalThreads, 0, stream>>>(g, st);
    tv_condat_global<T, 1><<<per_walker, kGlobalThreads, 0, stream>>>(g, st);
    tv_condat_global_chain<T><<<static_cast<unsigned>(lines), kGlobalThreads, 0, stream>>>(g, st);
    tv_condat_global<T, 3><<<per_walker, kGlobalThreads, 0, stream>>>(g, st);
    tv_condat_global<T, 4><<<per_walker, kGlobalThreads, 0, stream>>>(g, st);
    tv_condat_global<T, 5><<<per_walker, kGlobalThreads, 0, stream>>>(g, st);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The prox along the middle axis of x viewed as (outer, N, inner), contiguous;
// lam holds one value per `group` consecutive lines; `dbl` selects double (1)
// or float (0). route 0 (resident): CTAs of L lines, G = ceil(N / C) walkers
// a line, `smem` bytes of shared memory (refused unless it is the kernel's
// own count); route 1 (global, six launches and a memset): `scratch` of
// `smem` bytes (refused unless it is the kernel's own count). `prof` (int64[5], resident route only; may be
// null) takes CTA 0's clocks by phase; `stats` (uint64[6]; may be null) the
// run's counts. Returns cudaErrorInvalidValue for a shape or plan it does not
// take, else the launches' error.
int tv_condat_launch(const void* x, const void* lam, void* out, long long outer, int N,
                     long long inner, long long group, int dbl, int route, int C, int L,
                     long long smem, void* scratch, void* prof, void* stats, void* stream) {
    const long long lines = outer * inner;
    if (outer <= 0 || inner <= 0 || N <= 0 || group <= 0 || lines % group != 0 || C <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int G = (N - 1) / C + 1;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (route == 0)
        return dbl ? launch_resident<double>(x, lam, out, lines, N, inner, group, C, G, L, smem,
                                             prof, stats, st)
                   : launch_resident<float>(x, lam, out, lines, N, inner, group, C, G, L, smem,
                                            prof, stats, st);
    if (route == 1)
        return dbl ? launch_global<double>(x, lam, out, lines, N, inner, group, C, G, scratch,
                                           smem, stats, st)
                   : launch_global<float>(x, lam, out, lines, N, inner, group, C, G, scratch,
                                          smem, stats, st);
    return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel's sizes for the card tests: {walker bytes in float, in double,
// a resident CTA of 32 lines of 256 in float and in double (8 walkers a
// line), a global route's scratch for 16 lines of 65,536 in float (2,048
// walkers a line)}.
int tv_condat_sizes(long long* out) {
    out[0] = static_cast<long long>(sizeof(Walker<float>));
    out[1] = static_cast<long long>(sizeof(Walker<double>));
    out[2] = resident_bytes<float>(32, 256, 8);
    out[3] = resident_bytes<double>(32, 256, 8);
    out[4] = global_bytes<float>(16, 65536, 2048);
    return 0;
}

}  // extern "C"
