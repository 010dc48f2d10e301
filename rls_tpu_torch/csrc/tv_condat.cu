// Exact 1-D total-variation denoising of many lines at once, by Condat's
// direct algorithm (Condat 2013, "A direct algorithm for 1D total variation
// denoising"): out = argmin_u 1/2 ||u - c||^2 + lam TV(u) for each line c.
//
// Replaces no Pallas kernel. The JAX package runs this prox as a vmapped
// lax.while_loop (rls_tpu/models/tv_condat.py:25, tv_denoise_1d_condat),
// whose every event rewrites the whole line with masked stores: O(N) work
// per event, a design for the TPU's vector unit. In PyTorch that loop takes
// tens of launches and a host sync per event, thousands of launches per
// prox. This kernel is the natural GPU form of the same state machine: one
// thread per line walks it with the same events in the same order, and
// writes each segment once, when it closes.
//
// Lines. The input is viewed as (outer, N, inner): line t = o * inner + i
// holds the elements (o, k, i), k = 0 .. N - 1, at stride `inner`. Along a
// strided axis (inner >= 32) a warp's threads read neighbouring addresses
// for as long as they stay at the same k; along the contiguous axis
// (inner = 1) they are N elements apart, and each thread's walk is served
// by its own cache lines (accepted in this first version; PERF.md records
// it). lam is read once per line, lam[t / group].
//
// What bounds it on an H100. The function moves each element twice (read
// once, written once) and does a handful of operations per element, so its
// bound is the memory's rate: 2 * 4 B a float element over 3.35 TB/s.
// What holds it above that is the dependent chain of one line: each event
// needs the previous event's state, so a thread's time is its line's event
// count times a dependent step, and a launch is as long as its slowest
// line. Many lines (a 2-D image's rows or columns) fill the card; a few
// long lines (16 signals of 65,536) leave it nearly idle.
//
// Arithmetic. The events are those of tv_condat.py:25-117 in the same
// order, with the same operations: sums and differences, one division per
// segment update, and 2 * lam (exact). No product is contracted into an FMA
// but 2 * lam + v, whose product is exact, and nvcc's default division is
// correctly rounded; so the kernel is bit for bit its plain PyTorch
// version (kernels/tv_condat.py, tv_condat_lines_torch).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ void fill(T* y, long long inner, int lo, int hi, T v) {
    for (int j = lo; j <= hi; ++j) y[static_cast<long long>(j) * inner] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) tv_condat_kernel(
    const T* __restrict__ x, const T* __restrict__ lam, T* __restrict__ out,
    long long lines, int N, long long inner, long long group) {
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (t >= lines) return;
    const long long o = t / inner;
    const long long base = o * static_cast<long long>(N) * inner + (t - o * inner);
    const T* __restrict__ c = x + base;
    T* __restrict__ y = out + base;
    if (N == 1) {
        y[0] = c[0];
        return;
    }
    const T l = lam[t / group];
    const T two_l = T(2) * l;
    const int last = N - 1;
    int k = 0, k0 = 0, km = 0, kp = 0;
    T vmin = c[0] - l, vmax = c[0] + l, umin = l, umax = -l;
    for (;;) {
        if (k == last) {  // the boundary events
            if (umin < T(0)) {
                fill(y, inner, k0, km, vmin);
                const int kn = min(km + 1, last);
                vmin = c[static_cast<long long>(kn) * inner];
                umin = l;
                umax = (vmin + umin) - vmax;
                k = k0 = km = kn;
            } else if (umax > T(0)) {
                fill(y, inner, k0, kp, vmax);
                const int kn = min(kp + 1, last);
                vmax = c[static_cast<long long>(kn) * inner];
                umax = -l;
                umin = (vmax + umax) - vmin;
                k = k0 = kp = kn;
            } else {
                vmin = vmin + umin / static_cast<T>(k - k0 + 1);
                fill(y, inner, k0, k, vmin);
                return;
            }
            continue;
        }
        const T cnext = c[static_cast<long long>(k + 1) * inner];
        const T umin_n = (umin + cnext) - vmin;
        const T umax_n = (umax + cnext) - vmax;
        if (umin_n < -l) {  // a negative jump: the run at vmin closes
            fill(y, inner, k0, km, vmin);
            const int kn = km + 1;
            vmin = c[static_cast<long long>(kn) * inner];
            vmax = vmin + two_l;
            umin = l;
            umax = -l;
            k = k0 = km = kp = kn;
        } else if (umax_n > l) {  // a positive jump: the run at vmax closes
            fill(y, inner, k0, kp, vmax);
            const int kn = kp + 1;
            vmax = c[static_cast<long long>(kn) * inner];
            vmin = vmax - two_l;
            umin = l;
            umax = -l;
            k = k0 = km = kp = kn;
        } else {  // advance
            const int kn = k + 1;
            if (umin_n >= l) {
                km = kn;
                vmin = vmin + (umin_n - l) / static_cast<T>(km - k0 + 1);
                umin = l;
            } else {
                umin = umin_n;
            }
            if (umax_n <= -l) {
                kp = kn;
                vmax = vmax + (umax_n + l) / static_cast<T>(kp - k0 + 1);
                umax = -l;
            } else {
                umax = umax_n;
            }
            k = kn;
        }
    }
}

template <typename T>
int launch(const void* x, const void* lam, void* out, long long outer, int N, long long inner,
           long long group, cudaStream_t stream) {
    const long long lines = outer * inner;
    const long long blocks = (lines + kThreads - 1) / kThreads;
    tv_condat_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(lam), static_cast<T*>(out), lines, N,
        inner, group);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The prox along the middle axis of x viewed as (outer, N, inner), contiguous;
// lam holds one value per `group` consecutive lines; `dbl` selects double (1)
// or float (0). Returns cudaErrorInvalidValue for an empty or oversized shape,
// else the launch's error.
int tv_condat_launch(const void* x, const void* lam, void* out, long long outer, int N,
                     long long inner, long long group, int dbl, void* stream) {
    const long long lines = outer * inner;
    if (outer <= 0 || inner <= 0 || N <= 0 || group <= 0 || lines % group != 0 ||
        (lines + kThreads - 1) / kThreads >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dbl ? launch<double>(x, lam, out, outer, N, inner, group, st)
               : launch<float>(x, lam, out, outer, N, inner, group, st);
}

}  // extern "C"
