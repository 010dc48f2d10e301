// The shared-memory mbarrier of the ring kernels (kaczmarz.cu, kaczmarz_greedy.cu):
// init, arrive with release semantics, and a wait with acquire semantics that
// traps rather than hang the card.
#pragma once

#include <cuda_runtime.h>

namespace rls {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

// arrive with release semantics: what this thread did before is visible to
// a thread that has waited for the phase
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_done(unsigned addr, unsigned parity) {
    unsigned ok;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(addr), "r"(parity)
        : "memory");
    return ok != 0;
}

// Wait (acquire) until the phase of parity `parity` of `bar` has completed.
// A wait past ~10 s of clocks traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    const unsigned addr = smem_u32(bar);
    if (mbar_done(addr, parity)) return;
    const long long t0 = clock64();
    while (!mbar_done(addr, parity))
        if (clock64() - t0 > 20000000000LL) __trap();
}

}  // namespace rls
