// The barrier of a group of CTAs that run in one cooperative grid and meet
// in global memory (L2): the slabs of a dense grid kernel's problem group
// (dense_grid.cuh: cgnr_fused.cu, pgm_dense_grid.cuh), the team of CTAs
// that holds one problem on row 8's grid route (fista_l1_dft_fused.cu), and
// the team that holds one slice on the grid routes of rows 9 and 10
// (sense_grid.cuh: sense_fused.cu, splitbregman_fused.cu). A group waits on
// its own counter, never on another group's.
#pragma once

#include <cuda_runtime.h>

namespace rls {
namespace grid {

// Wait until all `slabs` CTAs of the group have arrived: thread 0 adds 1
// to the group's counter with release semantics and polls it with
// acquire semantics; the counter counts up through the whole solve
// (target = slabs x barriers so far). A wait past ~10 s of clocks traps
// rather than hang the card.
__device__ inline void group_sync(unsigned* ctr, unsigned& target, int slabs) {
    __syncthreads();
    if (slabs == 1) return;
    target += slabs;
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(ctr), "r"(1u) : "memory");
        const long long t0 = clock64();
        for (;;) {
            unsigned seen;
            asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(ctr) : "memory");
            if (seen >= target) break;
            if (clock64() - t0 > 20000000000LL) __trap();
        }
    }
    __syncthreads();
}

}  // namespace grid
}  // namespace rls
