// The size rules of the in-kernel 2-D FFT that the compressed-sensing and
// SENSE kernels share (fista_l1_dft_fused.cu, sense_fused.cu,
// splitbregman_fused.cu): the masked normal op F^H M F of a problem's
// plane, whose stages live in fft_resident.cuh (the radix-2 stages in
// registers and shared memory) and fft_mixed.cuh (the odd stages).
//
// Counterpart of make_split_dft / make_split_dft3 / make_sense_normal
// (rls_tpu/kernels/_fgp_common.py:128-300). The TPU kernels evaluate the
// unitary DFT as dense matrix sandwiches F X F^T with bf16 hi/lo
// compensation (that runtime had no FFT and no complex dtype, and its matrix
// unit rounds its inputs to bf16): O(N) operations per point. Here it is a
// mixed-radix FFT (the odd stages of fft_mixed.cuh, then radix 2), whose
// plain PyTorch twin is rls_tpu_torch/kernels/_dft_common.py; the two follow
// the same stages with the same separately rounded operations (fmul / fadd /
// fsub: nvcc must not contract a butterfly into an FMA) and read the same
// twiddle table, so they agree bit for bit:
//   * rows, then columns forward by decimation in frequency (natural order
//     in, digit-reversed out, no permutation);
//   * the spectral weights: the mask in that digit-reversed order times the
//     unitary scale 1 / (H W);
//   * columns, then rows back by decimation in time on the conjugate
//     twiddles (digit-reversed in, natural out).
// H and W are any sizes from 2 to kFftMax (the wrappers check).
#pragma once

#include <cuda_runtime.h>

#include "fft_mixed.cuh"
#include "pgm_tv_common.cuh"

namespace rls {

constexpr int kFftMax = 1024;  // the largest H or W

// An axis the in-kernel FFT takes: any size from 2 to kFftMax.
inline bool valid_fft_size(int n) { return n >= 2 && n <= kFftMax; }

// Both axes powers of two: the kernels' radix-2 instantiation (kPow2).
inline bool pow2_shape(int H, int W) { return (H & (H - 1)) == 0 && (W & (W - 1)) == 0; }

// n floats rounded up to a multiple of 4: the arrays a kernel lays out in
// its dynamic shared memory stay 16-byte aligned.
__host__ __device__ inline size_t ceil4(size_t n) { return (n + 3) / 4 * 4; }

}  // namespace rls
