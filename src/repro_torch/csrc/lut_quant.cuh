// The in-kernel quantizers of the fused LUT kernels, rounded exactly as the
// reference rounds: a correctly rounded divide, a separately rounded add
// (no contraction, no fast math), round half to even, then the clip.
// fused_lut_conv and fused_lut_grouped quantize activations with a zero
// point (quantize_code); fused_lut_bwd and fused_lut_conv_bwd_w quantize
// both operands of the approximate backward per-tensor symmetric
// (quantize_symmetric, symmetric_index). round_up16 sizes shared-memory
// carve-ups.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lutgemm {

__host__ __device__ inline int round_up16(int bytes) {
  return (bytes + 15) & ~15;
}

// clip(round_half_even(x / xs + xz), lo, hi)
__device__ __forceinline__ int quantize_code(float x, float xs, float xz,
                                             float lo, float hi) {
  float q = rintf(__fadd_rn(__fdiv_rn(x, xs), xz));
  q = fminf(fmaxf(q, lo), hi);
  return static_cast<int>(q);
}

// clip(round_half_even(x / s), lo, hi): the approximate backward's
// per-tensor symmetric quantizer, no zero point
__device__ __forceinline__ int quantize_symmetric(float x, float s, float lo,
                                                  float hi) {
  float q = rintf(__fdiv_rn(x, s));
  q = fminf(fmaxf(q, lo), hi);
  return static_cast<int>(q);
}

// the symmetric code's table index, code + off, clamped to the table
__device__ __forceinline__ uint32_t symmetric_index(float x, float s,
                                                    float lo, float hi,
                                                    int off, int n) {
  return static_cast<uint32_t>(
      min(max(quantize_symmetric(x, s, lo, hi) + off, 0), n - 1));
}

}  // namespace lutgemm
