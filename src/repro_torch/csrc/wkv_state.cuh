// Device code shared by the WKV-6 forward (wkv.cu) and its backward
// (wkv_bwd.cu): the state update, so that the backward's restored states
// are the forward's bit for bit by construction, and the 16-byte
// asynchronous copies both use to stage a tile of steps' operands.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// One entry (i, j) of S_t = diag(w_t) S_{t-1} + k_t^T v_t, rounded as the
// reference's time_mix step: k*v and w*S each rounded on its own, then
// their sum (no contraction into an FMA). kv is k*v, rounded.
__device__ __forceinline__ float wkv_state_update(float w, float s,
                                                  float kv) {
  return __fadd_rn(__fmul_rn(w, s), kv);
}

__device__ __forceinline__ float wkv_state_step(float w, float s, float k,
                                                float v) {
  return wkv_state_update(w, s, __fmul_rn(k, v));
}

// N floats from shared memory into registers: 16-byte loads where N is a
// multiple of 4 (p then 16-byte aligned)
template <int N>
__device__ __forceinline__ void wkv_load(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + e);
      out[e] = x.x;
      out[e + 1] = x.y;
      out[e + 2] = x.z;
      out[e + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = p[e];
  }
}

__device__ __forceinline__ void wkv_cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void wkv_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies have landed, all of them (N = 0) or all but the
// last committed group (N = 1); the caller then takes the block's barrier
// before another thread reads them
template <int N>
__device__ __forceinline__ void wkv_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four partial sums over the 16 lanes that share lane & 16 (l = lane & 15),
// transposed: two shuffles exchange half the values (xor 8), then one each
// at xor 4, 2 and 1, so lane l ends with the full sum of value l >> 2
// (lanes 0-3: v0, 4-7: v1, 8-11: v2, 12-15: v3, the same bits on the four
// lanes of a value), added in a fixed order: halves first,
// ((l, l^8) + (l^4, l^12)) + ... .
__device__ __forceinline__ float wkv_reduce16(float v0, float v1, float v2,
                                              float v3, int l) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool b3 = l & 8;
  float k0 = b3 ? v2 : v0, k1 = b3 ? v3 : v1;
  const float s0 = b3 ? v0 : v2, s1 = b3 ? v1 : v3;
  k0 = __fadd_rn(k0, __shfl_xor_sync(kAll, s0, 8));
  k1 = __fadd_rn(k1, __shfl_xor_sync(kAll, s1, 8));
  const bool b2 = l & 4;
  float x = b2 ? k1 : k0;
  const float y = b2 ? k0 : k1;
  x = __fadd_rn(x, __shfl_xor_sync(kAll, y, 4));
  x = __fadd_rn(x, __shfl_xor_sync(kAll, x, 2));
  return __fadd_rn(x, __shfl_xor_sync(kAll, x, 1));
}
