// The narrow-N LUT-gather core of kernels 1, 4, 5 and 7 (lut_matmul.cu,
// fused_lut_bwd.cu, fused_lut_conv.cu, fused_lut_conv_bwd_w.cu):
//
//     acc[m, n] += LUT[a(m, k), b(k, n)]      (int32)
//
// summed over one group of 4 k at a time, from operands staged in shared
// memory as one-byte table indices: 4 row codes of one output row in one
// 32-bit word; a k row's column codes as bytes (kernels 1 and 5), or the 4
// k of one column in one word (kernels 4 and 7, load_bw).
//
// What bounds it on Hopper: every product is one data-dependent 16-bit
// gather from the int16 product table in shared memory, so the ceiling is
// one gather per lane per clock, and what a gather costs beyond that is its
// bank conflicts. A table row is 2n bytes (512 at 8 bits), so entry (a, b)
// lies in bank (b / 2) mod 32 for every row a: two lanes that read the same
// weight code on two different rows always conflict.
//
// The lane map (Lanes<BN> below) is what the core does about it. A warp's
// 32 lanes are (output column x K slice):
//  * BN >= 32: 32 lanes x TN = BN / 32 columns each (TN = 1, 2, 4, 8), one
//    K slice. At each (output row, k) every lane gathers from the same
//    table row at its own weight codes, so what is left is the collisions
//    among one row's 32 codes.
//  * BN = 16 (Cout or N <= 16: ResNet-20's stem, stage 0 and head): 16
//    columns x 2 K slices. Each half-warp walks its own (row, k): the two
//    halves read two table rows at different k, hence at unrelated weight
//    codes, which conflict only by coincidence. (16 columns on two output
//    rows at the same k would read two rows at the same 16 codes: a
//    conflict on every gather.)
//    The halves' sums meet by one __shfl_xor before the store; integer
//    adds associate, so this is bitwise the reference's accumulator.
// Each lookup is one byte extract, one multiply-add (the row's byte offset
// a * 2n plus the column's table address, both in registers), one 16-bit
// shared load and one accumulate.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lutnarrow {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline size_t round_up16(size_t bytes) {
  return (bytes + 15) & ~size_t(15);
}

// The lane map of a BN-column tile: lane l owns columns col(l) ..
// col(l) + TN - 1 and K slice slice(l) of KS.
template <int BN>
struct Lanes {
  static_assert(BN == 16 || BN == 32 || BN == 64 || BN == 128 || BN == 256,
                "column tiles are 16, 32, 64, 128 or 256 wide");
  static constexpr int KS = BN == 16 ? 2 : 1;   // K slices of a warp
  static constexpr int kCols = 32 / KS;         // lanes across the columns
  static constexpr int TN = BN / kCols;         // columns of a lane
  __device__ static int col(int lane) { return (lane % kCols) * TN; }
  __device__ static int slice(int lane) { return lane / kCols; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async with zero fill: src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The int16 table into shared memory, 16 bytes a copy where it is aligned,
// as its own cp.async group.
__device__ __forceinline__ void copy_table(int16_t* lut,
                                           const int16_t* lut_g, int n,
                                           int tid) {
  const int bytes = n * n * 2;
  const char* src = reinterpret_cast<const char*>(lut_g);
  char* dst = reinterpret_cast<char*>(lut);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && bytes % 16 == 0) {
    for (int i = tid * 16; i < bytes; i += kThreads * 16)
      cp_async16(dst + i, src + i, 16);
  } else {
    for (int i = tid; i < n * n; i += kThreads) lut[i] = lut_g[i];
  }
  cp_commit();
}

// TN weight codes of one k row, one byte each, as byte offsets 2b
template <int TN>
__device__ __forceinline__ void load_b(const uint8_t* row, int (&b2)[TN]) {
  if constexpr (TN == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(row);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b2[j] = ((w.x >> (8 * j)) & 0xff) << 1;
      b2[4 + j] = ((w.y >> (8 * j)) & 0xff) << 1;
    }
  } else {
    uint32_t w;
    if constexpr (TN == 4)
      w = *reinterpret_cast<const uint32_t*>(row);
    else if constexpr (TN == 2)
      w = *reinterpret_cast<const uint16_t*>(row);
    else
      w = *row;
#pragma unroll
    for (int j = 0; j < TN; ++j) b2[j] = ((w >> (8 * j)) & 0xff) << 1;
  }
}

// The column codes of one group of 4 k at this lane's TN columns, stored
// one word per column (byte q: k row q of the group), as byte offsets 2b:
// TN consecutive words, one vector load.
template <int TN>
__device__ __forceinline__ void load_bw(const uint32_t* p, int (&b2)[4][TN]) {
  uint32_t w[TN];
  if constexpr (TN == 1) {
    w[0] = *p;
  } else if constexpr (TN == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[h];
      w[4 * h] = v.x;
      w[4 * h + 1] = v.y;
      w[4 * h + 2] = v.z;
      w[4 * h + 3] = v.w;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < TN; ++j) b2[q][j] = ((w[j] >> (8 * q)) & 0xff) << 1;
}

// A 16-bit table entry at a shared-memory byte address.
__device__ __forceinline__ int lds_s16(uint32_t addr) {
  int v;
  asm volatile("ld.shared.s16 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The weight codes of one group of 4 k at this lane's columns, as byte
// offsets 2b: k row q at row + q * stride.
template <int TN>
__device__ __forceinline__ void load_b4(const uint8_t* row, int stride,
                                        int (&b2)[4][TN]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) load_b<TN>(row + q * stride, b2[q]);
}

// One group of 4 k: aw[i] holds output row i's 4 table rows (one byte
// each), b2[q] the k row q's weight codes (load_b4); lut_s is the table's
// shared-memory address. Each lookup is one byte extract (PRMT), one
// multiply-add forming the address a * 2n + (lut_s + 2b), one 16-bit
// gather and one accumulate. Rows i >= rows are skipped unless FULL.
template <int TM, int TN, bool FULL>
__device__ __forceinline__ void gather4(const uint32_t (&aw)[TM],
                                        const int (&b2)[4][TN],
                                        uint32_t lut_s, int row_bytes,
                                        int rows, int (&acc)[TM][TN]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t bb[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) bb[j] = lut_s + b2[q][j];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (!FULL && i >= rows) continue;
      const uint32_t a = __byte_perm(aw[i], 0u, 0x4440 + q);  // byte q
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] += lds_s16(a * row_bytes + bb[j]);
    }
  }
}

// The K slices' sums met, in every lane (called by all 32 lanes): the
// lanes of one column lie 32 / KS apart.
template <int KS, int TM, int TN>
__device__ __forceinline__ void sum_slices(int (&acc)[TM][TN]) {
#pragma unroll
  for (int o = 32 / KS; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], o);
}

}  // namespace lutnarrow
