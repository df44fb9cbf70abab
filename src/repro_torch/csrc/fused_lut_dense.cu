// fused_lut_dense: quantize -> LUT-gather GEMM -> dequant in one kernel,
//
//     q(x)     = clip(round_half_even(x / xs + xz), lo, hi)
//     acc[m,n] = sum_k LUT[q(x[m, k]) - (int)xz + off, wq[k, n] + off]
//     out[m,n] = float(acc) * (xs * ws[n])        (or acc with emit_acc)
//
// Replaces the Pallas kernel src/repro/kernels/fused_lut_dense/kernel.py
// (fused_lut_dense_kernel): the activation codes and the int32 accumulator
// never reach device memory. The scales stay on the device (pointers), so
// the launch never waits on them.
//
// What bounds it on Hopper: every product is one data-dependent 16-bit
// gather from the int16 product table in shared memory, so the ceiling is
// one gather per lane per clock (132 SMs x 32 lanes); the bytes (x, the
// int32 weight codes, the output) bound it only at one or two rows.
//
// What the design does about it:
//  * Work plan from the wrapper. The wrapper (kernels/fused_lut_dense/
//    ops.py: dense_plan) cuts the output into BM x BN tiles and K into
//    groups of 4, and hands each persistent block a list of segments
//    (tile, first group, end group, slot). Whole tiles are stored
//    directly; when the tiles number fewer than the SMs, or do not divide
//    into whole rounds, the rest is split along K (stream-K) so that every
//    SM gets the same share. A split tile's int32 partials are added into
//    a zeroed workspace slot with atomics, and the block whose segment
//    completes the tile's K groups (per-tile arrival counter) dequantizes
//    it, once, on the full sum: integer adds associate, so any split is
//    bitwise the reference's accumulator.
//  * Rows that fit M. A block is 8 warps of TM rows each (TM = 1, 2, 4, 8);
//    at small M the warps that have no rows split each K chunk instead, so
//    no thread gathers for a row past M (M = 32 runs 32-row tiles, M = 1 a
//    1-row tile over 8 warps along K).
//  * One table row per warp instruction. A warp owns TM rows and 32 x TN
//    columns: at each (row, k) all 32 lanes gather from the same table row,
//    at their own weight codes. A warp of 16 columns x 2 rows would read
//    two rows at the same 16 codes, a bank conflict on every gather (a
//    table row is 512 B, so entry (a, b) lies in bank (b / 2) mod 32 for
//    every a); what is left is the collisions among one row's 32 codes.
//  * One shared-memory instruction per lookup. Both operands are staged as
//    one-byte codes; a thread reads 4 activation codes (one 32-bit
//    broadcast load) and TN weight codes (one 32- or 64-bit load) and forms
//    the byte address a * 2n + 2b in registers, so the inner loop is one
//    add, one 16-bit gather and one accumulate per product.
//  * Overlapped staging. Each K chunk of 32 (float activations, int32
//    weight codes) is copied with cp.async into one of two buffers while
//    the previous chunk is gathered; the table itself is copied with
//    16-byte cp.async once per block. Each activation is quantized once
//    per segment (BM x its K range), for BN = 128 or 256 columns.
//  * The K pad. Every chunk's last group of 4 may run past the segment's K
//    range; those slots hold the offset code on both sides and the
//    reference's correction pad * LUT[off, off] is subtracted in integer
//    space, as kernel.py:76 does for its k_pad.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;          // K chunk staged per step
constexpr int kGroups = kBK / 4;  // groups of 4 K per chunk

__host__ __device__ inline size_t round_up16(size_t bytes) {
  return (bytes + 15) & ~size_t(15);
}

struct Params {
  const float* x;
  const int* wq;
  const int16_t* lut;
  const float* xs;
  const float* xz;
  const float* ws;
  void* out;
  const int* plan;     // [grid + 1] segment offsets, then 4 ints a segment
  int* work;           // [n_slots * BM * BN] int32 sums, [n_slots] counters
  int emit_acc, M, K, N, n_codes, offset, lo, hi;
  int wm, tiles_n, groups, n_slots;
};

// Shared memory carve-up, the same on host and device.
template <int TM, int TN>
struct Layout {
  static constexpr int BN = 32 * TN;
  static constexpr int BMmax = TM * kWarps;
  size_t lut, raw_a, raw_b, code_a, code_b, flag, total;
  __host__ __device__ explicit Layout(int n_codes) {
    lut = 0;
    raw_a = round_up16((size_t)n_codes * n_codes * 2);
    raw_b = raw_a + 2 * round_up16((size_t)BMmax * kBK * 4);
    code_a = raw_b + 2 * round_up16((size_t)kBK * BN * 4);
    code_b = code_a + round_up16((size_t)BMmax * kBK);
    flag = code_b + round_up16((size_t)kBK * BN);
    total = flag + 16;
  }
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

// In-kernel activation quantizer, rounded exactly as the reference:
// clip(round_half_even(x / xs + xz), lo, hi) with a correctly rounded
// divide and a separately rounded add (no contraction, no fast math).
__device__ __forceinline__ int quantize_code(float x, float xs, float xz,
                                             float lo, float hi) {
  float q = rintf(__fadd_rn(__fdiv_rn(x, xs), xz));
  q = fminf(fmaxf(q, lo), hi);
  return static_cast<int>(q);
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
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int j = 0; j < TN; ++j) b2[j] = ((w >> (8 * j)) & 0xff) << 1;
  }
}

// One warp's gathers over groups [g_begin, g_end) of the staged chunk:
// rows r0 .. r0 + rows - 1 of the tile (rows == TM when FULL), its lane's
// TN columns.
template <int TM, int TN, bool FULL>
__device__ __forceinline__ void gather(const uint8_t* code_a,
                                       const uint8_t* code_b,
                                       const char* lut_b, int row_bytes,
                                       int r0, int rows, int lane,
                                       int g_begin, int g_end,
                                       int (&acc)[TM][TN]) {
  constexpr int BN = 32 * TN;
  for (int g = g_begin; g < g_end; ++g) {
    uint32_t aw[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      aw[i] = (FULL || i < rows)
                  ? *reinterpret_cast<const uint32_t*>(
                        code_a + (r0 + i) * kBK + 4 * g)
                  : 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int b2[TN];
      load_b<TN>(code_b + (4 * g + q) * BN + lane * TN, b2);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (!FULL && i >= rows) continue;
        const int ab = static_cast<int>((aw[i] >> (8 * q)) & 0xff) *
                       row_bytes;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += *reinterpret_cast<const int16_t*>(lut_b + ab + b2[j]);
      }
    }
  }
}

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, 1)
fused_lut_dense_kernel(Params p) {
  constexpr int BN = 32 * TN;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<TM, TN> L(p.n_codes);
  int16_t* lut = reinterpret_cast<int16_t*>(smem + L.lut);
  // two buffers each of raw activations and raw weight codes
  float* raw_a = reinterpret_cast<float*>(smem + L.raw_a);
  int* raw_b = reinterpret_cast<int*>(smem + L.raw_b);
  constexpr int kRawA = (Layout<TM, TN>::BMmax * kBK * 4 + 15) / 16 * 4;
  constexpr int kRawB = kBK * BN;                           // ints
  uint8_t* code_a = smem + L.code_a;
  uint8_t* code_b = smem + L.code_b;
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  int* scratch = raw_b;  // the cross-warp K reduction, after the K loop

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = p.wm, wk = kWarps / wm;
  const int wmid = warp % wm, wkid = warp / wm;
  const int BM = TM * wm;
  const int M = p.M, K = p.K, N = p.N, n = p.n_codes;
  const int row_bytes = 2 * n;

  // the table, 16 bytes a copy where it is aligned (its own cp.async group)
  {
    const int bytes = n * n * 2;
    const char* src = reinterpret_cast<const char*>(p.lut);
    char* dst = reinterpret_cast<char*>(lut);
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && bytes % 16 == 0) {
      for (int i = tid * 16; i < bytes; i += kThreads * 16)
        cp_async16(dst + i, src + i, 16);
    } else {
      for (int i = tid; i < n * n; i += kThreads) lut[i] = p.lut[i];
    }
    cp_commit();
  }

  const float s = *p.xs, z = *p.xz;
  const int zi = static_cast<int>(z);
  const float lo = static_cast<float>(p.lo), hi = static_cast<float>(p.hi);
  const bool vec_a = (K % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  const bool vec_b = (N % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(p.wq) & 15) == 0;
  const char* lut_b = reinterpret_cast<const char*>(lut);

  const int seg_begin = p.plan[blockIdx.x];
  const int seg_end = p.plan[blockIdx.x + 1];
  const int* segs = p.plan + gridDim.x + 1;

  for (int sg = seg_begin; sg < seg_end; ++sg) {
    const int tile = segs[4 * sg], g0 = segs[4 * sg + 1];
    const int g1 = segs[4 * sg + 2], slot = segs[4 * sg + 3];
    const int m0 = (tile / p.tiles_n) * BM;
    const int n0 = (tile % p.tiles_n) * BN;
    const int kb = 4 * g0, ke = min(K, 4 * g1);
    const int n_chunks = (ke - kb + kBK - 1) / kBK;

    // stage chunk c's raw operands into buffer `buf`
    auto issue = [&](int c, int buf) {
      const int k0 = kb + c * kBK;
      float* ra = raw_a + buf * kRawA;
      int* rb = raw_b + buf * kRawB;
      if (vec_a) {
        for (int e = tid; e < BM * (kBK / 4); e += kThreads) {
          const int r = e / (kBK / 4), kq = (e % (kBK / 4)) * 4;
          const int m = m0 + r, k = k0 + kq;
          const bool ok = m < M && k < K;
          cp_async16(ra + r * kBK + kq,
                     ok ? p.x + (size_t)m * K + k : p.x, ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < BM * kBK; e += kThreads) {
          const int r = e / kBK, kk = e % kBK;
          const int m = m0 + r, k = k0 + kk;
          const bool ok = m < M && k < K;
          cp_async4(ra + e, ok ? p.x + (size_t)m * K + k : p.x, ok ? 4 : 0);
        }
      }
      if (vec_b) {
        for (int e = tid; e < kBK * (BN / 4); e += kThreads) {
          const int kk = e / (BN / 4), nq = (e % (BN / 4)) * 4;
          const int k = k0 + kk, nn = n0 + nq;
          const bool ok = k < K && nn < N;
          cp_async16(rb + kk * BN + nq,
                     ok ? p.wq + (size_t)k * N + nn : p.wq, ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < kBK * BN; e += kThreads) {
          const int kk = e / BN, nn = n0 + e % BN, k = k0 + kk;
          const bool ok = k < K && nn < N;
          cp_async4(rb + e, ok ? p.wq + (size_t)k * N + nn : p.wq,
                    ok ? 4 : 0);
        }
      }
    };

    int acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0;
    const int r0 = wmid * TM;
    const int rows = max(0, min(TM, M - (m0 + r0)));
    int pad = 0;  // K slots past the segment's range, summed as LUT[off, off]

    __syncthreads();  // the previous segment is done with every buffer
    issue(0, 0);
    cp_commit();
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) issue(c + 1, (c + 1) & 1);
      cp_commit();
      cp_wait<1>();     // chunk c (and, first, the table) has landed
      __syncthreads();  // ... for every thread's copies
      const int k0 = kb + c * kBK;
      const int kn = min(kBK, ke - k0);
      const int ng = (kn + 3) / 4;
      pad += 4 * ng - kn;
      {  // raw -> one-byte codes; slots past the range hold the offset
        const float* ra = raw_a + (c & 1) * kRawA;
        const int* rb = raw_b + (c & 1) * kRawB;
        for (int e = tid; e < BM * (kBK / 4); e += kThreads) {
          const int r = e / (kBK / 4), kq = (e % (kBK / 4)) * 4;
          const bool row_ok = m0 + r < M;
          uint32_t word = 0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            int v = p.offset;
            if (row_ok && kq + u < kn)
              v = min(max(quantize_code(ra[r * kBK + kq + u], s, z, lo, hi) -
                              zi + p.offset,
                          0),
                      n - 1);
            word |= static_cast<uint32_t>(v) << (8 * u);
          }
          *reinterpret_cast<uint32_t*>(code_a + r * kBK + kq) = word;
        }
        for (int e = tid; e < kBK * (BN / 4); e += kThreads) {
          const int kk = e / (BN / 4), nq = (e % (BN / 4)) * 4;
          const int4 w = *reinterpret_cast<const int4*>(rb + kk * BN + nq);
          const int wv[4] = {w.x, w.y, w.z, w.w};
          uint32_t word = 0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            int v = p.offset;
            if (kk < kn && n0 + nq + u < N)
              v = min(max(wv[u] + p.offset, 0), n - 1);
            word |= static_cast<uint32_t>(v) << (8 * u);
          }
          *reinterpret_cast<uint32_t*>(code_b + kk * BN + nq) = word;
        }
      }
      __syncthreads();
      if (rows > 0) {
        const int per = kGroups / wk;
        const int gb = wkid * per, ge = min(ng, gb + per);
        if (rows == TM)
          gather<TM, TN, true>(code_a, code_b, lut_b, row_bytes, r0, rows,
                               lane, gb, ge, acc);
        else
          gather<TM, TN, false>(code_a, code_b, lut_b, row_bytes, r0, rows,
                                lane, gb, ge, acc);
      }
    }

    // warps that split K hand their sums to the first warp of their rows
    if (wk > 1) {
      if (wkid > 0 && rows > 0) {
        int* dst = scratch + (size_t)(wkid - 1) * BM * BN;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            dst[(r0 + i) * BN + lane * TN + j] = acc[i][j];
      }
      __syncthreads();
      if (wkid == 0 && rows > 0)
        for (int o = 0; o < wk - 1; ++o) {
          const int* src = scratch + (size_t)o * BM * BN;
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] += src[(r0 + i) * BN + lane * TN + j];
        }
    }

    const int m00 = lut[p.offset * n + p.offset];
    const float xs = s;
    const bool whole = g0 == 0 && g1 == p.groups;
    int* sums = p.work + (size_t)max(slot, 0) * BM * BN;
    if (wkid == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (i >= rows) continue;
        const int m = m0 + r0 + i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int nn = n0 + lane * TN + j;
          if (nn >= N) continue;
          const int v = acc[i][j] - pad * m00;
          if (!whole)
            atomicAdd(sums + (r0 + i) * BN + lane * TN + j, v);
          else if (p.emit_acc)
            static_cast<int*>(p.out)[(size_t)m * N + nn] = v;
          else
            static_cast<float*>(p.out)[(size_t)m * N + nn] =
                __fmul_rn(__int2float_rn(v), __fmul_rn(xs, p.ws[nn]));
        }
      }
    }
    if (!whole) {  // the block that completes the tile's K stores it
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        int* count = p.work + (size_t)p.n_slots * BM * BN + slot;
        const int before = atomicAdd(count, g1 - g0);
        *flag = before + (g1 - g0) == p.groups;
      }
      __syncthreads();
      if (*flag) {
        __threadfence();
        for (int e = tid; e < BM * BN; e += kThreads) {
          const int m = m0 + e / BN, nn = n0 + e % BN;
          if (m >= M || nn >= N) continue;
          const int v = __ldcg(sums + e);
          if (p.emit_acc)
            static_cast<int*>(p.out)[(size_t)m * N + nn] = v;
          else
            static_cast<float*>(p.out)[(size_t)m * N + nn] =
                __fmul_rn(__int2float_rn(v), __fmul_rn(xs, p.ws[nn]));
        }
      }
    }
  }
  cp_wait<0>();
}

template <int TM, int TN>
int launch(const Params& prm, int grid, cudaStream_t stream) {
  const Layout<TM, TN> L(prm.n_codes);
  auto kernel = fused_lut_dense_kernel<TM, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, L.total, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_tn(const Params& prm, int tn, int grid, cudaStream_t stream) {
  return tn == 8 ? launch<TM, 8>(prm, grid, stream)
                 : launch<TM, 4>(prm, grid, stream);
}

}  // namespace

extern "C" int fused_lut_dense_launch(
    const float* x, const int* wq, const int16_t* lut, const float* xs,
    const float* xz, const float* ws, void* out, int emit_acc, int M, int K,
    int N, int n_codes, int offset, int lo, int hi, const int* plan,
    int grid, int tm, int tn, int wm, int tiles_n, int groups, int* work,
    int n_slots, void* stream) {
  Params prm{x,      wq, lut,    xs,      xz,     ws,  out,
             plan,   work, emit_acc, M,   K,      N,   n_codes,
             offset, lo, hi,     wm,      tiles_n, groups, n_slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!(tn == 4 || tn == 8) || wm < 1 || wm > kWarps || kWarps % wm)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tm) {
    case 1: return launch_tn<1>(prm, tn, grid, s);
    case 2: return launch_tn<2>(prm, tn, grid, s);
    case 4: return launch_tn<4>(prm, tn, grid, s);
    case 8: return launch_tn<8>(prm, tn, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
