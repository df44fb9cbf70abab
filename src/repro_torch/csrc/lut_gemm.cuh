// Shared core of the five LUT-gather GEMM kernels (lut_matmul,
// fused_lut_dense, fused_lut_conv, fused_lut_bwd, fused_lut_conv_bwd_w):
//
//     acc[m, n] = sum_k LUT[a(m, k), b(k, n)]      (int32)
//
// where a(m, k) is a row index and b(k, n) a column index into the product
// table, each produced by a per-kernel operand loader: int32 codes
// (lut_matmul, and the B side of the forward kernels), float values
// quantized on the fly (fused_lut_dense's A side, both sides of
// fused_lut_bwd and of fused_lut_conv_bwd_w's gradient), or an implicit
// im2col view of an NCHW image quantized pixel by pixel (fused_lut_conv's
// A side, read tap by tap; fused_lut_conv_bwd_w's A side, the same view
// transposed).
//
// What bounds it on Hopper: every product is one data-dependent gather from
// the (2^b)^2 table, so the ceiling is the shared-memory gather rate (one
// 4-byte lookup per lane per clock), not HBM traffic and not the tensor
// cores, which cannot evaluate an arbitrary product table.
//
// What the design does about it:
//  * the table lives in shared memory as int16: every 8-bit registry table
//    fits in [-32768, 32767], which halves it to 128 KiB (an int32 table is
//    256 KiB and does not fit the 227 KB a block may use). The wrapper
//    checks the range when it narrows the table;
//  * blocks are persistent (one per SM, the table takes most of its shared
//    memory), so the table is copied in once per SM and reused for every
//    work item that block walks;
//  * a work item is one output tile and one slice of the K range. The
//    forward kernels take the whole of K per tile (k_split >= K); the conv
//    weight gradient, whose output is a few tiles and whose K is every
//    output pixel of the batch, splits K so that every SM has work and
//    adds its partial tile into the output with int32 atomics;
//  * each thread owns a TM x TN block of outputs and does TM*TN independent
//    lookups per k step, which keeps enough gathers in flight to hide the
//    shared-memory latency with only 8 warps per SM;
//  * operands are read once per tile through the read-only data path
//    (__ldg: the kernels never write them) and staged in shared memory as
//    ready-made table offsets
//    ((a + off) * n_codes and b + off), so the inner loop is one integer add
//    and one 16-bit load per product.
//
// Integer adds are associative (and wrap the same way in any order), so any
// tile shape, K split and loop order gives the reference's int32
// accumulator bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lutgemm {

constexpr int kThreads = 256;  // threads per block
constexpr int kBK = 32;        // K chunk staged per step
constexpr int kTM = 4;         // output rows per thread
constexpr int kTN = 4;         // output columns per thread

template <int BN>
struct TileShape {
  static constexpr int kCols = BN / kTN;              // threads across N
  static constexpr int kRows = kThreads / kCols;      // threads across M
  static constexpr int BM = kRows * kTM;              // output rows per tile
  static constexpr int kAStride = BM + 1;             // padded: no bank clash
};

__host__ __device__ inline int round_up16(int bytes) {
  return (bytes + 15) & ~15;
}

// Bytes of dynamic shared memory a block needs: the int16 table, the staged
// A chunk (kBK x BM, padded), the staged B chunk (kBK x BN), and the A
// loader's own scratch.
template <int BN>
__host__ inline int smem_bytes(int n_codes, int loader_bytes) {
  using T = TileShape<BN>;
  return round_up16(n_codes * n_codes * 2) + T::kAStride * kBK * 4 +
         kBK * BN * 4 + loader_bytes;
}

// A-loader contract:
//   static constexpr int scratch_bytes(int bm);
//   __device__ void begin_tile(int m0, int* scratch, int bm, int tid) const;
//   __device__ void stage(int* As, int a_stride, int m0, int k0, int* scratch,
//                         int bm, int tid) const;
// `stage` writes As[ki * a_stride + mi] = (a + off) * n_codes for the
// kBK x BM chunk at (m0, k0); rows past M and columns past K must hold any
// valid table row (they are never summed into a stored output).
// B-loader contract:
//   template <int BN>
//   __device__ void stage(int* Bs, int k0, int n0, int tid) const;
// writes Bs[ki * BN + ni] = b + off for the kBK x BN chunk at (k0, n0), any
// valid table column past K or N.
// Store contract:
//   __device__ void operator()(int m, int n, int acc) const;
// called once per output and work item: with k_split < K it must add.
template <int BN, class Loader, class BLoader, class Store>
__global__ void __launch_bounds__(kThreads)
lut_gemm_kernel(Loader load, BLoader bload, Store store,
                const int16_t* __restrict__ lut_g, int n_codes, int M, int K,
                int N, int k_split) {
  using T = TileShape<BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  int* As = reinterpret_cast<int*>(smem + round_up16(n_codes * n_codes * 2));
  int* Bs = As + T::kAStride * kBK;
  int* scratch = Bs + kBK * BN;

  const int tid = threadIdx.x;
  const int tx = tid % T::kCols;
  const int ty = tid / T::kCols;

  for (int i = tid; i < n_codes * n_codes; i += kThreads) lut[i] = lut_g[i];

  const int tiles_m = (M + T::BM - 1) / T::BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int n_tiles = tiles_m * tiles_n;
  const int n_splits = (K + k_split - 1) / k_split;
  const int n_work = n_tiles * n_splits;

  for (int work = blockIdx.x; work < n_work; work += gridDim.x) {
    const int tile = work % n_tiles;
    const int k_begin = (work / n_tiles) * k_split;
    const int k_end = min(K, k_begin + k_split);
    const int m0 = (tile / tiles_n) * T::BM;
    const int n0 = (tile % tiles_n) * BN;
    __syncthreads();  // previous tile's readers are done with the scratch
    load.begin_tile(m0, scratch, T::BM, tid);

    int acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

    for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
      __syncthreads();  // previous chunk consumed (and begin_tile visible)
      load.stage(As, T::kAStride, m0, k0, scratch, T::BM, tid);
      bload.template stage<BN>(Bs, k0, n0, tid);
      __syncthreads();

      const int kn = min(kBK, k_end - k0);
      for (int kk = 0; kk < kn; ++kk) {
        int a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          a[i] = As[kk * T::kAStride + ty + i * T::kRows];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = Bs[kk * BN + tx + j * T::kCols];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] += lut[a[i] + b[j]];
      }
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + ty + i * T::kRows;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tx + j * T::kCols;
        if (n < N) store(m, n, acc[i][j]);
      }
    }
  }
}

// B side of the forward kernels: row-major (K, N) int32 shifted codes,
// consecutive threads on consecutive n (coalesced).
struct CodeBLoader {
  const int* w;
  int K, N, n_codes, offset;

  template <int BN>
  __device__ void stage(int* Bs, int k0, int n0, int tid) const {
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int ki = e / BN, ni = e % BN;
      const int k = k0 + ki, n = n0 + ni;
      int v = offset;
      if (k < K && n < N)
        v = min(max(__ldg(w + (size_t)k * N + n) + offset, 0), n_codes - 1);
      Bs[e] = v;
    }
  }
};

// Host side: size the persistent grid, raise the shared-memory limit, launch.
// `k_split` is the K range of one work item, rounded up to whole kBK chunks
// (K or more: one item per tile). Returns the first CUDA error
// (cudaSuccess == 0 on success).
template <int BN, class Loader, class BLoader, class Store>
inline int launch_bn(const Loader& load, const BLoader& bload,
                     const Store& store, const int16_t* lut, int n_codes,
                     int M, int K, int N, int num_blocks, int k_split,
                     cudaStream_t stream) {
  using T = TileShape<BN>;
  const int bytes = smem_bytes<BN>(n_codes, Loader::scratch_bytes(T::BM));
  auto kernel = lut_gemm_kernel<BN, Loader, BLoader, Store>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  k_split = k_split >= K ? (K > 0 ? K : 1)
                         : ((k_split + kBK - 1) / kBK) * kBK;
  const long long items =
      (long long)((M + T::BM - 1) / T::BM) * ((N + BN - 1) / BN) *
      ((K + k_split - 1) / k_split);
  const int grid = static_cast<int>(items < num_blocks ? items : num_blocks);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, bytes, stream>>>(load, bload, store, lut, n_codes,
                                            M, K, N, k_split);
  return static_cast<int>(cudaGetLastError());
}

// Picks the column tile from N: the head (N=10) and the 16-channel stage
// run 16-wide tiles, 32-channel convs 32-wide, the rest 64-wide.
template <class Loader, class BLoader, class Store>
inline int launch(const Loader& load, const BLoader& bload,
                  const Store& store, const int16_t* lut, int n_codes, int M,
                  int K, int N, int num_blocks, cudaStream_t stream,
                  int k_split = 0x7fffffff) {
  if (N <= 16)
    return launch_bn<16>(load, bload, store, lut, n_codes, M, K, N,
                         num_blocks, k_split, stream);
  if (N <= 32)
    return launch_bn<32>(load, bload, store, lut, n_codes, M, K, N,
                         num_blocks, k_split, stream);
  return launch_bn<64>(load, bload, store, lut, n_codes, M, K, N, num_blocks,
                       k_split, stream);
}

// Rows and columns of the output tile the kernel picks for N.
__host__ inline int tile_rows(int N) {
  if (N <= 16) return TileShape<16>::BM;
  if (N <= 32) return TileShape<32>::BM;
  return TileShape<64>::BM;
}

__host__ inline int tile_cols(int N) {
  return N <= 16 ? 16 : N <= 32 ? 32 : 64;
}

// K range of one work item: the whole of K when the output has enough
// tiles to give every block one, else about two work items per block (a
// weight gradient: a few tiles, K = every pixel or row of the batch).
__host__ inline int split_k(int M, int K, int N, int num_blocks) {
  const long long tiles =
      (long long)((M + tile_rows(N) - 1) / tile_rows(N)) *
      ((N + tile_cols(N) - 1) / tile_cols(N));
  if (tiles >= num_blocks) return K;
  const long long splits = (2LL * num_blocks + tiles - 1) / tiles;
  return static_cast<int>((K + splits - 1) / splits);
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

// Per-tensor symmetric quantizer of the approximate backward, rounded as
// the reference: clip(round_half_even(x / s), lo, hi), correctly rounded
// divide, no zero point.
__device__ __forceinline__ int quantize_symmetric(float x, float s, float lo,
                                                  float hi) {
  float q = rintf(__fdiv_rn(x, s));
  q = fminf(fmaxf(q, lo), hi);
  return static_cast<int>(q);
}

// B side of the backward kernels: a row-major (K, N) float operand
// quantized symmetric on staging, consecutive threads on consecutive n.
struct SymBLoader {
  const float* b;
  const float* sb;
  int K, N, n_codes, offset;
  float lo, hi;

  template <int BN>
  __device__ void stage(int* Bs, int k0, int n0, int tid) const {
    const float s = *sb;
    for (int e = tid; e < kBK * BN; e += kThreads) {
      const int ki = e / BN, ni = e % BN;
      const int k = k0 + ki, n = n0 + ni;
      int v = offset;
      if (k < K && n < N)
        v = quantize_symmetric(__ldg(b + (size_t)k * N + n), s, lo, hi) +
            offset;
      Bs[e] = min(max(v, 0), n_codes - 1);
    }
  }
};

// Epilogues shared by the fused kernels: raw int32 accumulator
// (emit_acc), one combined-scale dequant acc * (xs * ws[n]), or an int32
// atomic add of a split-K partial.
struct StoreInt {
  int* out;
  int N;
  __device__ void operator()(int m, int n, int acc) const {
    out[(size_t)m * N + n] = acc;
  }
};

struct StoreDequant {
  float* out;
  const float* xs;
  const float* ws;
  int N;
  __device__ void operator()(int m, int n, int acc) const {
    out[(size_t)m * N + n] =
        __fmul_rn(__int2float_rn(acc), __fmul_rn(*xs, ws[n]));
  }
};

struct StoreAtomicAdd {
  int* out;
  int N;
  __device__ void operator()(int m, int n, int acc) const {
    atomicAdd(out + (size_t)m * N + n, acc);
  }
};

}  // namespace lutgemm
