// Shared core of the three LUT-gather GEMM kernels (lut_matmul,
// fused_lut_dense, fused_lut_conv):
//
//     acc[m, n] = sum_k LUT[a(m, k), w(k, n) + off]      (int32)
//
// where a(m, k) is a row index into the product table, produced by a
// per-kernel operand loader: int32 codes (lut_matmul), float activations
// quantized on the fly (fused_lut_dense), or an implicit im2col view of an
// NCHW image quantized pixel by pixel (fused_lut_conv).
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
//    output tile that block walks;
//  * each thread owns a TM x TN block of outputs and does TM*TN independent
//    lookups per k step, which keeps enough gathers in flight to hide the
//    shared-memory latency with only 8 warps per SM;
//  * operand tiles are staged in shared memory as ready-made table offsets
//    ((a + off) * n_codes and w + off), so the inner loop is one integer add
//    and one 16-bit load per product.
//
// Integer adds are associative, so any tile shape and loop order gives the
// reference's int32 accumulator bit for bit.
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
// A chunk (kBK x BM, padded), the staged W chunk (kBK x BN), and the
// loader's own scratch.
template <int BN>
__host__ inline int smem_bytes(int n_codes, int loader_bytes) {
  using T = TileShape<BN>;
  return round_up16(n_codes * n_codes * 2) + T::kAStride * kBK * 4 +
         kBK * BN * 4 + loader_bytes;
}

// Loader contract:
//   static constexpr int scratch_bytes(int bm);
//   __device__ void begin_tile(int m0, int* scratch, int bm, int tid) const;
//   __device__ void stage(int* As, int a_stride, int m0, int k0, int* scratch,
//                         int bm, int tid) const;
// `stage` writes As[ki * a_stride + mi] = (a + off) * n_codes for the
// kBK x BM chunk at (m0, k0); rows past M and columns past K must hold any
// valid table row (they are never summed into a stored output).
// Store contract:
//   __device__ void operator()(int m, int n, int acc) const;
template <int BN, class Loader, class Store>
__global__ void __launch_bounds__(kThreads)
lut_gemm_kernel(Loader load, Store store, const int* __restrict__ w,
                const int16_t* __restrict__ lut_g, int n_codes, int offset,
                int M, int K, int N) {
  using T = TileShape<BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  int* As = reinterpret_cast<int*>(smem + round_up16(n_codes * n_codes * 2));
  int* Ws = As + T::kAStride * kBK;
  int* scratch = Ws + kBK * BN;

  const int tid = threadIdx.x;
  const int tx = tid % T::kCols;
  const int ty = tid / T::kCols;

  for (int i = tid; i < n_codes * n_codes; i += kThreads) lut[i] = lut_g[i];

  const int tiles_m = (M + T::BM - 1) / T::BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int n_tiles = tiles_m * tiles_n;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * T::BM;
    const int n0 = (tile % tiles_n) * BN;
    __syncthreads();  // previous tile's readers are done with the scratch
    load.begin_tile(m0, scratch, T::BM, tid);

    int acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < K; k0 += kBK) {
      __syncthreads();  // previous chunk consumed (and begin_tile visible)
      load.stage(As, T::kAStride, m0, k0, scratch, T::BM, tid);
      for (int e = tid; e < kBK * BN; e += kThreads) {
        const int ki = e / BN, ni = e % BN;
        const int k = k0 + ki, n = n0 + ni;
        int v = offset;
        if (k < K && n < N) v = min(max(w[(size_t)k * N + n] + offset, 0),
                                    n_codes - 1);
        Ws[e] = v;
      }
      __syncthreads();

      const int kn = min(kBK, K - k0);
      for (int kk = 0; kk < kn; ++kk) {
        int a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          a[i] = As[kk * T::kAStride + ty + i * T::kRows];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = Ws[kk * BN + tx + j * T::kCols];
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

// Host side: size the persistent grid, raise the shared-memory limit, launch.
// Returns the first CUDA error (cudaSuccess == 0 on success).
template <int BN, class Loader, class Store>
inline int launch_bn(const Loader& load, const Store& store, const int* w,
                     const int16_t* lut, int n_codes, int offset, int M,
                     int K, int N, int num_blocks, cudaStream_t stream) {
  using T = TileShape<BN>;
  const int bytes = smem_bytes<BN>(n_codes, Loader::scratch_bytes(T::BM));
  auto kernel = lut_gemm_kernel<BN, Loader, Store>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      (long long)((M + T::BM - 1) / T::BM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < num_blocks ? tiles : num_blocks);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, bytes, stream>>>(load, store, w, lut, n_codes,
                                            offset, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// Picks the column tile from N: the head (N=10) and the 16-channel stage
// run 16-wide tiles, 32-channel convs 32-wide, the rest 64-wide.
template <class Loader, class Store>
inline int launch(const Loader& load, const Store& store, const int* w,
                  const int16_t* lut, int n_codes, int offset, int M, int K,
                  int N, int num_blocks, cudaStream_t stream) {
  if (N <= 16)
    return launch_bn<16>(load, store, w, lut, n_codes, offset, M, K, N,
                         num_blocks, stream);
  if (N <= 32)
    return launch_bn<32>(load, store, w, lut, n_codes, offset, M, K, N,
                         num_blocks, stream);
  return launch_bn<64>(load, store, w, lut, n_codes, offset, M, K, N,
                       num_blocks, stream);
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

// Epilogues shared by the fused kernels: raw int32 accumulator
// (emit_acc) or one combined-scale dequant acc * (xs * ws[n]).
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

}  // namespace lutgemm
