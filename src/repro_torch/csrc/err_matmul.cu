// err_matmul: the LOWRANK mode's GEMM, an exact integer product plus a
// rank-r correction of the multiplier's error table,
//
//     out[m, n] = float(sum_k a[m,k] * w[k,n])
//                 + sum_k sum_r f[a[m,k] + off, r] * g[w[k,n] + off, r]
//
// on shifted codes of at most 8 bits (int32 in), with (n_codes, r) float32
// tables f and g (E[a, w] ~= f[a] . g[w]); float32 out.
//
// Replaces the Pallas kernel src/repro/kernels/err_matmul/kernel.py
// (err_matmul_kernel), which ran the exact term on the MXU and the
// correction as two 1-D table gathers feeding a (bm, bk*r) x (bk*r, bn)
// MXU product; its ops.py padded K with code 0 and subtracted the pad's
// f[off] . g[off] afterwards. Here nothing is padded: codes past K, M or N
// are never summed, so no correction is needed.
//
// What bounds it on Hopper: the correction, r fused multiply-adds per
// product on the FP32 lanes (132 SMs x 128 lanes); the exact term is one
// integer multiply-add per product, the bytes are the two code matrices
// read once and the output written once.
//
// What the design does about it (a simple design that is right first):
//  * blocks are persistent over output tiles; each copies f and g into
//    shared memory once, rows padded to an odd stride so that the rows
//    of different codes fall in different banks;
//  * a tile is BM x BN outputs over 256 threads, each thread a 4 x 4
//    register micro-tile; K is staged 32 at a time, raw codes in shared
//    memory (rows past M or N and columns past K hold code 0 and are
//    never summed);
//  * per product the thread adds a * w into an int32 accumulator (exact,
//    and wrapping as the reference's int32 sum does) and r FMAs of the
//    staged table rows into a float32 one; the two meet once, at the end:
//    out = float(int_acc) + float_acc.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;
constexpr int kTM = 4;
constexpr int kTN = 4;

template <int BN>
struct Tile {
  static constexpr int kCols = BN / kTN;          // threads across N
  static constexpr int kRows = kThreads / kCols;  // threads across M
  static constexpr int BM = kRows * kTM;
  static constexpr int kAStride = BM + 1;
};

__host__ __device__ inline int table_stride(int r) { return r | 1; }

template <int BN>
__host__ inline size_t smem_bytes(int n_codes, int r) {
  using T = Tile<BN>;
  return (size_t)2 * n_codes * table_stride(r) * sizeof(float) +
         (size_t)kBK * T::kAStride * sizeof(int) +
         (size_t)kBK * BN * sizeof(int);
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
err_matmul_kernel(const int* __restrict__ a, const int* __restrict__ w,
                  const float* __restrict__ f, const float* __restrict__ g,
                  float* __restrict__ out, int M, int K, int N, int n_codes,
                  int r, int offset) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = table_stride(r);
  float* Fs = reinterpret_cast<float*>(smem);
  float* Gs = Fs + n_codes * rs;
  int* As = reinterpret_cast<int*>(Gs + n_codes * rs);
  int* Bs = As + kBK * T::kAStride;

  const int tid = threadIdx.x;
  const int tx = tid % T::kCols;
  const int ty = tid / T::kCols;

  for (int i = tid; i < n_codes * r; i += kThreads) {
    const int c = i / r, j = i % r;
    Fs[c * rs + j] = __ldg(f + i);
    Gs[c * rs + j] = __ldg(g + i);
  }

  const int tiles_m = (M + T::BM - 1) / T::BM;
  const int tiles_n = (N + BN - 1) / BN;
  const int n_tiles = tiles_m * tiles_n;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * T::BM;
    const int n0 = (tile % tiles_n) * BN;

    int iacc[kTM][kTN];
    float facc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        iacc[i][j] = 0;
        facc[i][j] = 0.0f;
      }

    for (int k0 = 0; k0 < K; k0 += kBK) {
      __syncthreads();  // tables visible; previous chunk consumed
      for (int e = tid; e < T::BM * kBK; e += kThreads) {
        const int mi = e / kBK, ki = e % kBK;
        const int m = m0 + mi, k = k0 + ki;
        As[ki * T::kAStride + mi] =
            (m < M && k < K) ? __ldg(a + (size_t)m * K + k) : 0;
      }
      for (int e = tid; e < kBK * BN; e += kThreads) {
        const int ki = e / BN, ni = e % BN;
        const int k = k0 + ki, n = n0 + ni;
        Bs[e] = (k < K && n < N) ? __ldg(w + (size_t)k * N + n) : 0;
      }
      __syncthreads();

      const int kn = min(kBK, K - k0);
      for (int kk = 0; kk < kn; ++kk) {
        int av[kTM], bv[kTN];
        const float* fr[kTM];
        const float* gr[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          av[i] = As[kk * T::kAStride + ty + i * T::kRows];
          const int row = min(max(av[i] + offset, 0), n_codes - 1);
          fr[i] = Fs + row * rs;
        }
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          bv[j] = Bs[kk * BN + tx + j * T::kCols];
          const int row = min(max(bv[j] + offset, 0), n_codes - 1);
          gr[j] = Gs + row * rs;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) iacc[i][j] += av[i] * bv[j];
        for (int q = 0; q < r; ++q) {
          float fv[kTM], gv[kTN];
#pragma unroll
          for (int i = 0; i < kTM; ++i) fv[i] = fr[i][q];
#pragma unroll
          for (int j = 0; j < kTN; ++j) gv[j] = gr[j][q];
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j)
              facc[i][j] = __fmaf_rn(fv[i], gv[j], facc[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + ty + i * T::kRows;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tx + j * T::kCols;
        if (n < N)
          out[(size_t)m * N + n] =
              __fadd_rn(__int2float_rn(iacc[i][j]), facc[i][j]);
      }
    }
  }
}

template <int BN>
int launch_bn(const int* a, const int* w, const float* f, const float* g,
              float* out, int M, int K, int N, int n_codes, int r,
              int offset, int num_blocks, cudaStream_t stream) {
  using T = Tile<BN>;
  const size_t bytes = smem_bytes<BN>(n_codes, r);
  auto kernel = err_matmul_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      (long long)((M + T::BM - 1) / T::BM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < num_blocks ? tiles : num_blocks);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, bytes, stream>>>(a, w, f, g, out, M, K, N,
                                            n_codes, r, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The column tile follows N, as in the LUT kernels: 16 wide for the head
// (N = 10) and the 16-channel stage, 32 for 32 channels, 64 above.
extern "C" int err_matmul_launch(const int* a, const int* w, const float* f,
                                 const float* g, float* out, int M, int K,
                                 int N, int n_codes, int r, int offset,
                                 int num_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 16)
    return launch_bn<16>(a, w, f, g, out, M, K, N, n_codes, r, offset,
                         num_blocks, s);
  if (N <= 32)
    return launch_bn<32>(a, w, f, g, out, M, K, N, n_codes, r, offset,
                         num_blocks, s);
  return launch_bn<64>(a, w, f, g, out, M, K, N, n_codes, r, offset,
                       num_blocks, s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
