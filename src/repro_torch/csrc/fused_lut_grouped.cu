// fused_lut_grouped: the ragged grouped quantize -> LUT-gather GEMM ->
// dequant of an MoE layer's expert projections, every group in one launch,
//
//     group g = b * E + e (dispatch block b, expert e), C capacity rows each
//     live rows of g: r < clip(counts[g], 0, C)
//     q(x)         = clip(round_half_even(x / xs + xz), lo, hi)
//     acc[g, r, n] = sum_k LUT[q(x[g, r, k]) - (int)xz + off, wq[e, k, n] + off]
//     out[g, r, n] = float(acc) * (xs * ws[e, n])     (acc with emit_acc)
//     out[g, r, n] = 0 for every row past the count, never accumulated.
//
// Replaces the Pallas kernel src/repro/kernels/fused_lut_grouped/kernel.py
// (fused_lut_grouped_kernel). That kernel walks (group, row block, n block,
// k block) and skips row blocks past each group's live count; at an MoE
// decode step every group holds at most a row or two, so a per-group row
// tile would compute mostly dead rows. Here the live rows of one expert
// from all nb dispatch blocks are packed into one row list (they share that
// expert's weights), and a work item is (expert, 64-column tile, 16-row
// tile of the packed list):
//
//  * what bounds it: at decode (at most 16 live rows per expert) the int32
//    weight codes, read once per expert and column tile (all 40 experts of
//    granite's gate projection: 126 MB); at prefill, the shared-memory
//    gather rate, one lookup per lane per clock, as in lut_narrow.cuh;
//  * each thread owns one column and a quarter of every 128-deep K chunk:
//    its weight codes go straight from device memory into registers
//    (consecutive threads, consecutive columns), the next chunk's are in
//    flight while this one is summed, and the four quarters' partial sums
//    meet in shared memory at the end of the item;
//  * the activations of the tile's live rows are quantized once per chunk
//    into shared memory, read back four codes at a time (a broadcast: a
//    warp shares its rows), and the row loop stops at the tile's live
//    count, so lookups scale with the live rows;
//  * a warp builds the tile's row list with one parallel read of the
//    expert's counts and a prefix sum; an item past the expert's live rows
//    exits at once. The counts stay on the device, so the launch never
//    waits for the host. A last grid-stride pass writes the dead rows'
//    zeros (int 0 and 0.0f have the same bits);
//  * the int16 table sits in shared memory and blocks are persistent (one
//    per SM), as in the other LUT kernels; each block copies it in 16
//    bytes a load.
//
// Activations are float32 or bfloat16 (widened exactly on load). Nothing is
// padded, so there is no k_pad correction. Integer adds are associative, so
// every live row equals the reference's per-group accumulator bit for bit.
#include <cuda_bf16.h>

#include "lut_quant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BM = 16;                        // packed rows of one work item
constexpr int BN = 64;                        // columns of one work item
constexpr int BK = 128;                       // K chunk
constexpr int kSlices = kThreads / BN;        // 4 threads share a column
constexpr int kKPer = BK / kSlices;           // 32 k of a chunk per thread
constexpr int kAPer = BM * BK / kThreads;     // 8 activations per thread
static_assert(kSlices * BN == kThreads && kKPer % 4 == 0, "tile shape");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const T* __restrict__ x, const int* __restrict__ wq,
               const int16_t* __restrict__ lut_g, const float* xs_p,
               const float* xz_p, const float* __restrict__ ws,
               const int* __restrict__ counts, void* out_v, int emit_acc,
               int G, int E, int C, int K, int N, int n_codes, int offset,
               float lo, float hi) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  int* As = reinterpret_cast<int*>(smem + lutgemm::round_up16(
                                              n_codes * n_codes * 2));
  int* red = As + BM * BK;               // [kSlices][BM][BN] partial sums
  int* rowsrc = red + kSlices * BM * BN;  // packed row -> global row, or -1
  int* n_live_s = rowsrc + BM;

  const int tid = threadIdx.x;
  const int tx = tid % BN;               // column of the tile
  const int ty = tid / BN;               // quarter of each K chunk
  const int lane = tid % 32;
  const int nb = G / E;
  const float xs = *xs_p, xz = *xz_p;
  const int zi = static_cast<int>(xz);

  // the table, 16 bytes a load (the wrapper passes it 16-byte aligned)
  const int n_entries = n_codes * n_codes;
  const int n_vec = n_entries / 8;
  for (int i = tid; i < n_vec; i += kThreads)
    reinterpret_cast<int4*>(lut)[i] =
        __ldg(reinterpret_cast<const int4*>(lut_g) + i);
  for (int i = n_vec * 8 + tid; i < n_entries; i += kThreads)
    lut[i] = lut_g[i];

  const int n_tiles = (N + BN - 1) / BN;
  const int row_tiles = (nb * C + BM - 1) / BM;
  const long long n_work = (long long)E * n_tiles * row_tiles;

  for (long long work = blockIdx.x; work < n_work; work += gridDim.x) {
    const int rt = static_cast<int>(work % row_tiles);
    const int nt = static_cast<int>((work / row_tiles) % n_tiles);
    const int e = static_cast<int>(work / ((long long)row_tiles * n_tiles));
    __syncthreads();   // the previous item is done with shared memory
    if (tid < 32) {
      // rows rt*BM .. rt*BM+BM-1 of expert e's packed list: block b's live
      // rows follow those of blocks 0..b-1
      if (lane < BM) rowsrc[lane] = -1;
      __syncwarp();
      int base = 0;
      for (int b0 = 0; b0 < nb; b0 += 32) {
        const int b = b0 + lane;
        const int g = b * E + e;
        const int c = b < nb ? min(max(counts[g], 0), C) : 0;
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        const int first = base + incl - c;
        for (int r = 0; r < BM; ++r) {
          const int j = rt * BM + r;
          if (j >= first && j < first + c) rowsrc[r] = g * C + (j - first);
        }
        base += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) *n_live_s = min(max(base - rt * BM, 0), BM);
    }
    __syncthreads();
    const int n_live = *n_live_s;
    if (n_live == 0) continue;   // the tile starts past the live rows

    const int n = nt * BN + tx;
    const bool col_ok = n < N;
    const int* w_col = wq + (size_t)e * K * N + (col_ok ? n : 0);
    int bn[kKPer];
    float an[kAPer];
    auto load = [&](int k0) {
#pragma unroll
      for (int j = 0; j < kKPer; ++j) {
        const int k = k0 + ty * kKPer + j;
        bn[j] = (col_ok && k < K) ? __ldg(w_col + (size_t)k * N) : 0;
      }
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const int el = tid + i * kThreads;
        const int r = el / BK, k = k0 + el % BK;
        an[i] = (r < n_live && k < K) ? widen(x[(size_t)rowsrc[r] * K + k])
                                      : 0.f;
      }
    };

    int acc[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0;

    load(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();   // the previous chunk's codes have been read
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const int v = lutgemm::quantize_code(an[i], xs, xz, lo, hi) - zi +
                      offset;
        As[tid + i * kThreads] = min(max(v, 0), n_codes - 1) * n_codes;
      }
      int bc[kKPer];
#pragma unroll
      for (int j = 0; j < kKPer; ++j)
        bc[j] = min(max(bn[j] + offset, 0), n_codes - 1);
      __syncthreads();
      if (k0 + BK < K) load(k0 + BK);   // in flight while this chunk sums

      const int kn = min(BK, K - k0);
      if (kn == BK) {
        const int4* a4 = reinterpret_cast<const int4*>(As + ty * kKPer);
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          if (r < n_live) {
            int s = 0;
#pragma unroll
            for (int q = 0; q < kKPer / 4; ++q) {
              const int4 a = a4[r * (BK / 4) + q];
              s += lut[a.x + bc[4 * q]] + lut[a.y + bc[4 * q + 1]] +
                   lut[a.z + bc[4 * q + 2]] + lut[a.w + bc[4 * q + 3]];
            }
            acc[r] += s;
          }
        }
      } else {   // the last, partial chunk: sum only k < K
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          if (r < n_live) {
#pragma unroll
            for (int j = 0; j < kKPer; ++j)
              if (ty * kKPer + j < kn)
                acc[r] += lut[As[r * BK + ty * kKPer + j] + bc[j]];
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < BM; ++r)
      if (r < n_live) red[(ty * BM + r) * BN + tx] = acc[r];
    __syncthreads();
    for (int o = tid; o < n_live * BN; o += kThreads) {
      const int r = o / BN, c = o % BN, nn = nt * BN + c;
      if (nn >= N) continue;
      int v = 0;
#pragma unroll
      for (int sl = 0; sl < kSlices; ++sl) v += red[(sl * BM + r) * BN + c];
      const size_t out_i = (size_t)rowsrc[r] * N + nn;
      if (emit_acc)
        static_cast<int*>(out_v)[out_i] = v;
      else
        static_cast<float*>(out_v)[out_i] = __fmul_rn(
            __int2float_rn(v), __fmul_rn(xs, ws[(size_t)e * N + nn]));
    }
  }

  // dead rows: exactly zero, never accumulated
  int* out_bits = static_cast<int*>(out_v);
  for (int row = blockIdx.x; row < G * C; row += gridDim.x) {
    if (row % C < min(max(counts[row / C], 0), C)) continue;
    for (int n = tid; n < N; n += kThreads) out_bits[(size_t)row * N + n] = 0;
  }
}

template <typename T>
int launch(const T* x, const int* wq, const int16_t* lut, const float* xs,
           const float* xz, const float* ws, const int* counts, void* out,
           int emit_acc, int G, int E, int C, int K, int N, int n_codes,
           int offset, int lo, int hi, int num_blocks, cudaStream_t stream) {
  const int bytes = lutgemm::round_up16(n_codes * n_codes * 2) +
                    (BM * BK + kSlices * BM * BN + BM + 4) * 4;
  auto kernel = grouped_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (G <= 0 || E <= 0 || C <= 0 || N <= 0 || num_blocks <= 0)
    return static_cast<int>(cudaSuccess);
  kernel<<<num_blocks, kThreads, bytes, stream>>>(
      x, wq, lut, xs, xz, ws, counts, out, emit_acc, G, E, C, K, N, n_codes,
      offset, static_cast<float>(lo), static_cast<float>(hi));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_lut_grouped_launch(
    const void* x, int x_bf16, const int* wq, const int16_t* lut,
    const float* xs, const float* xz, const float* ws, const int* counts,
    void* out, int emit_acc, int G, int E, int C, int K, int N, int n_codes,
    int offset, int lo, int hi, int num_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), wq, lut, xs, xz, ws,
                  counts, out, emit_acc, G, E, C, K, N, n_codes, offset, lo,
                  hi, num_blocks, s);
  return launch(static_cast<const float*>(x), wq, lut, xs, xz, ws, counts,
                out, emit_acc, G, E, C, K, N, n_codes, offset, lo, hi,
                num_blocks, s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
