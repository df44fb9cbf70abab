// fused_lut_conv_tiled: approximate conv2d forward over halo'd bands of
// output rows, quantize and dequant fused,
//
//     out[n, oh, ow, co] = float(acc) * (xs * ws[co])    (or acc, emit_acc)
//     acc = sum_{c,u,v} LUT[q(x[n, c, oh*sh - ph + u*dh, ow*sw - pw + v*dw])
//                           - (int)xz + off, wq[u,v ; c, co] + off]
//
// Replaces the spatially tiled Pallas kernel
// src/repro/kernels/fused_lut_conv/kernel.py (fused_lut_conv_tiled_kernel,
// body _tiled_kernel), which kept only the (bh-1)*sh + (kh-1)*dh + 1 halo'd
// input rows of one band of output rows in VMEM, quantized them once per
// band, and sliced each tap's window out of those codes.
//
// Design on Hopper. One work item is one image, one band of `bh` output
// rows by a strip of `bw` output columns, and one `BN`-wide Cout tile;
// blocks are persistent and walk the items (Cout tile fastest, so
// neighbouring items read the same input rows from L2). For each chunk of
// `cc` input channels the block stages
//   * the band's halo'd input pixels, ((bh-1)*sh + (kh-1)*dh + 1) rows by
//     ((bw-1)*sw + (kw-1)*dw + 1) columns, read from NCHW with consecutive
//     threads on consecutive columns (coalesced), quantized ONCE each with
//     the quantizer of kernels 2 and 5 (lut_gemm.cuh: quantize_code) and
//     kept as one-byte table rows;
//   * the tile's weight codes, kh*kw x cc x BN bytes;
// then every tap (u, v) reads its strided window straight out of the
// shared band: no second global read and no second quantize of a pixel
// (kernel 5 re-reads and re-quantizes each pixel for every tap it feeds).
// Each thread keeps a 4 x 4 block of int32 accumulators (4 output pixels x
// 4 output channels) in registers across all chunks and taps.
//
// Pixels outside the image (SAME padding, the halo past the last row or
// column) take the zero-point code, table row `off`, as the reference's
// quantized 0.0 padding does. Channels are never padded: the last chunk
// sums only the channels that exist, so no c_pad * LUT[off, off]
// correction is needed. Output pixels of a tile past Ho or Wo are computed
// on zero-point codes and never stored.
//
// Bound: the shared-memory gather rate, as for every LUT GEMM
// (lut_gemm.cuh); the int16 table takes 128 KiB of the block's shared
// memory, the band and weight codes the rest (the wrapper picks bh, bw and
// cc so that all three fit: kernels/fused_lut_conv/ops.py,
// pick_tiled_kernel_tiling). Integer adds are associative, so every band
// height, strip width and chunk gives the reference's accumulator bit for
// bit.
#include "lut_gemm.cuh"

namespace {

constexpr int kThreads = lutgemm::kThreads;
constexpr int kTM = lutgemm::kTM;
constexpr int kTN = lutgemm::kTN;

struct TiledGeom {
  int n, c, h, w, cout, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo;
  int n_codes, offset;
  float lo, hi;
  int bh, bw, cc;          // band rows, strip columns, channel chunk
  int rows_in, cols_in;    // the halo'd band's input extent
  int tiles_h, tiles_w, tiles_n;
};

template <int BN>
__host__ __device__ inline int tiled_smem_bytes(const TiledGeom& g) {
  return lutgemm::round_up16(g.n_codes * g.n_codes * 2) +
         lutgemm::round_up16(g.cc * g.rows_in * g.cols_in) +
         lutgemm::round_up16(g.kh * g.kw * g.cc * BN);
}

template <int BN, bool kEmitAcc>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const float* __restrict__ x, const int* __restrict__ wq,
             const int16_t* __restrict__ lut_g, const float* __restrict__ xs_p,
             const float* __restrict__ xz_p, const float* __restrict__ ws,
             void* __restrict__ out_p, TiledGeom g) {
  constexpr int kCols = BN / kTN;            // threads across Cout
  constexpr int kRows = kThreads / kCols;    // threads across pixels
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  const int plane = g.rows_in * g.cols_in;
  uint8_t* band = smem + lutgemm::round_up16(g.n_codes * g.n_codes * 2);
  uint8_t* wsm = band + lutgemm::round_up16(g.cc * plane);

  const int tid = threadIdx.x;
  const int tx = tid % kCols;
  const int ty = tid / kCols;
  const int taps = g.kh * g.kw;
  const size_t hw = (size_t)g.h * g.w;

  for (int i = tid; i < g.n_codes * g.n_codes; i += kThreads)
    lut[i] = lut_g[i];

  const float xs = *xs_p, xz = *xz_p;
  const int zi = static_cast<int>(xz);

  // this thread's output pixels within a tile: row, column, and the band
  // offset of their tap (0, 0); pixels past the band's rows are dead
  int prow[kTM], pcol[kTM], pix[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int p = ty + i * kRows;
    prow[i] = p / g.bw;
    pcol[i] = p - prow[i] * g.bw;
    pix[i] = prow[i] < g.bh ? prow[i] * g.sh * g.cols_in + pcol[i] * g.sw
                            : 0;
  }

  const int n_work = g.n * g.tiles_h * g.tiles_w * g.tiles_n;
  for (int work = blockIdx.x; work < n_work; work += gridDim.x) {
    int rest = work;
    const int tn = rest % g.tiles_n;
    rest /= g.tiles_n;
    const int tw = rest % g.tiles_w;
    rest /= g.tiles_w;
    const int th = rest % g.tiles_h;
    const int img = rest / g.tiles_h;
    const int oh0 = th * g.bh, ow0 = tw * g.bw, n0 = tn * BN;
    const int ih0 = oh0 * g.sh - g.ph, iw0 = ow0 * g.sw - g.pw;

    int acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

    for (int c0 = 0; c0 < g.c; c0 += g.cc) {
      const int ncc = min(g.cc, g.c - c0);
      __syncthreads();  // the previous chunk's readers are done
      // the band: ncc x rows_in x cols_in codes, each pixel quantized once
      const float* xc = x + ((size_t)img * g.c + c0) * hw;
      for (int e = tid; e < ncc * plane; e += kThreads) {
        const int ci = e / plane;
        const int r = e - ci * plane;
        const int rr = r / g.cols_in;
        const int ih = ih0 + rr;
        const int iw = iw0 + (r - rr * g.cols_in);
        int v = g.offset;
        if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
          v = lutgemm::quantize_code(__ldg(xc + ci * hw + (size_t)ih * g.w +
                                           iw),
                                     xs, xz, g.lo, g.hi) -
              zi + g.offset;
        band[e] = static_cast<uint8_t>(min(max(v, 0), g.n_codes - 1));
      }
      // the weight tile: (tap, channel) rows of BN codes, coalesced on Cout
      for (int e = tid; e < taps * ncc * BN; e += kThreads) {
        const int tc = e / BN;
        const int ni = e - tc * BN;
        const int t = tc / ncc;
        const int co = n0 + ni;
        int v = g.offset;
        if (co < g.cout)
          v = min(max(__ldg(wq + ((size_t)t * g.c + c0 + (tc - t * ncc)) *
                                     g.cout + co) + g.offset, 0),
                  g.n_codes - 1);
        wsm[e] = static_cast<uint8_t>(v);
      }
      __syncthreads();

      for (int t = 0; t < taps; ++t) {
        const int u = t / g.kw;
        const uint8_t* bt = band + u * g.dh * g.cols_in + (t - u * g.kw) * g.dw;
        const uint8_t* wt = wsm + t * ncc * BN + tx;
#pragma unroll 4
        for (int ci = 0; ci < ncc; ++ci) {
          int a[kTM], b[kTN];
#pragma unroll
          for (int i = 0; i < kTM; ++i)
            a[i] = bt[ci * plane + pix[i]] * g.n_codes;
#pragma unroll
          for (int j = 0; j < kTN; ++j) b[j] = wt[ci * BN + j * kCols];
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[i][j] += lut[a[i] + b[j]];
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int oh = oh0 + prow[i], ow = ow0 + pcol[i];
      if (prow[i] >= g.bh || oh >= g.ho || ow >= g.wo) continue;
      const size_t m = ((size_t)img * g.ho + oh) * g.wo + ow;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int co = n0 + tx + j * kCols;
        if (co >= g.cout) continue;
        if (kEmitAcc)
          static_cast<int*>(out_p)[m * g.cout + co] = acc[i][j];
        else
          static_cast<float*>(out_p)[m * g.cout + co] = __fmul_rn(
              __int2float_rn(acc[i][j]), __fmul_rn(xs, ws[co]));
      }
    }
  }
}

template <int BN, bool kEmitAcc>
int launch_bn(const float* x, const int* wq, const int16_t* lut,
              const float* xs, const float* xz, const float* ws, void* out,
              TiledGeom g, int num_blocks, cudaStream_t stream) {
  constexpr int BM = kThreads * kTM * kTN / BN;
  if (g.bh < 1 || g.bw < 1 || g.bh * g.bw > BM || g.cc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  g.tiles_n = (g.cout + BN - 1) / BN;
  const int bytes = tiled_smem_bytes<BN>(g);
  auto kernel = tiled_kernel<BN, kEmitAcc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      (long long)g.n * g.tiles_h * g.tiles_w * g.tiles_n;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < num_blocks ? items : num_blocks);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, bytes, stream>>>(x, wq, lut, xs, xz, ws, out, g);
  return static_cast<int>(cudaGetLastError());
}

template <bool kEmitAcc>
int launch_emit(int bn, const float* x, const int* wq, const int16_t* lut,
                const float* xs, const float* xz, const float* ws, void* out,
                const TiledGeom& g, int num_blocks, cudaStream_t s) {
  switch (bn) {
    case 16:
      return launch_bn<16, kEmitAcc>(x, wq, lut, xs, xz, ws, out, g,
                                     num_blocks, s);
    case 32:
      return launch_bn<32, kEmitAcc>(x, wq, lut, xs, xz, ws, out, g,
                                     num_blocks, s);
    case 64:
      return launch_bn<64, kEmitAcc>(x, wq, lut, xs, xz, ws, out, g,
                                     num_blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// wq: (kh*kw, C, Cout) int32 shifted weight codes, tap-major.
extern "C" int fused_lut_conv_tiled_launch(
    const float* x, const int* wq, const int16_t* lut, const float* xs,
    const float* xz, const float* ws, void* out, int emit_acc, int n, int c,
    int h, int w, int cout, int kh, int kw, int sh, int sw, int ph, int pw,
    int dh, int dw, int ho, int wo, int n_codes, int offset, int lo, int hi,
    int bh, int bw, int cc, int bn, int num_blocks, void* stream) {
  TiledGeom g{n,  c,  h,  w,  cout, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo,
              n_codes, offset, static_cast<float>(lo),
              static_cast<float>(hi), bh, bw, cc,
              (bh - 1) * sh + (kh - 1) * dh + 1,
              (bw - 1) * sw + (kw - 1) * dw + 1,
              (ho + bh - 1) / bh, (wo + bw - 1) / bw, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emit_acc)
    return launch_emit<true>(bn, x, wq, lut, xs, xz, ws, out, g, num_blocks,
                             s);
  return launch_emit<false>(bn, x, wq, lut, xs, xz, ws, out, g, num_blocks,
                            s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
