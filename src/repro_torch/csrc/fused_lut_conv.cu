// fused_lut_conv: approximate conv2d forward, quantize and dequant fused,
//
//     out[n, oh, ow, co] = float(acc) * (xs * ws[co])    (or acc, emit_acc)
//     acc = sum_{c,u,v} LUT[q(x[n, c, oh*sh - ph + u*dh, ow*sw - pw + v*dw])
//                           - (int)xz + off, wq[u,v ; c, co] + off]
//
// Replaces the whole-image Pallas kernel
// src/repro/kernels/fused_lut_conv/kernel.py (fused_lut_conv_kernel), which
// kept one padded image resident in VMEM, quantized it once per image and
// looped over kh*kw tap windows of its codes. Its callers here: every conv
// of ResNet-20 (Cout 16, 32, 64; C 3 to 64; stride 2, 1x1 VALID
// shortcuts), CNN-224's c1 (3 -> 64 at 224^2) and c3 (128 -> 256 at 56^2).
//
// What bounds it on Hopper: every product is one data-dependent 16-bit
// gather from the int16 product table in shared memory (128 KiB at 8
// bits), so the ceiling is one gather per lane per clock, 132 SMs x 32
// lanes; the bytes (the image, the output) take a fraction of that time.
//
// What the design does about it:
//  * The narrow-N core (lut_narrow.cuh) over output pixels x Cout. Warp w
//    owns 8 output pixels of a 64-pixel tile, lane l its Cout columns. At
//    Cout tiles of 32, 64 and 128 every gather instruction reads one table
//    row (a pixel's code) at 32 lanes' weight codes; at 16 (Cout <= 16)
//    the two half-warps walk alternate (tap, group of 4 channels) pairs of
//    the reduction, so they read two table rows at different k. The
//    halves' sums meet by one __shfl_xor before the store.
//  * A work item is one image, or a band of bh output rows of it, times a
//    Cout tile. When the band's codes of every channel fit beside the
//    table (every ResNet-20 conv as a whole image; CNN-224's c1 in bands
//    of output rows) the item holds as many 64-pixel tiles as the band has
//    pixels, so each input pixel is quantized once per item and, with one
//    Cout tile, the weight codes are staged once per block. Otherwise
//    (128 channels at 56^2 and over) an item is one tile of at most 64
//    pixels (bh x bw) walked in steps of cc channels, as kernel 6 walks it
//    (csrc/fused_lut_conv_tiled.cu, whose staging this copies).
//  * Operands as one-byte codes. The item's halo'd band is copied raw
//    (float32, 4-byte cp.async, zero fill outside the image, so those
//    pixels are the reference's quantized 0.0 padding) and quantized once
//    into channel-innermost codes: one 32-bit word per (input pixel, 4
//    channels), one broadcast load per tap, stride or dilation. The weight
//    codes are [tap][channel][Cout tile] bytes (16-byte cp.async, two
//    buffers unless resident). Each step lists its (tap, group of 4
//    channels) pairs once, as a band word offset and a weight byte offset,
//    and a K slice walks every KS-th pair, two at a time. The quantizer is
//    lut_quant.cuh's (__fdiv_rn, rintf, separate __fadd_rn, clamp), the
//    reference's rounding.
//  * The channel pad. C % 4 != 0 (the stem's and c1's C = 3) is padded
//    with the offset code on both sides and taps * c_pad * LUT[off, off]
//    is subtracted in integer space (fused_lut_dense/kernel.py:76's rule).
// The tiling is the wrapper's (kernels/fused_lut_conv/ops.py:
// pick_conv_kernel_tiling, which sizes the shared memory exactly as Layout
// below does); the launch refuses any tiling it was not built for.
// Integer adds are associative, so every tiling gives the reference's
// accumulator bit for bit.
#include "lut_quant.cuh"    // lutgemm::quantize_code
#include "lut_narrow.cuh"

namespace {

using namespace lutnarrow;

constexpr int kTM = 8;                 // output pixels of one warp
constexpr int kPixels = kWarps * kTM;  // output pixels of one tile
constexpr int kSmemLimit = 232448;     // opt-in shared memory of a block

struct Geom {
  int n, c, h, w, cout, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo;
  int n_codes, offset, lo, hi;
  int bh, bw, cc;          // item rows, item columns, channel chunk
  int rows_in, cols_in;    // the halo'd band's input extent
  int c4, cout_pad;        // channels padded to 4, Cout padded to its tiles
  int wbufs;               // 1: the weight codes resident, 2: streamed
  int tiles_h, tiles_w, tiles_n, chunks;
  int tile_px;             // pixel tiles of one item
  int px_rows, px_cols;    // a tile's pixels as whole rows and columns
};

// Shared memory carve-up, the same on host and device (and in the
// wrapper's _conv_smem): the table, the raw band of one step (float), its
// codes (one word per input pixel and 4 channels), the step's (tap, group)
// pairs (band word, weight byte offsets), one or two buffers of weight
// codes.
struct Layout {
  size_t raw, codes, pairs, wts, wbuf, total;
  __host__ __device__ Layout(const Geom& g, int bn) {
    const size_t plane = (size_t)g.rows_in * g.cols_in;
    raw = round_up16((size_t)g.n_codes * g.n_codes * 2);
    codes = raw + round_up16(plane * g.cc * 4);
    pairs = codes + round_up16(plane * g.cc);
    wts = pairs + round_up16((size_t)g.kh * g.kw * (g.cc / 4) * 8);
    wbuf = round_up16((size_t)g.kh * g.kw * g.cc * bn);
    total = wts + g.wbufs * wbuf;
  }
};


template <int BN, bool kEmitAcc>
__global__ void __launch_bounds__(kThreads, 1)
conv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wcodes,
            const int16_t* __restrict__ lut_g, const float* __restrict__ xs_p,
            const float* __restrict__ xz_p, const float* __restrict__ ws,
            void* __restrict__ out_p, Geom g) {
  using LN = Lanes<BN>;
  constexpr int KS = LN::KS, TN = LN::TN;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(g, BN);
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  const uint32_t lut_s = smem_addr(smem);
  float* raw = reinterpret_cast<float*>(smem + L.raw);
  uint32_t* codes = reinterpret_cast<uint32_t*>(smem + L.codes);
  int2* pairs = reinterpret_cast<int2*>(smem + L.pairs);
  uint8_t* wbuf = smem + L.wts;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = g.n_codes, row_bytes = 2 * n;
  const int taps = g.kh * g.kw;
  const int plane = g.rows_in * g.cols_in;
  const int cg = g.cc / 4;            // band words per input pixel
  const size_t hw = (size_t)g.h * g.w;
  const int col = LN::col(lane), half = LN::slice(lane);
  const bool resident = g.wbufs == 1;

  copy_table(lut, lut_g, n, tid);

  const float xs = *xs_p, xz = *xz_p;
  const int zi = static_cast<int>(xz);
  const float lo = static_cast<float>(g.lo), hi = static_cast<float>(g.hi);

  const int n_items = g.n * g.tiles_h * g.tiles_w * g.tiles_n;
  const int my_items =
      blockIdx.x < n_items ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = my_items * g.chunks;

  struct Item { int img, th, tw, tn; };
  auto item_of = [&](int s) {   // Cout tile fastest
    int rest = blockIdx.x + (s / g.chunks) * gridDim.x;
    Item it;
    it.tn = rest % g.tiles_n;
    rest /= g.tiles_n;
    it.tw = rest % g.tiles_w;
    rest /= g.tiles_w;
    it.th = rest % g.tiles_h;
    it.img = rest / g.tiles_h;
    return it;
  };

  // step s's raw band into `raw`; its weight codes into buffer s & 1, or,
  // resident, once into buffer 0
  auto issue = [&](int s) {
    const Item it = item_of(s);
    const int c0 = (s % g.chunks) * g.cc;
    const int ncc = min(g.cc, g.c - c0), ncc4 = min(g.cc, g.c4 - c0);
    const int ih0 = it.th * g.bh * g.sh - g.ph;
    const int iw0 = it.tw * g.bw * g.sw - g.pw;
    const float* xc = x + ((size_t)it.img * g.c + c0) * hw;
    for (int e = tid; e < ncc * plane; e += kThreads) {
      const int ci = e / plane;
      const int r = e - ci * plane;
      const int rr = r / g.cols_in;
      const int ih = ih0 + rr, iw = iw0 + (r - rr * g.cols_in);
      const bool ok = ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
      cp_async4(raw + e, ok ? xc + ci * hw + (size_t)ih * g.w + iw : x,
                ok ? 4 : 0);
    }
    if (resident && s > 0) return;
    uint8_t* wb = wbuf + (resident ? 0 : (s & 1) * L.wbuf);
    const uint8_t* wsrc = wcodes + (size_t)it.tn * BN;
    constexpr int kCopies = BN / 16;    // 16-byte copies of one row
    for (int e = tid; e < taps * ncc4 * kCopies; e += kThreads) {
      const int row = e / kCopies, ch = e - row * kCopies;
      const int t = row / ncc4, ci = row - t * ncc4;
      cp_async16(wb + (t * g.cc + ci) * BN + ch * 16,
                 wsrc + ((size_t)t * g.c4 + c0 + ci) * g.cout_pad + ch * 16,
                 16);
    }
  };

  int acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  if (steps > 0) issue(0);
  cp_commit();
  for (int s = 0; s < steps; ++s) {
    const int chunk = s % g.chunks, c0 = chunk * g.cc;
    const int ncc = min(g.cc, g.c - c0), ng = (min(g.cc, g.c4 - c0)) / 4;
    cp_wait<0>();      // step s's copies (and, first, the table)
    __syncthreads();   // ... for every thread; step s - 1's gathers done
    // raw -> codes: 4 channels of one input pixel a word, the pad
    // channels the offset code
    for (int e = tid; e < ng * plane; e += kThreads) {
      const int gq = e / plane, pix = e - gq * plane;
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int ci = 4 * gq + q;
        int v = g.offset;
        if (ci < ncc)
          v = min(max(lutgemm::quantize_code(raw[ci * plane + pix], xs, xz,
                                             lo, hi) - zi + g.offset,
                      0),
                  n - 1);
        word |= static_cast<uint32_t>(v) << (8 * q);
      }
      codes[pix * cg + gq] = word;
    }
    // the step's (tap, group) pairs in tap-major order: the band word of
    // the tap's window at pixel (0, 0) and the weight codes' byte offset
    const int npairs = taps * ng;
    for (int e = tid; e < npairs; e += kThreads) {
      const int t = e / ng, gq = e - t * ng;
      const int u = t / g.kw, v = t - u * g.kw;
      pairs[e] = make_int2((u * g.dh * g.cols_in + v * g.dw) * cg + gq,
                           (t * g.cc + 4 * gq) * BN);
    }
    __syncthreads();   // the codes are in; the raw band is free
    if (s + 1 < steps) issue(s + 1);
    cp_commit();

    const Item it = item_of(s);
    const uint8_t* wb = wbuf + (resident ? 0 : (s & 1) * L.wbuf) + col;
    // this warp's pixels of the item's first tile, at row p / bw, column
    // p % bw; each later tile is kPixels further
    int prow[kTM], pcol[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int p = warp * kTM + i;
      prow[i] = p / g.bw;
      pcol[i] = p - prow[i] * g.bw;
    }
    for (int tile = 0; tile < g.tile_px; ++tile) {
      // the band word of each pixel's tap (0, 0); pixels past the item's
      // bh x bw are dead (read the band's first word, never stored)
      int pbase[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        pbase[i] = prow[i] < g.bh
                       ? (prow[i] * g.sh * g.cols_in + pcol[i] * g.sw) * cg
                       : 0;
      // this lane's K slice: pairs half, half + KS, ... (unrolled by 2, so
      // that two pairs' gathers are in flight)
#pragma unroll 2
      for (int e = half; e < npairs; e += KS) {
        const int2 pr = pairs[e];
        uint32_t aw[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) aw[i] = codes[pbase[i] + pr.x];
        int b2[4][TN];
        load_b4<TN>(wb + pr.y, BN, b2);
        gather4<kTM, TN, true>(aw, b2, lut_s, row_bytes, kTM, acc);
      }

      if (chunk == g.chunks - 1) {  // the item's last chunk: store it
        sum_slices<KS>(acc);
        if (half == 0) {
          const int corr = taps * (g.c4 - g.c) * lut[g.offset * n + g.offset];
          const int co0 = it.tn * BN + col;
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const int oh = it.th * g.bh + prow[i];
            const int ow = it.tw * g.bw + pcol[i];
            if (prow[i] < g.bh && oh < g.ho && ow < g.wo) {
              const size_t m = ((size_t)it.img * g.ho + oh) * g.wo + ow;
#pragma unroll
              for (int j = 0; j < TN; ++j) {
                const int co = co0 + j;
                if (co >= g.cout) continue;
                const int a = acc[i][j] - corr;
                if (kEmitAcc)
                  static_cast<int*>(out_p)[m * g.cout + co] = a;
                else
                  static_cast<float*>(out_p)[m * g.cout + co] = __fmul_rn(
                      __int2float_rn(a), __fmul_rn(xs, ws[co]));
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = 0;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {   // the next tile's pixels
        prow[i] += g.px_rows;
        pcol[i] += g.px_cols;
        if (pcol[i] >= g.bw) {
          pcol[i] -= g.bw;
          ++prow[i];
        }
      }
    }
  }
  cp_wait<0>();
}

template <int BN, bool kEmitAcc>
int launch_bn(const float* x, const uint8_t* wc, const int16_t* lut,
              const float* xs, const float* xz, const float* ws, void* out,
              const Geom& g, int smem_bytes, int num_blocks,
              cudaStream_t stream) {
  const Layout L(g, BN);
  if (static_cast<size_t>(smem_bytes) != L.total || L.total > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv_kernel<BN, kEmitAcc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items =
      (long long)g.n * g.tiles_h * g.tiles_w * g.tiles_n;
  if (items * g.chunks >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < num_blocks ? items : num_blocks);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(x, wc, lut, xs, xz, ws, out,
                                                 g);
  return static_cast<int>(cudaGetLastError());
}

template <bool kEmitAcc>
int launch_emit(int bn, const float* x, const uint8_t* wc,
                const int16_t* lut, const float* xs, const float* xz,
                const float* ws, void* out, const Geom& g, int smem_bytes,
                int num_blocks, cudaStream_t s) {
  switch (bn) {
    case 16:
      return launch_bn<16, kEmitAcc>(x, wc, lut, xs, xz, ws, out, g,
                                     smem_bytes, num_blocks, s);
    case 32:
      return launch_bn<32, kEmitAcc>(x, wc, lut, xs, xz, ws, out, g,
                                     smem_bytes, num_blocks, s);
    case 64:
      return launch_bn<64, kEmitAcc>(x, wc, lut, xs, xz, ws, out, g,
                                     smem_bytes, num_blocks, s);
    case 128:
      return launch_bn<128, kEmitAcc>(x, wc, lut, xs, xz, ws, out, g,
                                      smem_bytes, num_blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// wcodes: (kh*kw, c4, cout_pad) uint8 weight codes (wq + off), tap-major,
// the channel and Cout pads holding the offset code. The tiling (bh, bw,
// cc, bn, c4, wbufs) is the wrapper's, summed as given: c4 channels in
// steps of cc, taps * (c4 - c) * LUT[off, off] subtracted.
extern "C" int fused_lut_conv_launch(
    const float* x, const uint8_t* wcodes, const int16_t* lut,
    const float* xs, const float* xz, const float* ws, void* out,
    int emit_acc, int n, int c, int h, int w, int cout, int kh, int kw,
    int sh, int sw, int ph, int pw, int dh, int dw, int ho, int wo,
    int n_codes, int offset, int lo, int hi, int bh, int bw, int cc, int bn,
    int c4, int cout_pad, int wbufs, int smem_bytes, int num_blocks,
    void* stream) {
  // the tilings this kernel is built for, and no other
  if (bh < 1 || bw < 1 || cc < 4 || cc % 4 || c4 < 4 || c4 % 4 || bn < 16 ||
      cout_pad % bn || cout_pad < cout || n_codes > 256 ||
      (wbufs != 1 && wbufs != 2) ||
      (reinterpret_cast<uintptr_t>(wcodes) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (c4 + cc - 1) / cc, tiles_n = cout_pad / bn;
  const long long tile_px = ((long long)bh * bw + kPixels - 1) / kPixels;
  // an item of several pixel tiles holds every channel; resident weight
  // codes are the same for every step
  if ((tile_px > 1 && chunks > 1) ||
      (wbufs == 1 && (chunks > 1 || tiles_n > 1)) || tile_px >= (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g{n,  c,  h,  w,  cout, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo,
         n_codes, offset, lo, hi, bh, bw, cc,
         (bh - 1) * sh + (kh - 1) * dh + 1, (bw - 1) * sw + (kw - 1) * dw + 1,
         c4, cout_pad, wbufs, (ho + bh - 1) / bh, (wo + bw - 1) / bw,
         tiles_n, chunks, static_cast<int>(tile_px), kPixels / bw,
         kPixels % bw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emit_acc)
    return launch_emit<true>(bn, x, wcodes, lut, xs, xz, ws, out, g,
                             smem_bytes, num_blocks, s);
  return launch_emit<false>(bn, x, wcodes, lut, xs, xz, ws, out, g,
                            smem_bytes, num_blocks, s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
