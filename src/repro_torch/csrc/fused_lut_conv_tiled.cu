// fused_lut_conv_tiled: approximate conv2d forward over halo'd bands of
// output pixels, quantize and dequant fused,
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
// What bounds it on Hopper: every product is one data-dependent 16-bit
// gather from the int16 product table in shared memory (128 KiB at 8
// bits), so the ceiling is one gather per lane per clock, 132 SMs x 32
// lanes; the bytes (the image, the output) take a fraction of that time.
//
// The design (the dense GEMM's, csrc/fused_lut_dense.cu, carried to a
// conv). A work item is one image, one tile of bh output rows x bw output
// columns (at most 64 pixels) and one Cout tile of 32 * TN channels;
// blocks are persistent and walk the items Cout tile fastest, so
// neighbouring blocks read the same input rows from L2.
//  * One table row per warp instruction. Warp w owns 8 of the tile's
//    pixels and all 32 * TN channels, lane l the TN consecutive channels
//    l * TN + j. At each (pixel, channel, tap) all 32 lanes gather from the
//    same table row, the pixel's code, at their own weight codes, so what
//    is left of bank conflicts is the collisions among one row's 32 codes
//    (a warp of 16 channels x 2 pixels read two rows at the same 16 codes:
//    a conflict on every gather).
//  * One shared-memory instruction per lookup. The halo'd band's codes are
//    staged channel innermost, one 32-bit word per (input pixel, group of 4
//    channels), so one broadcast load gives the 4 channels of one pixel
//    for any tap, stride or dilation; the weight codes are staged as
//    [tap][channel][Cout tile] bytes, so a lane's TN codes are one 8-, 16-
//    or 32-bit load; the byte address a * 2n + 2b is formed in registers.
//    The inner loop is one add, one 16-bit gather and one accumulate per
//    product.
//  * The channel pad. A channel count that is not a multiple of 4 is
//    padded with the offset code on both sides (the wrapper pads the
//    weight codes; the band's pad channels are written as the offset), and
//    taps * c_pad * LUT[off, off] is subtracted in integer space, the
//    reference's rule for its K pad (fused_lut_dense/kernel.py:76).
//  * Overlapped staging. The steps of a block are (item, chunk of cc
//    channels). A step's raw band (float32, [channel][row][column] as the
//    NCHW image lies, 4-byte cp.async, zero fill outside the image) and its
//    weight codes (16-byte cp.async, two buffers) are copied while the
//    previous step is gathered; the raw band is quantized once per item
//    with the quantizer of kernels 2, 3 and 5 (__fdiv_rn, rintf, clamp) in
//    one pass between two barriers, and is then free for the next step's
//    copy. The table is copied once per block with 16-byte cp.async.
//  * Pixels outside the image (SAME padding, the halo past the last row or
//    column) are copied as 0.0 and quantized, the reference's quantized
//    0.0 padding. Pixels of a tile past Ho or Wo are computed and not
//    stored.
// The tiling (bh, bw, cc, TN) is the wrapper's
// (kernels/fused_lut_conv/ops.py: pick_tiled_kernel_tiling, which sizes
// the shared memory exactly as Layout below does); the launch refuses any
// tiling it was not built for. Integer adds are associative, so every
// tiling gives the reference's accumulator bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;                 // output pixels of one warp
constexpr int kPixels = kWarps * kTM;  // output pixels of one tile
constexpr int kSmemLimit = 232448;     // opt-in shared memory of a block

__host__ __device__ inline size_t round_up16(size_t bytes) {
  return (bytes + 15) & ~size_t(15);
}

struct Geom {
  int n, c, h, w, cout, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo;
  int n_codes, offset, lo, hi;
  int bh, bw, cc;          // tile rows, tile columns, channel chunk
  int rows_in, cols_in;    // the halo'd band's input extent
  int c4, cout_pad;        // channels padded to 4, Cout padded to its tiles
  int tiles_h, tiles_w, tiles_n, chunks;
};

// Shared memory carve-up, the same on host and device (and in the
// wrapper's _tiled_smem): the table, the raw band of one chunk (float),
// its codes (one word per input pixel and 4 channels), two buffers of
// weight codes.
struct Layout {
  size_t raw, codes, wts, wbuf, total;
  __host__ __device__ Layout(const Geom& g, int bn) {
    const size_t plane = (size_t)g.rows_in * g.cols_in;
    raw = round_up16((size_t)g.n_codes * g.n_codes * 2);
    codes = raw + round_up16(plane * g.cc * 4);
    wts = codes + round_up16(plane * g.cc);
    wbuf = round_up16((size_t)g.kh * g.kw * g.cc * bn);
    total = wts + 2 * wbuf;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
// cp.async with zero fill: src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The activation quantizer of kernels 2, 3 and 5, rounded exactly as the
// reference: clip(round_half_even(x / xs + xz), lo, hi), a correctly
// rounded divide and a separately rounded add (no contraction, no fast
// math).
__device__ __forceinline__ int quantize_code(float x, float xs, float xz,
                                             float lo, float hi) {
  float q = rintf(__fadd_rn(__fdiv_rn(x, xs), xz));
  q = fminf(fmaxf(q, lo), hi);
  return static_cast<int>(q);
}

// TN weight codes of one (tap, channel) row, as byte offsets 2b
template <int TN>
__device__ __forceinline__ void load_b(const uint8_t* row, int (&b2)[TN]) {
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

template <int TN, bool kEmitAcc>
__global__ void __launch_bounds__(kThreads, 1)
tiled_kernel(const float* __restrict__ x, const uint8_t* __restrict__ wcodes,
             const int16_t* __restrict__ lut_g, const float* __restrict__ xs_p,
             const float* __restrict__ xz_p, const float* __restrict__ ws,
             void* __restrict__ out_p, Geom g) {
  constexpr int BN = 32 * TN;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(g, BN);
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  const char* lut_b = reinterpret_cast<const char*>(smem);
  float* raw = reinterpret_cast<float*>(smem + L.raw);
  uint32_t* codes = reinterpret_cast<uint32_t*>(smem + L.codes);
  uint8_t* wbuf = smem + L.wts;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = g.n_codes, row_bytes = 2 * n;
  const int taps = g.kh * g.kw;
  const int plane = g.rows_in * g.cols_in;
  const int cg = g.cc / 4;            // band words per input pixel
  const size_t hw = (size_t)g.h * g.w;

  // the table, 16 bytes a copy where it is aligned (the first group)
  {
    const int bytes = n * n * 2;
    const char* src = reinterpret_cast<const char*>(lut_g);
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && bytes % 16 == 0) {
      for (int i = tid * 16; i < bytes; i += kThreads * 16)
        cp_async16(smem + i, src + i);
    } else {
      for (int i = tid; i < n * n; i += kThreads) lut[i] = lut_g[i];
    }
    cp_commit();
  }

  const float xs = *xs_p, xz = *xz_p;
  const int zi = static_cast<int>(xz);
  const float lo = static_cast<float>(g.lo), hi = static_cast<float>(g.hi);

  // this warp's pixels: band word of their tap (0, 0); pixels past the
  // tile's bh x bw are dead (read the band's first word, never stored)
  int pbase[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int p = warp * kTM + i, pr = p / g.bw, pc = p - pr * g.bw;
    pbase[i] = pr < g.bh ? (pr * g.sh * g.cols_in + pc * g.sw) * cg : 0;
  }

  const int n_items = g.n * g.tiles_h * g.tiles_w * g.tiles_n;
  const int my_items =
      blockIdx.x < n_items ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = my_items * g.chunks;

  struct Item { int img, th, tw, tn; };
  auto item_of = [&](int s) {
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

  // step s's raw band into `raw` and its weight codes into buffer s & 1
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
    uint8_t* wb = wbuf + (s & 1) * L.wbuf;
    const uint8_t* wsrc = wcodes + (size_t)it.tn * BN;
    constexpr int kCopies = BN / 16;    // 16-byte copies of one row
    for (int e = tid; e < taps * ncc4 * kCopies; e += kThreads) {
      const int row = e / kCopies, ch = e - row * kCopies;
      const int t = row / ncc4, ci = row - t * ncc4;
      cp_async16(wb + (t * g.cc + ci) * BN + ch * 16,
                 wsrc + ((size_t)t * g.c4 + c0 + ci) * g.cout_pad + ch * 16);
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
    cp_wait_all();     // step s's copies (and, first, the table)
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
          v = min(max(quantize_code(raw[ci * plane + pix], xs, xz, lo, hi) -
                          zi + g.offset,
                      0),
                  n - 1);
        word |= static_cast<uint32_t>(v) << (8 * q);
      }
      codes[pix * cg + gq] = word;
    }
    __syncthreads();   // the codes are in; the raw band is free
    if (s + 1 < steps) issue(s + 1);
    cp_commit();

    const uint8_t* wb = wbuf + (s & 1) * L.wbuf + lane * TN;
    for (int t = 0; t < taps; ++t) {
      const int u = t / g.kw, v = t - u * g.kw;
      const int toff = (u * g.dh * g.cols_in + v * g.dw) * cg;
      const uint8_t* wt = wb + t * g.cc * BN;
      for (int gq = 0; gq < ng; ++gq) {
        uint32_t aw[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) aw[i] = codes[pbase[i] + toff + gq];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          int b2[TN];
          load_b<TN>(wt + (4 * gq + q) * BN, b2);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const int ab = static_cast<int>((aw[i] >> (8 * q)) & 0xff) *
                           row_bytes;
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] +=
                  *reinterpret_cast<const int16_t*>(lut_b + ab + b2[j]);
          }
        }
      }
    }

    if (chunk == g.chunks - 1) {  // the item's last chunk: store it
      const Item it = item_of(s);
      const int corr = taps * (g.c4 - g.c) * lut[g.offset * n + g.offset];
      const int co0 = it.tn * BN + lane * TN;
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int p = warp * kTM + i, pr = p / g.bw, pc = p - pr * g.bw;
        const int oh = it.th * g.bh + pr, ow = it.tw * g.bw + pc;
        if (pr < g.bh && oh < g.ho && ow < g.wo) {
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
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0;
      }
    }
  }
  cp_wait_all();
}

template <int TN, bool kEmitAcc>
int launch_tn(const float* x, const uint8_t* wc, const int16_t* lut,
              const float* xs, const float* xz, const float* ws, void* out,
              const Geom& g, int smem_bytes, int num_blocks,
              cudaStream_t stream) {
  const Layout L(g, 32 * TN);
  if (static_cast<size_t>(smem_bytes) != L.total || L.total > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tiled_kernel<TN, kEmitAcc>;
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
int launch_emit(int tn, const float* x, const uint8_t* wc,
                const int16_t* lut, const float* xs, const float* xz,
                const float* ws, void* out, const Geom& g, int smem_bytes,
                int num_blocks, cudaStream_t s) {
  switch (tn) {
    case 1:
      return launch_tn<1, kEmitAcc>(x, wc, lut, xs, xz, ws, out, g,
                                    smem_bytes, num_blocks, s);
    case 2:
      return launch_tn<2, kEmitAcc>(x, wc, lut, xs, xz, ws, out, g,
                                    smem_bytes, num_blocks, s);
    case 4:
      return launch_tn<4, kEmitAcc>(x, wc, lut, xs, xz, ws, out, g,
                                    smem_bytes, num_blocks, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// wcodes: (kh*kw, c4, cout_pad) uint8 weight codes (wq + off), tap-major,
// the channel and Cout pads holding the offset code. The tiling (bh, bw,
// cc, tn, c4) is the wrapper's, summed as given: c4 channels in steps of
// cc, taps * (c4 - c) * LUT[off, off] subtracted.
extern "C" int fused_lut_conv_tiled_launch(
    const float* x, const uint8_t* wcodes, const int16_t* lut,
    const float* xs, const float* xz, const float* ws, void* out,
    int emit_acc, int n, int c, int h, int w, int cout, int kh, int kw,
    int sh, int sw, int ph, int pw, int dh, int dw, int ho, int wo,
    int n_codes, int offset, int lo, int hi, int bh, int bw, int cc, int tn,
    int c4, int cout_pad, int smem_bytes, int num_blocks, void* stream) {
  const int bn = 32 * tn;
  // the tilings this kernel is built for, and no other
  if (bh < 1 || bw < 1 || bh * bw > kPixels || cc < 4 || cc % 4 || c4 < 4 ||
      c4 % 4 ||
      cout_pad % bn || cout_pad < cout || n_codes > 256 ||
      (reinterpret_cast<uintptr_t>(wcodes) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g{n,  c,  h,  w,  cout, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo,
         n_codes, offset, lo, hi, bh, bw, cc,
         (bh - 1) * sh + (kh - 1) * dh + 1, (bw - 1) * sw + (kw - 1) * dw + 1,
         c4, cout_pad, (ho + bh - 1) / bh, (wo + bw - 1) / bw,
         cout_pad / bn, (c4 + cc - 1) / cc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emit_acc)
    return launch_emit<true>(tn, x, wcodes, lut, xs, xz, ws, out, g,
                             smem_bytes, num_blocks, s);
  return launch_emit<false>(tn, x, wcodes, lut, xs, xz, ws, out, g,
                            smem_bytes, num_blocks, s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
