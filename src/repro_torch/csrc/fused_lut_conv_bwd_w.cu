// fused_lut_conv_bwd_w: the approximate conv weight gradient,
//
//     acc[t, ci, o] = sum_{n, oh, ow} LUT[qx(n, ci, oh*sh + u*dh - ph,
//                                            ow*sw + v*dw - pw) + off,
//                                         qg(n, oh, ow, o) + off]
//
// with t = u*kw + v (tap-major rows, the reference's layout) and both
// quantizers per-tensor symmetric, clip(round_half_even(v / s), lo, hi).
// An out-of-image tap is code 0 and contributes LUT[off, qg + off], as the
// reference's quantized 0.0 pad does (nonzero for a table with M[0, x] !=
// 0). The output is the raw int32 accumulator; the caller dequants once.
//
// Replaces the Pallas kernel src/repro/kernels/fused_lut_conv/kernel.py
// (fused_lut_conv_bwd_w_kernel), which streamed halo'd input-row bands
// through VMEM, masked band-padding rows with an rmask and carried the
// accumulator across its sequential grid. Its callers: every conv of the
// fused route under approx_bwd (ResNet-20 at batch 128: rows kh*kw*Cin =
// 27..576, Cout 16, 32 or 64, the reduction every output pixel of the
// batch, 8,192 to 131,072).
//
// What bounds it on Hopper: every product is one data-dependent 16-bit
// gather from the int16 table in shared memory (lut_narrow.cuh), one per
// lane per clock at best; the bytes (the image and the gradient, read once)
// are a small fraction of that. The output is a few rows by Cout while the
// reduction is long, so the parallelism has to come from the pixels.
//
// What the design does about it:
//  * Items. An item is a slice of output pixels (a band of bh whole output
//    rows of one image, or of a column strip where a row does not fit), a
//    group of cg input channels with all kh*kw taps, and a Cout tile. The
//    wrapper's tiling (kernels/fused_lut_conv/ops.py: pick_bwd_w_tiling)
//    gives every SM at least two items at ResNet-20's and CNN-224's
//    shapes; each item's int32 partial is added into the zeroed output with
//    atomics (integer adds commute: the reference's bits in any order).
//  * Quantize once per item. The input band the slice's taps reach (halo
//    included, 0.0 outside the image) and the gradient slice (pixels x
//    the Cout tile) land by cp.async as raw float32 while the previous item
//    gathers, and are quantized once into one-byte codes: the band as
//    words of 4 channels of one input pixel, the gradient as words of 4
//    pixels of one column. The tap loop reads the band at shifted offsets
//    (a row list of (tap, 4 channels) word offsets): no divide and no
//    im2col index arithmetic in the gather loop.
//  * Lanes on the narrow-N core's lane map (lut_narrow.cuh): lanes own
//    Cout columns (at Cout tiles of 32 and 64 a warp gathers one table
//    row, an x code, at its 32 lanes' gradient codes; at 16 the two
//    half-warps walk alternate groups of 4 pixels and meet by one
//    __shfl_xor). A warp owns TW row words (4 x TW (tap, channel) rows)
//    and reads one x word per (pixel, row word): one x code per (row,
//    pixel) shared by the warp. Warps split the row words (wr of them) and
//    the item's pixel groups (8 / wr).
//  * Pixels past the slice (a group of 4 that overhangs it) are masked, so
//    they contribute nothing.
//  * rmask (optional, (N, Ho) int32 0/1, the reference's row mask): an
//    output row whose entry is 0 contributes nothing. A zero gradient code
//    would still add LUT[x, off], so masked rows are left out of the sum:
//    each item's pixel list is compacted to the pixels of its live rows
//    (the k-th live row found by a scan of the item's rows) before the
//    gather loop, which then runs as without a mask. The mesh runtime
//    (parallel/acu_shard.py: wrap_conv_bwd_w) masks band-padding rows and
//    padded images with it. Without a mask nothing changes.
#include "lut_narrow.cuh"
#include "lut_quant.cuh"

namespace {

using namespace lutnarrow;

constexpr int kSmemLimit = 232448;   // opt-in shared memory of a block

struct Geom {
  int n, c, h, w, cout, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo;
  int n_codes, offset, lo, hi;
  int bh, bw, tiles_h, tiles_w, cg, c4, tiles_c, tiles_n, wr;
  int rows_in, cols_in, plane, taps, n_words, n_sets, pgroups;
};

// Shared memory carve-up, the same on host and device (and in the
// wrapper's _bwd_w_smem): the table; the raw band ([channel][input pixel]
// float) and the raw gradient slice ([pixel][Cout tile] float) of the next
// item; the band's codes ([channel quad][input pixel] words), the
// gradient's codes ([pixel group][column] words); each pixel's band word
// offset; the row list (int4 a row word).
template <int BN, int TW>
struct Layout {
  size_t raw_x, raw_g, band, gcode, pix, rows, total;
  __host__ __device__ explicit Layout(const Geom& g) {
    const size_t px = (size_t)g.pgroups * 4;
    raw_x = round_up16((size_t)g.n_codes * g.n_codes * 2);
    raw_g = raw_x + round_up16((size_t)g.plane * g.cg * 4);
    band = raw_g + round_up16(px * BN * 4);
    gcode = band + round_up16((size_t)g.plane * g.cg);
    pix = gcode + round_up16((size_t)g.pgroups * BN * 4);
    rows = pix + round_up16(px * 4);
    total = rows + round_up16((size_t)g.n_sets * TW * 16);
  }
};

// One group of 4 pixels at a warp's TW row words, the first `live` pixels
// summed: per pixel one x word (4 channels of one tap) per row word, its 4
// codes gathered at this lane's TN gradient codes. pix: each pixel's band
// word; gcol: the gradient codes' words at this lane's first column.
template <int TW, int TN>
__device__ __forceinline__ void group4(const int* pix, const uint32_t* gcol,
                                       const uint32_t* band,
                                       const int (&roff)[TW], int gi,
                                       int live, int bn, uint32_t lut_s,
                                       int row_bytes, int (&acc)[4 * TW][TN]) {
  const int4 pb4 = *reinterpret_cast<const int4*>(pix + 4 * gi);
  const int pb[4] = {pb4.x, pb4.y, pb4.z, pb4.w};
  int b2[4][TN];
  load_bw<TN>(gcol + gi * bn, b2);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q >= live) continue;
    uint32_t bb[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) bb[j] = lut_s + b2[q][j];
#pragma unroll
    for (int w = 0; w < TW; ++w) {
      const uint32_t aw = band[pb[q] + roff[w]];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t a = __byte_perm(aw, 0u, 0x4440 + i);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[4 * w + i][j] += lds_s16(a * row_bytes + bb[j]);
      }
    }
  }
}

template <int BN, int TW>
__global__ void __launch_bounds__(kThreads, 1)
bwd_w_kernel(const float* __restrict__ x, const float* __restrict__ gr,
             const int16_t* __restrict__ lut_g, const float* __restrict__ sx_p,
             const float* __restrict__ sg_p, const int* __restrict__ rmask,
             int* __restrict__ out, Geom g) {
  using LN = Lanes<BN>;
  constexpr int KS = LN::KS, TN = LN::TN;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<BN, TW> L(g);
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  const uint32_t lut_s = smem_addr(smem);
  float* raw_x = reinterpret_cast<float*>(smem + L.raw_x);
  float* raw_g = reinterpret_cast<float*>(smem + L.raw_g);
  uint32_t* band = reinterpret_cast<uint32_t*>(smem + L.band);
  uint32_t* gcode = reinterpret_cast<uint32_t*>(smem + L.gcode);
  int* pix = reinterpret_cast<int*>(smem + L.pix);
  int4* rows = reinterpret_cast<int4*>(smem + L.rows);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = g.n_codes, off = g.offset, row_bytes = 2 * n;
  const int col = LN::col(lane), half = LN::slice(lane);
  const int wr = g.wr, wrid = warp % wr;
  const int slice = (warp / wr) * KS + half;   // this lane's pixel slice
  const int n_slices = (kWarps / wr) * KS;
  const int plane = g.plane, cgw = g.cg / 4;
  const size_t hw = (size_t)g.h * g.w;
  const float sx = *sx_p, sg = *sg_p;
  const float lo = static_cast<float>(g.lo), hi = static_cast<float>(g.hi);
  const bool vec_g = g.cout % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(gr) & 15) == 0;

  copy_table(lut, lut_g, n, tid);

  const int items = g.n * g.tiles_h * g.tiles_w * g.tiles_c * g.tiles_n;
  struct Item { int img, oh0, ow0, nb, nw, c0, co0; };
  auto item_of = [&](int it) {  // Cout tile fastest
    Item r;
    int rest = it;
    r.co0 = (rest % g.tiles_n) * BN;
    rest /= g.tiles_n;
    r.c0 = (rest % g.tiles_c) * g.cg;
    rest /= g.tiles_c;
    r.ow0 = (rest % g.tiles_w) * g.bw;
    rest /= g.tiles_w;
    r.oh0 = (rest % g.tiles_h) * g.bh;
    r.img = rest / g.tiles_h;
    r.nb = min(g.bh, g.ho - r.oh0);
    r.nw = min(g.bw, g.wo - r.ow0);
    return r;
  };

  // item it's raw band (0.0 outside the image and past C) and raw gradient
  // slice (0.0 past the slice and past Cout)
  auto issue = [&](const Item& r) {
    const int ih0 = r.oh0 * g.sh - g.ph, iw0 = r.ow0 * g.sw - g.pw;
    for (int e = tid; e < g.cg * plane; e += kThreads) {
      const int ci = e / plane, p = e - ci * plane;
      const int lr = p / g.cols_in;
      const int ih = ih0 + lr, iw = iw0 + p - lr * g.cols_in;
      const int ch = r.c0 + ci;
      const bool ok = ch < g.c && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
      cp_async4(raw_x + e,
                ok ? x + ((size_t)r.img * g.c + ch) * hw + (size_t)ih * g.w +
                         iw
                   : x,
                ok ? 4 : 0);
    }
    const int P = max(r.nb, 0) * r.nw;
    const int px = g.pgroups * 4;
    if (vec_g) {
      for (int e = tid; e < px * (BN / 4); e += kThreads) {
        const int p = e / (BN / 4), q4 = (e - p * (BN / 4)) * 4;
        const int oh = r.oh0 + p / max(r.nw, 1), ow = r.ow0 + p % max(r.nw, 1);
        const bool ok = p < P && r.co0 + q4 < g.cout;
        cp_async16(raw_g + p * BN + q4,
                   ok ? gr + (((size_t)r.img * g.ho + oh) * g.wo + ow) *
                                 g.cout + r.co0 + q4
                      : gr,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < px * BN; e += kThreads) {
        const int p = e / BN, o = e - p * BN;
        const int oh = r.oh0 + p / max(r.nw, 1), ow = r.ow0 + p % max(r.nw, 1);
        const bool ok = p < P && r.co0 + o < g.cout;
        cp_async4(raw_g + e,
                  ok ? gr + (((size_t)r.img * g.ho + oh) * g.wo + ow) *
                                g.cout + r.co0 + o
                     : gr,
                  ok ? 4 : 0);
      }
    }
  };

  if (blockIdx.x < items) issue(item_of(blockIdx.x));
  cp_commit();
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Item r = item_of(it);
    cp_wait<0>();      // this item's raw operands (and, first, the table)
    __syncthreads();   // ... for every thread; the last item's gathers done
    // the item's live output rows (all of them without a mask); pixel c of
    // the compacted list is raw slice pixel src(c)
    const int* rm = rmask != nullptr ? rmask + (size_t)r.img * g.ho + r.oh0
                                     : nullptr;
    int n_live = max(r.nb, 0);
    if (rm != nullptr) {
      n_live = 0;
      for (int rr = 0; rr < r.nb; ++rr) n_live += rm[rr] != 0;
    }
    auto src = [&](int c) {
      if (rm == nullptr) return c;
      int k = c / r.nw, rr = 0;
      for (;; ++rr)
        if (rm[rr] != 0 && k-- == 0) break;
      return rr * r.nw + c % r.nw;
    };
    const int P = n_live * r.nw;
    const int pg = (P + 3) / 4;
    // the band's codes: word (cq, p) = channels 4cq .. 4cq + 3 of input
    // pixel p; outside the image code 0 (the table row off), past C off
    const int ih0 = r.oh0 * g.sh - g.ph, iw0 = r.ow0 * g.sw - g.pw;
    for (int e = tid; e < cgw * plane; e += kThreads) {
      const int cq = e / plane, p = e - cq * plane;
      const int lr = p / g.cols_in;
      const int ih = ih0 + lr, iw = iw0 + p - lr * g.cols_in;
      const bool inside = ih >= 0 && ih < g.h && iw >= 0 && iw < g.w;
      uint32_t word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t code =
            inside && r.c0 + 4 * cq + i < g.c
                ? lutgemm::symmetric_index(raw_x[(4 * cq + i) * plane + p],
                                           sx, lo, hi, off, n)
                : static_cast<uint32_t>(off);
        word |= code << (8 * i);
      }
      band[e] = word;
    }
    // the gradient's codes: word (group, o) = pixels 4 group .. + 3 of
    // column o; past the slice and past Cout off (never summed or stored)
    for (int e = tid; e < pg * BN; e += kThreads) {
      const int gp = e / BN, o = e - gp * BN;
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t code =
            4 * gp + q < P && r.co0 + o < g.cout
                ? lutgemm::symmetric_index(raw_g[src(4 * gp + q) * BN + o],
                                           sg, lo, hi, off, n)
                : static_cast<uint32_t>(off);
        word |= code << (8 * q);
      }
      gcode[e] = word;
    }
    // each pixel's band word at tap (0, 0), channel quad 0
    for (int p = tid; p < pg * 4; p += kThreads) {
      const int ps = p < P ? src(p) : 0;
      const int rr = ps / max(r.nw, 1);
      pix[p] = p < P ? rr * g.sh * g.cols_in + (ps - rr * r.nw) * g.sw : 0;
    }
    // the row list: entry e = cq * taps + t -> (band word offset of the
    // tap's window, output row t * C + c, first channel c); dead entries
    // name a channel past C and are never stored
    for (int e = tid; e < g.n_sets * TW; e += kThreads) {
      if (e < g.n_words) {
        const int cq = e / g.taps, t = e - cq * g.taps;
        const int u = t / g.kw, v = t - u * g.kw;
        const int ch = r.c0 + 4 * cq;
        rows[e] = make_int4(cq * plane + u * g.dh * g.cols_in + v * g.dw,
                            t * g.c + ch, ch, 0);
      } else {
        rows[e] = make_int4(0, 0, g.c, 0);
      }
    }
    __syncthreads();   // the codes are in; the raw buffers are free
    if (it + gridDim.x < items) issue(item_of(it + gridDim.x));
    cp_commit();

    const int full = P / 4, live_tail = P - 4 * full;
    for (int set = wrid; set < g.n_sets; set += wr) {
      int roff[TW];
#pragma unroll
      for (int w = 0; w < TW; ++w) roff[w] = rows[set * TW + w].x;
      int acc[4 * TW][TN];
#pragma unroll
      for (int i = 0; i < 4 * TW; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0;
      for (int gi = slice; gi < full; gi += n_slices)
        group4<TW, TN>(pix, gcode + col, band, roff, gi, 4, BN, lut_s,
                       row_bytes, acc);
      if (live_tail && full % n_slices == slice)
        group4<TW, TN>(pix, gcode + col, band, roff, full, live_tail, BN,
                       lut_s, row_bytes, acc);
      sum_slices<KS>(acc);
      if (half == 0) {
#pragma unroll
        for (int w = 0; w < TW; ++w) {
          const int4 rl = rows[set * TW + w];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (rl.z + i >= g.c) continue;
            int* dst = out + (size_t)(rl.y + i) * g.cout;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const int co = r.co0 + col + j;
              if (co < g.cout) atomicAdd(dst + co, acc[4 * w + i][j]);
            }
          }
        }
      }
    }
  }
  cp_wait<0>();
}

template <int BN, int TW>
int launch(const float* x, const float* gr, const int16_t* lut,
           const float* sx, const float* sg, const int* rmask, int* out,
           const Geom& g, int smem_bytes, int num_blocks,
           cudaStream_t stream) {
  const Layout<BN, TW> L(g);
  if (static_cast<size_t>(smem_bytes) != L.total || L.total > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = bwd_w_kernel<BN, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = (long long)g.n * g.tiles_h * g.tiles_w *
                          g.tiles_c * g.tiles_n;
  if (items >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < num_blocks ? items : num_blocks);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(x, gr, lut, sx, sg, rmask,
                                                 out, g);
  return static_cast<int>(cudaGetLastError());
}

template <int TW>
int launch_bn(int bn, const float* x, const float* gr, const int16_t* lut,
              const float* sx, const float* sg, const int* rmask, int* out,
              const Geom& g, int smem_bytes, int num_blocks, cudaStream_t s) {
  switch (bn) {
    case 16:
      return launch<16, TW>(x, gr, lut, sx, sg, rmask, out, g, smem_bytes,
                            num_blocks, s);
    case 32:
      return launch<32, TW>(x, gr, lut, sx, sg, rmask, out, g, smem_bytes,
                            num_blocks, s);
    case 64:
      return launch<64, TW>(x, gr, lut, sx, sg, rmask, out, g, smem_bytes,
                            num_blocks, s);
    default:
      break;
  }
  if constexpr (TW == 4)
    if (bn == 128)
      return launch<128, 4>(x, gr, lut, sx, sg, rmask, out, g, smem_bytes,
                            num_blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// out: the zeroed (kh*kw, c, cout) int32 accumulator; rmask: null, or
// (n, ho) int32, a 0 leaving that output row out. The tiling (bands of
// bh output rows, tiles_h of them; column strips of bw; cg channels an
// item, c4 channels in all; Cout tiles of bn; tw row words a warp, wr warps
// across the row words) is the wrapper's, run as given: an item past the
// image (tiles_h too large) adds nothing, tiles_h too small leaves bands
// out. The launch refuses a tiling it is not built for.
extern "C" int fused_lut_conv_bwd_w_launch(
    const float* x, const float* g, const int16_t* lut, const float* sx,
    const float* sg, const int* rmask, int* out, int n, int c, int h, int w,
    int cout, int kh,
    int kw, int sh, int sw, int ph, int pw, int dh, int dw, int ho, int wo,
    int n_codes, int offset, int lo, int hi, int bh, int bw, int tiles_h,
    int cg, int c4, int bn, int tw, int wr, int smem_bytes, int num_blocks,
    void* stream) {
  if (bh < 1 || bw < 1 || bw > wo || tiles_h < 1 || cg < 4 || cg % 4 ||
      c4 < 4 || c4 % 4 || n_codes > 256 || (tw != 4 && tw != 9) ||
      (wr != 1 && wr != 2 && wr != 4 && wr != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int taps = kh * kw;
  const int n_words = taps * cg / 4;
  Geom geo{n, c, h, w, cout, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo,
           n_codes, offset, lo, hi, bh, bw, tiles_h, (wo + bw - 1) / bw, cg,
           c4, (c4 + cg - 1) / cg, (cout + bn - 1) / bn, wr,
           (bh - 1) * sh + (kh - 1) * dh + 1, (bw - 1) * sw + (kw - 1) * dw + 1,
           0, taps, n_words, (n_words + tw - 1) / tw, (bh * bw + 3) / 4};
  geo.plane = geo.rows_in * geo.cols_in;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tw == 9)
    return launch_bn<9>(bn, x, g, lut, sx, sg, rmask, out, geo, smem_bytes,
                        num_blocks, s);
  return launch_bn<4>(bn, x, g, lut, sx, sg, rmask, out, geo, smem_bytes,
                      num_blocks, s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
