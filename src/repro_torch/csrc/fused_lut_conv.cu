// fused_lut_conv: approximate conv2d forward as an implicit-im2col
// LUT-gather GEMM, quantize and dequant fused,
//
//     out[n, oh, ow, co] = float(acc) * (xs * ws[co])    (or acc, emit_acc)
//     acc = sum_{c,u,v} LUT[q(x[n, c, oh*sh - ph + u*dh, ow*sw - pw + v*dw])
//                           - (int)xz + off, wq[c,u,v ; co] + off]
//
// Replaces the whole-image Pallas kernel
// src/repro/kernels/fused_lut_conv/kernel.py (fused_lut_conv_kernel), which
// kept one padded image resident in VMEM and looped over kh*kw tap windows.
// On Hopper the GEMM rows are the output pixels of the whole batch
// (m = (n, oh, ow)) and the reduction runs over k = (c, u, v), the same
// channel-major order as the im2col reference; the patch tensor never
// exists in device memory. Each output tile stages its patch entries
// straight from the NCHW image, quantizing each staged pixel on the fly.
// A pixel outside the image gets the zero-point code, i.e. table row
// `off`, exactly what the reference's quantized 0.0 padding gives, so SAME
// padding needs no correction. Channels are not padded, so there is no
// c_pad correction either. The output tile spans whole batch rows, so tile
// occupancy does not depend on the image size: the kernel needs no spatial
// tiling and no VMEM-style residency limit.
//
// Bound: the shared-memory gather rate, as for every LUT GEMM
// (lut_gemm.cuh). Per tile the kernel precomputes each output row's image
// base and input origin once, and each staged chunk's (c, u, v) offsets
// once, so staging a patch entry costs two adds, a bounds test and one
// quantize.
#include "lut_gemm.cuh"

namespace {

struct ConvLoader {
  const float* x;
  const float* xs;
  const float* xz;
  int M, K, n_codes, offset;
  float lo, hi;
  int c, h, w, kh, kw, sh, sw, ph, pw, dh, dw, ho, wo;

  // per tile: image base, first input row, first input column of each
  // output row; per chunk: channel offset, row tap, column tap of each k
  static constexpr int scratch_bytes(int bm) {
    return 3 * bm * 4 + 3 * lutgemm::kBK * 4;
  }

  __device__ void begin_tile(int m0, int* scratch, int bm, int tid) const {
    int* base = scratch;
    int* ih0 = scratch + bm;
    int* iw0 = scratch + 2 * bm;
    const int hw_out = ho * wo;
    for (int mi = tid; mi < bm; mi += lutgemm::kThreads) {
      const int m = m0 + mi;
      if (m < M) {
        const int n = m / hw_out;
        const int p = m - n * hw_out;
        const int oh = p / wo;
        const int ow = p - oh * wo;
        base[mi] = n * c * h * w;
        ih0[mi] = oh * sh - ph;
        iw0[mi] = ow * sw - pw;
      } else {
        base[mi] = -1;
        ih0[mi] = 0;
        iw0[mi] = 0;
      }
    }
  }

  __device__ void stage(int* As, int a_stride, int m0, int k0, int* scratch,
                        int bm, int tid) const {
    const int* base = scratch;
    const int* ih0 = scratch + bm;
    const int* iw0 = scratch + 2 * bm;
    int* kc = scratch + 3 * bm;
    int* kdh = kc + lutgemm::kBK;
    int* kdw = kdh + lutgemm::kBK;
    const int taps = kh * kw;
    if (tid < lutgemm::kBK) {
      const int k = k0 + tid;
      if (k < K) {
        const int ci = k / taps;
        const int t = k - ci * taps;
        const int u = t / kw;
        kc[tid] = ci * h * w;
        kdh[tid] = u * dh;
        kdw[tid] = (t - u * kw) * dw;
      } else {
        kc[tid] = -1;
        kdh[tid] = 0;
        kdw[tid] = 0;
      }
    }
    __syncthreads();

    const float s = *xs, z = *xz;
    const int zi = static_cast<int>(z);
    // consecutive threads take consecutive output pixels of one k: their
    // input columns are sw apart, close to coalesced
    for (int e = tid; e < bm * lutgemm::kBK; e += lutgemm::kThreads) {
      const int ki = e / bm, mi = e % bm;
      int v = offset;
      const int b = base[mi];
      const int cofs = kc[ki];
      if (b >= 0 && cofs >= 0) {
        const int ih = ih0[mi] + kdh[ki];
        const int iw = iw0[mi] + kdw[ki];
        if (ih >= 0 && ih < h && iw >= 0 && iw < w)
          v = lutgemm::quantize_code(x[(size_t)b + cofs + ih * w + iw], s, z,
                                     lo, hi) - zi + offset;
      }
      As[ki * a_stride + mi] = min(max(v, 0), n_codes - 1) * n_codes;
    }
  }
};

}  // namespace

extern "C" int fused_lut_conv_launch(
    const float* x, const int* wq, const int16_t* lut, const float* xs,
    const float* xz, const float* ws, void* out, int emit_acc, int n, int c,
    int h, int w, int cout, int kh, int kw, int sh, int sw, int ph, int pw,
    int dh, int dw, int ho, int wo, int n_codes, int offset, int lo, int hi,
    int num_blocks, void* stream) {
  const int M = n * ho * wo;
  const int K = c * kh * kw;
  ConvLoader load{x,  xs, xz, M,  K,  n_codes, offset, static_cast<float>(lo),
                  static_cast<float>(hi), c, h, w, kh, kw, sh, sw, ph, pw,
                  dh, dw, ho, wo};
  lutgemm::CodeBLoader bload{wq, K, cout, n_codes, offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emit_acc) {
    lutgemm::StoreInt store{static_cast<int*>(out), cout};
    return lutgemm::launch(load, bload, store, lut, n_codes, M, K, cout,
                           num_blocks, s);
  }
  lutgemm::StoreDequant store{static_cast<float*>(out), xs, ws, cout};
  return lutgemm::launch(load, bload, store, lut, n_codes, M, K, cout,
                         num_blocks, s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
