// fused_lut_conv_bwd_w: the approximate conv weight gradient as a split-K
// LUT-gather GEMM over the output pixels of the whole batch,
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
// through VMEM, masked band-padding rows with an rmask, and carried the
// accumulator across its sequential grid. Here the GEMM rows are the
// kh*kw*Cin (tap, channel) pairs, the columns Cout, and the reduction runs
// over the N*Ho*Wo output pixels, staged straight from the unpadded NCHW
// image (transposed implicit im2col) and the NHWC gradient, so there are
// no bands and no padded rows to mask.
//
// Bound: the shared-memory gather rate, as for every LUT GEMM
// (lut_gemm.cuh). The trouble is parallelism: the output is at most a few
// tiles (576 x 64 ints for a 64-channel 3x3 conv) while the contraction is
// long (131,072 pixels for a 32x32 conv at batch 128), so one tile per
// block would leave 1 to 9 of 132 SMs busy. The kernel therefore splits
// the pixels into slices (about two work items per SM), sums each slice in
// registers and adds the partial tile into the zeroed output with int32
// atomics. Integer adds commute, so the result is bitwise the reference's
// in any order, and the same from run to run.
#include "lut_gemm.cuh"

namespace {

struct ConvBwdWLoader {
  const float* x;
  const float* sx;
  int M, K, n_codes, offset;
  float lo, hi;
  int c, h, w, kw, sh, sw, ph, pw, dh, dw, wo, hw_out;

  // per tile: channel offset, row tap offset, column tap offset of each
  // (tap, channel) row; per chunk: image base, first input row, first
  // input column of each output pixel
  static constexpr int scratch_bytes(int bm) {
    return 3 * bm * 4 + 3 * lutgemm::kBK * 4;
  }

  __device__ void begin_tile(int m0, int* scratch, int bm, int tid) const {
    int* rc = scratch;
    int* rdh = scratch + bm;
    int* rdw = scratch + 2 * bm;
    for (int mi = tid; mi < bm; mi += lutgemm::kThreads) {
      const int m = m0 + mi;
      if (m < M) {
        const int t = m / c;
        const int ci = m - t * c;
        const int u = t / kw;
        rc[mi] = ci * h * w;
        rdh[mi] = u * dh - ph;
        rdw[mi] = (t - u * kw) * dw - pw;
      } else {
        rc[mi] = -1;
        rdh[mi] = 0;
        rdw[mi] = 0;
      }
    }
  }

  __device__ void stage(int* As, int a_stride, int, int k0, int* scratch,
                        int bm, int tid) const {
    const int* rc = scratch;
    const int* rdh = scratch + bm;
    const int* rdw = scratch + 2 * bm;
    int* pb = scratch + 3 * bm;
    int* pih = pb + lutgemm::kBK;
    int* piw = pih + lutgemm::kBK;
    if (tid < lutgemm::kBK) {
      const int p = k0 + tid;
      if (p < K) {
        const int n = p / hw_out;
        const int r = p - n * hw_out;
        const int oh = r / wo;
        pb[tid] = n * c * h * w;
        pih[tid] = oh * sh;
        piw[tid] = (r - oh * wo) * sw;
      } else {
        pb[tid] = -1;
        pih[tid] = 0;
        piw[tid] = 0;
      }
    }
    __syncthreads();

    const float s = *sx;
    // consecutive threads take consecutive output pixels of one row: their
    // input columns are sw apart, close to coalesced
    for (int e = tid; e < bm * lutgemm::kBK; e += lutgemm::kThreads) {
      const int mi = e / lutgemm::kBK, ki = e % lutgemm::kBK;
      int v = offset;
      const int cofs = rc[mi];
      const int b = pb[ki];
      if (cofs >= 0 && b >= 0) {
        const int ih = pih[ki] + rdh[mi];
        const int iw = piw[ki] + rdw[mi];
        if (ih >= 0 && ih < h && iw >= 0 && iw < w)
          v = lutgemm::quantize_symmetric(
              __ldg(x + (size_t)b + cofs + ih * w + iw), s, lo, hi) + offset;
      }
      As[ki * a_stride + mi] = min(max(v, 0), n_codes - 1) * n_codes;
    }
  }
};

}  // namespace

extern "C" int fused_lut_conv_bwd_w_launch(
    const float* x, const float* g, const int16_t* lut, const float* sx,
    const float* sg, int* out, int n, int c, int h, int w, int cout, int kh,
    int kw, int sh, int sw, int ph, int pw, int dh, int dw, int ho, int wo,
    int n_codes, int offset, int lo, int hi, int num_blocks, void* stream) {
  const int M = kh * kw * c;      // (tap, channel) rows
  const int K = n * ho * wo;      // output pixels
  const float flo = static_cast<float>(lo), fhi = static_cast<float>(hi);
  ConvBwdWLoader load{x,  sx, M,  K,  n_codes, offset, flo, fhi, c,
                      h,  w,  kw, sh, sw, ph, pw, dh, dw, wo, ho * wo};
  lutgemm::SymBLoader bload{g, sg, K, cout, n_codes, offset, flo, fhi};
  lutgemm::StoreAtomicAdd store{out, cout};
  const int k_split = lutgemm::split_k(M, K, cout, num_blocks);
  return lutgemm::launch(load, bload, store, lut, n_codes, M, K, cout,
                         num_blocks, static_cast<cudaStream_t>(stream),
                         k_split);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
