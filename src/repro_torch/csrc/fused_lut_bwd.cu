// fused_lut_bwd: the approximate STE gradient GEMM, both float operands
// quantized in-kernel, per-tensor symmetric (zero point 0),
//
//     qa = clip(round_half_even(a / sa), lo, hi),  qb likewise with sb
//     acc[m,n] = sum_k LUT[qa[m, k] + off, qb[k, n] + off]
//     out[m,n] = float(acc) * (sa * sb)            (or acc with emit_acc)
//
// Replaces the Pallas kernel src/repro/kernels/fused_lut_dense/kernel.py
// (fused_lut_bwd_kernel). It computes the dense layer's gx = g @ wf^T and
// gw = xf^T @ g, and (emit_acc) the conv input gradient's patch GEMM
// g @ wf, whose int32 result the caller scatters back into the image in
// integers. Bound, as every LUT GEMM here: the shared-memory gather rate
// (lut_gemm.cuh). The only difference from fused_lut_dense is the B side:
// a float operand quantized while it is staged (SymBLoader) instead of
// ready-made weight codes, one correctly rounded divide per staged value,
// amortised over the tile's rows. Operands are row-major; the wrapper
// copies a transposed operand (wf^T, xf^T) contiguous first. Nothing is
// padded, so there is no k_pad correction, and ragged M, K and N (the
// head's K=10 and N=10) are masked in staging and in the store. The scales
// stay on the device (pointers).
#include "lut_gemm.cuh"

namespace {

// Row-major (M, K) float operand, quantized symmetric on staging;
// consecutive threads read consecutive k of one row (coalesced).
struct SymALoader {
  const float* a;
  const float* sa;
  int M, K, n_codes, offset;
  float lo, hi;

  static constexpr int scratch_bytes(int) { return 0; }
  __device__ void begin_tile(int, int*, int, int) const {}
  __device__ void stage(int* As, int a_stride, int m0, int k0, int*, int bm,
                        int tid) const {
    const float s = *sa;
    for (int e = tid; e < bm * lutgemm::kBK; e += lutgemm::kThreads) {
      const int mi = e / lutgemm::kBK, ki = e % lutgemm::kBK;
      const int m = m0 + mi, k = k0 + ki;
      int v = offset;
      if (m < M && k < K)
        v = lutgemm::quantize_symmetric(__ldg(a + (size_t)m * K + k), s, lo,
                                        hi) + offset;
      As[ki * a_stride + mi] = min(max(v, 0), n_codes - 1) * n_codes;
    }
  }
};

// out = float(acc) * (sa * sb), the reference's single combined-scale
// dequant
struct StoreSymDequant {
  float* out;
  const float* sa;
  const float* sb;
  int N;
  __device__ void operator()(int m, int n, int acc) const {
    out[(size_t)m * N + n] =
        __fmul_rn(__int2float_rn(acc), __fmul_rn(*sa, *sb));
  }
};

}  // namespace

extern "C" int fused_lut_bwd_launch(const float* a, const float* b,
                                    const int16_t* lut, const float* sa,
                                    const float* sb, void* out, int emit_acc,
                                    int M, int K, int N, int n_codes,
                                    int offset, int lo, int hi,
                                    int num_blocks, void* stream) {
  const float flo = static_cast<float>(lo), fhi = static_cast<float>(hi);
  SymALoader load{a, sa, M, K, n_codes, offset, flo, fhi};
  lutgemm::SymBLoader bload{b, sb, K, N, n_codes, offset, flo, fhi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emit_acc) {
    lutgemm::StoreInt store{static_cast<int*>(out), N};
    return lutgemm::launch(load, bload, store, lut, n_codes, M, K, N,
                           num_blocks, s);
  }
  StoreSymDequant store{static_cast<float*>(out), sa, sb, N};
  return lutgemm::launch(load, bload, store, lut, n_codes, M, K, N,
                         num_blocks, s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
