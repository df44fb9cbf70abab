// fused_lut_dense: quantize -> LUT-gather GEMM -> dequant in one kernel,
//
//     q(x)     = clip(round_half_even(x / xs + xz), lo, hi)
//     acc[m,n] = sum_k LUT[q(x[m, k]) - (int)xz + off, wq[k, n] + off]
//     out[m,n] = float(acc) * (xs * ws[n])        (or acc with emit_acc)
//
// Replaces the Pallas kernel src/repro/kernels/fused_lut_dense/kernel.py
// (fused_lut_dense_kernel): the activation codes and the int32 accumulator
// never reach device memory. Like lut_matmul it is bound by the
// shared-memory gather rate (lut_gemm.cuh); the in-kernel quantizer adds one
// correctly rounded divide per staged activation, amortised over the N
// columns of the tile. No operand is padded, so no k_pad correction. The
// scales stay on the device (pointers), so the launch never waits on them.
#include "lut_gemm.cuh"

namespace {

struct QuantLoader {
  const float* x;
  const float* xs;
  const float* xz;
  int M, K, n_codes, offset;
  float lo, hi;

  static constexpr int scratch_bytes(int) { return 0; }
  __device__ void begin_tile(int, int*, int, int) const {}
  __device__ void stage(int* As, int a_stride, int m0, int k0, int*, int bm,
                        int tid) const {
    const float s = *xs, z = *xz;
    const int zi = static_cast<int>(z);
    for (int e = tid; e < bm * lutgemm::kBK; e += lutgemm::kThreads) {
      const int mi = e / lutgemm::kBK, ki = e % lutgemm::kBK;
      const int m = m0 + mi, k = k0 + ki;
      int v = offset;
      if (m < M && k < K)
        v = lutgemm::quantize_code(x[(size_t)m * K + k], s, z, lo, hi) - zi +
            offset;
      As[ki * a_stride + mi] = min(max(v, 0), n_codes - 1) * n_codes;
    }
  }
};

}  // namespace

extern "C" int fused_lut_dense_launch(const float* x, const int* wq,
                                      const int16_t* lut, const float* xs,
                                      const float* xz, const float* ws,
                                      void* out, int emit_acc, int M, int K,
                                      int N, int n_codes, int offset, int lo,
                                      int hi, int num_blocks, void* stream) {
  QuantLoader load{x, xs, xz, M, K, n_codes, offset,
                   static_cast<float>(lo), static_cast<float>(hi)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (emit_acc) {
    lutgemm::StoreInt store{static_cast<int*>(out), N};
    return lutgemm::launch(load, store, wq, lut, n_codes, offset, M, K, N,
                           num_blocks, s);
  }
  lutgemm::StoreDequant store{static_cast<float*>(out), xs, ws, N};
  return lutgemm::launch(load, store, wq, lut, n_codes, offset, M, K, N,
                         num_blocks, s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
