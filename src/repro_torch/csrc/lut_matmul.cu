// lut_matmul: the unfused LUT-gather GEMM on integer codes,
//
//     out[m, n] = sum_k LUT[a[m, k] + off, w[k, n] + off]      (int32)
//
// Replaces the Pallas kernel src/repro/kernels/lut_matmul/kernel.py
// (lut_matmul_kernel), which pinned the int32 table in VMEM and gathered
// 128^3 tiles in 8-row sub-slices. Here the table is int16 in shared memory
// and blocks are persistent; see lut_gemm.cuh for what bounds the kernel
// (the shared-memory gather rate) and how the design meets it. Nothing is
// padded, so no k_pad * LUT[off, off] correction is needed.
#include "lut_gemm.cuh"

namespace {

// Row-major (M, K) int32 codes. Consecutive threads read consecutive k of
// one row (coalesced); the padded A stride keeps the transposed shared
// stores free of bank conflicts.
struct CodeLoader {
  const int* a;
  int M, K, n_codes, offset;

  static constexpr int scratch_bytes(int) { return 0; }
  __device__ void begin_tile(int, int*, int, int) const {}
  __device__ void stage(int* As, int a_stride, int m0, int k0, int*, int bm,
                        int tid) const {
    for (int e = tid; e < bm * lutgemm::kBK; e += lutgemm::kThreads) {
      const int mi = e / lutgemm::kBK, ki = e % lutgemm::kBK;
      const int m = m0 + mi, k = k0 + ki;
      int v = offset;
      if (m < M && k < K)
        v = min(max(a[(size_t)m * K + k] + offset, 0), n_codes - 1);
      As[ki * a_stride + mi] = v * n_codes;
    }
  }
};

}  // namespace

extern "C" int lut_matmul_launch(const int* a, const int* w,
                                 const int16_t* lut, int* out, int M, int K,
                                 int N, int n_codes, int offset,
                                 int num_blocks, void* stream) {
  CodeLoader load{a, M, K, n_codes, offset};
  lutgemm::StoreInt store{out, N};
  return lutgemm::launch(load, store, w, lut, n_codes, offset, M, K, N,
                         num_blocks, static_cast<cudaStream_t>(stream));
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
