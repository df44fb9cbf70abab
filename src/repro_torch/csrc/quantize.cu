// quantize: the affine quantizer of every ACU operand,
//
//     out[i] = int(clamp(rint(float(x[i]) / s[i] + z[i]), lo, hi))
//
// over a tensor of at most four (merged) dims, x float32 or bfloat16 read
// through its strides, s and z float32 broadcast views
// (stride 0 along broadcast dims), out int32, contiguous.
//
// Replaces the Pallas kernel src/repro/kernels/quantize/kernel.py
// (quantize_kernel), a per-tensor quantizer over a flat array padded to
// blocks of 1024 with the scale and zero point as (1,) arrays. Here the
// scale and zero point may also be per channel along any axis, since the
// port quantizes every weight per output channel on every call, and
// nothing is padded: the grid strides over the elements.
//
// Rounding is the plain version's bit for bit: a correctly rounded divide
// (__fdiv_rn), a separately rounded add (__fadd_rn: nothing may contract
// or reorder it), rintf in the default mode (half to even, as
// torch.round), then the clamp; no --use_fast_math.
//
// What bounds it on Hopper: bytes. Each element reads 2 or 4 bytes and
// writes 4; the scale and zero point are a row or a scalar that stays in
// L1/L2. The design keeps the loads in flight: each thread starts
// kItems independent loads before it converts any of them, and the index
// arithmetic is 32-bit over only the dims that could not be merged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 4;
constexpr int kThreads = 256;
constexpr int kItems = 4;

struct Geometry {
  unsigned size[kMaxRank];            // innermost last; leading dims 1
  long long xs[kMaxRank], ss[kMaxRank], zs[kMaxRank];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ s,
                const float* __restrict__ z, int* __restrict__ out,
                Geometry g, unsigned n, float lo, float hi) {
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned base = blockIdx.x * kThreads + threadIdx.x; base < n;
       base += stride * kItems) {
    T xv[kItems];
    float sv[kItems], zv[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned i = base + j * stride;
      if (i >= n) break;
      unsigned rem = i;
      long long xo = 0, so = 0, zo = 0;
#pragma unroll
      for (int d = kMaxRank - 1; d >= kMaxRank - R; --d) {
        const unsigned c = (d == kMaxRank - R) ? rem : rem % g.size[d];
        rem = (d == kMaxRank - R) ? 0 : rem / g.size[d];
        xo += c * g.xs[d];
        so += c * g.ss[d];
        zo += c * g.zs[d];
      }
      xv[j] = x[xo];
      sv[j] = s[so];
      zv[j] = z[zo];
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned i = base + j * stride;
      if (i >= n) break;
      float q = rintf(__fadd_rn(__fdiv_rn(widen(xv[j]), sv[j]), zv[j]));
      q = fminf(fmaxf(q, lo), hi);
      out[i] = static_cast<int>(q);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* s, const float* z,
                         int* out, int rank, const Geometry& g, unsigned n,
                         float lo, float hi, int blocks, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  switch (rank) {
    case 1:
      quantize_kernel<T, 1><<<blocks, kThreads, 0, st>>>(xt, s, z, out, g,
                                                         n, lo, hi);
      break;
    case 2:
      quantize_kernel<T, 2><<<blocks, kThreads, 0, st>>>(xt, s, z, out, g,
                                                         n, lo, hi);
      break;
    case 3:
      quantize_kernel<T, 3><<<blocks, kThreads, 0, st>>>(xt, s, z, out, g,
                                                         n, lo, hi);
      break;
    default:
      quantize_kernel<T, 4><<<blocks, kThreads, 0, st>>>(xt, s, z, out, g,
                                                         n, lo, hi);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. size/strides: kMaxRank each,
// outermost first, only the last `rank` used.
extern "C" int quantize_launch(
    const void* x, int dtype, const float* s, const float* z, int* out,
    int rank, long long n0, long long n1, long long n2, long long n3,
    long long x0, long long x1, long long x2, long long x3, long long s0,
    long long s1, long long s2, long long s3, long long z0, long long z1,
    long long z2, long long z3, long long n, int lo, int hi, int max_blocks,
    void* stream) {
  if (rank < 1 || rank > kMaxRank || n <= 0 || n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry g;
  const long long sz[kMaxRank] = {n0, n1, n2, n3};
  const long long xs[kMaxRank] = {x0, x1, x2, x3};
  const long long ss[kMaxRank] = {s0, s1, s2, s3};
  const long long zs[kMaxRank] = {z0, z1, z2, z3};
  for (int d = 0; d < kMaxRank; ++d) {
    g.size[d] = static_cast<unsigned>(sz[d]);
    g.xs[d] = xs[d];
    g.ss[d] = ss[d];
    g.zs[d] = zs[d];
  }
  long long want = (n + (long long)kThreads * kItems - 1) /
                   ((long long)kThreads * kItems);
  const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned un = static_cast<unsigned>(n);
  const float flo = static_cast<float>(lo), fhi = static_cast<float>(hi);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_typed<float>(x, s, z, out, rank, g, un, flo, fhi, blocks,
                                st);
      break;
    case 1:
      err = launch_typed<__nv_bfloat16>(x, s, z, out, rank, g, un, flo, fhi,
                                        blocks, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
