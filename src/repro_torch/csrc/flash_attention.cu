// flash_attention: exact GQA attention in float32, causal, sliding-window
// and logit-softcapped, with queries aligned to key 0 (kernel 11).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// (_kernel, flash_attention_kernel). For each query row b (= batch * Hq +
// head), reading KV row b / rep, and each q tile of rows i:
//
//   s[i, j] = (f32(q[i]) * f32(1 / sqrt(D))) . f32(k[j])
//   s       = c * tanh(s / c)                               (softcap c)
//   s       = NEG_INF = -1e30 unless j <= i (causal) and j > i - window
//   online softmax over KV tiles:
//     m' = max(m, max_j s), p = exp(s - m'), alpha = exp(m - m')
//     l' = alpha * l + sum_j p,  acc' = alpha * acc + p @ v
//   out = acc / max(l, 1e-30), in q's dtype
//
// A block where every key of a row is masked gives that row p = exp(0);
// the first visible key's alpha = exp(-1e30 - m') = 0 washes it out, as in
// the reference. The reference asserts whole tiles; here query rows past
// Sq are not written and keys past Sk get -inf (p = 0, as if absent), so
// any S runs. KV tiles are walked from the first up to the reference's
// causal block bound.
//
// What bounds it on Hopper: operations. 2 * Hq * D * S(S+1)/2
// multiply-adds per layer for QK and PV (gemma2-27b at S = 4352: 1.55e11
// flops) against a few MB of Q, K, V and output.
//
// What the design does about it (a simple design that is right first):
//  * one block of 256 threads per (query row b, q tile of 64 rows),
//    heaviest (last) tiles first; Q is scaled and widened to float32 once
//    into shared memory, K and V tiles of 64 keys are staged the same way,
//    each operand read in its own dtype (float32 or bfloat16) through its
//    strides, so a (B, S, H, D) tensor is read where it lies;
//  * thread (ty, tx) of 16 x 16 owns query rows 4 ty .. 4 ty + 3: their
//    online-softmax state (m, l) and a 4 x D/16 slice of the output
//    accumulator stay in registers for the whole KV walk; QK gives it the
//    scores of keys tx + 16 j, reduced across the 16 lanes of a row group
//    with shuffles; p goes through shared memory to PV, where the thread
//    owns columns 4 tx + 64 g;
//  * shared rows are padded by 4 floats so that the float4 reads of
//    different rows fall in different banks;
//  * float32 FMAs on the CUDA cores (no tensor cores: the reference's
//    float32 result is the contract), expf and tanhf without fast math,
//    IEEE division for s / c and the final normalisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per KV tile
constexpr int kRows = 4;         // query rows per thread
constexpr int kCols = kBK / 16;  // scores per thread and row
constexpr int kPS = kBK + 4;     // padded row of the p tile
constexpr float kNegInf = -1e30f;

// (heads per batch row, batch stride, head stride, position stride), in
// elements, of a (rows, S, D) or (B, H, S, D) operand
struct Addr {
  int heads;
  long long b, h, s;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ const T* row_base(const T* p, const Addr& a,
                                             int row) {
  return p + (row / a.heads) * a.b + (row % a.heads) * a.h;
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)((kBQ + 2 * kBK) * (D + 4) + kBQ * kPS) * sizeof(float);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int sq, int sk,
             int rep, Addr qa, Addr ka, Addr va, Addr oa, int causal,
             int window, int has_cap, float cap, float scale) {
  constexpr int S = D + 4;        // padded row of the Q, K and V tiles
  constexpr int NG = D / 64;      // float4 column groups per thread in PV
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * S;
  float* vs = ks + kBK * S;
  float* ps = vs + kBK * S;

  const int row = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int kv_row = row / rep;
  const T* qp = row_base(q, qa, row);
  const T* kp = row_base(k, ka, kv_row);
  const T* vp = row_base(v, va, kv_row);
  T* op = out + (row / oa.heads) * oa.b + (row % oa.heads) * oa.h;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int r0 = ty * kRows;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, pos = q0 + r;
    qs[r * S + c] = pos < sq ? widen(qp[pos * qa.s + c]) * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][4 * NG];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  const int last = min(q0 + kBQ, sq) - 1;   // the tile's last real row
  const int n_kv = (sk + kBK - 1) / kBK;
  const int kv_hi = causal ? min(n_kv, last / kBK + 1) : n_kv;

  for (int kb = 0; kb < kv_hi; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();   // the last tile's readers are done (and Q is staged)
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D, pos = k0 + r;
      const bool in = pos < sk;
      ks[r * S + c] = in ? widen(kp[pos * ka.s + c]) : 0.f;
      vs[r * S + c] = in ? widen(vp[pos * va.s + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * S + c);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * S + c);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + r0 + i;
      float bmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j];
        if (has_cap) x = cap * tanhf(x / cap);
        const bool vis = (!causal || kpos <= qpos) &&
                         (window < 0 || kpos > qpos - window);
        x = kpos >= sk ? -INFINITY : (vis ? x : kNegInf);
        s[i][j] = x;
        bmax = fmaxf(bmax, x);
      }
#pragma unroll
      for (int o = 8; o; o >>= 1)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, o));
      const float m_new = fmaxf(m[i], bmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(r0 + i) * kPS + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 8; o; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = alpha * l[i] + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (r0 + i) * kPS + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (j + jj) * S + 4 * tx + 64 * g);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                          : jj == 2 ? pv[i].z : pv[i].w;
            float* a = acc[i] + 4 * g;
            a[0] = fmaf(p, vv.x, a[0]);
            a[1] = fmaf(p, vv.y, a[1]);
            a[2] = fmaf(p, vv.z, a[2]);
            a[3] = fmaf(p, vv.w, a[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int pos = q0 + r0 + i;
    if (pos >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = op + pos * oa.s;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        narrow(o + 4 * tx + 64 * g + e, acc[i][4 * g + e] / den);
  }
}

template <int D, typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     int bh, int sq, int sk, int rep, const Addr* a,
                     int causal, int window, int has_cap, float cap,
                     float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  flash_kernel<D, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, rep, a[0],
      a[1], a[2], a[3], causal, window, has_cap, cap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int d, const void* q, const void* k, const void* v,
                         void* out, int bh, int sq, int sk, int rep,
                         const Addr* a, int causal, int window, int has_cap,
                         float cap, float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_t<64, T>(q, k, v, out, bh, sq, sk, rep, a, causal,
                             window, has_cap, cap, scale, stream);
    case 128:
      return launch_t<128, T>(q, k, v, out, bh, sq, sk, rep, a, causal,
                              window, has_cap, cap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (bh, sq, d) rows addressed as (qh heads per batch row, batch,
// head and position strides); k, v: (bh / rep, sk, d) rows, kh heads per
// batch row. Strides in elements, the last dim dense. window < 0: none.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int is_bf16,
    int bh, int sq, int sk, int d, int rep, int qh, int kh, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, int causal, int window,
    int has_cap, float cap, float scale, void* stream) {
  if (bh <= 0 || sq <= 0 || sk < 0 || rep <= 0 || qh <= 0 || kh <= 0 ||
      bh % rep != 0 || (sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Addr a[4] = {{qh, qsb, qsh, qss}, {kh, ksb, ksh, kss},
                     {kh, vsb, vsh, vss}, {qh, osb, osh, oss}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dtype<__nv_bfloat16>(d, q, k, v, out, bh, sq, sk, rep,
                                            a, causal, window, has_cap, cap,
                                            scale, s)
              : launch_dtype<float>(d, q, k, v, out, bh, sq, sk, rep, a,
                                    causal, window, has_cap, cap, scale, s);
  return static_cast<int>(err);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
