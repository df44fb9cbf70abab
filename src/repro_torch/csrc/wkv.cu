// wkv: the RWKV-6 "Finch" WKV recurrence with data-dependent decay,
//
//     kv_t  = k_t^T v_t
//     out_t = r_t (S + u * kv_t)
//     S     = diag(w_t) S + kv_t
//
// per (batch, head) over T steps; r/k/v/w (B, T, H, hd) float32 read
// through their strides (contiguous along hd), u (H, hd), s0 (B, H, hd,
// hd) float32 contiguous; out (B, T, H, hd) and S_T (B, H, hd, hd), which
// may alias s0.
//
// Replaces the Pallas kernel src/repro/kernels/wkv/kernel.py (wkv_kernel),
// one grid cell per folded (b*H + h) row with the (hd, hd) state in VMEM
// scratch and a fori_loop over t; its ops.py folded (B, T, H, hd) to
// (B*H, T, hd) with transposes, which the strides here make unnecessary.
//
// What bounds it on Hopper: at decode (T = 1) bytes, the state read once
// and written once (2 * B*H*hd*hd*4 bytes); at prefill the sequential
// chain over t, since each step depends on the last (the data-dependent
// decay leaves no associative form that keeps the reference's rounding).
//
// What the design does about it (a simple design that is right first):
//  * one block per (b, h), hd threads; thread v keeps column S[:, v] in
//    hd registers for the whole walk, so the state crosses device memory
//    once each way; the column loads and stores are coalesced across the
//    warp (neighbouring v, neighbouring addresses);
//  * r_t, k_t and w_t, which every thread reads whole, sit in a double
//    buffer in shared memory; each thread loads its element of step t+1
//    into registers before it computes step t, and stores it into the
//    other buffer after, so one barrier per step suffices; v_t[v] stays
//    in the thread's own register;
//  * the state rounds as the plain version: k*v, u*kv, S + u*kv, w*S,
//    + kv, each __fmul_rn / __fadd_rn on its own (no contraction), so S_T
//    is bitwise equal; out_v sums r_k * a[k, v] over k in order, which
//    differs from the plain version's einsum only in summation order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, t, h;
};

template <int HD>
__global__ void __launch_bounds__(HD)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* s0,
           float* __restrict__ out, float* sT, float* __restrict__ bounds,
           int chunk, int T, int H, Strides rs, Strides ks, Strides vs,
           Strides ws) {
  __shared__ float rb[2][HD], kb[2][HD], wb[2][HD], ub[HD];
  const int row = blockIdx.x;  // b * H + h
  const int b = row / H, h = row % H;
  const int j = threadIdx.x;   // this thread's column v
  const size_t state = (size_t)row * HD * HD;

  float S[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0[state + (size_t)i * HD + j];
  ub[j] = u[h * HD + j];

  const float* rp = r + b * rs.b + h * rs.h + j;
  const float* kp = k + b * ks.b + h * ks.h + j;
  const float* vp = v + b * vs.b + h * vs.h + j;
  const float* wp = w + b * ws.b + h * ws.h + j;
  float* op = out + ((size_t)b * T * H + h) * HD + j;
  const size_t out_t = (size_t)H * HD;

  float vv = 0.f;
  if (T > 0) {
    rb[0][j] = rp[0];
    kb[0][j] = kp[0];
    wb[0][j] = wp[0];
    vv = vp[0];
  }
  __syncthreads();
  const size_t bound_stride = (size_t)gridDim.x * HD * HD;
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (bounds != nullptr && t % chunk == 0) {
      float* bp = bounds + (size_t)(t / chunk) * bound_stride + state + j;
#pragma unroll
      for (int i = 0; i < HD; ++i) bp[(size_t)i * HD] = S[i];
    }
    const bool more = t + 1 < T;
    float rn = 0.f, kn = 0.f, wn = 0.f, vn = 0.f;
    if (more) {
      rn = rp[(t + 1) * rs.t];
      kn = kp[(t + 1) * ks.t];
      wn = wp[(t + 1) * ws.t];
      vn = vp[(t + 1) * vs.t];
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float kv = __fmul_rn(kb[cur][i], vv);
      const float a = __fadd_rn(S[i], __fmul_rn(ub[i], kv));
      acc = __fadd_rn(acc, __fmul_rn(rb[cur][i], a));
      S[i] = __fadd_rn(__fmul_rn(wb[cur][i], S[i]), kv);
    }
    op[t * out_t] = acc;
    if (more) {
      rb[cur ^ 1][j] = rn;
      kb[cur ^ 1][j] = kn;
      wb[cur ^ 1][j] = wn;
      vv = vn;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) sT[state + (size_t)i * HD + j] = S[i];
}

template <int HD>
cudaError_t launch_hd(const float* r, const float* k, const float* v,
                      const float* w, const float* u, const float* s0,
                      float* out, float* sT, float* bounds, int chunk,
                      int B, int T, int H, const Strides* st,
                      cudaStream_t stream) {
  wkv_kernel<HD><<<B * H, HD, 0, stream>>>(r, k, v, w, u, s0, out, sT,
                                          bounds, chunk, T, H, st[0], st[1],
                                          st[2], st[3]);
  return cudaGetLastError();
}

}  // namespace

// strides: (b, t, h) of r, k, v, w in turn, in elements. bounds, when not
// null, receives the state before every step t with t % chunk == 0:
// (ceil(T / chunk), B*H, hd, hd), what the backward (wkv_bwd.cu) restarts
// its chunks from.
extern "C" int wkv_launch(const float* r, const float* k, const float* v,
                          const float* w, const float* u, const float* s0,
                          float* out, float* sT, float* bounds, int chunk,
                          int B, int T, int H, int hd,
                          long long rsb, long long rst, long long rsh,
                          long long ksb, long long kst, long long ksh,
                          long long vsb, long long vst, long long vsh,
                          long long wsb, long long wst, long long wsh,
                          void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || (bounds != nullptr && chunk <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[4] = {{rsb, rst, rsh}, {ksb, kst, ksh}, {vsb, vst, vsh},
                         {wsb, wst, wsh}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<16>(r, k, v, w, u, s0, out, sT, bounds, chunk, B, T,
                             H, st, s);
    case 64:
      return launch_hd<64>(r, k, v, w, u, s0, out, sT, bounds, chunk, B, T,
                             H, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
