// wkv_bwd: the backward of the RWKV-6 WKV recurrence (wkv.cu),
//
//     kv_t  = k_t^T v_t,   a_t = S_{t-1} + u * kv_t,   out_t = r_t a_t,
//     S_t   = diag(w_t) S_{t-1} + kv_t,
//
// given dout (B, T, H, hd) and dS_T (B*H, hd, hd) or nothing:
//
//     da      = r_t^T dout_t               dr_t = a_t dout_t
//     dkv     = dS_t + u * da              du  += sum_v kv_t * da
//     dk_t    = dkv v_t                    dv_t = k_t dkv
//     dw_t    = sum_v S_{t-1} * dS_t       dS_{t-1} = w_t * dS_t + da
//
// The reference has no kernel for this: it differentiates its recurrence
// as a chunked lax.scan whose inner scan is jax.checkpoint'ed
// (src/repro/models/rwkv.py, rwkv_chunk 256), so only the chunk-boundary
// states are kept and each chunk's states are recomputed on the way back.
// This kernel does the same: the forward (wkv.cu) writes the state before
// every chunk into `bounds`; here each chunk is walked forward again from
// its boundary to restore its states, then in reverse to reduce the
// gradients.
//
// Why CUDA and not Triton: the state and its gradient stay resident in
// registers across a sequential time loop of T steps, with one barrier a
// step; Triton has no loop-carried register tile of that kind across a
// sequential loop with per-step cross-thread exchange.
//
// The design (simple and right first):
//  * one block per (b, h), hd threads; thread i owns row i of dS in hd
//    registers, so dr, dw, dk and du's term are sums along its own row;
//    only dv (a column sum) crosses threads, through a padded hd x (hd+1)
//    shared tile summed in row order;
//  * a chunk's restored states go to a global scratch (B*H, chunk, hd, hd),
//    stored column-major so a warp's accesses are coalesced; the state
//    rounds as the forward's, k*v then w*S then + kv, so the restored
//    states are bitwise the forward's;
//  * du is reduced in a fixed order: each block sums its row's terms over
//    t in order into du_part (B*H, hd), then wkv_bwd_du sums du_part over
//    b in order. No float atomics: two runs give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int HD>
__global__ void __launch_bounds__(HD)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ bounds,
               const float* __restrict__ dout, const float* __restrict__ dsT,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ ds0, float* __restrict__ du_part,
               float* __restrict__ scratch, int chunk, int T, int H) {
  __shared__ float vb[HD], gb[HD];
  __shared__ float red[HD][HD + 1];
  const int row = blockIdx.x;  // b * H + h
  const int b = row / H, h = row % H;
  const int i = threadIdx.x;   // this thread's row of S and dS
  const size_t state = (size_t)row * HD * HD;
  const size_t bound_stride = (size_t)gridDim.x * HD * HD;
  const int span = chunk < T ? chunk : T;
  float* scr = scratch + (size_t)row * span * HD * HD + i;

  float dS[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j)
    dS[j] = dsT != nullptr ? dsT[state + (size_t)i * HD + j] : 0.f;
  const float ui = u[h * HD + i];
  float dui = 0.f;

  const int nc = T > 0 ? (T + chunk - 1) / chunk : 0;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const int t1 = t0 + chunk < T ? t0 + chunk : T;
    {  // restore the chunk's states S_{t-1}, t0 <= t < t1
      float S[HD];
      const float* bp = bounds + (size_t)c * bound_stride + state +
                        (size_t)i * HD;
#pragma unroll
      for (int j = 0; j < HD; ++j) S[j] = bp[j];
      for (int t = t0; t < t1; ++t) {
        float* sp = scr + (size_t)(t - t0) * HD * HD;
#pragma unroll
        for (int j = 0; j < HD; ++j) sp[(size_t)j * HD] = S[j];
        const size_t at = ((size_t)(b * T + t) * H + h) * HD;
        __syncthreads();
        vb[i] = v[at + i];
        __syncthreads();
        const float kt = k[at + i], wt = w[at + i];
#pragma unroll
        for (int j = 0; j < HD; ++j)
          S[j] = __fadd_rn(__fmul_rn(wt, S[j]), __fmul_rn(kt, vb[j]));
      }
    }
    for (int t = t1 - 1; t >= t0; --t) {
      const size_t at = ((size_t)(b * T + t) * H + h) * HD;
      __syncthreads();
      vb[i] = v[at + i];
      gb[i] = dout[at + i];
      __syncthreads();
      const float rt = r[at + i], kt = k[at + i], wt = w[at + i];
      const float* sp = scr + (size_t)(t - t0) * HD * HD;
      float drv = 0.f, dwv = 0.f, dkv_sum = 0.f;
#pragma unroll
      for (int j = 0; j < HD; ++j) {
        const float sprev = sp[(size_t)j * HD];
        const float kv = __fmul_rn(kt, vb[j]);
        const float a = __fadd_rn(sprev, __fmul_rn(ui, kv));
        drv = __fadd_rn(drv, __fmul_rn(a, gb[j]));
        dwv = __fadd_rn(dwv, __fmul_rn(sprev, dS[j]));
        const float da = __fmul_rn(rt, gb[j]);
        const float dkv = __fadd_rn(dS[j], __fmul_rn(ui, da));
        dui = __fadd_rn(dui, __fmul_rn(kv, da));
        dkv_sum = __fadd_rn(dkv_sum, __fmul_rn(dkv, vb[j]));
        red[i][j] = __fmul_rn(kt, dkv);
        dS[j] = __fadd_rn(__fmul_rn(wt, dS[j]), da);
      }
      dr[at + i] = drv;
      dw[at + i] = dwv;
      dk[at + i] = dkv_sum;
      __syncthreads();
      float dvv = 0.f;  // thread i now sums column i, rows in order
#pragma unroll
      for (int ii = 0; ii < HD; ++ii) dvv = __fadd_rn(dvv, red[ii][i]);
      dv[at + i] = dvv;
    }
  }
#pragma unroll
  for (int j = 0; j < HD; ++j) ds0[state + (size_t)i * HD + j] = dS[j];
  du_part[(size_t)row * HD + i] = dui;
}

// du[h, i] = sum over b, in order, of du_part[b*H + h, i]
__global__ void wkv_bwd_du(const float* __restrict__ du_part,
                           float* __restrict__ du, int B, int H, int hd) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * hd) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b)
    acc = __fadd_rn(acc, du_part[(size_t)b * H * hd + idx]);
  du[idx] = acc;
}

template <int HD>
cudaError_t launch_hd(const float* r, const float* k, const float* v,
                      const float* w, const float* u, const float* bounds,
                      const float* dout, const float* dsT, float* dr,
                      float* dk, float* dv, float* dw, float* ds0,
                      float* du_part, float* du, float* scratch, int B, int T,
                      int H, int chunk, cudaStream_t stream) {
  wkv_bwd_kernel<HD><<<B * H, HD, 0, stream>>>(
      r, k, v, w, u, bounds, dout, dsT, dr, dk, dv, dw, ds0, du_part,
      scratch, chunk, T, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = H * HD;
  wkv_bwd_du<<<(n + 255) / 256, 256, 0, stream>>>(du_part, du, B, H, HD);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, dout, dr, dk, dv, dw: (B, T, H, hd) float32 contiguous; u and
// du: (H, hd); bounds: (ceil(T / chunk), B*H, hd, hd) from wkv_launch;
// dsT (may be null) and ds0: (B*H, hd, hd); du_part: (B*H, hd); scratch:
// (B*H, min(chunk, T), hd, hd).
extern "C" int wkv_bwd_launch(const float* r, const float* k, const float* v,
                              const float* w, const float* u,
                              const float* bounds, const float* dout,
                              const float* dsT, float* dr, float* dk,
                              float* dv, float* dw, float* ds0,
                              float* du_part, float* du, float* scratch,
                              int B, int T, int H, int hd, int chunk,
                              void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<16>(r, k, v, w, u, bounds, dout, dsT, dr, dk, dv, dw,
                           ds0, du_part, du, scratch, B, T, H, chunk, s);
    case 64:
      return launch_hd<64>(r, k, v, w, u, bounds, dout, dsT, dr, dk, dv, dw,
                           ds0, du_part, du, scratch, B, T, H, chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
