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
// and written once (2 * B*H*hd*hd*4 bytes); over a sequence FP32
// operations, 7 hd^2 FLOPs a token and head (0.035 ms of them at rwkv6-3b's
// training shape, B 4 x T 512 x 40 heads, against 0.033 ms of bytes),
// since each step depends on the last (the data-dependent decay leaves no
// associative form that keeps the reference's rounding). Six of its seven
// operations a state entry must round on their own (k*v, u*kv, S + u*kv,
// w*S, + kv) and only r*a may fuse into its sum, so the instructions
// themselves come to 1.7x the FLOP bound.
//
// Two kernels, one per regime:
//  * wkv_step_kernel, every call with T = 1 (decode): one block per
//    (b, h), hd threads; thread v keeps column S[:, v] in hd registers, so
//    the state crosses device memory once each way, its loads and stores
//    coalesced across the warp (neighbouring v, neighbouring addresses);
//    out_v sums r_k * a[k, v] over k in order.
//  * wkv_seq_kernel, every call with T > 1, on the state's elementwise
//    layout (the backward's column blocks, csrc/wkv_bwd.cu): 64-thread
//    blocks of 16 columns of one (b, h); a lane owns hd/16 rows x 4
//    columns of S in registers, 16 lanes a column, so B*H*hd/16 blocks of
//    2 warps (640 at the training shape) where one block of 2 warps a
//    (b, h) left a dependent hd-long sum and a barrier on each step. Each
//    16 steps' r, k, w and the block's v come into shared memory by
//    16-byte cp.async copies, double-buffered (two barriers a 16 steps,
//    none a step), and a full tile's 16 steps are unrolled into one basic
//    block; out_v sums r_k * a[k, v] over a lane's rows in order, then
//    over the column's 16 lanes (wkv_reduce16, a fixed order), and the
//    four lanes that hold a column's sum all store it (no branch).
// The sequence kernel at decode would stage one step through the 16-step
// buffers, with two barriers, in four times the blocks: 3.3x the decode
// kernel's time at 32 rows on an H100 at 700 W (tools/wkv_probe.py times
// the two side by side), so decode keeps its own kernel. The sequence
// kernel tests for a chunk boundary on every step only where the chunk is
// not a multiple of 16 (SUB_CHUNK false: the reduced configs' rwkv_chunk
// of 8), and on a tile's first step otherwise.
// Both update the state through wkv_state_update (wkv_state.cuh, shared
// with the backward): k*v, u*kv, S + u*kv, w*S, + kv, each __fmul_rn /
// __fadd_rn on its own (no contraction), so S_T and the chunk-boundary
// states are the plain version's bit for bit, and the backward's restored
// states this kernel's; out differs from the plain version's einsum only
// in summation order (and one FMA rounding less a term).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wkv_state.cuh"

namespace {

constexpr int kSub = 16;      // steps staged at once by wkv_seq_kernel
constexpr int kThreads = 64;  // wkv_seq_kernel's block
constexpr int kCols = 16;     // columns of S a wkv_seq_kernel block owns

struct Strides {
  long long b, t, h;
};

template <int HD>
__global__ void __launch_bounds__(HD)
wkv_step_kernel(const float* __restrict__ r, const float* __restrict__ k,
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
      S[i] = wkv_state_update(wb[cur][i], S[i], kv);
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

template <int HD, bool SUB_CHUNK>
__global__ void __launch_bounds__(kThreads)
wkv_seq_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* s0,
               float* __restrict__ out, float* sT,
               float* __restrict__ bounds, int chunk, int T, int H,
               Strides rs, Strides ks, Strides vs, Strides ws) {
  constexpr int NCB = HD / kCols;       // blocks of one (b, h)
  constexpr int R = HD / 16;            // rows a thread owns
  constexpr int SA = 3 * kSub * HD + kSub * kCols;   // one staging buffer
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x / NCB, blk = blockIdx.x % NCB;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = lane & 15;                            // rows rg*R .. +R
  const int jl = (tid >> 5) * 8 + (lane >> 4) * 4;     // columns jl .. +4
  const int j = blk * kCols + jl;
  const size_t bound_stride = (size_t)gridDim.x / NCB * HD * HD;
  // (bh, rg*R + e, j + c) of a (B*H, hd, hd) state
  auto at = [&](int e, int c) {
    return ((size_t)bh * HD + rg * R + e) * HD + j + c;
  };

  // steps q*kSub .. of r, k, w (all rows) and v (this block's columns)
  // into buffer B, committed as one group
  auto fetch = [&](int q, float* B) {
    const int ta = q * kSub;
    const int n = min(kSub, T - ta);
    const float* rp = r + b * rs.b + (long long)ta * rs.t + h * rs.h;
    const float* kp = k + b * ks.b + (long long)ta * ks.t + h * ks.h;
    const float* wp = w + b * ws.b + (long long)ta * ws.t + h * ws.h;
    const float* vp = v + b * vs.b + (long long)ta * vs.t + h * vs.h +
                      blk * kCols;
    constexpr int Q = HD / 4;
    for (int x = tid; x < n * Q; x += kThreads) {
      const int s = x / Q, p = x % Q;
      wkv_cp_async16(B + s * HD + p * 4, rp + s * rs.t + p * 4);
      wkv_cp_async16(B + (kSub + s) * HD + p * 4, kp + s * ks.t + p * 4);
      wkv_cp_async16(B + (2 * kSub + s) * HD + p * 4, wp + s * ws.t + p * 4);
    }
    for (int x = tid; x < n * (kCols / 4); x += kThreads) {
      const int s = x / (kCols / 4), p = x % (kCols / 4);
      wkv_cp_async16(B + 3 * kSub * HD + s * kCols + p * 4,
                     vp + s * vs.t + p * 4);
    }
    wkv_cp_async_commit();
  };

  float S[R][4], uu[R];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    uu[e] = u[h * HD + rg * R + e];
#pragma unroll
    for (int c = 0; c < 4; ++c) S[e][c] = s0[at(e, c)];
  }
  const size_t out_t = (size_t)H * HD;
  float* op = out + ((size_t)b * T * H + h) * HD + j + (rg >> 2);
  const int nt = (T + kSub - 1) / kSub;
  fetch(0, smem);
  int buf = 0;
  for (int q = 0; q < nt; ++q) {
    if (q + 1 < nt) {                  // the next tile's copies fly meanwhile
      fetch(q + 1, smem + (buf ^ 1) * SA);
      wkv_cp_async_wait<1>();
    } else {
      wkv_cp_async_wait<0>();
    }
    __syncthreads();
    const float* rb = smem + buf * SA;
    const float* kb = rb + kSub * HD;
    const float* wb = kb + kSub * HD;
    const float* vb = wb + kSub * HD;
    const int ta = q * kSub;
    const int n = min(kSub, T - ta);
    // the chunk boundaries: on a tile's first step when kSub divides
    // chunk (SUB_CHUNK), else tested every step
    auto boundary = [&](int t) {
      if (bounds != nullptr && t % chunk == 0) {
        float* bp = bounds + (size_t)(t / chunk) * bound_stride;
#pragma unroll
        for (int e = 0; e < R; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c) bp[at(e, c)] = S[e][c];
      }
    };
    if (SUB_CHUNK) boundary(ta);
    // a full tile's 16 steps unrolled whole (no bounds test), so they
    // interleave; a short tile tests each step
    auto tile = [&](auto full) {
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        if (decltype(full)::value || s < n) {
          if (!SUB_CHUNK) boundary(ta + s);
          float rr[R], kk[R], ww[R], vv[4];
          wkv_load<R>(rb + s * HD + rg * R, rr);
          wkv_load<R>(kb + s * HD + rg * R, kk);
          wkv_load<R>(wb + s * HD + rg * R, ww);
          wkv_load<4>(vb + s * kCols + jl, vv);
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int e = 0; e < R; ++e) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float kv = __fmul_rn(kk[e], vv[c]);
              const float a = __fadd_rn(S[e][c], __fmul_rn(uu[e], kv));
              acc[c] = __fmaf_rn(rr[e], a, acc[c]);
              S[e][c] = wkv_state_update(ww[e], S[e][c], kv);
            }
          }
          // four lanes hold each column's sum: all store it, no branch
          op[(size_t)(ta + s) * out_t] =
              wkv_reduce16(acc[0], acc[1], acc[2], acc[3], rg);
        }
      }
    };
    if (n == kSub)
      tile(std::true_type{});
    else
      tile(std::false_type{});
    __syncthreads();                   // every thread is done with buf
    buf ^= 1;
  }
#pragma unroll
  for (int e = 0; e < R; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) sT[at(e, c)] = S[e][c];
}

template <int HD>
cudaError_t launch_hd(const float* r, const float* k, const float* v,
                      const float* w, const float* u, const float* s0,
                      float* out, float* sT, float* bounds, int chunk,
                      int B, int T, int H, const Strides* st,
                      cudaStream_t stream) {
  if (T == 1) {
    wkv_step_kernel<HD><<<B * H, HD, 0, stream>>>(
        r, k, v, w, u, s0, out, sT, bounds, chunk, T, H, st[0], st[1],
        st[2], st[3]);
    return cudaGetLastError();
  }
  const int bytes = 2 * (3 * kSub * HD + kSub * kCols) * sizeof(float);
  if (bounds == nullptr || chunk % kSub == 0)
    wkv_seq_kernel<HD, true><<<B * H * (HD / kCols), kThreads, bytes,
                               stream>>>(r, k, v, w, u, s0, out, sT, bounds,
                                         chunk, T, H, st[0], st[1], st[2],
                                         st[3]);
  else
    wkv_seq_kernel<HD, false><<<B * H * (HD / kCols), kThreads, bytes,
                                stream>>>(r, k, v, w, u, s0, out, sT, bounds,
                                          chunk, T, H, st[0], st[1], st[2],
                                          st[3]);
  return cudaGetLastError();
}

}  // namespace

// strides: (b, t, h) of r, k, v, w in turn, in elements; with T > 1 every
// row of hd must start 16-byte aligned (the strides a multiple of 4, the
// pointers aligned). bounds, when not null, receives the state before
// every step t with t % chunk == 0: (ceil(T / chunk), B*H, hd, hd), what
// the backward (wkv_bwd.cu) restarts its chunks from.
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
