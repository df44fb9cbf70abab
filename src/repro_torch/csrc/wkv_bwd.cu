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
// The forward (wkv.cu) writes the state before every chunk into `bounds`
// and nothing more; every finer state below is this kernel's own.
//
// What bounds it on Hopper: FP32 operations, 14 hd^2 FLOPs a token and
// head for the function (3 to restore S, 11 for the reverse pass; ops.py:
// wkv_bwd_work), 0.070 ms at rwkv6-3b's training shape, B 4 x T 512 x 40
// heads of 64, against 0.059 ms of bytes. Both the state update
// and the gradient's, dS_{t-1} = w_t * dS_t + r_t dout_t^T, are
// elementwise in (i, j); only the reductions couple entries, within one
// step: dr, dw, dk and du are row sums over j, dv a column sum over i, and
// none feeds the next step. So the work spreads over many threads, and no
// step needs a barrier.
//
// The design: one launch, two kinds of 128-thread blocks, side by side.
//  * Row blocks (B*H*hd/8): 8 rows of one (b, h); 16 lanes a row, each
//    owning hd/16 columns. The state is walked chunk by chunk in reverse.
//    Pass 1 runs the chunk forward from its boundary state, 32 steps a
//    barrier, and keeps the state before each 16-step sub-chunk in shared
//    memory (each thread its own entries, so no barrier: 15 slots x 4
//    floats x 128 threads = 30 KB a block at chunk 256; nothing goes to
//    device memory). Pass 2 takes the sub-chunks in reverse: it restores
//    a sub-chunk's 16 states into registers (16 x 4 a thread) from its
//    slot, then walks them back. A step's four row partials (S dout,
//    S dS, dkv v, v.dout) take one shuffle level (lane l and l + 8) and
//    go to shared memory; after the sub-chunk one thread per (step, row)
//    sums the 8 pair sums in order and stores dr (plus u k (v.dout)), dw
//    and dk, and adds du's term k r (v.dout) to its step's slot. So a step
//    carries two shuffles and no dependent chain of them, and the stores
//    leave coalesced. dS stays in registers from dS_T to ds0. The
//    operands (k, w, v; in pass 2 r and dout too) come into shared memory
//    by 16-byte cp.async copies, double-buffered: the next job's copies
//    fly while this one computes.
//  * Column blocks (B*H*hd/32): dv, the one column sum, apart from S: 32
//    columns of one (b, h); a lane owns hd/16 rows x 4 columns of dS, 16
//    lanes a column. They carry dS back over all T (dv needs no S), sum
//    k dkv over their rows, then over the 16 lanes by wkv_reduce16. dS is
//    carried twice, by the same instructions in both kinds of blocks; that
//    costs 4 of about 17 instructions an entry and saves any exchange
//    across row blocks and a second pass over partial dv.
// Every step of a full sub-chunk (or tile) is unrolled into one basic
// block, with no store under a branch (a column's four lanes all store
// its sum), so consecutive steps' shuffles and FMAs interleave. About 166
// registers a thread: three row blocks an SM.
// Restored states round as the forward (wkv_state_step, shared with
// wkv.cu): bitwise the forward's. With `states` set, pass 2 also writes
// every restored S_{t-1} there, for a check against the forward's.
// du is reduced in a fixed order: per row, 16 slots (by step of the
// sub-chunk) sum their terms in the walk's order, then the slots in order
// into du_part (B*H, hd); wkv_bwd_du sums du_part over b in order. No
// float atomics anywhere: two runs give the same bits.
//
// Memory beside the operands and results: none in device memory (the
// scratch of restored states that the first version wrote and read back,
// 2 x 1.34 GB at the training shape, is gone). Shared memory a row block:
// (ceil(chunk / 16) - 1) x 2 KB of slots, 30 KB at chunk 256, 2 x 10 KB
// of staged operands and 17 KB of partial sums; a column block 2 x 14 KB.
//
// Why CUDA and not Triton: the restored states of a sub-chunk and dS stay
// resident in registers across a sequential time loop, indexed by the
// unrolled step; Triton has no loop-carried register tile of that kind
// across a sequential loop, nor lane shuffles in a fixed order.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wkv_state.cuh"

namespace {

constexpr int kSub = 16;       // steps of a sub-chunk (states in registers)
constexpr int kThreads = 128;  // threads of either kind of block
constexpr int kRows = 8;       // rows of S a row block owns
constexpr int kCols = 32;      // columns of dS a column block owns
constexpr unsigned kFull = 0xffffffffu;
// a row block's per-step partial sums in shared memory, float2 [kSub]
// [kRows][16 lanes], rows padded to 17 and steps to 136 so that both the
// lanes' writes and the (step, row) threads' reads are free of conflicts
constexpr int kPartRow = 17;
constexpr int kPartStep = kRows * kPartRow;

struct Args {
  const float *r, *k, *v, *w, *u, *bounds, *dout, *dsT;
  float *dr, *dk, *dv, *dw, *ds0, *du_part, *states;
  int BH, T, H, chunk, nslot;
};

// ---------------------------------------------------------------------------
// row blocks: dr, dk, dw, du and ds0 for 8 rows of one (b, h)
// ---------------------------------------------------------------------------
// floats of one staging buffer: in pass 2 v and dout [kSub][hd], then k,
// w and r [kSub][kRows] of the block's rows; in pass 1 v [2 kSub][hd],
// then k and w [2 kSub][kRows]
template <int HD>
__host__ __device__ constexpr int row_stage_floats() {
  return 2 * kSub * HD + 4 * kSub * kRows;
}

// a row block's unit of work, in chunk c: in pass p = 1, sub-chunk q
// (restore and walk back); in pass p = 0, the two sub-chunks 2q and 2q + 1
// (run forward to fill the slots: few operations a step, so twice the
// steps a barrier); c < 0 ends the walk
struct Job {
  int c, p, q;
};

// Pass 2 on one sub-chunk of n steps from ta: restore its states into
// registers from st0 (element e at st0[e * st0_stride]: the chunk's
// boundary state or a slot), then walk them back. FULL (n == kSub) drops
// every bounds test, so the unrolled steps interleave freely.
template <int HD, bool FULL>
__device__ __forceinline__ void walk_back(
    const Args& a, const float* buf, const float* st0, int st0_stride,
    int n, int ta, int bh, int i, int rl, int cg, float2* part, float ui,
    float (&dS)[HD / 16]) {
  constexpr int C = HD / 16;
  const float* vs = buf;
  const float* gs = vs + kSub * HD;
  const float* ks = gs + kSub * HD;
  const float* ws = ks + kSub * kRows;
  const float* rs = ws + kSub * kRows;
  const int j0 = cg * C;
  float st[kSub][C];   // st[s]: the state before step ta + s
#pragma unroll
  for (int e = 0; e < C; ++e) st[0][e] = st0[e * st0_stride];
#pragma unroll
  for (int s = 1; s < kSub; ++s) {
    if (FULL || s < n) {
      const float kk = ks[(s - 1) * kRows + rl];
      const float ww = ws[(s - 1) * kRows + rl];
      float vv[C];
      wkv_load<C>(vs + (s - 1) * HD + j0, vv);
#pragma unroll
      for (int e = 0; e < C; ++e)
        st[s][e] = wkv_state_step(ww, st[s - 1][e], kk, vv[e]);
    }
  }
  if (a.states != nullptr) {
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      if (FULL || s < n) {
        float* dst = a.states + ((size_t)bh * a.T + ta + s) * HD * HD +
                     (size_t)i * HD + j0;
#pragma unroll
        for (int e = 0; e < C; ++e) dst[e] = st[s][e];
      }
    }
  }
#pragma unroll
  for (int s = kSub - 1; s >= 0; --s) {
    if (FULL || s < n) {
      const float rr = rs[s * kRows + rl], kk = ks[s * kRows + rl];
      const float ww = ws[s * kRows + rl];
      float vv[C], gg[C];
      wkv_load<C>(vs + s * HD + j0, vv);
      wkv_load<C>(gs + s * HD + j0, gg);
      float pr = 0.f, pw = 0.f, pk = 0.f, pvg = 0.f;
#pragma unroll
      for (int e = 0; e < C; ++e) {
        const float rg = __fmul_rn(rr, gg[e]);
        const float dkv = __fmaf_rn(ui, rg, dS[e]);
        pr = __fmaf_rn(st[s][e], gg[e], pr);
        pw = __fmaf_rn(st[s][e], dS[e], pw);
        pk = __fmaf_rn(dkv, vv[e], pk);
        pvg = __fmaf_rn(vv[e], gg[e], pvg);
        dS[e] = __fmaf_rn(ww, dS[e], rg);
      }
      // the butterfly's first level (xor 8) here: lanes 0-7 keep the
      // (S dout, S dS) pair sums, lanes 8-15 the (dkv v, v.dout) ones; the
      // rest after the sub-chunk, from shared memory (row_block)
      const bool hi = cg & 8;
      float k0 = hi ? pk : pr, k1 = hi ? pvg : pw;
      const float s0 = hi ? pr : pk, s1 = hi ? pw : pvg;
      k0 = __fadd_rn(k0, __shfl_xor_sync(kFull, s0, 8));
      k1 = __fadd_rn(k1, __shfl_xor_sync(kFull, s1, 8));
      part[s * kPartStep + rl * kPartRow + cg] = make_float2(k0, k1);
    }
  }
}

template <int HD>
__device__ __forceinline__ void row_block(const Args& a, float* smem,
                                          int rb) {
  constexpr int C = HD / 16;           // columns a thread owns
  constexpr int NB = HD / kRows;       // row blocks of one (b, h)
  constexpr int SA = row_stage_floats<HD>();
  const int bh = rb / NB, band = rb % NB;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x;
  const int rl = tid >> 4, cg = tid & 15;  // row in the block, column group
  const int i = band * kRows + rl, j0 = cg * C;
  const size_t row_off = ((size_t)bh * HD + i) * HD + j0;
  const size_t step = (size_t)a.H * HD;    // elements from t to t + 1
  float* slots = smem;                     // [nslot][C][kThreads]
  float* bufs = smem + a.nslot * C * kThreads;   // two staging buffers

  auto n_sub = [&](int c) {
    return (min(a.chunk, a.T - c * a.chunk) + kSub - 1) / kSub;
  };
  auto first = [&](int c) {
    const int nq = n_sub(c);
    return nq > 1 ? Job{c, 0, 0} : Job{c, 1, nq - 1};
  };
  // pass 1 runs the chunk's first nq - 1 sub-chunks, two a job
  auto next = [&](Job j) {
    if (j.p == 0)
      return 2 * j.q + 3 < n_sub(j.c) ? Job{j.c, 0, j.q + 1}
                                      : Job{j.c, 1, n_sub(j.c) - 1};
    if (j.q > 0) return Job{j.c, 1, j.q - 1};
    return j.c > 0 ? first(j.c - 1) : Job{-1, 0, 0};
  };
  // the job's steps into buffer B: k, w (this block's rows) and v; in pass
  // 2 also r and dout; committed as one group
  auto fetch = [&](Job j, float* B) {
    const int t0 = j.c * a.chunk;
    const int len = min(a.chunk, a.T - t0);
    const int ta = t0 + j.q * kSub * (j.p == 0 ? 2 : 1);
    const int n = j.p == 0 ? min(2 * kSub, (n_sub(j.c) - 1) * kSub - (ta - t0))
                           : min(kSub, t0 + len - ta);
    float* vs = B;
    float* gs = vs + kSub * HD;
    float* ks = vs + 2 * kSub * HD;
    float* ws = ks + (j.p == 0 ? 2 : 1) * kSub * kRows;
    float* rs = ws + kSub * kRows;
    const size_t at0 = ((size_t)b * a.T + ta) * step + (size_t)h * HD;
    constexpr int Q = HD / 4;
    for (int x = tid; x < n * Q; x += kThreads) {
      const int s = x / Q, q = x % Q;
      const size_t off = at0 + s * step + q * 4;
      wkv_cp_async16(vs + s * HD + q * 4, a.v + off);
      if (j.p == 1) wkv_cp_async16(gs + s * HD + q * 4, a.dout + off);
    }
    for (int x = tid; x < n * 2; x += kThreads) {
      const int s = x >> 1, q = x & 1;
      const size_t off = at0 + s * step + band * kRows + q * 4;
      wkv_cp_async16(ks + s * kRows + q * 4, a.k + off);
      wkv_cp_async16(ws + s * kRows + q * 4, a.w + off);
      if (j.p == 1) wkv_cp_async16(rs + s * kRows + q * 4, a.r + off);
    }
    wkv_cp_async_commit();
  };

  const float ui = a.u[h * HD + i];
  float2* part = reinterpret_cast<float2*>(bufs + 2 * SA);
  // the reduction after each sub-chunk: thread tid takes step tid / 8 of
  // it and row tid % 8 of the block
  const int red_s = tid >> 3, red_row = tid & 7;
  const int red_i = band * kRows + red_row;
  const float red_u = a.u[h * HD + red_i];
  const size_t red_off = (size_t)b * a.T * step + (size_t)h * HD + red_i;
  float dS[C];
#pragma unroll
  for (int e = 0; e < C; ++e)
    dS[e] = a.dsT != nullptr ? a.dsT[row_off + e] : 0.f;
  float du_acc = 0.f;                  // du's terms at step red_s of each
                                       // sub-chunk, for row red_row
  float S[C];                          // pass 1's running state

  Job cur = first((a.T + a.chunk - 1) / a.chunk - 1);
  fetch(cur, bufs);
  int buf = 0;
  while (cur.c >= 0) {
    const Job nxt = next(cur);
    if (nxt.c >= 0) {                  // the next job's copies fly meanwhile
      fetch(nxt, bufs + (buf ^ 1) * SA);
      wkv_cp_async_wait<1>();
    } else {
      wkv_cp_async_wait<0>();
    }
    __syncthreads();
    const float* B = bufs + buf * SA;
    const float* bp = a.bounds + (size_t)cur.c * a.BH * HD * HD + row_off;
    if (cur.p == 0) {                  // slot m: the state before m + 1
      const float* vs = B;
      const float* ks = vs + 2 * kSub * HD;
      const float* ws = ks + 2 * kSub * kRows;
      if (cur.q == 0) {
#pragma unroll
        for (int e = 0; e < C; ++e) S[e] = bp[e];
      }
      const int halves = 2 * cur.q + 2 < n_sub(cur.c) ? 2 : 1;
      for (int half = 0; half < halves; ++half) {
#pragma unroll
        for (int s = half * kSub; s < (half + 1) * kSub; ++s) {
          const float kk = ks[s * kRows + rl], ww = ws[s * kRows + rl];
          float vv[C];
          wkv_load<C>(vs + s * HD + j0, vv);
#pragma unroll
          for (int e = 0; e < C; ++e)
            S[e] = wkv_state_step(ww, S[e], kk, vv[e]);
        }
        float* sp = slots + (2 * cur.q + half) * C * kThreads + tid;
#pragma unroll
        for (int e = 0; e < C; ++e) sp[e * kThreads] = S[e];
      }
    } else {
      const int t0 = cur.c * a.chunk;
      const int ta = t0 + cur.q * kSub;
      const int n = min(kSub, min(a.chunk, a.T - t0) - cur.q * kSub);
      const float* st0 =
          cur.q == 0 ? bp : slots + (cur.q - 1) * C * kThreads + tid;
      const int stride = cur.q == 0 ? 1 : kThreads;
      if (n == kSub)
        walk_back<HD, true>(a, B, st0, stride, n, ta, bh, i, rl, cg, part,
                            ui, dS);
      else
        walk_back<HD, false>(a, B, st0, stride, n, ta, bh, i, rl, cg, part,
                             ui, dS);
      const float* ks = B + 2 * kSub * HD;
      const float kk = ks[red_s * kRows + red_row];
      const float rr = ks[(2 * kSub + red_s) * kRows + red_row];
      __syncthreads();                 // the partial sums are all written
      if (red_s < n) {                 // the rest of the butterfly, in order
        const float2* pp = part + red_s * kPartStep + red_row * kPartRow;
        float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          const float2 lo = pp[l], up = pp[8 + l];
          x0 = __fadd_rn(x0, lo.x);   // S dout
          x1 = __fadd_rn(x1, lo.y);   // S dS: dw
          x2 = __fadd_rn(x2, up.x);   // dkv v: dk
          x3 = __fadd_rn(x3, up.y);   // v.dout
        }
        const size_t o = red_off + (size_t)(ta + red_s) * step;
        a.dr[o] = __fmaf_rn(__fmul_rn(red_u, kk), x3, x0);
        a.dw[o] = x1;
        a.dk[o] = x2;
        du_acc = __fmaf_rn(__fmul_rn(kk, rr), x3, du_acc);
      }
    }
    __syncthreads();                   // every thread is done with B
    cur = nxt;
    buf ^= 1;
  }
#pragma unroll
  for (int e = 0; e < C; ++e) a.ds0[row_off + e] = dS[e];
  // du: each row's 16 step slots summed in order
  float* du_slots = reinterpret_cast<float*>(part);
  du_slots[tid] = du_acc;
  __syncthreads();
  if (tid < kRows) {
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < kSub; ++q)
      acc = __fadd_rn(acc, du_slots[q * kRows + tid]);
    a.du_part[(size_t)bh * HD + band * kRows + tid] = acc;
  }
}

// ---------------------------------------------------------------------------
// column blocks: dv for 32 columns of one (b, h)
// ---------------------------------------------------------------------------
// floats of one staging buffer: r, k and w [kSub][hd], dout [kSub][kCols]
template <int HD>
__host__ __device__ constexpr int column_stage_floats() {
  return 3 * kSub * HD + kSub * kCols;
}

template <int HD>
__device__ __forceinline__ void column_block(const Args& a, float* smem,
                                             int cb) {
  constexpr int COLS = HD < kCols ? HD : kCols;   // columns of the block
  constexpr int NCB = HD / COLS;       // column blocks of one (b, h)
  constexpr int R = HD / 16;           // rows a thread owns
  constexpr int CA = column_stage_floats<HD>();
  const int bh = cb / NCB, blk = cb % NCB;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = lane & 15;            // rows rg*R .. +R
  const int jl = (tid >> 5) * 8 + (lane >> 4) * 4;   // columns jl .. +4
  const bool live = jl < COLS;         // hd 16: two warps idle
  const int j = blk * COLS + jl;
  const size_t step = (size_t)a.H * HD;
  float* dv = a.dv + (size_t)b * a.T * step + (size_t)h * HD + j + (rg >> 2);

  // tile q's steps into buffer B, committed as one group
  auto fetch = [&](int q, float* B) {
    const int ta = q * kSub;
    const int n = min(kSub, a.T - ta);
    const size_t at0 = ((size_t)b * a.T + ta) * step + (size_t)h * HD;
    constexpr int Q = HD / 4;
    for (int x = tid; x < n * Q; x += kThreads) {
      const int s = x / Q, p = x % Q;
      const size_t off = at0 + s * step + p * 4;
      wkv_cp_async16(B + s * HD + p * 4, a.r + off);
      wkv_cp_async16(B + (kSub + s) * HD + p * 4, a.k + off);
      wkv_cp_async16(B + (2 * kSub + s) * HD + p * 4, a.w + off);
    }
    for (int x = tid; x < n * (COLS / 4); x += kThreads) {
      const int s = x / (COLS / 4), p = x % (COLS / 4);
      wkv_cp_async16(B + 3 * kSub * HD + s * kCols + p * 4,
                     a.dout + at0 + s * step + blk * COLS + p * 4);
    }
    wkv_cp_async_commit();
  };

  float uu[R], dS[R][4];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int i = rg * R + e;
    uu[e] = a.u[h * HD + i];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dS[e][c] = a.dsT != nullptr && live
                     ? a.dsT[((size_t)bh * HD + i) * HD + j + c]
                     : 0.f;
  }
  const int nt = (a.T + kSub - 1) / kSub;
  fetch(nt - 1, smem);
  int buf = 0;
  for (int q = nt - 1; q >= 0; --q) {
    if (q > 0) {
      fetch(q - 1, smem + (buf ^ 1) * CA);
      wkv_cp_async_wait<1>();
    } else {
      wkv_cp_async_wait<0>();
    }
    __syncthreads();
    const float* rs = smem + buf * CA;
    const float* ks = rs + kSub * HD;
    const float* ws = ks + kSub * HD;
    const float* gs = ws + kSub * HD;
    const int ta = q * kSub;
    const int n = min(kSub, a.T - ta);
    // a full tile's 16 steps unrolled whole (no bounds test), so they
    // interleave; a short tile tests each step
    auto tile = [&](auto full) {
#pragma unroll
      for (int s = kSub - 1; s >= 0; --s) {
        if (decltype(full)::value || s < n) {
          float rr[R], kk[R], ww[R], gg[4];
          wkv_load<R>(rs + s * HD + rg * R, rr);
          wkv_load<R>(ks + s * HD + rg * R, kk);
          wkv_load<R>(ws + s * HD + rg * R, ww);
          wkv_load<4>(gs + s * kCols + jl, gg);
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int e = 0; e < R; ++e) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float rgc = __fmul_rn(rr[e], gg[c]);
              const float dkv = __fmaf_rn(uu[e], rgc, dS[e][c]);
              acc[c] = __fmaf_rn(kk[e], dkv, acc[c]);
              dS[e][c] = __fmaf_rn(ww[e], dS[e][c], rgc);
            }
          }
          // four lanes hold each column's sum: all store it, no branch
          dv[(size_t)(ta + s) * step] =
              wkv_reduce16(acc[0], acc[1], acc[2], acc[3], rg);
        }
      }
    };
    if (live) {
      if (n == kSub)
        tile(std::true_type{});
      else
        tile(std::false_type{});
    }
    __syncthreads();                   // every thread is done with buf
    buf ^= 1;
  }
}

// row blocks first: they carry the most work, the column blocks fill in
template <int HD>
__global__ void __launch_bounds__(kThreads) wkv_bwd_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int nrow = a.BH * (HD / kRows);
  if (static_cast<int>(blockIdx.x) < nrow)
    row_block<HD>(a, smem, blockIdx.x);
  else
    column_block<HD>(a, smem, blockIdx.x - nrow);
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
cudaError_t launch_hd(Args a, int B, float* du, cudaStream_t stream) {
  const int span = a.chunk < a.T ? a.chunk : a.T;
  a.nslot = (span + kSub - 1) / kSub - 1;
  const size_t row_f = (size_t)a.nslot * (HD / 16) * kThreads +
                       2 * row_stage_floats<HD>() + 2 * kSub * kPartStep;
  const size_t col_f = 2 * column_stage_floats<HD>();
  const size_t bytes = (row_f > col_f ? row_f : col_f) * sizeof(float);
  if (bytes > 232448) return cudaErrorInvalidValue;  // chunk past ~1700
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const long long grid = (long long)a.BH * (HD / kRows) +
                         (long long)a.BH * (HD < kCols ? 1 : HD / kCols);
  if (grid >= (1LL << 31)) return cudaErrorInvalidValue;
  wkv_bwd_kernel<HD><<<static_cast<unsigned>(grid), kThreads, bytes,
                       stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = a.H * HD;
  wkv_bwd_du<<<(n + 255) / 256, 256, 0, stream>>>(a.du_part, du, B, a.H, HD);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, dout, dr, dk, dv, dw: (B, T, H, hd) float32 contiguous, each
// 16-byte aligned; u and du: (H, hd); bounds: (ceil(T / chunk), B*H, hd,
// hd) from wkv_launch; dsT (may be null) and ds0: (B*H, hd, hd); du_part:
// (B*H, hd); states (may be null): (B*H, T, hd, hd), receives every
// restored state S_{t-1}.
extern "C" int wkv_bwd_launch(const float* r, const float* k, const float* v,
                              const float* w, const float* u,
                              const float* bounds, const float* dout,
                              const float* dsT, float* dr, float* dk,
                              float* dv, float* dw, float* ds0,
                              float* du_part, float* du, float* states,
                              int B, int T, int H, int hd, int chunk,
                              void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{r,  k,  v,  w,   u,       bounds, dout, dsT,   dr, dk, dv,
         dw, ds0, du_part, states, B * H,  T,    H,     chunk, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return static_cast<int>(launch_hd<16>(a, B, du, s));
    case 64:
      return static_cast<int>(launch_hd<64>(a, B, du, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
