// approx_flash_attention: approximate GQA flash attention on the ACU, over
// a contiguous KV cache (kernel 8) or a block-paged KV pool (kernel 9).
//
// Replaces the Pallas kernels src/repro/kernels/flash_attention/approx.py
// (approx_flash_attention_kernel and approx_flash_attention_paged_kernel).
// For each query row b (= batch * Hq + head) and q tile of bq rows:
//
//   codes      q, k, v -> clip(rint(x / s), lo, hi)      (per-tensor scales)
//   s[i, j]  = score_scale * sum_d LUT[q[i, d], k[j, d]]          (int32 sum)
//   softcap, then mask (rowinfo extents, causal, window) to NEG_INF = -1e30
//   online softmax over KV blocks of exactly bk keys:
//     m' = max(m, max_j s), p = exp(s - m'), alpha = exp(m - m')
//     l' = alpha * l + sum_j p
//     acc' = alpha * acc + pv_scale * (sum_j LUT[code(p), v[j, d]] - pad)
//   out = acc / max(l, 1e-30)
//
// with code(p) = clip(rint(p * hi), 0, hi). Query row b reads KV row
// b / rep, or in the paged pool head (b / rep) % Hkv, whose logical block
// ki starts at page_table[b, ki] * bk instead of ki * bk: the only
// difference between the two kernels. Consecutive groups of row_heads query
// rows (the heads of one batch row) share one rowinfo and page-table row.
//
// Semantics held from the reference, all observable under a biased
// multiplier (LUT[0, x] != 0):
//  * KV is walked in the reference's bk blocks, because p is taken relative
//    to the running max at the end of each block;
//  * a tile runs the causal block bound of the whole padded q tile of bq
//    rows, even at decode where one real row sits in a tile of 8;
//  * a masked key has p = 0 (or p = 1 in a block where every key seen so
//    far is masked, the next live block scaling it away with alpha = 0) and
//    still adds LUT[code(p), v];
//  * keys past the end of a contiguous cache hold 0 and the Sk-pad
//    correction clip((ki+1)*bk - seq_k, 0, bk) * LUT[0, 0] is subtracted.
//    The head-dim pad is not materialised: its (dp - d) products of
//    LUT[0, 0] and its correction cancel exactly in the integer sum.
//
// What bounds it on Hopper: as in lut_narrow.cuh, every product is one
// data-dependent gather from the int16 table in shared memory; the bytes
// (Q, the visible K/V, the output) are small beside 2 * rows * keys * d
// lookups except at decode, where one query row reads its whole cache.
// The design: persistent blocks, one per SM, each copying the 128 KiB table
// into shared memory once and walking work items of (query row b, q tile,
// chunk of kRC rows); K and V of a block are quantized once on staging
// (K transposed, so lanes of a warp read consecutive bytes) and reused by
// every row of the chunk; QK and PV each give one output per thread, the
// softmax one row per warp. Padding rows of a q tile are not computed (only
// their tile's block bound is used), so a decode step costs one row.
//
// Decode paths. A call with at most 8 query rows per (batch row, KV head)
// (rep heads x Sq <= 8, head dim 64 or 128, K/V rows 16-byte aligned) runs
// one of two decode kernels instead, chosen by the wrapper
// (kernels/flash_attention/ops.py: decode_plan). At decode the general
// path above stages and quantizes each K/V block once per query row and
// idles most of its 256 threads behind five block-wide barriers a block;
// the decode paths share the work of one KV head instead:
//  * a work item is one (batch row, KV head) with its rep query heads,
//    rows b = g * rep + t (ir = b / row_heads and kvr = b / rep, or (b /
//    rep) % KH in the pool, as above), on a group of 8 warps: one warp a
//    query row; the warps without a row copy keys with cp.async into a
//    ring of 4 stages and quantize the next stage (K by key, V
//    transposed, padded so that a warp's code loads hit distinct banks)
//    while the row warps compute the current one, so every key is read
//    and quantized once per item for all its rows. The correctly rounded
//    quantizers cost more than the gathers of a stage;
//  * the item's warps meet at one named barrier a stage: no block-wide
//    barrier inside the KV loop. Blocks of 512 threads hold two items
//    where shared memory allows (contiguous: one while the items are no
//    more than the SMs, so that each has an SM of its own);
//  * per stage and row, in one warp: QK as 16 keys x 2 halves of the head
//    dim over the lanes, one shuffle to add the halves; the online softmax
//    with the same reductions as the path above; PV as the head dim over
//    the lanes, 16 gathers each.
// Paged (kernel 9, approx_decode_kernel): a stage is one 16-key page, K
// and V, read through the item's page-table row (staged once per item);
// the page is the reference's bk, so each stage ends with its softmax and
// PV. Contiguous (kernel 8, approx_decode_contig_kernel): the reference's
// bk is min(128, round_up(Sk, 128)) keys, and p is taken against the
// running max at the end of each bk block. So a stage is 32 keys (two
// 16-key tiles) of K or of V, streamed in the order the rows use them: a
// block's bk/32 K stages (each row warp keeps the block's bk scores in
// shared memory), the softmax, then its bk/32 V stages (int32 PV
// partials, folded into acc with the Sk-pad correction at the block's
// last stage). A block that holds one item gives it all 16 warps, and a
// row warp keeps its Q codes (as table-row offsets) in shared memory: at
// 512 threads a thread has 128 registers, and the gathers in flight need
// them more (measured: both lowered the call's time). Keys past the
// cache's end are copied as zeros (cp.async zero fill). KV is never split
// across items (a flash-decoding merge would take p against another max:
// another function).
// Every semantic above holds on both: KV walked in order in the
// reference's blocks, the causal bound of the whole padded q tile, masked
// keys adding LUT[code(p), v], the alpha = 0 rescale of a fully masked
// block, the Sk-pad correction, K/V read in place through their strides.
//
// Float glue: __fdiv_rn in the quantizers, rintf (half to even), expf and
// tanhf (no fast math), __fmul_rn / __fadd_rn where the reference rounds a
// product and a sum separately. The scales stay on the device.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRC = 32;          // query rows per work item
constexpr float kNegInf = -1e30f;

__host__ __device__ inline size_t round_up16(size_t bytes) {
  return (bytes + 15) & ~size_t(15);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int quantize_symmetric(float x, float s, float lo,
                                                  float hi) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), lo), hi));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int16_t* lut;
  const int* rowinfo;     // (BH / row_heads, 3): q_base, kv_start, kv_len
  const int* page_table;  // (BH / row_heads, n_kv), paged only
  const float* sq;
  const float* sk;
  const float* sv;
  const float* score_scale;
  const float* pv_scale;
  float* out;             // (BH, Sq, D)
  int BH, Sq, D, seq_k, bq, bk, n_kv, rep, QH, KH;
  int row_heads;          // query rows sharing one rowinfo / page-table row
  long long qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss;
  int n_codes, offset, lo, hi, causal, window, has_softcap, paged;
  float softcap;
  int dec_rows;           // decode path: query heads of one item (0: off)
  int dec_items;          // decode path: items per block
};

// Shared memory carve-up, the same on host and device.
struct Layout {
  size_t lut, q, kt, v, s, p, acc, stats, total;
  __host__ __device__ Layout(int n_codes, int D, int bk) {
    lut = 0;
    q = lut + round_up16((size_t)n_codes * n_codes * 2);
    kt = q + round_up16((size_t)kRC * D * 2);
    v = kt + round_up16((size_t)D * bk);
    s = v + round_up16((size_t)bk * D);
    p = s + round_up16((size_t)kRC * bk * 4);
    acc = p + round_up16((size_t)kRC * bk * 2);
    stats = acc + round_up16((size_t)kRC * D * 4);
    total = stats + 3 * round_up16(kRC * 4);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
approx_attention_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(p.n_codes, p.D, p.bk);
  int16_t* lut = reinterpret_cast<int16_t*>(smem + L.lut);
  uint16_t* q_rows = reinterpret_cast<uint16_t*>(smem + L.q);  // code*n
  uint8_t* k_t = smem + L.kt;                                  // [D][bk]
  uint8_t* v_c = smem + L.v;                                   // [bk][D]
  float* S = reinterpret_cast<float*>(smem + L.s);             // [kRC][bk]
  uint16_t* P = reinterpret_cast<uint16_t*>(smem + L.p);       // [kRC][bk]
  float* acc = reinterpret_cast<float*>(smem + L.acc);         // [kRC][D]
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* l_s = m_s + round_up16(kRC * 4) / 4;
  float* a_s = l_s + round_up16(kRC * 4) / 4;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = p.n_codes, D = p.D, bk = p.bk;
  for (int i = tid; i < n * n; i += kThreads) lut[i] = p.lut[i];
  __syncthreads();
  const int m00 = lut[p.offset * n + p.offset];

  const T* qg = static_cast<const T*>(p.q);
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  const float sq = *p.sq, sk = *p.sk, sv = *p.sv;
  const float score_scale = *p.score_scale, pv_scale = *p.pv_scale;
  const float lo = static_cast<float>(p.lo), hi = static_cast<float>(p.hi);

  const int n_qt = (p.Sq + p.bq - 1) / p.bq;
  const int chunks = (p.bq + kRC - 1) / kRC;
  const int n_items = p.BH * n_qt * chunks;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int c = item % chunks;
    const int qt = (item / chunks) % n_qt;
    const int b = item / (chunks * n_qt);
    const int r0 = qt * p.bq + c * kRC;
    const int r_end = min(min(qt * p.bq + min((c + 1) * kRC, p.bq), p.Sq),
                          r0 + kRC);
    const int rows = r_end - r0;   // real query rows of this work item
    if (rows <= 0) continue;       // uniform across the block
    const int ir = b / p.row_heads;
    const int q_base = p.rowinfo[3 * ir];
    const int kv_start = p.rowinfo[3 * ir + 1];
    const int kv_len = p.rowinfo[3 * ir + 2];
    const int n_eff =
        p.causal ? min(p.n_kv, floor_div(q_base + (qt + 1) * p.bq - 1, bk) + 1)
                 : p.n_kv;
    int kvr = b / p.rep;
    if (p.paged) kvr %= p.KH;
    const long long k_off = (kvr / p.KH) * p.ksb + (kvr % p.KH) * p.ksh;
    const long long v_off = (kvr / p.KH) * p.vsb + (kvr % p.KH) * p.vsh;
    const long long q_off = (b / p.QH) * p.qsb + (b % p.QH) * p.qsh;

    __syncthreads();  // the previous item's epilogue is done with acc, l
    for (int e = tid; e < rows * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const float x = to_float(qg[q_off + (long long)(r0 + r) * p.qss + d]);
      q_rows[r * D + d] = static_cast<uint16_t>(
          (quantize_symmetric(x, sq, lo, hi) + p.offset) * n);
      acc[r * D + d] = 0.f;
    }
    for (int r = tid; r < rows; r += kThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
    }

    for (int ki = 0; ki < n_eff; ++ki) {
      const int start = p.paged ? p.page_table[ir * p.n_kv + ki] * bk : ki * bk;
      __syncthreads();  // the previous block's readers are done
      // K transposed, keys fastest (consecutive bytes in shared memory)
      for (int e = tid; e < bk * D; e += kThreads) {
        const int j = e % bk, d = e / bk;
        float x = 0.f;  // keys past a contiguous cache's end hold 0
        if (ki * bk + j < p.seq_k)
          x = to_float(kg[k_off + (long long)(start + j) * p.kss + d]);
        k_t[d * bk + j] =
            static_cast<uint8_t>(quantize_symmetric(x, sk, lo, hi) + p.offset);
      }
      for (int e = tid; e < bk * D; e += kThreads) {
        const int j = e / D, d = e % D;
        float x = 0.f;
        if (ki * bk + j < p.seq_k)
          x = to_float(vg[v_off + (long long)(start + j) * p.vss + d]);
        v_c[j * D + d] =
            static_cast<uint8_t>(quantize_symmetric(x, sv, lo, hi) + p.offset);
      }
      __syncthreads();

      // scores: one (row, key) pair per thread and step
      for (int e = tid; e < rows * bk; e += kThreads) {
        const int r = e / bk, j = e % bk;
        const uint16_t* qr = q_rows + r * D;
        int s_int = 0;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s_int += lut[qr[d] + k_t[d * bk + j]];
        float s = __fmul_rn(__int2float_rn(s_int), score_scale);
        if (p.has_softcap)
          s = __fmul_rn(p.softcap, tanhf(__fdiv_rn(s, p.softcap)));
        const int k_pos = ki * bk + j, q_pos = q_base + r0 + r;
        bool live = k_pos >= kv_start && k_pos < kv_len;
        if (p.causal) live = live && k_pos <= q_pos;
        if (p.window >= 0) live = live && k_pos > q_pos - p.window;
        S[r * bk + j] = live ? s : kNegInf;
      }
      __syncthreads();

      // online softmax: one row per warp
      for (int r = warp; r < rows; r += kWarps) {
        float mx = kNegInf;
        for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, S[r * bk + j]);
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        float psum = 0.f;
        for (int j = lane; j < bk; j += 32) {
          const float pj = expf(__fsub_rn(S[r * bk + j], m_new));
          psum = __fadd_rn(psum, pj);
          const float code = fminf(fmaxf(rintf(__fmul_rn(pj, hi)), 0.f), hi);
          P[r * bk + j] =
              static_cast<uint16_t>((static_cast<int>(code) + p.offset) * n);
        }
        for (int o = 16; o > 0; o >>= 1)
          psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, o));
        if (lane == 0) {
          const float alpha = expf(__fsub_rn(m_old, m_new));
          a_s[r] = alpha;
          l_s[r] = __fadd_rn(__fmul_rn(alpha, l_s[r]), psum);
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      // PV: one (row, head-dim) output per thread and step
      const int pad = min(max((ki + 1) * bk - p.seq_k, 0), bk);
      for (int e = tid; e < rows * D; e += kThreads) {
        const int r = e / D, d = e % D;
        const uint16_t* pr = P + r * bk;
        int pv_int = 0;
#pragma unroll 8
        for (int j = 0; j < bk; ++j) pv_int += lut[pr[j] + v_c[j * D + d]];
        pv_int -= pad * m00;
        const float pv = __fmul_rn(__int2float_rn(pv_int), pv_scale);
        acc[e] = __fadd_rn(__fmul_rn(acc[e], a_s[r]), pv);
      }
    }
    __syncthreads();
    for (int e = tid; e < rows * D; e += kThreads) {
      const int r = e / D, d = e % D;
      p.out[((size_t)b * p.Sq + r0 + r) * D + d] =
          __fdiv_rn(acc[e], fmaxf(l_s[r], 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// decode paths: one item (batch row, KV head) on a group of 8 warps, one
// warp a query row, the others copying and quantizing its keys
// ---------------------------------------------------------------------------
constexpr int kPage = 16;          // keys of one page / one tile
constexpr int kStages = 4;         // cp.async ring depth
constexpr int kItemWarps = 8;      // warps of one item
constexpr int kDecodeThreads = 512;  // at most two items a block

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// cp.async with zero fill: src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// the warps of one item only (a named barrier, never the whole block)
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The 128 KiB table into shared memory, every 16-byte copy in flight at
// once; returns after the block's barrier.
__device__ __forceinline__ void stage_table(int16_t* lut, const int16_t* src,
                                            int n, int tid) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n * n) % 8 == 0) {
    const char* s = reinterpret_cast<const char*>(src);
    char* d = reinterpret_cast<char*>(lut);
    for (int i = tid * 16; i < n * n * 2; i += kDecodeThreads * 16)
      cp_async16(d + i, s + i);
    cp_commit();
    cp_wait<0>();
  } else {
    for (int i = tid; i < n * n; i += kDecodeThreads) lut[i] = src[i];
  }
  __syncthreads();
}

// Code buffers of one 16-key tile: K by key (rows of D + 8 bytes), V
// transposed (rows of 16 keys padded to 20 bytes), both so that a warp's
// code loads hit distinct banks.
template <int D>
struct TileCodes {
  static constexpr int KS = D + 8;
  static constexpr int VS = kPage + 4;
};

// raw K (16 keys x D, as stored) -> K codes
template <typename T, int D>
__device__ __forceinline__ void quantize_k_tile(const T* rk, uint8_t* kc,
                                                float s, float lo, float hi,
                                                int offset, int qtid,
                                                int qthreads) {
  for (int e = qtid; e < kPage * D / 4; e += qthreads) {
    const int jj = e / (D / 4), d4 = (e % (D / 4)) * 4;  // 4 dims of a key
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      word |= static_cast<uint32_t>(
                  quantize_symmetric(to_float(rk[jj * D + d4 + c]), s, lo,
                                     hi) +
                  offset)
              << (8 * c);
    *reinterpret_cast<uint32_t*>(kc + jj * TileCodes<D>::KS + d4) = word;
  }
}

// raw V (16 keys x D, as stored) -> V codes, transposed
template <typename T, int D>
__device__ __forceinline__ void quantize_v_tile(const T* rv, uint8_t* vt,
                                                float s, float lo, float hi,
                                                int offset, int qtid,
                                                int qthreads) {
  for (int e = qtid; e < D * kPage / 4; e += qthreads) {
    const int d = e % D, j4 = (e / D) * 4;  // 4 keys of one dim
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      word |= static_cast<uint32_t>(
                  quantize_symmetric(to_float(rv[(j4 + c) * D + d]), s, lo,
                                     hi) +
                  offset)
              << (8 * c);
    *reinterpret_cast<uint32_t*>(vt + d * TileCodes<D>::VS + j4) = word;
  }
}

// QK of one query row over one 16-key tile: lane (j, h) sums key j over
// its half h of the head dim (qo: its Q codes as table-row byte offsets,
// head dims 4 * (2u + h) + c); one shuffle adds the halves
template <int D>
__device__ __forceinline__ int qk_tile(const uint8_t* kc,
                                       const int (&qo)[D / 2],
                                       const char* lut_b, int j, int h) {
  int s_int = 0;
#pragma unroll
  for (int u = 0; u < D / 8; ++u) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(
        kc + j * TileCodes<D>::KS + 4 * (2 * u + h));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s_int += *reinterpret_cast<const int16_t*>(
          lut_b + qo[4 * u + c] + (((w >> (8 * c)) & 0xff) << 1));
  }
  return s_int + __shfl_xor_sync(0xffffffffu, s_int, 16);
}

// The same over Q offsets kept in shared memory (qs: the row's D table-row
// byte offsets): one broadcast 16-byte load serves 4 gathers, and the 32
// or 64 registers qo would hold stay free for gathers in flight
template <int D>
__device__ __forceinline__ int qk_tile_s(const uint8_t* kc, const int* qs,
                                         const char* lut_b, int j, int h) {
  int s_int = 0;
#pragma unroll
  for (int u = 0; u < D / 8; ++u) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(
        kc + j * TileCodes<D>::KS + 4 * (2 * u + h));
    const int4 q4 = *reinterpret_cast<const int4*>(qs + 4 * (2 * u + h));
    s_int += *reinterpret_cast<const int16_t*>(lut_b + q4.x +
                                               ((w & 0xff) << 1)) +
             *reinterpret_cast<const int16_t*>(lut_b + q4.y +
                                               (((w >> 8) & 0xff) << 1)) +
             *reinterpret_cast<const int16_t*>(lut_b + q4.z +
                                               (((w >> 16) & 0xff) << 1)) +
             *reinterpret_cast<const int16_t*>(lut_b + q4.w +
                                               ((w >> 24) << 1));
  }
  return s_int + __shfl_xor_sync(0xffffffffu, s_int, 16);
}

// PV of one query row over one 16-key tile: head dims lane + 32u, 16
// gathers each at the keys' probability-code rows pr (byte offsets)
template <int D>
__device__ __forceinline__ void pv_tile(const uint8_t* vt,
                                        const int (&pr)[kPage],
                                        const char* lut_b, int lane,
                                        int (&pv)[D / 32]) {
#pragma unroll
  for (int u = 0; u < D / 32; ++u) {
    const int d = lane + 32 * u;
#pragma unroll
    for (int w4 = 0; w4 < kPage / 4; ++w4) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          vt + d * TileCodes<D>::VS + 4 * w4);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pv[u] += *reinterpret_cast<const int16_t*>(
            lut_b + pr[4 * w4 + c] + (((w >> (8 * c)) & 0xff) << 1));
    }
  }
}

// a row warp's Q codes, as table row byte offsets: head dims 4 * (2u + h)
// + c, the ones its lane's QK half reads
template <typename T, int D>
__device__ __forceinline__ void load_q(const T* qg, long long q_off, int h,
                                       float sq, float lo, float hi,
                                       int offset, int row_bytes,
                                       int (&qo)[D / 2]) {
#pragma unroll
  for (int u = 0; u < D / 8; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = to_float(qg[q_off + 4 * (2 * u + h) + c]);
      qo[4 * u + c] = (quantize_symmetric(x, sq, lo, hi) + offset) * row_bytes;
    }
}

// Which of an item's iw warps do what: a row warp (rw < rows) computes
// one query row; the quantizer warps (the ones without a row, or all of
// them when every warp has one) copy and quantize keys.
struct ItemRoles {
  int rows, rw, q0, qthreads, qtid, gthreads, gtid, bar_item, bar_quant;
  bool is_row, is_quant;
  __device__ ItemRoles(int warp, int lane, int slot, int items, int n_rows,
                       int iw) {
    rows = n_rows;
    rw = warp % iw;
    is_row = rw < rows;
    q0 = rows < iw ? rows : 0;
    is_quant = rw >= q0;
    qthreads = (iw - q0) * 32;
    qtid = (rw - q0) * 32 + lane;
    gthreads = iw * 32;
    gtid = rw * 32 + lane;
    bar_item = 1 + slot;
    bar_quant = 1 + items + slot;
  }
};

// Shared memory of the paged decode path: the table, then per item slot a
// ring of raw pages (K then V, as stored), two buffers each of K and V
// codes and the item's page-table row.
struct DecodeLayout {
  size_t ring, page, kc, vt, pages, slot, base, total;
  __host__ __device__ DecodeLayout(int n_codes, int D, int es, int items,
                                   int n_kv) {
    page = (size_t)2 * kPage * D * es;
    ring = kStages * page;
    kc = round_up16((size_t)kPage * (D + 8));
    vt = round_up16((size_t)D * (kPage + 4));
    pages = round_up16((size_t)n_kv * 4);
    slot = ring + 2 * kc + 2 * vt + pages;
    base = round_up16((size_t)n_codes * n_codes * 2);
    total = base + items * slot;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads, 1)
approx_decode_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DecodeLayout L(p.n_codes, D, sizeof(T), p.dec_items, p.n_kv);
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  const char* lut_b = reinterpret_cast<const char*>(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = p.n_codes, row_bytes = 2 * n;
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte copies a key
  stage_table(lut, p.lut, n, tid);  // the last block-wide barrier

  const int slot = warp / kItemWarps;
  if (slot >= p.dec_items) return;  // a block with one item: idle warps
  const ItemRoles R(warp, lane, slot, p.dec_items, p.dec_rows * p.Sq,
                    kItemWarps);
  const int t = R.rw / p.Sq, r = R.rw % p.Sq;  // a row warp's head, query
  unsigned char* ring = smem + L.base + slot * L.slot;
  uint8_t* kc0 = ring + L.ring;
  uint8_t* vt0 = kc0 + 2 * L.kc;
  int* pt = reinterpret_cast<int*>(vt0 + 2 * L.vt);  // this item's pages

  const T* qg = static_cast<const T*>(p.q);
  const char* kg = static_cast<const char*>(p.k);
  const char* vg = static_cast<const char*>(p.v);
  const float sq = *p.sq, sk = *p.sk, sv = *p.sv;
  const float score_scale = *p.score_scale, pv_scale = *p.pv_scale;
  const float lo = static_cast<float>(p.lo), hi = static_cast<float>(p.hi);
  const int m00 = lut[p.offset * n + p.offset];
  const int j = lane & 15, h = lane >> 4;  // QK: key, half of the head dim
  const int n_items = p.BH / p.dec_rows;

  for (int g = blockIdx.x * p.dec_items + slot; g < n_items;
       g += gridDim.x * p.dec_items) {
    const int b0 = g * p.dec_rows, b = b0 + t;
    const int ir = b0 / p.row_heads;
    const int kvr = (b0 / p.rep) % p.KH;
    const int q_base = p.rowinfo[3 * ir];
    const int kv_start = p.rowinfo[3 * ir + 1];
    const int kv_len = p.rowinfo[3 * ir + 2];
    const int n_eff =
        p.causal ? min(p.n_kv, floor_div(q_base + p.bq - 1, kPage) + 1)
                 : p.n_kv;
    const long long k_off = kvr * p.ksh, v_off = kvr * p.vsh;
    // the page-table row, read once: a page's copy then waits on nothing
    group_sync(R.bar_item, R.gthreads);  // the previous item is done with it
    for (int i = R.gtid; i < n_eff; i += R.gthreads)
      pt[i] = p.page_table[(size_t)ir * p.n_kv + i];
    group_sync(R.bar_item, R.gthreads);

    auto issue = [&](int page) {   // page's raw K and V into its ring slot
      if (page < n_eff) {
        const long long start = (long long)pt[page] * kPage;
        unsigned char* dst = ring + (page % kStages) * L.page;
        for (int e = R.qtid; e < 2 * kPage * CPR; e += R.qthreads) {
          const int kv = e / (kPage * CPR), jj = (e / CPR) % kPage;
          const int ch = e % CPR;
          const char* src =
              kv == 0 ? kg + ((k_off + (start + jj) * p.kss) * sizeof(T))
                      : vg + ((v_off + (start + jj) * p.vss) * sizeof(T));
          cp_async16(dst + (size_t)e * 16, src + ch * 16);
        }
      }
      cp_commit();
    };
    auto quantize_page = [&](int page) {  // ring -> codes[page % 2]
      const T* rk =
          reinterpret_cast<const T*>(ring + (page % kStages) * L.page);
      quantize_k_tile<T, D>(rk, kc0 + (page & 1) * L.kc, sk, lo, hi,
                            p.offset, R.qtid, R.qthreads);
      quantize_v_tile<T, D>(rk + kPage * D, vt0 + (page & 1) * L.vt, sv, lo,
                            hi, p.offset, R.qtid, R.qthreads);
    };

    int qo[D / 2];
    float m_run = kNegInf, l_run = 0.f, acc[D / 32];
#pragma unroll
    for (int u = 0; u < D / 32; ++u) acc[u] = 0.f;
    if (R.is_row)
      load_q<T, D>(qg, (b / p.QH) * p.qsb + (b % p.QH) * p.qsh +
                           (long long)r * p.qss,
                   h, sq, lo, hi, p.offset, row_bytes, qo);

    if (R.is_quant) {
      for (int s = 0; s < kStages - 1; ++s) issue(s);
      cp_wait<kStages - 2>();              // page 0 (this thread's copies)
      group_sync(R.bar_quant, R.qthreads);  // ... and every quantizer's
      if (n_eff > 0) quantize_page(0);
      cp_wait<kStages - 3>();              // page 1
    }
    group_sync(R.bar_item, R.gthreads);

    for (int ki = 0; ki < n_eff; ++ki) {
      if (R.is_quant) issue(ki + kStages - 1);
      if (R.is_row) {
        const uint8_t* kc = kc0 + (ki & 1) * L.kc;
        const uint8_t* vt = vt0 + (ki & 1) * L.vt;

        // scores: lane (j, h) sums key j over its half of the head dim
        const int s_int = qk_tile<D>(kc, qo, lut_b, j, h);
        float sc = __fmul_rn(__int2float_rn(s_int), score_scale);
        if (p.has_softcap)
          sc = __fmul_rn(p.softcap, tanhf(__fdiv_rn(sc, p.softcap)));
        const int k_pos = ki * kPage + j, q_pos = q_base + r;
        bool live = k_pos >= kv_start && k_pos < kv_len;
        if (p.causal) live = live && k_pos <= q_pos;
        if (p.window >= 0) live = live && k_pos > q_pos - p.window;
        const float sj = lane < kPage ? (live ? sc : kNegInf) : kNegInf;

        // online softmax, reduced as the general path reduces it
        float mx = sj;
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m_run, mx);
        float pj = 0.f, psum = 0.f;
        if (lane < kPage) {
          pj = expf(__fsub_rn(sj, m_new));
          psum = __fadd_rn(psum, pj);
        }
        for (int o = 16; o > 0; o >>= 1)
          psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, o));
        const float code = fminf(fmaxf(rintf(__fmul_rn(pj, hi)), 0.f), hi);
        const int prow = (static_cast<int>(code) + p.offset) * row_bytes;
        const float alpha = expf(__fsub_rn(m_run, m_new));
        l_run = __fadd_rn(__fmul_rn(alpha, l_run), psum);
        m_run = m_new;

        // PV: head dims lane + 32u, 16 gathers each
        int pr[kPage];
#pragma unroll
        for (int jj = 0; jj < kPage; ++jj)
          pr[jj] = __shfl_sync(0xffffffffu, prow, jj);
        const int pad = min(max((ki + 1) * kPage - p.seq_k, 0), kPage);
        int pv_int[D / 32];
#pragma unroll
        for (int u = 0; u < D / 32; ++u) pv_int[u] = 0;
        pv_tile<D>(vt, pr, lut_b, lane, pv_int);
#pragma unroll
        for (int u = 0; u < D / 32; ++u) {
          const float pv =
              __fmul_rn(__int2float_rn(pv_int[u] - pad * m00), pv_scale);
          acc[u] = __fadd_rn(__fmul_rn(acc[u], alpha), pv);
        }
      }
      if (R.is_quant) {
        if (ki + 1 < n_eff) quantize_page(ki + 1);
        cp_wait<kStages - 3>();        // page ki + 2 (this thread's copies)
      }
      group_sync(R.bar_item, R.gthreads);
    }
    if (R.is_row) {
      const float denom = fmaxf(l_run, 1e-30f);
#pragma unroll
      for (int u = 0; u < D / 32; ++u)
        p.out[((size_t)b * p.Sq + r) * D + lane + 32 * u] =
            __fdiv_rn(acc[u], denom);
    }
  }
  cp_wait<0>();
}

// The contiguous path's stage: kContigSub 16-key tiles of K or of V (32
// keys), so that a 128-key block takes 8 stages, each with twice a
// page-tile's work behind one barrier; a ring of 4 such stages.
constexpr int kContigSub = 2;
constexpr int kContigKeys = kContigSub * kPage;
constexpr int kContigStages = 4;

// Shared memory of the contiguous decode path: the table, then per item
// slot a ring of raw stages (32 keys of K or V, as stored), two code
// buffers (a stage's K or V tiles each), each row warp's bk scores, which
// its softmax overwrites with the keys' probability-code rows, and each
// row's D Q codes as table-row byte offsets.
struct ContigLayout {
  size_t tile, ring, sub, codes, scores, qoff, slot, base, total;
  __host__ __device__ ContigLayout(int n_codes, int D, int es, int items,
                                   int bk) {
    tile = (size_t)kContigKeys * D * es;
    ring = kContigStages * tile;
    const size_t kbytes = (size_t)kPage * (D + 8), vbytes =
        (size_t)D * (kPage + 4);
    sub = round_up16(kbytes > vbytes ? kbytes : vbytes);
    codes = kContigSub * sub;
    scores = round_up16((size_t)kItemWarps * bk * 4);
    qoff = round_up16((size_t)kItemWarps * D * 4);
    slot = ring + 2 * codes + scores + qoff;
    base = round_up16((size_t)n_codes * n_codes * 2);
    total = base + items * slot;
  }
};

// Contiguous decode (kernel 8): the item's keys stream in stages of 32
// keys in the order its rows consume them, for each bk block its bk/32
// stages of K and then its bk/32 stages of V. A row warp writes each K
// tile's 16 scores, takes the block's softmax after its last K stage (the
// reference's bk block, not the stage), and sums each V tile's PV into
// int32 partials that the block's last V stage corrects for the Sk pad
// and folds into acc.
template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads, 1)
approx_decode_contig_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ContigLayout L(p.n_codes, D, sizeof(T), p.dec_items, p.bk);
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  const char* lut_b = reinterpret_cast<const char*>(smem);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n = p.n_codes, row_bytes = 2 * n, bk = p.bk;
  constexpr int CPR = D * (int)sizeof(T) / 16;  // 16-byte copies a key
  stage_table(lut, p.lut, n, tid);  // the last block-wide barrier

  // an item's warps: all 16 of a block that holds one item (more
  // quantizers for its few rows), 8 of one that holds two
  const int iw = kDecodeThreads / 32 / p.dec_items;
  const int slot = warp / iw;
  const ItemRoles R(warp, lane, slot, p.dec_items, p.dec_rows * p.Sq, iw);
  const int t = R.rw / p.Sq, r = R.rw % p.Sq;
  unsigned char* ring = smem + L.base + slot * L.slot;
  uint8_t* codes0 = ring + L.ring;
  float* S = reinterpret_cast<float*>(codes0 + 2 * L.codes) +
             (R.rw % kItemWarps) * bk;            // this row warp's scores
  int* P = reinterpret_cast<int*>(S);              // ... then its p rows
  int* qs = reinterpret_cast<int*>(codes0 + 2 * L.codes + L.scores) +
            (R.rw % kItemWarps) * D;              // its Q offsets

  const T* qg = static_cast<const T*>(p.q);
  const char* kg = static_cast<const char*>(p.k);
  const char* vg = static_cast<const char*>(p.v);
  const float sq = *p.sq, sk = *p.sk, sv = *p.sv;
  const float score_scale = *p.score_scale, pv_scale = *p.pv_scale;
  const float lo = static_cast<float>(p.lo), hi = static_cast<float>(p.hi);
  const int m00 = lut[p.offset * n + p.offset];
  const int j = lane & 15, h = lane >> 4;
  const int nst = bk / kContigKeys, per_block = 2 * nst;
  const int n_items = p.BH / p.dec_rows;

  for (int g = blockIdx.x * p.dec_items + slot; g < n_items;
       g += gridDim.x * p.dec_items) {
    const int b0 = g * p.dec_rows, b = b0 + t;
    const int ir = b0 / p.row_heads;
    const int kvr = b0 / p.rep;
    const int q_base = p.rowinfo[3 * ir];
    const int kv_start = p.rowinfo[3 * ir + 1];
    const int kv_len = p.rowinfo[3 * ir + 2];
    // the causal bound of the whole padded q tile of bq rows
    const int n_eff =
        p.causal ? min(p.n_kv, floor_div(q_base + p.bq - 1, bk) + 1)
                 : p.n_kv;
    const int n_stages = n_eff * per_block;
    const char* kbase =
        kg + ((kvr / p.KH) * p.ksb + (kvr % p.KH) * p.ksh) * sizeof(T);
    const char* vbase =
        vg + ((kvr / p.KH) * p.vsb + (kvr % p.KH) * p.vsh) * sizeof(T);

    // stage -> its raw 32 keys in the ring; keys past the cache hold 0
    auto issue = [&](int st) {
      if (st < n_stages) {
        const int w = st % per_block;
        const bool is_v = w >= nst;
        const int key0 =
            (st / per_block) * bk + (is_v ? w - nst : w) * kContigKeys;
        const char* base = is_v ? vbase : kbase;
        const long long stride = (is_v ? p.vss : p.kss) * sizeof(T);
        unsigned char* dst = ring + (st % kContigStages) * L.tile;
        for (int e = R.qtid; e < kContigKeys * CPR; e += R.qthreads) {
          const int key = key0 + e / CPR;
          const bool ok = key < p.seq_k;
          cp_async16(dst + (size_t)e * 16,
                     ok ? base + key * stride + (e % CPR) * 16 : base,
                     ok ? 16 : 0);
        }
      }
      cp_commit();
    };
    auto quantize_stage = [&](int st) {  // ring -> codes[st % 2]
      const T* raw =
          reinterpret_cast<const T*>(ring + (st % kContigStages) * L.tile);
      uint8_t* dst = codes0 + (st & 1) * L.codes;
#pragma unroll
      for (int sb = 0; sb < kContigSub; ++sb) {
        if (st % per_block < nst)
          quantize_k_tile<T, D>(raw + sb * kPage * D, dst + sb * L.sub, sk,
                                lo, hi, p.offset, R.qtid, R.qthreads);
        else
          quantize_v_tile<T, D>(raw + sb * kPage * D, dst + sb * L.sub, sv,
                                lo, hi, p.offset, R.qtid, R.qthreads);
      }
    };

    float m_run = kNegInf, l_run = 0.f, alpha = 1.f, acc[D / 32];
    int pv_int[D / 32];
#pragma unroll
    for (int u = 0; u < D / 32; ++u) {
      acc[u] = 0.f;
      pv_int[u] = 0;
    }
    group_sync(R.bar_item, R.gthreads);  // the previous item is done
    if (R.is_row) {
      const long long q_off =
          (b / p.QH) * p.qsb + (b % p.QH) * p.qsh + (long long)r * p.qss;
      for (int dd = lane; dd < D; dd += 32)
        qs[dd] = (quantize_symmetric(to_float(qg[q_off + dd]), sq, lo, hi) +
                  p.offset) *
                 row_bytes;
      __syncwarp();
    }
    if (R.is_quant) {
      for (int st = 0; st < kContigStages - 1; ++st) issue(st);
      cp_wait<kContigStages - 2>();        // stage 0 (this thread's copies)
      group_sync(R.bar_quant, R.qthreads);  // ... and every quantizer's
      if (n_stages > 0) quantize_stage(0);
      cp_wait<kContigStages - 3>();        // stage 1
    }
    group_sync(R.bar_item, R.gthreads);

    for (int st = 0; st < n_stages; ++st) {
      if (R.is_quant) issue(st + kContigStages - 1);
      if (R.is_row) {
        const uint8_t* codes = codes0 + (st & 1) * L.codes;
        const int ki = st / per_block, w = st % per_block;
        if (w < nst) {
          // scores of keys (w * 2 + sb) * 16 + j of block ki
#pragma unroll
          for (int sb = 0; sb < kContigSub; ++sb) {
            const int key = (w * kContigSub + sb) * kPage + j;
            const int s_int = qk_tile_s<D>(codes + sb * L.sub, qs, lut_b, j,
                                           h);
            float sc = __fmul_rn(__int2float_rn(s_int), score_scale);
            if (p.has_softcap)
              sc = __fmul_rn(p.softcap, tanhf(__fdiv_rn(sc, p.softcap)));
            const int k_pos = ki * bk + key, q_pos = q_base + r;
            bool live = k_pos >= kv_start && k_pos < kv_len;
            if (p.causal) live = live && k_pos <= q_pos;
            if (p.window >= 0) live = live && k_pos > q_pos - p.window;
            if (h == 0) S[key] = live ? sc : kNegInf;
          }
          if (w == nst - 1) {
            // the block's online softmax over its bk scores
            __syncwarp();
            float mx = kNegInf;
            for (int jj = lane; jj < bk; jj += 32) mx = fmaxf(mx, S[jj]);
            for (int o = 16; o > 0; o >>= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m_run, mx);
            float psum = 0.f;
            for (int jj = lane; jj < bk; jj += 32) {
              const float pj = expf(__fsub_rn(S[jj], m_new));
              psum = __fadd_rn(psum, pj);
              const float code =
                  fminf(fmaxf(rintf(__fmul_rn(pj, hi)), 0.f), hi);
              P[jj] = (static_cast<int>(code) + p.offset) * row_bytes;
            }
            for (int o = 16; o > 0; o >>= 1)
              psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, o));
            alpha = expf(__fsub_rn(m_run, m_new));
            l_run = __fadd_rn(__fmul_rn(alpha, l_run), psum);
            m_run = m_new;
            __syncwarp();
          }
        } else {
          // PV of keys ((w - nst) * 2 + sb) * 16 .. +15 of block ki
          const int sp = w - nst;
#pragma unroll
          for (int sb = 0; sb < kContigSub; ++sb) {
            int pr[kPage];
            const int* prow = P + (sp * kContigSub + sb) * kPage;
#pragma unroll
            for (int q4 = 0; q4 < kPage / 4; ++q4) {
              const int4 v4 = *reinterpret_cast<const int4*>(prow + 4 * q4);
              pr[4 * q4] = v4.x;
              pr[4 * q4 + 1] = v4.y;
              pr[4 * q4 + 2] = v4.z;
              pr[4 * q4 + 3] = v4.w;
            }
            pv_tile<D>(codes + sb * L.sub, pr, lut_b, lane, pv_int);
          }
          if (sp == nst - 1) {
            const int pad = min(max((ki + 1) * bk - p.seq_k, 0), bk);
#pragma unroll
            for (int u = 0; u < D / 32; ++u) {
              const float pv =
                  __fmul_rn(__int2float_rn(pv_int[u] - pad * m00), pv_scale);
              acc[u] = __fadd_rn(__fmul_rn(acc[u], alpha), pv);
              pv_int[u] = 0;
            }
          }
        }
      }
      if (R.is_quant) {
        if (st + 1 < n_stages) quantize_stage(st + 1);
        cp_wait<kContigStages - 3>();  // stage + 2 (this thread's copies)
      }
      group_sync(R.bar_item, R.gthreads);
    }
    if (R.is_row) {
      const float denom = fmaxf(l_run, 1e-30f);
#pragma unroll
      for (int u = 0; u < D / 32; ++u)
        p.out[((size_t)b * p.Sq + r) * D + lane + 32 * u] =
            __fdiv_rn(acc[u], denom);
    }
  }
  cp_wait<0>();
}

template <typename T, int D>
int launch_decode(const Params& prm, int num_blocks, cudaStream_t stream) {
  const bool paged = prm.paged != 0;
  const size_t total =
      paged ? DecodeLayout(prm.n_codes, D, sizeof(T), prm.dec_items,
                           prm.n_kv).total
            : ContigLayout(prm.n_codes, D, sizeof(T), prm.dec_items,
                           prm.bk).total;
  // the tilings the decode paths are built for, and no other
  if (total > 232448 || prm.dec_items < 1 ||
      prm.dec_items * kItemWarps > kDecodeThreads / 32 ||
      prm.dec_rows * prm.Sq > kItemWarps || prm.BH % prm.dec_rows ||
      (paged ? prm.bk != kPage
             : (prm.bk % kContigKeys != 0 || prm.bk <= 0 ||
                prm.Sq > prm.bq)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged ? approx_decode_kernel<T, D>
                      : approx_decode_contig_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = prm.BH / prm.dec_rows;
  const int blocks = (items + prm.dec_items - 1) / prm.dec_items;
  const int grid = blocks < num_blocks ? blocks : num_blocks;
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kDecodeThreads, total, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_decode_d(const Params& prm, int num_blocks, cudaStream_t stream) {
  return prm.D == 64 ? launch_decode<T, 64>(prm, num_blocks, stream)
                     : launch_decode<T, 128>(prm, num_blocks, stream);
}

template <typename T>
int launch(const Params& prm, int num_blocks, cudaStream_t stream) {
  const Layout L(prm.n_codes, prm.D, prm.bk);
  auto kernel = approx_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = (long long)prm.BH * ((prm.Sq + prm.bq - 1) / prm.bq) *
                          ((prm.bq + kRC - 1) / kRC);
  const int grid = static_cast<int>(items < num_blocks ? items : num_blocks);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, L.total, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int approx_flash_attention_launch(
    const void* q, const void* k, const void* v, const int16_t* lut,
    const int* rowinfo, const int* page_table, const float* sq,
    const float* sk, const float* sv, const float* score_scale,
    const float* pv_scale, float* out, int bf16, int BH, int Sq, int D,
    int seq_k, int bq, int bk, int n_kv, int rep, int QH, int KH,
    int row_heads, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh, long long vss,
    int n_codes,
    int offset, int lo, int hi, int causal, int window, int has_softcap,
    float softcap, int paged, int dec_rows, int dec_items, int num_blocks,
    void* stream) {
  Params prm{q,      k,       v,           lut,      rowinfo, page_table,
             sq,     sk,      sv,          score_scale, pv_scale, out,
             BH,     Sq,      D,           seq_k,    bq,      bk,
             n_kv,   rep,     QH,          KH,       row_heads, qsb,
             qsh,    qss,     ksb,         ksh,      kss,     vsb,
             vsh,    vss,     n_codes,     offset,   lo,      hi,
             causal, window,  has_softcap, paged,    softcap, dec_rows,
             dec_items};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dec_items > 0) {
    if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
    return bf16 ? launch_decode_d<__nv_bfloat16>(prm, num_blocks, s)
                : launch_decode_d<float>(prm, num_blocks, s);
  }
  return bf16 ? launch<__nv_bfloat16>(prm, num_blocks, s)
              : launch<float>(prm, num_blocks, s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
