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
// What bounds it on Hopper: as in lut_gemm.cuh, every product is one
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
    float softcap, int paged, int num_blocks, void* stream) {
  Params prm{q,      k,       v,           lut,      rowinfo, page_table,
             sq,     sk,      sv,          score_scale, pv_scale, out,
             BH,     Sq,      D,           seq_k,    bq,      bk,
             n_kv,   rep,     QH,          KH,       row_heads, qsb,
             qsh,    qss,     ksb,         ksh,      kss,     vsb,
             vsh,    vss,     n_codes,     offset,   lo,      hi,
             causal, window,  has_softcap, paged,    softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(prm, num_blocks, s)
              : launch<float>(prm, num_blocks, s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
