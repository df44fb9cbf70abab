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
// A tile where every key of a row is masked gives that row p = exp(0);
// the first visible key's alpha = exp(-1e30 - m') = 0 washes it out, as in
// the reference. So the plan (kernels/flash_attention/ops.py: flash_plan)
// lets an item start at the first KV tile any of its rows can see: the
// tiles it skips would have been wiped out exactly. It ends at the tile of
// its last real row's own key (the reference may walk one tile more, which
// masks every key: p = 0, alpha = 1, no change). Query rows past Sq are not
// written and keys past Sk get -inf (p = 0, as if absent), so any S runs.
//
// What bounds it on Hopper: operations. 2 * Hq * D multiply-adds per
// visible (query, key) pair for QK and PV (gemma2-27b at S = 4352: 1.55e11
// flops a layer), at most 495 TFLOP/s on TF32 tensor cores, against a few
// MB of Q, K, V and output; and the float32 contract, which one TF32 pass
// (11 significant bits) misses by about 1000x (flash_tolerance). A float32
// CUDA-core version of this kernel ran at 31 % of the FP32 rate.
//
// What the design does about it:
//  * Split TF32 on the tensor cores (mma.sync m16n8k8, float32
//    accumulators). Each operand x is split as hi + lo (Veltkamp: hi is x
//    rounded to 11 significant bits, lo = x - hi read as TF32), a TF32
//    product being exact in float32. bfloat16 K and V are exact in TF32,
//    so QK is (q_hi + q_lo) . k and PV is (p_hi + p_lo) . v, two products
//    each, q scaled first (f32(q) * f32(1/sqrt(D))) as the reference does;
//    float32 K and V take 3xTF32: hi.hi + (hi.lo + lo.hi). The emulation
//    is kernels/flash_attention/ref.py: flash_attention_tf32_ref.
//  * P stays in registers. The MMA's k index is permuted: in every 8-wide
//    k step, k = t is element 2t and k = t + 4 element 2t + 1. For PV
//    (k = keys) that makes the QK product's C fragment, which holds the
//    scores of keys 2t and 2t + 1 of rows g and g + 8, exactly the A
//    fragment of P: no shuffles and no trip through shared memory. For QK
//    (k = head dims) it makes each lane's two K values adjacent, so one
//    ldmatrix gives a bfloat16 K fragment; ldmatrix.trans gives V's.
//  * One block an item of the plan: a KV row with its query heads (all rep
//    where they fit) and a q tile, 16 query rows a warp; each K/V tile is
//    staged once for all of them. Items come heaviest first.
//  * K and V tiles of 64 keys are copied in their own dtype by cp.async
//    through the operands' strides into a two-stage ring (rows padded by
//    16 bytes, so ldmatrix's eight rows fall in distinct banks): the next
//    tile lands while this one is multiplied, one block barrier a tile.
//    The scaled, split Q lives in shared memory in fragment order (each
//    lane's four values one 16-byte load), staged by its own warp.
//  * The per-score softmax is the reference's in float32: expf and tanhf
//    without fast math, IEEE division for s / c and acc / max(l, 1e-30),
//    the -1e30 mask; the mask test is skipped on tiles that a warp's 16
//    rows see whole.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;          // keys of a KV tile
constexpr int kMaxWarps = 8;     // 128 query rows an item
constexpr int kSmemLimit = 232448;
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

template <typename T>
__device__ __forceinline__ const T* row_base(const T* p, const Addr& a,
                                             int row) {
  return p + (row / a.heads) * a.b + (row % a.heads) * a.h;
}

// Shared memory: the split Q (hi then lo, float4 a lane and k step), then
// two stages of a K and a V tile. The same on the host, and in ops.py
// (flash_smem).
template <int D, typename T>
struct Layout {
  static constexpr int kPitch = D + 16 / (int)sizeof(T);   // a staged row
  static constexpr int kTile = kBK * kPitch;               // elements
  __host__ __device__ static size_t q_bytes(int warps) {
    return (size_t)warps * 16 * D * 8;
  }
  __host__ __device__ static size_t bytes(int warps) {
    return q_bytes(warps) + 4 * (size_t)kTile * sizeof(T);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// x = hi + lo: hi is x rounded to its top 11 significant bits (Veltkamp's
// split by 2^13 + 1, a TF32 value), lo = x - hi exactly, of which the
// tensor core reads the top 11 bits
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float t = __fmul_rn(x, 8193.0f);
  const float h = __fsub_rn(t, __fsub_rn(t, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a bfloat16 pair from ldmatrix as two TF32 values (exact): low half is
// element 2t (k = t), high half element 2t + 1 (k = t + 4)
__device__ __forceinline__ void unpack_pair(uint32_t r, uint32_t (&b)[2]) {
  b[0] = r << 16;
  b[1] = r & 0xffff0000u;
}

__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

template <int D, typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 const int4* __restrict__ items, int sq, int sk, int rep,
                 int bq, Addr qa, Addr ka, Addr va, Addr oa, int causal,
                 int window, int has_cap, float cap, float scale) {
  using L = Layout<D, T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int KS = D / 8;      // k steps of QK, column tiles of PV
  constexpr int NT = kBK / 8;    // column tiles of QK, k steps of PV
  constexpr int kChunks = D * (int)sizeof(T) / 16;   // 16 B pieces a row
  constexpr int kPitch = L::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const float4* q_hi = reinterpret_cast<const float4*>(smem);
  const float4* q_lo = q_hi + warps * KS * 32;
  T* stages = reinterpret_cast<T*>(smem + L::q_bytes(warps));

  const int4 item = items[blockIdx.x];   // (first query row, q0, tiles)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int per_head = bq / 16;
  const int row = item.x + warp / per_head;          // folded query row
  const int r0 = item.y + 16 * (warp % per_head);    // its first position
  const int kv_row = item.x / rep;
  const T* kp = row_base(k, ka, kv_row);
  const T* vp = row_base(v, va, kv_row);

  const int t_lo = item.z, t_hi = item.w;
  auto stage = [&](int tile, int st) {
    T* ks = stages + 2 * st * L::kTile;
    T* vs = ks + L::kTile;
    const int k0 = tile * kBK;
    for (int i = threadIdx.x; i < kBK * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * (16 / (int)sizeof(T));
      const int pos = k0 + r;
      const bool in = pos < sk;
      const long long p = in ? pos : 0;
      cp_async16(ks + r * kPitch + c, kp + p * ka.s + c, in ? 16 : 0);
      cp_async16(vs + r * kPitch + c, vp + p * va.s + c, in ? 16 : 0);
    }
    cp_commit();
  };

  if (t_lo < t_hi) stage(t_lo, 0);   // lands while Q is staged

  // -- the warp's 16 query rows, scaled, split, in fragment order -------
  {
    const T* qp = row_base(q, qa, row);
    float* hi = reinterpret_cast<float*>(smem) + warp * KS * 128;
    float* lo = hi + warps * KS * 128;
    for (int e = lane; e < 16 * D; e += 32) {
      const int i = e / D, d = e % D, pos = r0 + i;
      const float x =
          pos < sq ? __fmul_rn(widen(qp[pos * qa.s + d]), scale) : 0.f;
      uint32_t h, l;
      split(x, h, l);
      // lane (i % 8) * 4 + (d % 8) / 2 of k step d / 8, component
      // i / 8 + 2 (d % 2): a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1), a3
      const int at = ((d / 8) * 32 + (i % 8) * 4 + (d % 8) / 2) * 4 +
                     i / 8 + 2 * (d % 2);
      hi[at] = __uint_as_float(h);
      lo[at] = __uint_as_float(l);
    }
  }

  float o[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int st = (tile - t_lo) & 1;
    cp_wait_all();
    __syncthreads();   // this tile landed; the last one's readers are done
    if (tile + 1 < t_hi) stage(tile + 1, st ^ 1);
    const T* ks = stages + 2 * st * L::kTile;
    const T* vs = ks + L::kTile;
    const int k0 = tile * kBK;

    // -- s = q_hi . k + q_lo . k (+ q_hi . k_lo at float32) ----------------
    float sh[NT][4], sl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[j][e] = sl[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const float4 fh = q_hi[(warp * KS + kk) * 32 + lane];
      const float4 fl = q_lo[(warp * KS + kk) * 32 + lane];
      const uint32_t ah[4] = {__float_as_uint(fh.x), __float_as_uint(fh.y),
                              __float_as_uint(fh.z), __float_as_uint(fh.w)};
      const uint32_t al[4] = {__float_as_uint(fl.x), __float_as_uint(fl.y),
                              __float_as_uint(fl.z), __float_as_uint(fl.w)};
      if constexpr (kBf16) {
#pragma unroll
        for (int n4 = 0; n4 < NT; n4 += 4) {
          // matrix lane / 8: keys (n4 + lane / 8) * 8 + lane % 8, dims kk * 8
          uint32_t r[4];
          ldmatrix_x4(r, ks + ((n4 + lane / 8) * 8 + lane % 8) * kPitch +
                             kk * 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            uint32_t b[2];
            unpack_pair(r[mi], b);
            mma_tf32(sh[n4 + mi], ah, b);
            mma_tf32(sl[n4 + mi], al, b);
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 kv = *reinterpret_cast<const float2*>(
              ks + (nt * 8 + g) * kPitch + kk * 8 + 2 * t);
          uint32_t bh[2], bl[2];
          split(kv.x, bh[0], bl[0]);
          split(kv.y, bh[1], bl[1]);
          mma_tf32(sh[nt], ah, bh);
          mma_tf32(sl[nt], ah, bl);
          mma_tf32(sl[nt], al, bh);
        }
      }
    }

    // -- softcap, masks, online softmax (rows g and g + 8) ---------------
    const bool whole = k0 + kBK <= sk && (!causal || k0 + kBK - 1 <= r0) &&
                       (window < 0 || k0 > r0 + 15 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sh[j][e] + sl[j][e];
        if (has_cap) x = cap * tanhf(x / cap);
        if (!whole) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          const int qpos = r0 + g + 8 * (e >> 1);
          const bool vis = (!causal || kpos <= qpos) &&
                           (window < 0 || kpos > qpos - window);
          x = kpos >= sk ? -INFINITY : (vis ? x : kNegInf);
        }
        sh[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], mnew[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mnew[i] = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - mnew[i]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sh[j][e] - mnew[e >> 1]);
        sh[j][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l[i] = alpha[i] * l[i] + psum[i];
      m[i] = mnew[i];
    }
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // -- acc += p_lo . v + p_hi . v (+ p_hi . v_lo at float32) -------------
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // the C fragment of scores j is the A fragment of P (see header)
      uint32_t ph[4], pl[4];
      split(sh[j][0], ph[0], pl[0]);
      split(sh[j][2], ph[1], pl[1]);
      split(sh[j][1], ph[2], pl[2]);
      split(sh[j][3], ph[3], pl[3]);
      if constexpr (kBf16) {
#pragma unroll
        for (int d4 = 0; d4 < KS; d4 += 4) {
          // matrix lane / 8: keys j * 8 + lane % 8, dims (d4 + lane / 8) * 8
          uint32_t r[4];
          ldmatrix_x4_trans(r, vs + (j * 8 + lane % 8) * kPitch +
                                   (d4 + lane / 8) * 8);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) {
            uint32_t b[2];
            unpack_pair(r[mi], b);
            mma_tf32(o[d4 + mi], pl, b);
            mma_tf32(o[d4 + mi], ph, b);
          }
        }
      } else {
#pragma unroll
        for (int dn = 0; dn < KS; ++dn) {
          const T* vr = vs + (j * 8 + 2 * t) * kPitch + dn * 8 + g;
          uint32_t bh[2], bl[2];
          split(vr[0], bh[0], bl[0]);
          split(vr[kPitch], bh[1], bl[1]);
          mma_tf32(o[dn], ph, bl);
          mma_tf32(o[dn], pl, bh);
          mma_tf32(o[dn], ph, bh);
        }
      }
    }
  }

  // -- out = acc / max(l, 1e-30), in the operands' dtype ------------------
  T* op = out + (row / oa.heads) * oa.b + (row % oa.heads) * oa.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = r0 + g + 8 * i;
    if (pos >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = op + pos * oa.s;
#pragma unroll
    for (int j = 0; j < KS; ++j)
      store_pair(orow + j * 8 + 2 * t, o[j][2 * i] / den,
                 o[j][2 * i + 1] / den);
  }
}

template <int D, typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     const int4* items, int n_items, int sq, int sk, int rep,
                     int bq, int warps, const Addr* a, int causal,
                     int window, int has_cap, float cap, float scale,
                     int smem_model, cudaStream_t stream) {
  const size_t smem = Layout<D, T>::bytes(warps);
  if (smem > (size_t)kSmemLimit || (int)smem != smem_model)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_mma_kernel<D, T><<<n_items, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), items, sq, sk, rep, bq,
      a[0], a[1], a[2], a[3], causal, window, has_cap, cap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(int d, const void* q, const void* k, const void* v,
                         void* out, const int4* items, int n_items, int sq,
                         int sk, int rep, int bq, int warps, const Addr* a,
                         int causal, int window, int has_cap, float cap,
                         float scale, int smem, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_t<64, T>(q, k, v, out, items, n_items, sq, sk, rep, bq,
                             warps, a, causal, window, has_cap, cap, scale,
                             smem, stream);
    case 128:
      return launch_t<128, T>(q, k, v, out, items, n_items, sq, sk, rep, bq,
                              warps, a, causal, window, has_cap, cap, scale,
                              smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (bh, sq, d) rows addressed as (qh heads per batch row, batch,
// head and position strides); k, v: (bh / rep, sk, d) rows, kh heads per
// batch row, 16-byte aligned. Strides in elements, the last dim dense.
// items: n_items x (first query row, q0, first KV tile, end KV tile) of
// warps * 16 / bq query rows and bq positions each (ops.py: flash_plan);
// smem: the plan's shared-memory model, checked against this source's.
// window < 0: none.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, const void* items,
    int n_items, int is_bf16, int bh, int sq, int sk, int d, int rep, int qh,
    int kh, int bq, int warps, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh,
    long long oss, int causal, int window, int has_cap, float cap,
    float scale, int smem, void* stream) {
  if (n_items <= 0 || bh <= 0 || sq <= 0 || sk < 0 || rep <= 0 || qh <= 0 ||
      kh <= 0 || bh % rep != 0 || bq <= 0 || bq % 16 != 0 || warps <= 0 ||
      warps > kMaxWarps || (warps * 16) % bq != 0 ||
      rep % (warps * 16 / bq) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Addr a[4] = {{qh, qsb, qsh, qss}, {kh, ksb, ksh, kss},
                     {kh, vsb, vsh, vss}, {qh, osb, osh, oss}};
  const int4* it = static_cast<const int4*>(items);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_dtype<__nv_bfloat16>(d, q, k, v, out, it, n_items, sq,
                                            sk, rep, bq, warps, a, causal,
                                            window, has_cap, cap, scale,
                                            smem, s)
              : launch_dtype<float>(d, q, k, v, out, it, n_items, sq, sk,
                                    rep, bq, warps, a, causal, window,
                                    has_cap, cap, scale, smem, s);
  return static_cast<int>(err);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
