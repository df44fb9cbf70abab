// fused_lut_grouped: the ragged grouped quantize -> LUT-gather GEMM ->
// dequant of an MoE layer's expert projections, every group in one launch,
//
//     group g = b * E + e (dispatch block b, expert e), C capacity rows each
//     live rows of g: r < clip(counts[g], 0, C)
//     q(x)         = clip(round_half_even(x / xs + xz), lo, hi)
//     acc[g, r, n] = sum_k LUT[q(x[g, r, k]) - (int)xz + off, wq[e, k, n] + off]
//     out[g, r, n] = float(acc) * (xs * ws[e, n])     (acc with emit_acc)
//     out[g, r, n] = 0 for every row past the count, never accumulated.
//
// Replaces the Pallas kernel src/repro/kernels/fused_lut_grouped/kernel.py
// (fused_lut_grouped_kernel). That kernel walks (group, row block, n block,
// k block) and skips row blocks past each group's live count. Here the live
// rows of one expert from all nb dispatch blocks are packed into one row
// list (they share that expert's weights).
//
// What bounds it on Hopper: at an MoE decode step (a few live rows per
// expert) the int32 weight codes, read once per expert and column (all 40
// experts of granite's gate projection: 126 MB, 38 us at 3.35 TB/s); with
// more rows, the shared-memory gather rate, one lookup per lane per clock.
// Measured, the decode step is bound by the gathers and each warp's
// per-chunk latency, not by the bytes (PERF.md).
//
// What the design does about it:
//  * Work plan from the wrapper (kernels/fused_lut_grouped/ops.py:
//    grouped_plan), from shapes only: a tile is (expert, row tile of BM
//    packed rows, BN columns), K is cut into chunks of 32, the ring's
//    depth, and alpha, the fixed cost of a chunk in live rows.
//  * The split from the counts: every block reads the live counts on the
//    device (the launch never waits for the host), costs each tile's
//    chunks at alpha + its live rows (0 with none) and takes its equal
//    share of the total, as a list of segments (tile, first chunk, end
//    chunk). A split shaped by chunks alone left the busiest SM with 1.5-2
//    times the mean gathers at a decode step; this one puts every live
//    expert's chunks on all SMs, so one expert's tokens no longer wait on
//    a few SMs. A split tile's int32 partials are added into a zeroed
//    workspace slot with atomics and the block that completes its chunks
//    (per-tile arrival counter) dequantizes it once, on the full sum:
//    integer adds associate, so any split is bitwise the reference's
//    accumulator. A segment list from the plan replaces the split when
//    given (a check's pinned or planted segments).
//  * Weight codes streamed through a ring of 2-4 stages of cp.async beside
//    the resident int16 table, so three 16 KB chunks are in flight while
//    one is summed; every weight code is read once per tile, whatever its
//    live rows (a row tile holds every packed row of an expert at
//    granite's decode and prefill shapes: 16, 32 or 128).
//  * One row group (a decode step, at most 16 packed rows): warp w owns 4
//    k of every chunk; each lane stages its own 4 columns' codes and 2
//    activations, quantizes the next chunk's while this one is summed, and
//    sums alone: no block barrier until the segment's end. Several row
//    groups (prefill): the chunk is narrowed once to one-byte weight and
//    row codes in a second double buffer, one barrier a chunk, each warp
//    16 rows of the tile, the other warps splitting K; their sums meet by
//    shared-memory atomics.
//  * One table row per warp instruction: at each (row, k) a warp's 32
//    lanes gather from the same table row at their own weight codes
//    (kernel 3's lane map), one add, one 16-bit gather and one accumulate
//    per product; the row loop stops at the live rows.
//  * The table is copied with 16-byte cp.async once per block. A last pass
//    of the same launch, a warp a row, writes the dead rows' zeros (int 0
//    and 0.0f have the same bits).
//
// Activations are float32 or bfloat16 (widened exactly before the
// quantizer). The last chunk of K may be partial: with row groups its
// slots past K hold the offset code on both sides, and pad * LUT[off, off]
// is subtracted in integer space, as the reference's kernel.py does for
// its k_pad; with one row group the slots past K are never summed.
#include <cuda_bf16.h>

#include "lut_quant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int TM = 16;                 // packed rows of one warp
constexpr int kBK = 32;                // K chunk, the unit of a segment
constexpr int kGroups = kBK / 4;       // groups of 4 K in a chunk
constexpr int kSmemLimit = 232448;     // the H100's opt-in block maximum

struct Params {
  const void* x;
  const int* wq;
  const int16_t* lut;
  const float* xs;
  const float* xz;
  const float* ws;
  const int* counts;
  void* out;
  const int* plan;  // null: the split below; else [grid + 1] offsets, then
                    // 4 ints a segment (tile, first chunk, end chunk, slot)
  int* work;        // [n_tiles * BM * BN] int32 sums, then [n_tiles] counters
  int emit_acc, G, E, C, K, N, n_codes, offset, lo, hi;
  int wm, stages, row_tiles, tiles_n, chunks, alpha;
};

__host__ __device__ inline size_t round16(size_t bytes) {
  return (bytes + 15) & ~size_t(15);
}

// Shared memory carve-up, the same on host and device and in the plan
// (ops.py: grouped_smem).
struct Layout {
  size_t ring, stage, stage_a, wcode, acode, rowsrc, pre, flag, erows,
      ecost, total;
  __host__ __device__ Layout(int n_codes, int E, int nb, int bm, int bn,
                             int stages, int xbytes) {
    ring = round16((size_t)n_codes * n_codes * 2);
    stage_a = round16((size_t)kBK * bn * 4);          // raw weight codes
    stage = stage_a + round16((size_t)bm * kBK * xbytes);  // + activations
    wcode = ring + stages * stage;                     // 2 x [kBK][bn] B
    acode = wcode + 2 * round16((size_t)kBK * bn);      // 2 x [bm][kBK] B
    rowsrc = acode + 2 * round16((size_t)bm * kBK);
    pre = rowsrc + round16((size_t)bm * 4);
    flag = pre + round16((size_t)(nb + 1) * 4);
    erows = flag + 16;                                  // [E] live rows
    ecost = erows + round16((size_t)E * 4);            // [E + 1] prefix
    total = ecost + round16((size_t)(E + 1) * 8);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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
// at most n (0..3) of this thread's latest groups still in flight
__device__ __forceinline__ void cp_wait_upto(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    default: cp_wait<3>(); break;
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// TN weight codes of one k row, one byte each, as byte offsets 2b
template <int TN>
__device__ __forceinline__ void load_b(const uint8_t* row, int (&b2)[TN]) {
  if constexpr (TN == 4) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int j = 0; j < 4; ++j) b2[j] = ((w >> (8 * j)) & 0xff) << 1;
  } else if constexpr (TN == 2) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(row);
    b2[0] = (w & 0xff) << 1;
    b2[1] = ((w >> 8) & 0xff) << 1;
  } else {
    b2[0] = static_cast<int>(row[0]) << 1;
  }
}

// One warp's gathers over groups [g_begin, g_end) of a chunk's codes: rows
// r0 .. r0 + rows - 1 of the tile, its lane's TN columns.
template <int TN>
__device__ __forceinline__ void gather(const uint8_t* acode,
                                       const uint8_t* wcode,
                                       const char* lut_b, int row_bytes,
                                       int r0, int rows, int lane,
                                       int g_begin, int g_end,
                                       int (&acc)[TM][TN]) {
  constexpr int BN = 32 * TN;
  for (int g = g_begin; g < g_end; ++g) {
    uint32_t aw[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (i >= rows) break;
      aw[i] = *reinterpret_cast<const uint32_t*>(acode + (r0 + i) * kBK +
                                                 4 * g);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int b2[TN];
      load_b<TN>(wcode + (4 * g + q) * BN + lane * TN, b2);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (i >= rows) break;
        const int ab = static_cast<int>((aw[i] >> (8 * q)) & 0xff) *
                       row_bytes;
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] += *reinterpret_cast<const int16_t*>(lut_b + ab + b2[j]);
      }
    }
  }
}

// One chunk of row tile rt of an expert with r live rows, in the split's
// cost units: alpha (streaming the chunk's weight codes) plus one a live
// row (its gathers); 0 for a row tile with no live row.
__device__ __forceinline__ long long chunk_cost(int r, int rt, int bm,
                                                int alpha) {
  const int rows = min(max(r - rt * bm, 0), bm);
  return rows > 0 ? alpha + rows : 0;
}

// Walks the tiles (expert, row tile, column tile) in order, each `chunks`
// chunks of its chunk_cost, and yields the chunks whose cost offset lies in
// this block's range [lo, hi): the block's segments, the same in every
// thread of the block.
struct SplitCursor {
  int e, rt, nt;
  long long base;
  __device__ bool next(const int* erows, int E, int row_tiles, int tiles_n,
                       int chunks, int bm, int alpha, long long lo,
                       long long hi, int& tile, int& c0, int& c1) {
    while (e < E && base < hi) {
      const long long u = chunk_cost(erows[e], rt, bm, alpha);
      if (u == 0) {  // this row tile and the expert's later ones: no rows
        ++e;
        rt = nt = 0;
        continue;
      }
      const long long start = base, end = start + chunks * u;
      tile = (e * row_tiles + rt) * tiles_n + nt;
      base = end;
      if (++nt == tiles_n) {
        nt = 0;
        if (++rt == row_tiles) {
          rt = 0;
          ++e;
        }
      }
      if (end <= lo) continue;
      c0 = lo > start ? static_cast<int>((lo - start + u - 1) / u) : 0;
      c1 = static_cast<int>(min((long long)chunks, (hi - start + u - 1) / u));
      if (c0 < c1) return true;
    }
    return false;
  }
};

template <int TN, typename T, bool ONE_GROUP>
__global__ void __launch_bounds__(kThreads, 1)
grouped_kernel(Params p) {
  constexpr int BN = 32 * TN;
  constexpr int NT = kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = p.E, C = p.C, K = p.K, N = p.N, n = p.n_codes;
  const int nb = p.G / E;
  const int wm = p.wm, wk = kWarps / wm, BM = TM * wm, S = p.stages;
  const Layout L(n, E, nb, BM, BN, S, sizeof(T));
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  unsigned char* ring = smem + L.ring;
  uint8_t* wcode = smem + L.wcode;
  uint8_t* acode = smem + L.acode;
  int* rowsrc = reinterpret_cast<int*>(smem + L.rowsrc);
  int* pre = reinterpret_cast<int*>(smem + L.pre);
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  int* erows = reinterpret_cast<int*>(smem + L.erows);
  long long* ecost = reinterpret_cast<long long*>(smem + L.ecost);
  int* red = reinterpret_cast<int*>(ring);  // the warps' sums, after K
  constexpr int kWcode = kBK * BN;           // bytes of one code buffer
  const int acode_bytes = static_cast<int>(round16((size_t)BM * kBK));

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wmid = warp % wm, wkid = warp / wm;
  const int row_bytes = 2 * n;
  const T* x = static_cast<const T*>(p.x);

  // the table, 16 bytes a copy (the wrapper passes it 16-byte aligned;
  // its own cp.async group, older than every chunk's)
  {
    const int bytes = n * n * 2;
    const char* src = reinterpret_cast<const char*>(p.lut);
    char* dst = reinterpret_cast<char*>(lut);
    for (int i = tid * 16; i + 16 <= bytes; i += NT * 16)
      cp_async16(dst + i, src + i, 16);
    for (int i = (bytes / 16) * 8 + tid; i < n * n; i += NT)
      lut[i] = p.lut[i];
    cp_commit();
  }

  const float xs = *p.xs, xz = *p.xz;
  const int zi = static_cast<int>(xz);
  const float lo = static_cast<float>(p.lo), hi = static_cast<float>(p.hi);
  const bool vec_a = (K * static_cast<int>(sizeof(T))) % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  const bool vec_b = (N % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(p.wq) & 15) == 0;
  const char* lut_b = reinterpret_cast<const char*>(lut);

  // The split: every block reads the counts and splits the tiles' chunks
  // into grid equal shares of their cost, weighted by each tile's live
  // rows, and takes its own (or walks the segments the plan lists).
  const bool split = p.plan == nullptr;
  long long lo_w = 0, hi_w = 0;
  SplitCursor cursor{0, 0, 0, 0};
  int sg = 0, seg_end = 0;
  const int* segs = nullptr;
  if (split) {
    for (int e = tid; e < E; e += NT) erows[e] = 0;
    __syncthreads();
    for (int g = tid; g < p.G; g += NT)  // every count in one round of loads
      atomicAdd(erows + g % E, min(max(p.counts[g], 0), C));
    __syncthreads();
    if (warp == 0) {  // the experts' costs, prefix-summed
      long long base = 0;
      for (int e0 = 0; e0 < E; e0 += 32) {
        const int e = e0 + lane;
        long long c = 0;
        if (e < E)
          for (int rt = 0; rt < p.row_tiles; ++rt)
            c += (long long)p.tiles_n * p.chunks *
                 chunk_cost(erows[e], rt, BM, p.alpha);
        long long incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const long long v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        if (e < E) ecost[e] = base + incl - c;
        base += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) ecost[E] = base;
    }
    __syncthreads();
    const long long W = ecost[E];
    lo_w = W * blockIdx.x / gridDim.x;
    hi_w = W * (blockIdx.x + 1) / gridDim.x;
    int e_lo = 0, e_hi = E - 1;  // the expert whose cost range holds lo_w
    while (e_lo < e_hi) {
      const int mid = (e_lo + e_hi + 1) >> 1;
      if (ecost[mid] <= lo_w) e_lo = mid; else e_hi = mid - 1;
    }
    cursor = SplitCursor{e_lo, 0, 0, ecost[e_lo]};
  } else {
    sg = p.plan[blockIdx.x];
    seg_end = p.plan[blockIdx.x + 1];
    segs = p.plan + gridDim.x + 1;
  }
  int cur_e = -1;

  for (;;) {
    int tile, c0, c1, slot;
    if (split) {
      if (!cursor.next(erows, E, p.row_tiles, p.tiles_n, p.chunks, BM,
                       p.alpha, lo_w, hi_w, tile, c0, c1))
        break;
      slot = c0 == 0 && c1 == p.chunks ? -1 : tile;
    } else {
      if (sg >= seg_end) break;
      tile = segs[4 * sg];
      c0 = segs[4 * sg + 1];
      c1 = segs[4 * sg + 2];
      slot = segs[4 * sg + 3];
      ++sg;
    }
    const int nt = tile % p.tiles_n;
    const int rt = (tile / p.tiles_n) % p.row_tiles;
    const int e = tile / (p.tiles_n * p.row_tiles);
    __syncthreads();  // the previous segment is done with shared memory
    if (e != cur_e) {
      // prefix of the expert's live rows over the dispatch blocks:
      // block b's rows follow those of blocks 0..b-1 in the packed list
      if (warp == 0) {
        int base = 0;
        for (int b0 = 0; b0 < nb; b0 += 32) {
          const int b = b0 + lane;
          const int c = b < nb ? min(max(p.counts[b * E + e], 0), C) : 0;
          int incl = c;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += v;
          }
          if (b < nb) pre[b] = base + incl - c;
          base += __shfl_sync(0xffffffffu, incl, 31);
        }
        if (lane == 0) pre[nb] = base;
      }
      __syncthreads();
      cur_e = e;
    }
    const int n_live = min(max(pre[nb] - rt * BM, 0), BM);
    if (n_live == 0) continue;  // no live row: no weight code is read
    if (tid < n_live) {         // packed row -> row of x and out
      const int j = rt * BM + tid;
      int lo_b = 0, hi_b = nb - 1;
      while (lo_b < hi_b) {
        const int mid = (lo_b + hi_b + 1) >> 1;
        if (pre[mid] <= j) lo_b = mid; else hi_b = mid - 1;
      }
      rowsrc[tid] = (lo_b * E + e) * C + (j - pre[lo_b]);
    }
    __syncthreads();

    const int n0 = nt * BN;
    const int k_begin = c0 * kBK, k_end = min(K, c1 * kBK);
    const int nck = c1 - c0;
    const int r0 = wmid * TM;
    const int rows = max(0, min(TM, n_live - r0));
    const int* w_e = p.wq + (size_t)e * K * N;

    // stage chunk i of the segment into ring slot i % S (one group a call)
    auto issue = [&](int i) {
      if (i < nck) {
        const int k0 = k_begin + i * kBK;
        unsigned char* st = ring + (size_t)(i % S) * L.stage;
        int* rb = reinterpret_cast<int*>(st);
        T* ra = reinterpret_cast<T*>(st + L.stage_a);
        if (vec_b) {
          for (int q = tid; q < kBK * (BN / 4); q += NT) {
            const int kk = q / (BN / 4), nq = (q % (BN / 4)) * 4;
            const int k = k0 + kk, nn = n0 + nq;
            const bool ok = k < K && nn < N;
            cp_async16(rb + kk * BN + nq, ok ? w_e + (size_t)k * N + nn : w_e,
                       ok ? 16 : 0);
          }
        } else {
          for (int q = tid; q < kBK * BN; q += NT) {
            const int kk = q / BN, nn = n0 + q % BN, k = k0 + kk;
            const bool ok = k < K && nn < N;
            cp_async4(rb + q, ok ? w_e + (size_t)k * N + nn : w_e,
                      ok ? 4 : 0);
          }
        }
        if (vec_a) {
          constexpr int kPer = 16 / sizeof(T);        // elements a copy
          constexpr int kPieces = kBK / kPer;         // copies a row
          for (int q = tid; q < n_live * kPieces; q += NT) {
            const int r = q / kPieces, kk = (q % kPieces) * kPer;
            const int k = k0 + kk;
            const bool ok = k < K;
            cp_async16(ra + r * kBK + kk,
                       ok ? x + (size_t)rowsrc[r] * K + k : x, ok ? 16 : 0);
          }
        } else {
          for (int q = tid; q < n_live * kBK; q += NT) {
            const int r = q / kBK, k = k0 + q % kBK;
            ra[q] = k < K ? x[(size_t)rowsrc[r] * K + k] : zero_of<T>();
          }
        }
      }
      cp_commit();
    };

    // narrow chunk i (ring slot i % S) into code buffer i & 1: one-byte
    // table columns and rows; slots past K hold the offset code
    auto narrow = [&](int i) {
      const int k0 = k_begin + i * kBK;
      const int kn = min(kBK, k_end - k0);
      const unsigned char* st = ring + (size_t)(i % S) * L.stage;
      const int* rb = reinterpret_cast<const int*>(st);
      const T* ra = reinterpret_cast<const T*>(st + L.stage_a);
      uint8_t* wc = wcode + (i & 1) * kWcode;
      uint8_t* ac = acode + (i & 1) * acode_bytes;
      for (int q = tid; q < kBK * (BN / 4); q += NT) {
        const int kk = q / (BN / 4), nq = (q % (BN / 4)) * 4;
        const int4 w = *reinterpret_cast<const int4*>(rb + kk * BN + nq);
        const int wv[4] = {w.x, w.y, w.z, w.w};
        uint32_t word = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          int v = p.offset;
          if (kk < kn && n0 + nq + u < N)
            v = min(max(wv[u] + p.offset, 0), n - 1);
          word |= static_cast<uint32_t>(v) << (8 * u);
        }
        *reinterpret_cast<uint32_t*>(wc + kk * BN + nq) = word;
      }
      for (int q = tid; q < n_live * kBK; q += NT) {  // one a thread
        int v = p.offset;
        if (q % kBK < kn)
          v = min(max(lutgemm::quantize_code(widen(ra[q]), xs, xz, lo, hi) -
                          zi + p.offset,
                      0),
                  n - 1);
        ac[q] = static_cast<uint8_t>(v);
      }
    };

    int acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0;
    int pad = 0;  // K slots past the end, summed as LUT[off, off]

    if constexpr (ONE_GROUP) {
      // One row tile of at most 16 rows (wm = 1, an MoE decode step):
      // warp w owns k = kOwn w .. kOwn w + kOwn - 1 of every chunk. Each
      // lane stages its own TN columns' codes of those k, and lane l two
      // activations of row l / kPairs, so a warp stages, quantizes and
      // sums its slice alone: no block barrier until the segment's end,
      // S - 1 chunks in flight, and each chunk's activations quantized
      // while the chunk before it is summed.
      constexpr int kOwn = kBK / kWarps;   // k of a chunk a warp owns
      constexpr int kPairs = kOwn / 2;     // activation pairs a row
      const int kw = kOwn * warp;
      const int ar = lane / kPairs, ak = 2 * (lane % kPairs);
      uint8_t* aword = acode + warp * 2 * TM * kOwn;
      const bool vec_a2 =
          K % 2 == 0 &&
          (reinterpret_cast<uintptr_t>(p.x) & (2 * sizeof(T) - 1)) == 0;
      const int nn = n0 + lane * TN;
      // this lane's codes of row k_begin + kw, columns nn ..
      const int* w_lane = w_e + (size_t)(k_begin + kw) * N + nn;
      auto issue_w = [&](int i) {
        if (i < nck) {
          const int k0 = k_begin + i * kBK + kw;
          unsigned char* st = ring + (size_t)(i % S) * L.stage;
          int* rb = reinterpret_cast<int*>(st) + kw * BN + lane * TN;
          const int* src = w_lane + (size_t)i * kBK * N;
#pragma unroll
          for (int u = 0; u < kOwn; ++u) {
            const int k = k0 + u;
            if (TN == 4 && vec_b) {
              const bool ok = k < K && nn < N;
              cp_async16(rb + u * BN, ok ? src + u * N : w_e, ok ? 16 : 0);
            } else {
#pragma unroll
              for (int j = 0; j < TN; ++j) {
                const bool ok = k < K && nn + j < N;
                cp_async4(rb + u * BN + j, ok ? src + u * N + j : w_e,
                          ok ? 4 : 0);
              }
            }
          }
          if (ar < n_live) {
            T* ra = reinterpret_cast<T*>(st + L.stage_a) + ar * kBK + kw + ak;
            const T* xs_src = x + (size_t)rowsrc[ar] * K + k0 + ak;
            if (vec_a2) {
              const bool ok = k0 + ak < K;
              if constexpr (sizeof(T) == 4)
                cp_async8(ra, ok ? xs_src : x, ok ? 8 : 0);
              else
                cp_async4(ra, ok ? xs_src : x, ok ? 4 : 0);
            } else {
#pragma unroll
              for (int v = 0; v < 2; ++v)
                ra[v] = k0 + ak + v < K ? xs_src[v] : zero_of<T>();
            }
          }
        }
        cp_commit();
      };

      // this lane's two codes of chunk i (row ar, bytes ak, ak + 1) into
      // the row-code buffer i & 1
      auto quantize_w = [&](int i) {
        const int k0 = k_begin + i * kBK + kw;
        const int kn = min(kOwn, k_end - k0);
        if (kn <= 0 || ar >= n_live) return;
        const T* ra = reinterpret_cast<const T*>(
                          ring + (size_t)(i % S) * L.stage + L.stage_a) +
                      ar * kBK + kw + ak;
        uint32_t pair = 0;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          int c = p.offset;
          if (ak + v < kn)
            c = min(max(lutgemm::quantize_code(widen(ra[v]), xs, xz, lo, hi) -
                            zi + p.offset,
                        0),
                    n - 1);
          pair |= static_cast<uint32_t>(c) << (8 * v);
        }
        *reinterpret_cast<uint16_t*>(aword + (i & 1) * TM * kOwn +
                                     ar * kOwn + ak) =
            static_cast<uint16_t>(pair);
      };

      for (int i = 0; i < S; ++i) issue_w(i);
      cp_wait_upto(S - 1);  // chunk 0 (and, first, the table) has landed
      __syncthreads();      // ... the table for every thread
      quantize_w(0);
      for (int i = 0; i < nck; ++i) {
        if (i + 1 < nck) {
          cp_wait_upto(S - 2);  // this lane's part of chunk i + 1 landed
          quantize_w(i + 1);
        }
        __syncwarp();  // chunk i's row codes, from every lane
        const int k0 = k_begin + i * kBK + kw;
        const int kn = min(kOwn, k_end - k0);
        if (kn > 0) {  // warp-uniform; once past K, for good
          const unsigned char* st = ring + (size_t)(i % S) * L.stage;
          const uint8_t* aw = aword + (i & 1) * TM * kOwn;
          // the kOwn k's codes of this lane's columns, as byte offsets 2b
          const int* rb =
              reinterpret_cast<const int*>(st) + kw * BN + lane * TN;
          int b2[kOwn][TN];
#pragma unroll
          for (int u = 0; u < kOwn; ++u) {
            int wv[TN];
            if constexpr (TN == 4) {
              const int4 w4 = *reinterpret_cast<const int4*>(rb + u * BN);
              wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
            } else {
#pragma unroll
              for (int j = 0; j < TN; ++j) wv[j] = rb[u * BN + j];
            }
#pragma unroll
            for (int j = 0; j < TN; ++j)
              b2[u][j] = min(max(wv[j] + p.offset, 0), n - 1) << 1;
          }
          // row codes in registers; rows past the live ones hold stale
          // codes, gathered inside the table and never stored
          uint32_t awr[TM];
#pragma unroll
          for (int r = 0; r < TM; r += 2) {
            if (r >= rows) break;
            awr[r] = *reinterpret_cast<const uint32_t*>(aw + kOwn * r);
            awr[r + 1] = *reinterpret_cast<const uint32_t*>(aw + kOwn * r +
                                                            kOwn);
          }
          if (kn == kOwn) {
#pragma unroll
            for (int r0p = 0; r0p < TM; r0p += 2) {  // rows in pairs
              if (r0p >= rows) break;
#pragma unroll
              for (int r = r0p; r < r0p + 2; ++r)
#pragma unroll
                for (int u = 0; u < kOwn; ++u) {
                  const int ab =
                      static_cast<int>((awr[r] >> (8 * u)) & 0xff) * row_bytes;
#pragma unroll
                  for (int j = 0; j < TN; ++j)
                    acc[r][j] += *reinterpret_cast<const int16_t*>(
                        lut_b + ab + b2[u][j]);
                }
            }
          } else {  // the last, partial slice of K
#pragma unroll
            for (int u = 0; u < kOwn; ++u) {
              if (u >= kn) break;
#pragma unroll
              for (int r = 0; r < TM; ++r) {
                if (r >= rows) break;
                const int ab =
                    static_cast<int>((awr[r] >> (8 * u)) & 0xff) * row_bytes;
#pragma unroll
                for (int j = 0; j < TN; ++j)
                  acc[r][j] += *reinterpret_cast<const int16_t*>(
                      lut_b + ab + b2[u][j]);
              }
            }
          }
        }
        __syncwarp();    // every lane is done with chunk i's row codes
        issue_w(i + S);  // into chunk i's slot: this lane's own part
      }
    } else {
      for (int i = 0; i < S; ++i) issue(i);
      cp_wait_upto(S - 1);  // chunk 0 (and, first, the table) has landed
      __syncthreads();
      narrow(0);
      for (int i = 0; i < nck; ++i) {
        cp_wait_upto(S - 2);  // chunk i + 1 has landed
        __syncthreads();      // ... for every thread; chunk i is narrowed
        issue(i + S);         // into chunk i's slot, narrowed before
        if (i + 1 < nck) narrow(i + 1);
        const int kn = min(kBK, k_end - (k_begin + i * kBK));
        const int ng = (kn + 3) / 4;
        pad += 4 * ng - kn;
        if (rows > 0) {
          const int per = kGroups / wk;
          const int gb = wkid * per, ge = min(ng, gb + per);
          gather<TN>(acode + (i & 1) * acode_bytes,
                     wcode + (i & 1) * kWcode, lut_b, row_bytes, r0, rows,
                     lane, gb, ge, acc);
        }
      }
    }

    const int m00 = lut[p.offset * n + p.offset];
    const bool whole = slot < 0;
    int* sums = p.work + (size_t)max(slot, 0) * BM * BN;
    // one packed row's sum at column nn: stored, or added into the slot
    auto emit = [&](int r, int nn, int v) {
      if (!whole) {
        atomicAdd(sums + r * BN + (nn - n0), v);
      } else if (p.emit_acc) {
        static_cast<int*>(p.out)[(size_t)rowsrc[r] * N + nn] = v;
      } else {
        static_cast<float*>(p.out)[(size_t)rowsrc[r] * N + nn] = __fmul_rn(
            __int2float_rn(v), __fmul_rn(xs, p.ws[(size_t)e * N + nn]));
      }
    };
    if (wk > 1) {  // the warps that split K meet in shared memory
      cp_wait<0>();
      __syncthreads();  // every warp is done with the ring
      if (wkid == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (i >= rows) break;
#pragma unroll
          for (int j = 0; j < TN; ++j)
            red[(r0 + i) * BN + lane * TN + j] = acc[i][j];
        }
      }
      __syncthreads();
      if (wkid > 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (i >= rows) break;
#pragma unroll
          for (int j = 0; j < TN; ++j)
            atomicAdd(red + (r0 + i) * BN + lane * TN + j, acc[i][j]);
        }
      }
      __syncthreads();
      for (int o = tid; o < n_live * BN; o += NT) {
        const int nn = n0 + o % BN;
        if (nn < N) emit(o / BN, nn, red[o] - pad * m00);
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (i >= rows) break;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int nn = n0 + lane * TN + j;
          if (nn < N) emit(r0 + i, nn, acc[i][j] - pad * m00);
        }
      }
    }
    if (!whole) {  // the block that completes the tile's chunks stores it
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        int* count = p.work +
                     (size_t)p.row_tiles * p.tiles_n * E * BM * BN + slot;
        const int before = atomicAdd(count, nck);
        *flag = before + nck == p.chunks;
      }
      __syncthreads();
      if (*flag) {
        __threadfence();
        for (int o = tid; o < n_live * BN; o += NT) {
          const int nn = n0 + o % BN;
          if (nn >= N) continue;
          const int v = __ldcg(sums + o);
          const size_t out_i = (size_t)rowsrc[o / BN] * N + nn;
          if (p.emit_acc)
            static_cast<int*>(p.out)[out_i] = v;
          else
            static_cast<float*>(p.out)[out_i] = __fmul_rn(
                __int2float_rn(v), __fmul_rn(xs, p.ws[(size_t)e * N + nn]));
        }
      }
    }
  }
  cp_wait<0>();

  // dead rows: exactly zero, never accumulated (a warp a row: every
  // block's warps read their rows' counts at once)
  int* out_bits = static_cast<int*>(p.out);
  for (int row = blockIdx.x * kWarps + warp; row < p.G * C;
       row += gridDim.x * kWarps) {
    if (row % C < min(max(__ldg(p.counts + row / C), 0), C)) continue;
    for (int nn = lane; nn < N; nn += 32) out_bits[(size_t)row * N + nn] = 0;
  }
}

template <int TN, typename T, bool ONE_GROUP>
int launch(const Params& prm, int grid, int smem_bytes, cudaStream_t stream) {
  const Layout L(prm.n_codes, prm.E, prm.G / prm.E, TM * prm.wm, 32 * TN,
                 prm.stages, sizeof(T));
  if (static_cast<int>(L.total) != smem_bytes || L.total > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = grouped_kernel<TN, T, ONE_GROUP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

// one row group (wm = 1): the warps own K slices; else row groups
template <int TN, typename T>
int launch_wm(const Params& prm, int grid, int smem_bytes,
              cudaStream_t stream) {
  if (prm.wm == 1) return launch<TN, T, true>(prm, grid, smem_bytes, stream);
  return launch<TN, T, false>(prm, grid, smem_bytes, stream);
}

template <typename T>
int launch_tn(const Params& prm, int tn, int grid, int smem_bytes,
              cudaStream_t stream) {
  switch (tn) {
    case 1: return launch_wm<1, T>(prm, grid, smem_bytes, stream);
    case 2: return launch_wm<2, T>(prm, grid, smem_bytes, stream);
    case 4: return launch_wm<4, T>(prm, grid, smem_bytes, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fused_lut_grouped_launch(
    const void* x, int x_bf16, const int* wq, const int16_t* lut,
    const float* xs, const float* xz, const float* ws, const int* counts,
    void* out, int emit_acc, int G, int E, int C, int K, int N, int n_codes,
    int offset, int lo, int hi, const int* plan, int grid, int tn, int wm,
    int stages, int row_tiles, int tiles_n, int chunks, int alpha, int* work,
    int smem_bytes, void* stream) {
  if (E <= 0 || G % E != 0 || !(wm == 1 || wm == 2 || wm == 4 || wm == 8) ||
      stages < 2 || stages > 4 || alpha < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{x,      wq,        lut,     xs,      xz,     ws,   counts,
             out,    plan,      work,    emit_acc, G,     E,    C,
             K,      N,         n_codes, offset,  lo,     hi,   wm,
             stages, row_tiles, tiles_n, chunks,  alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_tn<__nv_bfloat16>(prm, tn, grid, smem_bytes, s);
  return launch_tn<float>(prm, tn, grid, smem_bytes, s);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
