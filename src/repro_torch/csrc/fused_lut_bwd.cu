// fused_lut_bwd: the approximate STE gradient GEMM, both float operands
// quantized in-kernel, per-tensor symmetric (zero point 0),
//
//     qa = clip(round_half_even(a / sa), lo, hi),  qb likewise with sb
//     acc[m,n] = sum_k LUT[qa[m, k] + off, qb[k, n] + off]
//     out[m,n] = float(acc) * (sa * sb)            (or acc with emit_acc)
//
// Replaces the Pallas kernel src/repro/kernels/fused_lut_dense/kernel.py
// (fused_lut_bwd_kernel). Its callers: the conv input gradient's patch GEMM
// g (N*Ho*Wo, Cout) @ wf (Cout, Cin*kh*kw) with emit_acc, whose int32
// result the caller scatters back into the image (core/approx_ops.py), and
// the dense layers' gx = g @ wf^T and gw = xf^T @ g. At ResNet-20's convs K
// = Cout is 16, 32 or 64 and N = Cin*9 is 144, 288 or 576, with M up to
// 131,072 rows.
//
// What bounds it on Hopper: every product is one data-dependent 16-bit
// gather from the int16 table in shared memory (lut_narrow.cuh), one per
// lane per clock at best. The emit_acc output is large beside it (M x N
// int32: 767 MB a ResNet-20 training step, a third of the gathers' bound).
//
// What the design does about it:
//  * Items that quantize each operand once. An item is a row tile of BM =
//    8 warps x TM rows (TM 4, 8 or 16) together with the column tiles of N
//    (all of them, or a share where that gives every SM two items), when the
//    whole of K fits one chunk (at most 64) and B's codes fit beside the
//    table: B (at ResNet-20 the weight, at most 64 x 576 codes) is
//    quantized once per block into one-byte codes that stay resident, and
//    A's codes are quantized once per item and read for all of N. Any other
//    shape (an LM layer's long K, a B too large to keep) runs through the
//    same loop with items of one column tile, B staged per (column tile, K
//    chunk of 32) and quantized once per item, K split stream-K where the
//    tiles are fewer than the SMs (the wrapper's plan,
//    kernels/fused_lut_dense/ops.py: bwd_plan).
//  * Copies by cp.async that overlap the gathers: the next chunk's float
//    rows (and, streamed, B's) are in flight while the current one is
//    gathered; each lands as raw float32 and is quantized into one-byte
//    codes, 4 k of one row (A) or of one column (B) to a word. Between two
//    such steps each warp walks the item's column tiles and stores them
//    on its own, with no block-wide barrier.
//  * The narrow-N core's lane map (lut_narrow.cuh): at column tiles of 32
//    and over a warp's 32 lanes gather one table row (an A code) at their
//    own B codes; at 16 (N <= 16, the head's gw) the two half-warps walk
//    alternate groups of 4 k and meet by one __shfl_xor. Above 16 the
//    column tile is the one of 32..256 that costs least for N (padding
//    times the issue cost of a lookup at its columns per lane).
//  * Stores of 16 bytes a lane: at 4 columns a lane and more each lane
//    writes its own columns as int4; below, a warp turns its tile round in
//    shared memory and writes 16-byte rows, so every store is coalesced.
//  * The K pad: a chunk's last group of 4 may run past K; those slots hold
//    the offset code on both sides and pad * LUT[off, off] is subtracted in
//    integer space, the reference's rule (fused_lut_dense/kernel.py:76).
// Split tiles add their int32 partials into a zeroed workspace slot and the
// block that completes a tile's K stores it (kernel 1's stream-K protocol).
// Integer adds are associative, so every plan gives the reference's
// accumulator bit for bit. The scales stay on the device (pointers).
#include "lut_narrow.cuh"
#include "lut_quant.cuh"

namespace {

using namespace lutnarrow;

constexpr int kSmemLimit = 232448;   // opt-in shared memory of a block
constexpr int kMaxChunk = 64;        // K of one chunk, at most

struct Params {
  const float* a;
  const float* b;
  const int16_t* lut;
  const float* sa;
  const float* sb;
  void* out;
  const int* plan;   // [grid + 1] segment offsets, then 4 ints a segment
  int* work;         // [n_slots * slot] int32 sums, [n_slots] counters
  int M, K, N, n_codes, offset, lo, hi, emit_acc;
  int kc;            // K of one chunk (a multiple of 4)
  int nt;            // column tiles of one item
  int tiles_n;       // column tiles over N
  int tiles_c;       // column groups of nt tiles
  int groups;        // groups of 4 over K
  int n_slots;
  int resident;      // B's codes all in shared memory
};

__host__ __device__ inline int raw_stride(int kc) {
  // floats of one staged A row: kc plus a pad that makes it an odd number
  // of 16-byte words, so that 8 lanes reading 8 rows hit 32 banks
  return kc + 4 * (1 + (kc / 4) % 2);
}

// Shared memory carve-up, the same on host and device (and in the
// wrapper's _bwd_smem): the table; two buffers of raw A rows and A's codes
// ([group][row] words); B's codes, resident ([group][column] words over
// all of K and N) or one chunk's with two raw buffers; each warp's output
// turn-round buffer (fewer than 4 columns a lane); the completion flag.
template <int TM, int BN>
struct Layout {
  static constexpr int BM = TM * kWarps;
  static constexpr int TN = Lanes<BN>::TN;
  size_t a_raw, a_code, b_raw, b_code, stage, flag, total, a_buf, b_buf;
  __host__ __device__ explicit Layout(const Params& p) {
    a_raw = round_up16((size_t)p.n_codes * p.n_codes * 2);
    a_buf = round_up16((size_t)BM * raw_stride(p.kc) * 4);
    a_code = a_raw + 2 * a_buf;
    b_raw = a_code + round_up16((size_t)(p.kc / 4) * BM * 4);
    b_buf = p.resident ? 0 : round_up16((size_t)p.kc * BN * 4);
    b_code = b_raw + 2 * b_buf;
    stage = b_code + (p.resident
                          ? round_up16((size_t)p.groups * p.tiles_n * BN * 4)
                          : round_up16((size_t)(p.kc / 4) * BN * 4));
    flag = stage + (TN < 4 ? kWarps * round_up16((size_t)TM * BN * 4) : 0);
    total = flag + 16;
  }
};

// One segment of the plan: the row tile, the item's column tiles, the K
// range (groups g0..g1) and the workspace slot (-1: the tile is whole).
struct Seg {
  int m0, ct0, ntiles, kb, ke, g0, g1, slot, chunks;
};

template <int TM, int BN>
__global__ void __launch_bounds__(kThreads, 1) bwd_kernel(Params p) {
  using LN = Lanes<BN>;
  constexpr int KS = LN::KS, TN = LN::TN;
  constexpr int BM = TM * kWarps;
  constexpr bool kTurn = TN < 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<TM, BN> L(p);
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  const uint32_t lut_s = smem_addr(smem);
  float* a_raw = reinterpret_cast<float*>(smem + L.a_raw);
  uint32_t* a_code = reinterpret_cast<uint32_t*>(smem + L.a_code);
  float* b_raw = reinterpret_cast<float*>(smem + L.b_raw);
  uint32_t* b_code = reinterpret_cast<uint32_t*>(smem + L.b_code);
  uint32_t* turn = reinterpret_cast<uint32_t*>(smem + L.stage);
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int M = p.M, K = p.K, N = p.N, n = p.n_codes, off = p.offset;
  const int row_bytes = 2 * n, kc = p.kc, ars = raw_stride(kc);
  const int col = LN::col(lane), half = LN::slice(lane);
  const int np = p.tiles_n * BN;     // resident B's columns
  const float lo = static_cast<float>(p.lo), hi = static_cast<float>(p.hi);
  const float sa = *p.sa, sb = *p.sb;
  const int a_bufw = static_cast<int>(L.a_buf / 4);  // floats a buffer
  const int b_bufw = static_cast<int>(L.b_buf / 4);

  copy_table(lut, p.lut, n, tid);

  const bool vec_a = K % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(p.a) & 15) == 0;
  const bool vec_b = N % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(p.b) & 15) == 0;
  const bool vec_out = N % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(p.out) & 15) == 0;

  if (p.resident) {  // B once per block: word (g, c) = b[4g + q][c], q < 4
    for (int e = tid; e < p.groups * np; e += kThreads) {
      const int g = e / np, c = e - g * np;
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * g + q;
        const uint32_t v =
            (k < K && c < N)
                ? lutgemm::symmetric_index(__ldg(p.b + (size_t)k * N + c), sb,
                                           lo, hi, off, n)
                : static_cast<uint32_t>(off);
        word |= v << (8 * q);
      }
      b_code[e] = word;
    }
  }

  const int seg_begin = p.plan[blockIdx.x];
  const int seg_end = p.plan[blockIdx.x + 1];
  const int* segs = p.plan + gridDim.x + 1;
  auto seg_of = [&](int sg) {
    Seg s;
    const int tile = segs[4 * sg];
    s.g0 = segs[4 * sg + 1];
    s.g1 = segs[4 * sg + 2];
    s.slot = segs[4 * sg + 3];
    s.m0 = (tile / p.tiles_c) * BM;
    s.ct0 = (tile % p.tiles_c) * p.nt;
    s.ntiles = min(p.nt, p.tiles_n - s.ct0);
    s.kb = 4 * s.g0;
    s.ke = min(K, 4 * s.g1);
    s.chunks = max(1, (s.ke - s.kb + kc - 1) / kc);
    return s;
  };

  // the copies of step (segment s, chunk c): A's rows into A buffer
  // `buf`; B's chunk of the segment's column tile unless resident (then
  // the segment has that one column tile)
  auto issue = [&](const Seg& s, int c, int buf) {
    const int k0 = s.kb + c * kc;
    const int kn = min(kc, s.ke - k0);
    float* dst = a_raw + buf * a_bufw;
    if (vec_a) {
      const int kq = kc / 4;
      for (int e = tid; e < BM * kq; e += kThreads) {
        const int r = e / kq, q4 = (e - r * kq) * 4;
        const bool ok = s.m0 + r < M && q4 < kn;
        cp_async16(dst + r * ars + q4,
                   ok ? p.a + (size_t)(s.m0 + r) * K + k0 + q4 : p.a,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * kc; e += kThreads) {
        const int r = e / kc, kk = e - r * kc;
        const bool ok = s.m0 + r < M && kk < kn;
        cp_async4(dst + r * ars + kk,
                  ok ? p.a + (size_t)(s.m0 + r) * K + k0 + kk : p.a,
                  ok ? 4 : 0);
      }
    }
    if (!p.resident) {
      float* bdst = b_raw + buf * b_bufw;
      const int n0 = s.ct0 * BN;
      if (vec_b) {
        for (int e = tid; e < kc * (BN / 4); e += kThreads) {
          const int kk = e / (BN / 4), q4 = (e - kk * (BN / 4)) * 4;
          const bool ok = kk < kn && n0 + q4 < N;
          cp_async16(bdst + kk * BN + q4,
                     ok ? p.b + (size_t)(k0 + kk) * N + n0 + q4 : p.b,
                     ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < kc * BN; e += kThreads) {
          const int kk = e / BN, cc = e - kk * BN;
          const bool ok = kk < kn && n0 + cc < N;
          cp_async4(bdst + e,
                    ok ? p.b + (size_t)(k0 + kk) * N + n0 + cc : p.b,
                    ok ? 4 : 0);
        }
      }
    }
  };

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  const int r0 = warp * TM;
  const float scale = __fmul_rn(sa, sb);
  const int wcols = p.nt * BN;   // a slot's row
  int sg = seg_begin, c = 0, buf = 0;
  Seg s = sg < seg_end ? seg_of(sg) : Seg{};
  if (sg < seg_end) issue(s, 0, 0);
  cp_commit();
  while (sg < seg_end) {
    // the next step (chunk, else segment), its copies into the other
    // buffers
    int nsg = sg, nc = c + 1;
    if (nc >= s.chunks) {
      nc = 0;
      ++nsg;
    }
    Seg ns = s;
    if (nsg != sg && nsg < seg_end) ns = seg_of(nsg);
    cp_wait<0>();     // this step's copies (and, first, the table) landed
    __syncthreads();  // ... for every thread; the last step's gathers done

    const int k0 = s.kb + c * kc;
    const int kn = min(kc, s.ke - k0);
    const int ng = (kn + 3) / 4;
    {  // A's rows -> codes, word (g, r) = a[r][4g + q]
      const float* src = a_raw + buf * a_bufw;
      for (int e = tid; e < BM * ng; e += kThreads) {
        const int g = e / BM, r = e - g * BM;
        const float4 v = *reinterpret_cast<const float4*>(src + r * ars +
                                                          4 * g);
        const float av[4] = {v.x, v.y, v.z, v.w};
        uint32_t word = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t code =
              (s.m0 + r < M && 4 * g + q < kn)
                  ? lutgemm::symmetric_index(av[q], sa, lo, hi, off, n)
                  : static_cast<uint32_t>(off);
          word |= code << (8 * q);
        }
        a_code[g * BM + r] = word;
      }
    }
    if (!p.resident) {  // B's chunk -> codes, word (g, c) = b[4g + q][c]
      const float* src = b_raw + buf * b_bufw;
      const int n0 = s.ct0 * BN;
      for (int e = tid; e < ng * BN; e += kThreads) {
        const int g = e / BN, cc = e - g * BN;
        uint32_t word = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = 4 * g + q;
          const uint32_t code =
              (kk < kn && n0 + cc < N)
                  ? lutgemm::symmetric_index(src[kk * BN + cc], sb, lo, hi,
                                             off, n)
                  : static_cast<uint32_t>(off);
          word |= code << (8 * q);
        }
        b_code[g * BN + cc] = word;
      }
    }
    __syncthreads();  // the codes are in; the raw buffers are free
    if (nsg < seg_end) issue(ns, nc, buf ^ 1);
    cp_commit();

    // each warp walks the item's column tiles on its own: its K slice of
    // the chunk (groups half, half + KS, ...), then, at the segment's last
    // chunk, the tile's store
    const int rows = max(0, min(TM, M - (s.m0 + r0)));
    const bool last = c == s.chunks - 1;
    const int pad = 4 * (s.g1 - s.g0) - (s.ke - s.kb);
    for (int t = 0; t < s.ntiles; ++t) {
      const int n0 = (s.ct0 + t) * BN;
      if (rows > 0) {
        const uint32_t* bsrc = p.resident
                                   ? b_code + (k0 / 4) * np + n0 + col
                                   : b_code + col;
        const int bstride = p.resident ? np : BN;
        for (int g = half; g < ng; g += KS) {
          uint32_t aw[TM];
#pragma unroll
          for (int i = 0; i < TM; i += 4) {
            const uint4 v =
                *reinterpret_cast<const uint4*>(a_code + g * BM + r0 + i);
            aw[i] = v.x;
            aw[i + 1] = v.y;
            aw[i + 2] = v.z;
            aw[i + 3] = v.w;
          }
          int b2[4][TN];
          load_bw<TN>(bsrc + g * bstride, b2);
          gather4<TM, TN, true>(aw, b2, lut_s, row_bytes, TM, acc);
        }
      }
      if (!last) continue;
      sum_slices<KS>(acc);
      const int corr = pad * lut[off * n + off];
      if (s.slot < 0 && rows > 0) {
        uint32_t v[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int x = acc[i][j] - corr;
            v[i][j] = p.emit_acc
                          ? static_cast<uint32_t>(x)
                          : __float_as_uint(__fmul_rn(__int2float_rn(x),
                                                      scale));
          }
        uint32_t* out = static_cast<uint32_t*>(p.out);
        if (vec_out) {
          if constexpr (kTurn) {
            // the warp's TM x BN tile turned round in shared memory, then
            // written 16 bytes a lane, a row's columns consecutive
            uint32_t* tw = turn + warp * TM * BN;
            if (half == 0) {
#pragma unroll
              for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) tw[i * BN + col + j] = v[i][j];
            }
            __syncwarp();
            for (int e = lane; e < TM * BN / 4; e += 32) {
              const int i = (4 * e) / BN, cq = 4 * e - i * BN;
              if (i < rows && n0 + cq < N)
                *reinterpret_cast<uint4*>(
                    out + (size_t)(s.m0 + r0 + i) * N + n0 + cq) =
                    *reinterpret_cast<const uint4*>(tw + 4 * e);
            }
            __syncwarp();
          } else {  // 4 or 8 columns a lane: an int4 each
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              if (i >= rows) continue;
#pragma unroll
              for (int j = 0; j < TN; j += 4) {
                if (n0 + col + j >= N) continue;
                *reinterpret_cast<uint4*>(out + (size_t)(s.m0 + r0 + i) * N +
                                          n0 + col + j) =
                    make_uint4(v[i][j], v[i][j + 1], v[i][j + 2],
                               v[i][j + 3]);
              }
            }
          }
        } else if (half == 0) {  // ragged N: element by element
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            if (i >= rows) continue;
#pragma unroll
            for (int j = 0; j < TN; ++j)
              if (n0 + col + j < N)
                out[(size_t)(s.m0 + r0 + i) * N + n0 + col + j] = v[i][j];
          }
        }
      } else if (s.slot >= 0 && half == 0) {  // a split item: its slot
        int* sums = p.work + (size_t)s.slot * BM * wcols;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          if (i >= rows) continue;
#pragma unroll
          for (int j = 0; j < TN; ++j)
            atomicAdd(sums + (r0 + i) * wcols + t * BN + col + j,
                      acc[i][j] - corr);
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0;
    }

    if (last && s.slot >= 0) {
      // the block that completes the item's K stores the slot
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        int* count = p.work + (size_t)p.n_slots * BM * wcols + s.slot;
        const int before = atomicAdd(count, s.g1 - s.g0);
        *flag = before + (s.g1 - s.g0) == p.groups;
      }
      __syncthreads();
      if (*flag) {
        __threadfence();
        const int* sums = p.work + (size_t)s.slot * BM * wcols;
        const int c0 = s.ct0 * BN;
        for (int e = tid; e < BM * wcols; e += kThreads) {
          const int r = e / wcols, cc = e - r * wcols;
          const int m = s.m0 + r, nn = c0 + cc;
          if (m >= M || nn >= N) continue;
          const int x = __ldcg(sums + e);
          static_cast<uint32_t*>(p.out)[(size_t)m * N + nn] =
              p.emit_acc ? static_cast<uint32_t>(x)
                         : __float_as_uint(__fmul_rn(__int2float_rn(x),
                                                     scale));
        }
      }
    }

    buf ^= 1;
    sg = nsg;
    c = nc;
    s = ns;
  }
  cp_wait<0>();
}

template <int TM, int BN>
int launch(const Params& prm, int grid, int smem_bytes, cudaStream_t stream) {
  const Layout<TM, BN> L(prm);
  if (static_cast<size_t>(smem_bytes) != L.total || L.total > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = bwd_kernel<TM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_bn(const Params& prm, int bn, int grid, int smem, cudaStream_t s) {
  switch (bn) {
    case 16: return launch<TM, 16>(prm, grid, smem, s);
    case 32: return launch<TM, 32>(prm, grid, smem, s);
    case 64: return launch<TM, 64>(prm, grid, smem, s);
    case 128: return launch<TM, 128>(prm, grid, smem, s);
    case 256: return launch<TM, 256>(prm, grid, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The plan (offsets, then segments of (tile, first group, end group,
// slot)) and its shape (tm rows a warp, bn columns a tile, kc K a chunk, nt
// column tiles an item, resident B) are the wrapper's, run as given; the
// launch refuses a shape this kernel is not built for. Tiles are numbered
// row tile major over tiles_c groups of nt column tiles.
extern "C" int fused_lut_bwd_launch(const float* a, const float* b,
                                    const int16_t* lut, const float* sa,
                                    const float* sb, void* out, int emit_acc,
                                    int M, int K, int N, int n_codes,
                                    int offset, int lo, int hi,
                                    const int* plan, int grid, int tm,
                                    int bn, int kc, int nt, int resident,
                                    int tiles_n, int tiles_c, int groups,
                                    int* work, int n_slots, int smem_bytes,
                                    void* stream) {
  Params prm{a,  b,  lut, sa, sb, out, plan, work, M, K, N, n_codes, offset,
             lo, hi, emit_acc, kc, nt, tiles_n, tiles_c, groups, n_slots,
             resident};
  if (kc < 4 || kc % 4 || kc > kMaxChunk || nt < 1 || n_codes > 256 ||
      groups != (K + 3) / 4 || tiles_n != (N + bn - 1) / bn ||
      tiles_c != (tiles_n + nt - 1) / nt || (nt > 1 && 4 * groups > kc))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 4: return launch_bn<4>(prm, bn, grid, smem_bytes, s);
    case 8: return launch_bn<8>(prm, bn, grid, smem_bytes, s);
    case 16:  // 128-row tiles at up to 2 columns a lane
      switch (bn) {
        case 16: return launch<16, 16>(prm, grid, smem_bytes, s);
        case 32: return launch<16, 32>(prm, grid, smem_bytes, s);
        case 64: return launch<16, 64>(prm, grid, smem_bytes, s);
        default: break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
