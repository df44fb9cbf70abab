// lut_matmul: the unfused LUT-gather GEMM on integer codes,
//
//     out[m, n] = sum_k LUT[a[m, k] + off, w[k, n] + off]      (int32)
//
// Replaces the Pallas kernel src/repro/kernels/lut_matmul/kernel.py
// (lut_matmul_kernel), which pinned the int32 table in VMEM and gathered
// 128^3 tiles in 8-row sub-slices. Its callers: every GEMM of the unfused
// ACU (im2col + this kernel: ResNet-20's convs at N = 16, 32, 64 and its
// head at N = 10, CNN-224's five layers), the unfused route's weight
// gradients (M = Cin*kh*kw, K = every pixel of the batch) and input
// gradients.
//
// What bounds it on Hopper: every product is one data-dependent 16-bit
// gather from the int16 product table in shared memory (lut_narrow.cuh),
// so the ceiling is one gather per lane per clock, 132 SMs x 32 lanes.
//
// What the design does about it:
//  * The narrow-N core (lut_narrow.cuh). A warp owns TM output rows and a
//    BN-column tile; at BN >= 32 its 32 lanes gather from one table row
//    per instruction, at BN = 16 (N <= 16) each half-warp walks its own K
//    slice, so the two halves read two rows at different k. The slices
//    meet by one __shfl_xor.
//  * Work plan from the wrapper (kernels/lut_matmul/ops.py: lut_plan, in
//    the mould of kernel 3's dense_plan and on the same stream-K split).
//    The output is cut into BM x BN tiles and K into groups of 4; each
//    persistent block runs a list of segments (tile, first group, end
//    group, slot). Whole tiles go round-robin; what does not divide into
//    whole rounds (all of it for a weight gradient, whose few tiles have K
//    = every pixel of the batch) is split along K so that every SM gets
//    the same share. A split tile's int32 partials are added into a zeroed
//    workspace slot, and the block whose segment completes the tile's
//    groups (per-tile arrival counter) stores it.
//  * Rows that fit M. A block is 8 warps: wm across the tile's rows (TM
//    rows each) and 8 / wm across each K chunk, so at small M no warp
//    gathers for a row past M.
//  * One-byte operands. Each K chunk of 32 (int32 codes of A and W) is
//    copied with cp.async into one of two buffers while the previous chunk
//    is gathered, then clamped to the table and packed as bytes: a thread
//    reads 4 row codes with one broadcast load and TN weight codes with
//    one load. The table is copied once per block.
//  * The K pad. A chunk's last group of 4 may run past the segment's K
//    range; those slots hold the offset code on both sides and pad *
//    LUT[off, off] is subtracted in integer space, the reference's rule
//    for its K pad (fused_lut_dense/kernel.py:76).
// Integer adds are associative, so every plan gives the reference's
// accumulator bit for bit.
#include "lut_narrow.cuh"

namespace {

using namespace lutnarrow;

constexpr int kBK = 32;           // K chunk staged per step
constexpr int kGroups = kBK / 4;  // groups of 4 K per chunk

struct Params {
  const int* a;
  const int* w;
  const int16_t* lut;
  int* out;
  const int* plan;     // [grid + 1] segment offsets, then 4 ints a segment
  int* work;           // [n_slots * BM * BN] int32 sums, [n_slots] counters
  int M, K, N, n_codes, offset;
  int wm, tiles_n, groups, n_slots;
};

// Shared memory carve-up, the same on host and device (and in the
// wrapper's _lut_smem): the table, two buffers each of raw A and raw W
// codes (int32), their one-byte codes, the completion flag.
template <int TM, int BN>
struct Layout {
  static constexpr int BMmax = TM * kWarps;
  size_t raw_a, raw_b, code_a, code_b, flag, total;
  __host__ __device__ explicit Layout(int n_codes) {
    raw_a = round_up16((size_t)n_codes * n_codes * 2);
    raw_b = raw_a + 2 * round_up16((size_t)BMmax * kBK * 4);
    code_a = raw_b + 2 * round_up16((size_t)kBK * BN * 4);
    code_b = code_a + round_up16((size_t)BMmax * kBK);
    flag = code_b + round_up16((size_t)kBK * BN);
    total = flag + 16;
  }
};

__device__ __forceinline__ uint32_t code_of(int v, int off, int n) {
  return static_cast<uint32_t>(min(max(v + off, 0), n - 1));
}

template <int TM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
lut_matmul_kernel(Params p) {
  using LN = Lanes<BN>;
  constexpr int KS = LN::KS, TN = LN::TN;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<TM, BN> L(p.n_codes);
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  int* raw_a = reinterpret_cast<int*>(smem + L.raw_a);
  int* raw_b = reinterpret_cast<int*>(smem + L.raw_b);
  constexpr int kRawA = (Layout<TM, BN>::BMmax * kBK * 4 + 15) / 16 * 4;
  constexpr int kRawB = kBK * BN;                           // ints
  uint8_t* code_a = smem + L.code_a;
  uint8_t* code_b = smem + L.code_b;
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  int* scratch = raw_b;  // the cross-warp K reduction, after the K loop

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = p.wm, wk = kWarps / wm;
  const int wmid = warp % wm, wkid = warp / wm;
  const int BM = TM * wm;
  const int M = p.M, K = p.K, N = p.N, n = p.n_codes, off = p.offset;
  const int row_bytes = 2 * n;
  const int col = LN::col(lane), half = LN::slice(lane);
  // this lane's K slice: groups g = slice, slice + n_slices, ... of a chunk
  const int slice = wkid * KS + half, n_slices = wk * KS;

  copy_table(lut, p.lut, n, tid);

  const bool vec_a = (K % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(p.a) & 15) == 0;
  const bool vec_b = (N % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(p.w) & 15) == 0;
  const uint32_t lut_s = smem_addr(lut);

  const int seg_begin = p.plan[blockIdx.x];
  const int seg_end = p.plan[blockIdx.x + 1];
  const int* segs = p.plan + gridDim.x + 1;

  for (int sg = seg_begin; sg < seg_end; ++sg) {
    const int tile = segs[4 * sg], g0 = segs[4 * sg + 1];
    const int g1 = segs[4 * sg + 2], slot = segs[4 * sg + 3];
    const int m0 = (tile / p.tiles_n) * BM;
    const int n0 = (tile % p.tiles_n) * BN;
    const int kb = 4 * g0, ke = min(K, 4 * g1);
    const int n_chunks = (ke - kb + kBK - 1) / kBK;

    // stage chunk c's raw codes into buffer `buf`
    auto issue = [&](int c, int buf) {
      const int k0 = kb + c * kBK;
      int* ra = raw_a + buf * kRawA;
      int* rb = raw_b + buf * kRawB;
      if (vec_a) {
        for (int e = tid; e < BM * (kBK / 4); e += kThreads) {
          const int r = e / (kBK / 4), kq = (e % (kBK / 4)) * 4;
          const int m = m0 + r, k = k0 + kq;
          const bool ok = m < M && k < K;
          cp_async16(ra + r * kBK + kq,
                     ok ? p.a + (size_t)m * K + k : p.a, ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < BM * kBK; e += kThreads) {
          const int r = e / kBK, kk = e % kBK;
          const int m = m0 + r, k = k0 + kk;
          const bool ok = m < M && k < K;
          cp_async4(ra + e, ok ? p.a + (size_t)m * K + k : p.a, ok ? 4 : 0);
        }
      }
      if (vec_b) {
        for (int e = tid; e < kBK * (BN / 4); e += kThreads) {
          const int kk = e / (BN / 4), nq = (e % (BN / 4)) * 4;
          const int k = k0 + kk, nn = n0 + nq;
          const bool ok = k < K && nn < N;
          cp_async16(rb + kk * BN + nq,
                     ok ? p.w + (size_t)k * N + nn : p.w, ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < kBK * BN; e += kThreads) {
          const int kk = e / BN, nn = n0 + e % BN, k = k0 + kk;
          const bool ok = k < K && nn < N;
          cp_async4(rb + e, ok ? p.w + (size_t)k * N + nn : p.w,
                    ok ? 4 : 0);
        }
      }
    };

    int acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0;
    const int r0 = wmid * TM;
    const int rows = max(0, min(TM, M - (m0 + r0)));
    int pad = 0;  // K slots past the segment's range, summed as LUT[off, off]

    __syncthreads();  // the previous segment is done with every buffer
    issue(0, 0);
    cp_commit();
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) issue(c + 1, (c + 1) & 1);
      cp_commit();
      cp_wait<1>();     // chunk c (and, first, the table) has landed
      __syncthreads();  // ... for every thread's copies
      const int k0 = kb + c * kBK;
      const int kn = min(kBK, ke - k0);
      const int ng = (kn + 3) / 4;
      pad += 4 * ng - kn;
      {  // raw -> one-byte codes; slots past the range hold the offset
        const int* ra = raw_a + (c & 1) * kRawA;
        const int* rb = raw_b + (c & 1) * kRawB;
        for (int e = tid; e < BM * (kBK / 4); e += kThreads) {
          const int r = e / (kBK / 4), kq = (e % (kBK / 4)) * 4;
          const bool row_ok = m0 + r < M;
          const int4 v = *reinterpret_cast<const int4*>(ra + r * kBK + kq);
          const int av[4] = {v.x, v.y, v.z, v.w};
          uint32_t word = 0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t code = (row_ok && kq + u < kn)
                                      ? code_of(av[u], off, n)
                                      : static_cast<uint32_t>(off);
            word |= code << (8 * u);
          }
          *reinterpret_cast<uint32_t*>(code_a + r * kBK + kq) = word;
        }
        for (int e = tid; e < kBK * (BN / 4); e += kThreads) {
          const int kk = e / (BN / 4), nq = (e % (BN / 4)) * 4;
          const int4 v = *reinterpret_cast<const int4*>(rb + kk * BN + nq);
          const int wv[4] = {v.x, v.y, v.z, v.w};
          uint32_t word = 0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t code = (kk < kn && n0 + nq + u < N)
                                      ? code_of(wv[u], off, n)
                                      : static_cast<uint32_t>(off);
            word |= code << (8 * u);
          }
          *reinterpret_cast<uint32_t*>(code_b + kk * BN + nq) = word;
        }
      }
      __syncthreads();
      if (rows > 0) {
        for (int g = slice; g < ng; g += n_slices) {
          uint32_t aw[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            aw[i] = (i < rows) ? *reinterpret_cast<const uint32_t*>(
                                     code_a + (r0 + i) * kBK + 4 * g)
                               : 0u;
          int b2[4][TN];
          load_b4<TN>(code_b + 4 * g * BN + col, BN, b2);
          if (rows == TM)
            gather4<TM, TN, true>(aw, b2, lut_s, row_bytes, rows, acc);
          else
            gather4<TM, TN, false>(aw, b2, lut_s, row_bytes, rows, acc);
        }
      }
    }
    sum_slices<KS>(acc);

    // warps that split K hand their sums to the first warp of their rows
    const bool lead = half == 0;
    if (wk > 1) {
      if (wkid > 0 && rows > 0 && lead) {
        int* dst = scratch + (size_t)(wkid - 1) * BM * BN;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            dst[(r0 + i) * BN + col + j] = acc[i][j];
      }
      __syncthreads();
      if (wkid == 0 && rows > 0 && lead)
        for (int o = 0; o < wk - 1; ++o) {
          const int* src = scratch + (size_t)o * BM * BN;
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] += src[(r0 + i) * BN + col + j];
        }
    }

    const int m00 = lut[off * n + off];
    const bool whole = g0 == 0 && g1 == p.groups;
    int* sums = p.work + (size_t)max(slot, 0) * BM * BN;
    if (wkid == 0 && lead) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (i >= rows) continue;
        const int m = m0 + r0 + i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int nn = n0 + col + j;
          if (nn >= N) continue;
          const int v = acc[i][j] - pad * m00;
          if (whole)
            p.out[(size_t)m * N + nn] = v;
          else
            atomicAdd(sums + (r0 + i) * BN + col + j, v);
        }
      }
    }
    if (!whole) {  // the block that completes the tile's K stores it
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        int* count = p.work + (size_t)p.n_slots * BM * BN + slot;
        const int before = atomicAdd(count, g1 - g0);
        *flag = before + (g1 - g0) == p.groups;
      }
      __syncthreads();
      if (*flag) {
        __threadfence();
        for (int e = tid; e < BM * BN; e += kThreads) {
          const int m = m0 + e / BN, nn = n0 + e % BN;
          if (m >= M || nn >= N) continue;
          p.out[(size_t)m * N + nn] = __ldcg(sums + e);
        }
      }
    }
  }
  cp_wait<0>();
}

template <int TM, int BN>
int launch(const Params& prm, int grid, cudaStream_t stream) {
  const Layout<TM, BN> L(prm.n_codes);
  auto kernel = lut_matmul_kernel<TM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, L.total, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <int TM>
int launch_bn(const Params& prm, int bn, int grid, cudaStream_t s) {
  switch (bn) {
    case 16: return launch<TM, 16>(prm, grid, s);
    case 32: return launch<TM, 32>(prm, grid, s);
    default: break;
  }
  if constexpr (TM <= 8) {
    switch (bn) {
      case 64: return launch<TM, 64>(prm, grid, s);
      case 128: return launch<TM, 128>(prm, grid, s);
      case 256: return launch<TM, 256>(prm, grid, s);
      default: break;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The plan (offsets, then segments) and its tile (tm rows a warp, wm warps
// across rows, bn columns) are the wrapper's, run as given; the launch
// refuses a tile this kernel is not built for.
extern "C" int lut_matmul_launch(const int* a, const int* w,
                                 const int16_t* lut, int* out, int M, int K,
                                 int N, int n_codes, int offset,
                                 const int* plan, int grid, int tm, int wm,
                                 int bn, int tiles_n, int groups, int* work,
                                 int n_slots, void* stream) {
  Params prm{a, w, lut, out, plan, work, M, K, N, n_codes, offset,
             wm, tiles_n, groups, n_slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ks = bn == 16 ? 2 : 1;
  if (wm < 1 || wm > kWarps || kWarps % wm || (kWarps / wm) * ks > kGroups ||
      (tm == 16 && wm != kWarps) || n_codes > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tm) {
    case 4: return launch_bn<4>(prm, bn, grid, s);
    case 8: return launch_bn<8>(prm, bn, grid, s);
    case 16: return launch_bn<16>(prm, bn, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
