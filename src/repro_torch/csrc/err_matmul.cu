// err_matmul: the LOWRANK mode's GEMM, an exact integer product plus a
// rank-r correction of the multiplier's error table,
//
//     out[m, n] = float(sum_k a[m,k] * w[k,n])
//                 + sum_k sum_r f[a[m,k] + off, r] * g[w[k,n] + off, r]
//
// on shifted codes of at most 8 bits (int32 in), with (n_codes, r) float32
// tables f and g (E[a, w] ~= f[a] . g[w]); float32 out.
//
// Replaces the Pallas kernel src/repro/kernels/err_matmul/kernel.py
// (err_matmul_kernel), which ran both terms on the MXU: the exact term as
// int8 x int8 -> int32, the correction as one (bm, bk*r) x (bk*r, bn)
// product of gathered table rows; its ops.py padded K with code 0 and
// subtracted the pad's f[off] . g[off] afterwards. Here nothing is padded:
// codes past K are never summed, rows and columns past M and N never
// stored.
//
// What bounds it on Hopper: the correction's 2*M*K*N*r flops, at r = 8
// one m16n8k8 TF32 tensor-core product per 16 rows x 8 columns x code k,
// three of them for the 3xTF32 split (495 TFLOP/s dense TF32; a float32
// CUDA-core version, as this kernel was, is held to 67); and the bytes of
// the int32 code matrices, read once. At ResNet-20's widths (N = 10-64)
// the operands are gathered per code and reused over few columns, so the
// shared-memory fragment loads rival the MMAs, and mma.sync issues TF32
// products well below the dense rate that only wgmma reaches; both share
// the measured time (PERF.md).
//
// What the design does about it:
//  * Both terms on the tensor cores with mma.sync. The exact term: int8
//    m16n8k32 with int32 accumulate, on the codes cast to int8 as the
//    reference's kernel.py does; one product per 32 k. The correction at
//    r = 8: for each code k one m16n8k8 whose A fragment is 16 rows x the
//    8 ranks of f[a[m, k]] and whose B fragment is the 8 ranks x 8 columns
//    of g[w[k, n]], each lane gathering its elements from the tables in
//    shared memory straight into registers; the (M, K*r) matrix is never
//    built. Other ranks walk k*r in groups of 8 with the tail zeroed.
//  * 3xTF32: each table value is split into a TF32 hi and a lo, and
//    lo*hi + hi*lo and hi*hi go into two float32 accumulators (two
//    independent chains of MMAs): the correction keeps about 22 bits a
//    value, where one TF32 pass rounds each value at 2^-11.
//  * Gathers without bank conflicts: at r = 8 the tables are split once,
//    when a block loads them, and each row holds two copies of (hi_t,
//    hi_t+4, lo_t, lo_t+4) for t = 0..3, so that a lane's four values are
//    one 16-byte load and lane (g, t) reads copy g % 2: the 2 rows of a
//    quarter-warp's load lie in the two halves of the banks whatever their
//    codes. Staged code rows are 48 bytes, so the 8 rows of a fragment's
//    32-bit code loads hit 8 banks.
//  * Fragment reuse: a warp owns WM rows x WN columns; an A fragment
//    serves the WN / 8 column tiles, a B fragment the WM / 16 row tiles.
//  * Staging: persistent blocks over output tiles (the column tile
//    follows N: 16, 32, 64); each block's (tile, K chunk of 32) steps run
//    as one pipeline, the next step's codes in flight by cp.async while
//    this one is summed, and each landed step narrowed once into int8
//    codes (the exact term) and one-byte table indices (the gathers).
//  * The two terms meet once: out = float(int_acc) + (cross + hi*hi).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;          // K chunk: one int8 m16n8k32 deep
constexpr int kRowB = 48;        // bytes of one staged code row (32 + pad)
constexpr int kTabRow = 32;      // floats of one r = 8 table row
constexpr int kSmemLimit = 232448;

__host__ __device__ inline size_t round16(size_t bytes) {
  return (bytes + 15) & ~size_t(15);
}

// Shared memory carve-up, the same on host and device and in ops.py
// (err_smem).
struct Layout {
  size_t tab_g, raw_a, raw_b, code_a, idx_a, code_b, idx_b, total;
  __host__ __device__ Layout(int n_codes, int r, int bm, int bn) {
    const size_t tab =
        round16((size_t)n_codes * (r == 8 ? kTabRow : r) * 4);
    tab_g = tab;
    raw_a = tab_g + tab;                            // 2 x [bm][32] int32
    raw_b = raw_a + 2 * (size_t)bm * kBK * 4;        // 2 x [32][bn] int32
    code_a = raw_b + 2 * (size_t)kBK * bn * 4;       // 2 x [bm][48] int8
    idx_a = code_a + 2 * (size_t)bm * kRowB;         // 2 x [bm][48] index
    code_b = idx_a + 2 * (size_t)bm * kRowB;         // 2 x [bn][48] int8
    idx_b = code_b + 2 * (size_t)bn * kRowB;         // 2 x [bn][48] index
    total = idx_b + 2 * (size_t)bn * kRowB;
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

// x = hi + lo: hi is x rounded to its top 11 significant bits (Veltkamp's
// split by 2^13 + 1, so hi is a TF32 value), lo = x - hi exactly (at most
// 12 significant bits, of which the tensor core reads the top 11). Four
// float32 operations, on the FMA pipe.
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
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte u of w, zero-extended
__device__ __forceinline__ uint32_t byte_of(uint32_t w, int u) {
  return __byte_perm(w, 0u, 0x4440u | static_cast<uint32_t>(u));
}

// A block of 8 warps: BN / WN across the tile's columns, the rest across
// its rows, WM rows x WN columns each.
template <int BN, int WM>
struct Tile {
  static constexpr int WN = BN < 32 ? BN : 32;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kWarpsM = kWarps / kWarpsN;
  static constexpr int BM = WM * kWarpsM;
  static constexpr int MB = WM / 16;   // m16 row blocks of a warp
  static constexpr int NB = WN / 8;    // n8 column blocks of a warp
};

template <int BN, int WM, bool R8>
__global__ void __launch_bounds__(kThreads, 1)
err_matmul_kernel(const int* __restrict__ a, const int* __restrict__ w,
                  const float* __restrict__ f, const float* __restrict__ g,
                  float* __restrict__ out, int M, int K, int N, int n_codes,
                  int r, int offset) {
  using T = Tile<BN, WM>;
  constexpr int BM = T::BM, MB = T::MB, NB = T::NB;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(n_codes, r, BM, BN);
  float* Fs = reinterpret_cast<float*>(smem);
  float* Gs = reinterpret_cast<float*>(smem + L.tab_g);
  int* raw_a = reinterpret_cast<int*>(smem + L.raw_a);
  int* raw_b = reinterpret_cast<int*>(smem + L.raw_b);
  uint8_t* code_a = smem + L.code_a;
  uint8_t* idx_a = smem + L.idx_a;
  uint8_t* code_b = smem + L.code_b;
  uint8_t* idx_b = smem + L.idx_b;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane >> 2, tq = lane & 3;  // the fragments' group, thread
  const int row0 = (warp % T::kWarpsM) * WM + gq;  // + 16 mb (+ 8)
  const int col0 = (warp / T::kWarpsM) * T::WN + gq;  // + 8 nb

  // the tables (made visible by the first barrier below)
  if (R8) {
    // row c: two copies of (hi_t, hi_t+4, lo_t, lo_t+4) for t = 0..3
    for (int i = tid; i < n_codes * 8; i += kThreads) {
      const int c = i / 8, j = i % 8;
      const int pos = 4 * (j % 4) + j / 4;
      uint32_t fh, fl, gh, gl;
      split(__ldg(f + i), fh, fl);
      split(__ldg(g + i), gh, gl);
#pragma unroll
      for (int cp = 0; cp < 2; ++cp) {
        float* fr = Fs + c * kTabRow + 16 * cp + pos;
        float* gr = Gs + c * kTabRow + 16 * cp + pos;
        fr[0] = __uint_as_float(fh);
        fr[2] = __uint_as_float(fl);
        gr[0] = __uint_as_float(gh);
        gr[2] = __uint_as_float(gl);
      }
    }
  } else {
    for (int i = tid; i < n_codes * r; i += kThreads) {
      Fs[i] = __ldg(f + i);
      Gs[i] = __ldg(g + i);
    }
  }

  const int bx = static_cast<int>(blockIdx.x);
  const int grid = static_cast<int>(gridDim.x);
  const int tiles_n = (N + BN - 1) / BN;
  const int n_tiles = ((M + BM - 1) / BM) * tiles_n;
  const int nk = (K + kBK - 1) / kBK;
  const int steps = bx < n_tiles ? ((n_tiles - 1 - bx) / grid + 1) * nk : 0;
  const bool vec_a = K % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool vec_b = N % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;

  // step s: chunk s % nk of the block's (s / nk)-th tile
  auto tile_of = [&](int s) { return bx + (s / nk) * grid; };

  auto issue = [&](int s) {
    if (s < steps) {
      const int tile = tile_of(s);
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      const int k0 = (s % nk) * kBK;
      int* ra = raw_a + (s & 1) * BM * kBK;
      int* rb = raw_b + (s & 1) * kBK * BN;
      if (vec_a) {
        for (int q = tid; q < BM * (kBK / 4); q += kThreads) {
          const int row = q / (kBK / 4), kq = (q % (kBK / 4)) * 4;
          const int m = m0 + row, k = k0 + kq;
          const bool ok = m < M && k < K;
          cp_async16(ra + row * kBK + kq, ok ? a + (size_t)m * K + k : a,
                     ok ? 16 : 0);
        }
      } else {
        for (int q = tid; q < BM * kBK; q += kThreads) {
          const int m = m0 + q / kBK, k = k0 + q % kBK;
          const bool ok = m < M && k < K;
          cp_async4(ra + q, ok ? a + (size_t)m * K + k : a, ok ? 4 : 0);
        }
      }
      if (vec_b) {
        for (int q = tid; q < kBK * (BN / 4); q += kThreads) {
          const int kk = q / (BN / 4), nq = (q % (BN / 4)) * 4;
          const int k = k0 + kk, n = n0 + nq;
          const bool ok = k < K && n < N;
          cp_async16(rb + kk * BN + nq, ok ? w + (size_t)k * N + n : w,
                     ok ? 16 : 0);
        }
      } else {
        for (int q = tid; q < kBK * BN; q += kThreads) {
          const int k = k0 + q / BN, n = n0 + q % BN;
          const bool ok = k < K && n < N;
          cp_async4(rb + q, ok ? w + (size_t)k * N + n : w, ok ? 4 : 0);
        }
      }
    }
    cp_commit();
  };

  // 4 codes -> their int8 bytes and their clamped table indices
  auto pack = [&](const int (&v)[4], uint32_t& cw, uint32_t& iw) {
    cw = 0;
    iw = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c8 = static_cast<int8_t>(v[u] & 0xff);
      cw |= static_cast<uint32_t>(v[u] & 0xff) << (8 * u);
      iw |= static_cast<uint32_t>(min(max(c8 + offset, 0), n_codes - 1))
            << (8 * u);
    }
  };

  // narrow step s's raw codes into code and index buffer s & 1: A's rows
  // and B's columns, 32 k a row of 48 bytes
  auto narrow = [&](int s) {
    const int* ra = raw_a + (s & 1) * BM * kBK;
    const int* rb = raw_b + (s & 1) * kBK * BN;
    uint8_t* ca = code_a + (s & 1) * BM * kRowB;
    uint8_t* ia = idx_a + (s & 1) * BM * kRowB;
    uint8_t* cb = code_b + (s & 1) * BN * kRowB;
    uint8_t* ib = idx_b + (s & 1) * BN * kRowB;
    for (int q = tid; q < BM * (kBK / 4); q += kThreads) {
      const int row = q / (kBK / 4), kq = q % (kBK / 4);
      const int4 v4 = *reinterpret_cast<const int4*>(ra + row * kBK + 4 * kq);
      const int v[4] = {v4.x, v4.y, v4.z, v4.w};
      uint32_t cw, iw;
      pack(v, cw, iw);
      *reinterpret_cast<uint32_t*>(ca + row * kRowB + 4 * kq) = cw;
      *reinterpret_cast<uint32_t*>(ia + row * kRowB + 4 * kq) = iw;
    }
    for (int q = tid; q < BN * (kBK / 4); q += kThreads) {
      const int col = q % BN, kq = q / BN;
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = rb[(4 * kq + u) * BN + col];
      uint32_t cw, iw;
      pack(v, cw, iw);
      *reinterpret_cast<uint32_t*>(cb + col * kRowB + 4 * kq) = cw;
      *reinterpret_cast<uint32_t*>(ib + col * kRowB + 4 * kq) = iw;
    }
  };

  int iacc[MB][NB][4];
  float facc[MB][NB][4];   // hi * hi
  float fcross[MB][NB][4]; // lo * hi + hi * lo

  issue(0);
  issue(1);
  cp_wait<1>();
  __syncthreads();  // step 0's codes and the tables
  narrow(0);
  for (int s = 0; s < steps; ++s) {
    cp_wait<0>();     // step s + 1 has landed
    __syncthreads();  // ... for every thread; step s is narrowed
    issue(s + 2);     // into step s's raw buffer, narrowed before
    if (s + 1 < steps) narrow(s + 1);

    const int c = s % nk;
    const int kn = min(kBK, K - c * kBK);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            iacc[i][j][v] = 0;
            facc[i][j][v] = 0.0f;
            fcross[i][j][v] = 0.0f;
          }
    }
    const uint8_t* ca = code_a + (s & 1) * BM * kRowB;
    const uint8_t* ia = idx_a + (s & 1) * BM * kRowB;
    const uint8_t* cb = code_b + (s & 1) * BN * kRowB;
    const uint8_t* ib = idx_b + (s & 1) * BN * kRowB;

    // the exact term: one int8 m16n8k32 a (row block, column block); the
    // codes past K are 0
    {
      uint32_t af[MB][4], bf[NB][2];
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        const uint8_t* p0 = ca + (row0 + 16 * i) * kRowB + 4 * tq;
        const uint8_t* p1 = p0 + 8 * kRowB;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p1);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const uint8_t* p0 = cb + (col0 + 8 * j) * kRowB + 4 * tq;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p0);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p0 + 16);
      }
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_s8(iacc[i][j], af[i], bf[j]);
    }

    // the correction
    if (R8) {
      // lane (gq, tq) reads copy gq % 2 of a row: hi and lo of ranks tq
      // and tq + 4, one 16-byte load
      const char* fl = reinterpret_cast<const char*>(
          Fs + 16 * (gq & 1) + 4 * tq);
      const char* gl = reinterpret_cast<const char*>(
          Gs + 16 * (gq & 1) + 4 * tq);
      const int ng = (kn + 3) / 4;
      for (int kq = 0; kq < ng; ++kq) {
        uint32_t wa[MB][2], wb[NB];
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          const uint8_t* p0 = ia + (row0 + 16 * i) * kRowB + 4 * kq;
          wa[i][0] = *reinterpret_cast<const uint32_t*>(p0);
          wa[i][1] = *reinterpret_cast<const uint32_t*>(p0 + 8 * kRowB);
        }
#pragma unroll
        for (int j = 0; j < NB; ++j)
          wb[j] = *reinterpret_cast<const uint32_t*>(
              ib + (col0 + 8 * j) * kRowB + 4 * kq);
        const int un = min(4, kn - 4 * kq);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u >= un) break;
          uint32_t ah[MB][4], al[MB][4], bh[NB][2], bl[NB][2];
#pragma unroll
          for (int i = 0; i < MB; ++i) {
            const uint4 x0 = *reinterpret_cast<const uint4*>(
                fl + (byte_of(wa[i][0], u) << 7));
            const uint4 x1 = *reinterpret_cast<const uint4*>(
                fl + (byte_of(wa[i][1], u) << 7));
            ah[i][0] = x0.x; ah[i][1] = x1.x; ah[i][2] = x0.y; ah[i][3] = x1.y;
            al[i][0] = x0.z; al[i][1] = x1.z; al[i][2] = x0.w; al[i][3] = x1.w;
          }
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const uint4 y = *reinterpret_cast<const uint4*>(
                gl + (byte_of(wb[j], u) << 7));
            bh[j][0] = y.x; bh[j][1] = y.y;
            bl[j][0] = y.z; bl[j][1] = y.w;
          }
#pragma unroll
          for (int i = 0; i < MB; ++i)
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              mma_tf32(fcross[i][j], al[i], bh[j]);
              mma_tf32(fcross[i][j], ah[i], bl[j]);
              mma_tf32(facc[i][j], ah[i], bh[j]);
            }
        }
      }
    } else {
      // k * r flattened, in groups of 8 (the MMA's depth); past kn * r 0
      const int q_end = kn * r;
      for (int q0 = 0; q0 < q_end; q0 += 8) {
        uint32_t ah[MB][4], al[MB][4], bh[NB][2], bl[NB][2];
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const int q = q0 + tq + 4 * part;
          const bool ok = q < q_end;
          const int k = ok ? q / r : 0, j = ok ? q % r : 0;
#pragma unroll
          for (int i = 0; i < MB; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + 16 * i + 8 * h;
              const float v =
                  ok ? Fs[ia[row * kRowB + k] * r + j] : 0.0f;
              split(v, ah[i][h + 2 * part], al[i][h + 2 * part]);
            }
#pragma unroll
          for (int jb = 0; jb < NB; ++jb) {
            const int col = col0 + 8 * jb;
            const float v = ok ? Gs[ib[col * kRowB + k] * r + j] : 0.0f;
            split(v, bh[jb][part], bl[jb][part]);
          }
        }
#pragma unroll
        for (int i = 0; i < MB; ++i)
#pragma unroll
          for (int jb = 0; jb < NB; ++jb) {
            mma_tf32(fcross[i][jb], al[i], bh[jb]);
            mma_tf32(fcross[i][jb], ah[i], bl[jb]);
            mma_tf32(facc[i][jb], ah[i], bh[jb]);
          }
      }
    }

    if (c == nk - 1) {  // the tile's last chunk: the two terms meet once
      const int tile = tile_of(s);
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + row0 + 16 * i + 8 * h;
          if (m >= M) continue;
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int n = n0 + (col0 - gq) + 8 * j + 2 * tq + v;
              if (n < N)
                out[(size_t)m * N + n] = __fadd_rn(
                    __int2float_rn(iacc[i][j][2 * h + v]),
                    __fadd_rn(fcross[i][j][2 * h + v],
                              facc[i][j][2 * h + v]));
            }
        }
    }
  }
  cp_wait<0>();
}

template <int BN, int WM>
int launch(const int* a, const int* w, const float* f, const float* g,
           float* out, int M, int K, int N, int n_codes, int r, int offset,
           int num_blocks, cudaStream_t stream) {
  using T = Tile<BN, WM>;
  const Layout L(n_codes, r, T::BM, BN);
  if (L.total > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = r == 8 ? err_matmul_kernel<BN, WM, true>
                       : err_matmul_kernel<BN, WM, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      (long long)((M + T::BM - 1) / T::BM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < num_blocks ? tiles : num_blocks);
  if (grid <= 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, L.total, stream>>>(a, w, f, g, out, M, K, N,
                                              n_codes, r, offset);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_wm(int wm, const int* a, const int* w, const float* f,
              const float* g, float* out, int M, int K, int N, int n_codes,
              int r, int offset, int num_blocks, cudaStream_t stream) {
  if (wm == 16)
    return launch<BN, 16>(a, w, f, g, out, M, K, N, n_codes, r, offset,
                          num_blocks, stream);
  if (wm == 32)
    return launch<BN, 32>(a, w, f, g, out, M, K, N, n_codes, r, offset,
                          num_blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The column tile follows N (ops.py: err_tile): 16 for the head (N = 10)
// and the 16-channel stage, 32 for 32 channels, 64 above; wm rows a warp.
extern "C" int err_matmul_launch(const int* a, const int* w, const float* f,
                                 const float* g, float* out, int M, int K,
                                 int N, int n_codes, int r, int offset,
                                 int bn, int wm, int num_blocks,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_codes > 256 || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bn) {
    case 16: return launch_wm<16>(wm, a, w, f, g, out, M, K, N, n_codes, r,
                                  offset, num_blocks, s);
    case 32: return launch_wm<32>(wm, a, w, f, g, out, M, K, N, n_codes, r,
                                  offset, num_blocks, s);
    case 64: return launch_wm<64>(wm, a, w, f, g, out, M, K, N, n_codes, r,
                                  offset, num_blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
