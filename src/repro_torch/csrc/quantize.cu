// quantize: the affine quantizer of every ACU operand,
//
//     out[i] = int(clamp(rint(float(x[i]) / s[i] + z[i]), lo, hi))
//
// over a tensor of at most four (merged) dims, x float32 or bfloat16 read
// through its strides, s and z float32 broadcast views
// (stride 0 along broadcast dims), out int32, contiguous.
//
// Replaces the Pallas kernel src/repro/kernels/quantize/kernel.py
// (quantize_kernel), a per-tensor quantizer over a flat array padded to
// blocks of 1024 with the scale and zero point as (1,) arrays. Here the
// scale and zero point may also be per channel along any axis, since the
// port quantizes every weight per output channel on every call, and
// nothing is padded.
//
// Rounding is the plain version's bit for bit: a correctly rounded divide
// (__fdiv_rn), a separately rounded add (__fadd_rn: nothing may contract
// or reorder it), rintf in the default mode (half to even, as
// torch.round), then the clamp; no --use_fast_math.
//
// What bounds it on Hopper: bytes. Each element reads 2 or 4 bytes and
// writes 4 (an rwkv6-3b decode step streams 17.4 GB of weights and codes);
// the scale and zero point are a row or a scalar that stays in L1/L2. A
// kernel of one scalar load and store an element, its index found by a
// divide and a modulo an element, reached half of the bytes bound.
//
// What the design does about it: three paths, picked on the host
// (kernels/quantize/ops.py: quantize_plan).
//  * strip (every weight the port quantizes): the merged dims are (groups,
//    rows, columns), x dense and 16-byte aligned along the columns. A
//    thread owns one 16-byte column vector (8 bfloat16 or 4 float32) of
//    one group and takes 4 rows, all 4 vectors (64 B bfloat16) in flight
//    before it converts any, then writes each vector's codes as 16-byte
//    int4 stores, evict-first; at bfloat16 a warp's 8 codes a lane are
//    exchanged by shuffles so that each of its two stores writes one
//    contiguous 512-byte run (own-lane stores left 16-byte holes and ran
//    at 80 % of the rate these reach). A block takes one such row step
//    and ends, so the blocks in flight cover adjacent rows (a one-wave
//    grid whose blocks walked long row bands ran 7 % slower). A scale or
//    zero point that varies along the columns (a (1, N) weight scale, the
//    (E, 1, N) grouped one) is loaded once a thread and kept in registers;
//    one that varies along the rows (a conv weight's (Cout, 1, 1, 1)) is
//    one scalar a row. Index arithmetic is 32-bit and done once a vector.
//  * flat: x dense, its rows ragged or its start not 16-byte aligned. The
//    flat stream in 16-byte vectors from the first aligned element, 4 in
//    flight a thread, one divide a vector to place it; the elements
//    before the first vector and after the last one element by element.
//  * strided: the general walk through the strides, one element a thread
//    and kItems loads in flight, for a non-unit inner stride or four
//    merged dims.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRank = 4;
constexpr int kThreads = 256;
constexpr int kItems = 4;     // elements a thread has in flight (strided)
constexpr int kUnroll = 4;    // vectors a thread has in flight (strip, flat)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int code(float x, float s, float z, float lo,
                                    float hi) {
  const float q = rintf(__fadd_rn(__fdiv_rn(x, s), z));
  return static_cast<int>(fminf(fmaxf(q, lo), hi));
}

// the 16 / sizeof(T) values of one 16-byte vector, widened exactly
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The streams pass through once: codes are stored evict-first (st.cs)
// and x is loaded without a place in L1.
__device__ __forceinline__ void store4(int* o, int a, int b, int c, int d) {
  __stcs(reinterpret_cast<int4*>(o), make_int4(a, b, c, d));
}

template <int V>
__device__ __forceinline__ void store_vec(int* o, const int (&c)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) store4(o + i, c[i], c[i + 1], c[i + 2],
                                        c[i + 3]);
}

// The 8 codes each lane of a warp holds for 256 adjacent columns (lane l
// columns 8l .. 8l + 7), stored as two 512-byte runs, lane l writing
// columns 4l .. 4l + 3 of each: every 16-byte store of the warp lands in
// one contiguous run (a lane's own two int4 would leave 16-byte holes).
__device__ __forceinline__ void store_run8(int* base, const int (&c)[8],
                                           int lane) {
  const int src = lane >> 1;
  const bool odd = lane & 1;
  int a[4], b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a0 = __shfl_sync(0xffffffffu, c[i], src);
    const int a1 = __shfl_sync(0xffffffffu, c[4 + i], src);
    const int b0 = __shfl_sync(0xffffffffu, c[i], src + 16);
    const int b1 = __shfl_sync(0xffffffffu, c[4 + i], src + 16);
    a[i] = odd ? a1 : a0;
    b[i] = odd ? b1 : b0;
  }
  store4(base + 4 * lane, a[0], a[1], a[2], a[3]);
  store4(base + 128 + 4 * lane, b[0], b[1], b[2], b[3]);
}

__device__ __forceinline__ uint4 load_vec(const void* p) {
  uint4 r;
  asm volatile(
      "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// ---- strided path ---------------------------------------------------------

struct Geometry {
  unsigned size[kMaxRank];            // innermost last; leading dims 1
  long long xs[kMaxRank], ss[kMaxRank], zs[kMaxRank];
};

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
quantize_strided(const T* __restrict__ x, const float* __restrict__ s,
                 const float* __restrict__ z, int* __restrict__ out,
                 Geometry g, unsigned n, float lo, float hi) {
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned base = blockIdx.x * kThreads + threadIdx.x; base < n;
       base += stride * kItems) {
    T xv[kItems];
    float sv[kItems], zv[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned i = base + j * stride;
      if (i >= n) break;
      unsigned rem = i;
      long long xo = 0, so = 0, zo = 0;
#pragma unroll
      for (int d = kMaxRank - 1; d >= kMaxRank - R; --d) {
        const unsigned c = (d == kMaxRank - R) ? rem : rem % g.size[d];
        rem = (d == kMaxRank - R) ? 0 : rem / g.size[d];
        xo += c * g.xs[d];
        so += c * g.ss[d];
        zo += c * g.zs[d];
      }
      xv[j] = x[xo];
      sv[j] = s[so];
      zv[j] = z[zo];
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned i = base + j * stride;
      if (i >= n) break;
      out[i] = code(widen(xv[j]), sv[j], zv[j], lo, hi);
    }
  }
}

// ---- vector paths: (groups, rows, columns), x dense along the columns ----

struct Vec3 {
  int G, R, C;                 // groups, rows, columns
  int xg, xr;                  // x strides of a group and a row
  int sg, sr, sc, zg, zr, zc;  // the scale's and zero point's strides
  int cv;                      // strip: column vectors a row
  int tx, rows;                // strip: threads across column vectors,
                               // rows of a block
  unsigned vectors;            // vectors walked
  int head;                    // flat: elements before the first vector
  unsigned tail, n;            // flat: first element after the last one
};

// strip: block (column tile, row band, group); thread (tx, ty) owns column
// vector blockIdx.x * tx + tx and rows ty, ty + 256 / tx, ... of the band
template <typename T, bool SROW, bool ZROW>
__global__ void __launch_bounds__(kThreads)
quantize_strip(const T* __restrict__ x, const float* __restrict__ s,
               const float* __restrict__ z, int* __restrict__ out, Vec3 g,
               float lo, float hi) {
  constexpr int V = 16 / sizeof(T);
  const int tx = threadIdx.x % g.tx, ty_n = kThreads / g.tx;
  const int cv = blockIdx.x * g.tx + tx;
  const int lane = threadIdx.x & 31;
  // every lane of this warp has a column vector (tx is a multiple of 32)
  const bool whole_warp = cv - lane + 31 < g.cv;
  if (cv >= g.cv) return;      // the last column tile's idle threads
  const int grp = blockIdx.z, c0 = cv * V;
  float sv[V], zv[V];          // the strip's own scales (column-wise)
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (!SROW) sv[j] = __ldg(s + grp * g.sg + (c0 + j) * g.sc);
    if (!ZROW) zv[j] = __ldg(z + grp * g.zg + (c0 + j) * g.zc);
  }
  const T* xb = x + grp * g.xg + c0;
  int* ob = out + grp * g.R * g.C + c0;
  const int r_end = min(g.R, (int)(blockIdx.y + 1) * g.rows);
  const unsigned vbase = (unsigned)grp * g.R;
  for (int r = blockIdx.y * g.rows + threadIdx.x / g.tx; r < r_end;
       r += ty_n * kUnroll) {
    uint4 raw[kUnroll];
    float srow[kUnroll], zrow[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int rr = r + u * ty_n;
      ok[u] = rr < r_end && (vbase + rr) * g.cv + cv < g.vectors;
      if (ok[u]) {
        raw[u] = load_vec(xb + rr * g.xr);
        if (SROW) srow[u] = __ldg(s + grp * g.sg + rr * g.sr);
        if (ZROW) zrow[u] = __ldg(z + grp * g.zg + rr * g.zr);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int c[V];
      if (ok[u]) {
        float f[V];
        unpack(raw[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j)
          c[j] = code(f[j], SROW ? srow[u] : sv[j], ZROW ? zrow[u] : zv[j],
                      lo, hi);
      }
      int* o = ob + (r + u * ty_n) * g.C;
      if (V == 8 && whole_warp && __all_sync(0xffffffffu, ok[u]))
        store_run8(o - lane * V, *reinterpret_cast<const int(*)[8]>(c),
                   lane);
      else if (ok[u])
        store_vec<V>(o, c);
    }
  }
}

// the code of flat element e, placed by two divides
template <typename T>
__device__ __forceinline__ int flat_one(const T* x, const float* s,
                                        const float* z, const Vec3& g,
                                        unsigned e, float lo, float hi) {
  const unsigned q = e / g.C, c = e - q * g.C;
  const unsigned grp = q / g.R, r = q - grp * g.R;
  return code(widen(x[e]), __ldg(s + grp * g.sg + r * g.sr + c * g.sc),
              __ldg(z + grp * g.zg + r * g.zr + c * g.zc), lo, hi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_flat(const T* __restrict__ x, const float* __restrict__ s,
              const float* __restrict__ z, int* __restrict__ out, Vec3 g,
              float lo, float hi) {
  constexpr int V = 16 / sizeof(T);
  const unsigned gtid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned e = gtid; e < (unsigned)g.head; e += stride)
    out[e] = flat_one(x, s, z, g, e, lo, hi);
  for (unsigned e = g.tail + gtid; e < g.n; e += stride)
    out[e] = flat_one(x, s, z, g, e, lo, hi);
  const bool wide = g.head % 4 == 0;   // the codes' int4 stores aligned
  for (unsigned v0 = gtid; v0 < g.vectors; v0 += stride * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * stride;
      if (v < g.vectors) raw[u] = load_vec(x + g.head + v * V);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned v = v0 + u * stride;
      if (v >= g.vectors) continue;
      const unsigned i0 = g.head + v * V;
      unsigned q = i0 / g.C;
      int c = i0 - q * g.C;
      int grp = q / g.R, r = q - grp * g.R;
      int si = grp * g.sg + r * g.sr + c * g.sc;
      int zi = grp * g.zg + r * g.zr + c * g.zc;
      float f[V];
      int cd[V];
      unpack(raw[u], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        cd[j] = code(f[j], __ldg(s + si), __ldg(z + zi), lo, hi);
        if (++c == g.C) {      // the next row (and group)
          c = 0;
          if (++r == g.R) {
            r = 0;
            ++grp;
          }
          si = grp * g.sg + r * g.sr;
          zi = grp * g.zg + r * g.zr;
        } else {
          si += g.sc;
          zi += g.zc;
        }
      }
      if (wide) {
        store_vec<V>(out + i0, cd);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) out[i0 + j] = cd[j];
      }
    }
  }
}

template <typename T>
cudaError_t launch_strided(const void* x, const float* s, const float* z,
                           int* out, int rank, const Geometry& g, unsigned n,
                           float lo, float hi, int blocks, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  switch (rank) {
    case 1:
      quantize_strided<T, 1><<<blocks, kThreads, 0, st>>>(xt, s, z, out, g,
                                                           n, lo, hi);
      break;
    case 2:
      quantize_strided<T, 2><<<blocks, kThreads, 0, st>>>(xt, s, z, out, g,
                                                           n, lo, hi);
      break;
    case 3:
      quantize_strided<T, 3><<<blocks, kThreads, 0, st>>>(xt, s, z, out, g,
                                                           n, lo, hi);
      break;
    default:
      quantize_strided<T, 4><<<blocks, kThreads, 0, st>>>(xt, s, z, out, g,
                                                           n, lo, hi);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vector(int path, const void* x, const float* s,
                          const float* z, int* out, const Vec3& g,
                          dim3 grid, float lo, float hi, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (path == 2) {
    quantize_flat<T><<<grid, kThreads, 0, st>>>(xt, s, z, out, g, lo, hi);
    return cudaGetLastError();
  }
  const bool srow = g.sr != 0, zrow = g.zr != 0;
  if (srow && zrow)
    quantize_strip<T, true, true><<<grid, kThreads, 0, st>>>(xt, s, z, out,
                                                             g, lo, hi);
  else if (srow)
    quantize_strip<T, true, false><<<grid, kThreads, 0, st>>>(xt, s, z, out,
                                                              g, lo, hi);
  else if (zrow)
    quantize_strip<T, false, true><<<grid, kThreads, 0, st>>>(xt, s, z, out,
                                                              g, lo, hi);
  else
    quantize_strip<T, false, false><<<grid, kThreads, 0, st>>>(xt, s, z,
                                                               out, g, lo,
                                                               hi);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. path: 0 strided, 1 strip, 2 flat.
// size/strides: kMaxRank each, outermost first, only the last `rank` used
// (the vector paths read the last three as groups, rows, columns). grid,
// tx, rows, vectors, head, tail: the plan (kernels/quantize/ops.py).
extern "C" int quantize_launch(
    const void* x, int dtype, const float* s, const float* z, int* out,
    int path, int rank, long long n0, long long n1, long long n2,
    long long n3, long long x0, long long x1, long long x2, long long x3,
    long long s0, long long s1, long long s2, long long s3, long long z0,
    long long z1, long long z2, long long z3, long long n, int lo, int hi,
    int gx, int gy, int gz, int tx, int rows, long long vectors,
    long long head, long long tail, void* stream) {
  if (rank < 1 || rank > kMaxRank || n <= 0 || n >= (1LL << 31) ||
      gx <= 0 || gy <= 0 || gz <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float flo = static_cast<float>(lo), fhi = static_cast<float>(hi);
  if (path == 0) {
    Geometry g;
    const long long sz[kMaxRank] = {n0, n1, n2, n3};
    const long long xs[kMaxRank] = {x0, x1, x2, x3};
    const long long ss[kMaxRank] = {s0, s1, s2, s3};
    const long long zs[kMaxRank] = {z0, z1, z2, z3};
    for (int d = 0; d < kMaxRank; ++d) {
      g.size[d] = static_cast<unsigned>(sz[d]);
      g.xs[d] = xs[d];
      g.ss[d] = ss[d];
      g.zs[d] = zs[d];
    }
    const unsigned un = static_cast<unsigned>(n);
    return static_cast<int>(
        dtype == 0 ? launch_strided<float>(x, s, z, out, rank, g, un, flo,
                                           fhi, gx, st)
                   : launch_strided<__nv_bfloat16>(x, s, z, out, rank, g, un,
                                                   flo, fhi, gx, st));
  }
  const int es = dtype == 0 ? 4 : 2, V = 16 / es;
  if ((path != 1 && path != 2) || rank > 3 || n0 != 1 || x3 != 1 ||
      n1 * n2 * n3 != n || vectors < 0 || vectors >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Vec3 g;
  g.G = (int)n1;
  g.R = (int)n2;
  g.C = (int)n3;
  g.xg = (int)x1;
  g.xr = (int)x2;
  g.sg = (int)s1;
  g.sr = (int)s2;
  g.sc = (int)s3;
  g.zg = (int)z1;
  g.zr = (int)z2;
  g.zc = (int)z3;
  g.cv = g.C / V;
  g.tx = tx;
  g.rows = rows;
  g.vectors = (unsigned)vectors;
  g.head = (int)head;
  g.tail = (unsigned)tail;
  g.n = (unsigned)n;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (path == 1) {
    // every vector load and store 16-byte aligned, the grid within the
    // geometry
    if ((xa | reinterpret_cast<uintptr_t>(out)) % 16 || g.C % V ||
        g.xr % V || g.xg % V || (tx != 32 && tx != 64 && tx != 128 &&
                                 tx != 256) || rows <= 0 || gz != g.G ||
        (long long)gx * tx < g.cv || (long long)gy * rows < g.R ||
        vectors > (long long)g.G * g.R * g.cv ||
        (g.sr != 0 && g.sc != 0) || (g.zr != 0 && g.zc != 0))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (head < 0 || head >= V || (xa + head * es) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16 || gy != 1 || gz != 1 ||
        head + vectors * V > tail || tail > n)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(gx, gy, gz);
  const cudaError_t err =
      dtype == 0 ? launch_vector<float>(path, x, s, z, out, g, grid, flo,
                                        fhi, st)
                 : launch_vector<__nv_bfloat16>(path, x, s, z, out, g, grid,
                                                flo, fhi, st);
  return static_cast<int>(err);
}

extern "C" const char* lut_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
