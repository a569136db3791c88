// Batched tiny-SPD Cholesky factor and solves for NVIDIA Hopper (sm_90a).
//
// Replaces the five TPU kernels of hamilton_tpu/ops/pallas_solve.py, which are
// two bodies (_chol_entries :75, _solve_entries :100) combined three ways, with
// an optional accessor that forms K = (sqrt(M) J)^T (sqrt(M) J) on demand
// (_k_at_from_jac :304).  Here:
//   factor_lanes_kernel<T, G, NMAX>      K2b _chol_kernel (:124)       K -> L
//   substitute_lanes_kernel<T, G, NMAX>  K2c _chosolve_kernel (:131)   L, b -> x
//   factor_kernel<T, true>               K2e _jac_chol_kernel (:323)   sqrt(M) J -> L
//   factor_solve_kernel<T, false>        K2a _solve_kernel (:117)      K, b -> x
//   factor_solve_kernel<T, true>         K2d _jac_solve_kernel (:316)  sqrt(M) J, b -> x
// each for float32 and float64, any 1 <= n <= 32 at run time, any batch.
// Operands are member-major and contiguous: K and L (B, n, n), sqrt(M) J
// (B, m, n), b and x (B, n).  L is written with zeros above the diagonal.
//
// Arithmetic: the left-looking Cholesky of _chol_entries and the forward and
// back substitutions of _solve_entries, in the same operation order as the
// plain PyTorch versions beside the wrappers
// (hamilton_tpu_torch/ops/batched_spd.py).  Every multiply, add and subtract
// goes through the round-to-nearest intrinsics, which nvcc never contracts
// into an FMA, and the square root and the reciprocal are correctly rounded
// (the IEEE routines, or in K2b and K2c's float32 their straight-line
// equals of libm_fast.cuh), so a member's result is the plain version's bit
// for bit.  A matrix that is not SPD takes the square root of a negative
// number and gives NaN in that member only, as in the reference.
//
// K2b and K2c (the library leapfrog's, one factor and five solves a step):
// a block stages a tile of members, contiguous in memory, into shared memory
// with cp.async, a warp's reads contiguous and the whole tile in flight at
// once (each member at an odd stride, so that the lanes reading one entry of
// 32 members fall in 32 banks), factors or solves each member, and writes L
// or x back from shared memory with 16-byte stores.  A tile holds as many
// members as the tables below give (kFactorShape, kSubstituteShape, by
// dtype and n: the winners of scripts/k2_sweep.py), fewer where shared
// memory or the batch asks, so that a small batch still spreads over every
// SM.  A member runs on one thread or on G lanes of a warp:
//   - one thread (factor_regs, substitute_regs): the loops over the
//     member's columns unrolled to the largest n of its class, so that its
//     vector, or the row j of L that column j reads, lives in registers and
//     only the entries of L come from shared memory;
//   - G lanes (factor_member, substitute_member): column j of the factor
//     takes the rows j..n-1 in turn on the lanes, each row's sum from k = 0,
//     and the lane with row j hands 1/d to the others by a shuffle; the
//     solve gives row r to lane r mod G, the forward sweep is the plain
//     version's column sweep (each y_i shuffled to the lanes as it is
//     found), and in the back sweep, whose sums run in increasing k so that
//     the term found last comes first, the lanes form the products
//     L[c][i] x_c of their rows i < c as each x_c arrives and row i's owner
//     subtracts them in order.
// At 16384 x 20 one thread a member wins (PERF.md): the member's chain of
// dependent operations sets the time, not the bytes, and lanes lengthen it
// by a shuffle a column.
//
// K2a, K2d and K2e: each thread stages its member's K (copied, or formed
// from sqrt(M) J) in shared memory and factors it there in place, the factor
// entry-major and thread-minor (entry e of thread t at e * blockDim.x + t),
// so a warp's 32 accesses to one entry fall in distinct banks.  Their loads
// of K, sqrt(M) J and L do not coalesce (neighbouring threads are n^2 or m*n
// values apart): they are served through L1 and L2.
//
// What bounds them on this card: by count, bytes (16384 x 20: K2b reads and
// writes 26 MB each way, K2c reads 26 MB; under one operation a byte
// against the card's 20, 67 TFLOP/s over 3.35 TB/s); as measured, the
// latency of each member's chain of ~n^2/2 dependent operations through
// shared memory, with one or a few warps a scheduler to hide it: K2b and
// K2c take the same time on operands that the L2 holds and on operands it
// does not.
//
// Build (no fast-math, so sqrt and division stay IEEE):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libbatched_spd.so batched_spd.cu

#include <cuda_runtime.h>

#include <type_traits>

#include "libm_fast.cuh"

namespace {

constexpr int kMaxN = 32;
// shared memory an SM offers blocks (228 KB), and the per-block reservation
constexpr long long kSmemPerSm = 233472;
constexpr long long kSmemPerBlockMax = 232448;
constexpr long long kSmemReserved = 1024;
constexpr long long kDefaultSmem = 48 * 1024;

// One IEEE operation each, rounded to nearest, never fused.
template <typename T>
struct Ieee;

template <>
struct Ieee<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fadd_rn(a, -b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.0f, a); }
};

template <>
struct Ieee<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dadd_rn(a, -b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double rcp(double a) { return __ddiv_rn(1.0, a); }
};

// A thread's slice of the dynamic shared memory: entry e at base[e * stride].
template <typename T>
struct Scratch {
  T* base;
  int stride;
  __device__ __forceinline__ T& operator[](int e) const { return base[e * stride]; }
};

template <typename T>
__device__ __forceinline__ Scratch<T> scratch(int offset) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  return Scratch<T>{smem + offset * blockDim.x + threadIdx.x, static_cast<int>(blockDim.x)};
}

// packed lower triangle, row-major: (i, j) with j <= i
__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Stage K of one member in the packed triangle `lo`: copied from K (n, n), or
// formed from sqrt(M) J (m, n) as sum_r J[r][i] * J[r][j], accumulated from
// r = 0 (_k_at_from_jac's order).  J is read once, row by row (a member's
// row is contiguous), through the n-entry scratch `row`; reading it entry by
// entry instead, as the TPU kernel's accessor does, costs m*n*(n+1) scattered
// loads a member and made the J kernels 20-30x slower than the K ones.
template <typename T, bool FROM_J>
__device__ void stage_k(const T* __restrict__ src, int n, int m, Scratch<T> lo,
                        Scratch<T> row) {
  using O = Ieee<T>;
  if constexpr (FROM_J) {
    for (int r = 0; r < m; ++r) {
      for (int i = 0; i < n; ++i) row[i] = src[r * n + i];
      for (int i = 0; i < n; ++i) {
        const T ri = row[i];
        for (int j = 0; j <= i; ++j) {
          const T p = O::mul(ri, row[j]);
          lo[tri(i, j)] = r == 0 ? p : O::add(lo[tri(i, j)], p);
        }
      }
    }
  } else {
    for (int i = 0; i < n; ++i)
      for (int j = 0; j <= i; ++j) lo[tri(i, j)] = src[i * n + j];
  }
}

// _chol_entries on the staged K, in place: column by column, each entry's
// sum taken from k = 0 (entry (i, j) of K is read once, just before L[i][j]
// replaces it).  The diagonal slot gets d, or 1/d when the factor only feeds
// the substitutions.
template <typename T, bool STORE_INV>
__device__ void factor(int n, Scratch<T> lo) {
  using O = Ieee<T>;
  for (int j = 0; j < n; ++j) {
    T s = lo[tri(j, j)];
    for (int k = 0; k < j; ++k) {
      const T ljk = lo[tri(j, k)];
      s = O::sub(s, O::mul(ljk, ljk));
    }
    const T d = O::sqrt(s);
    const T inv_d = O::rcp(d);
    lo[tri(j, j)] = STORE_INV ? inv_d : d;
    for (int i = j + 1; i < n; ++i) {
      T e = lo[tri(i, j)];
      for (int k = 0; k < j; ++k) e = O::sub(e, O::mul(lo[tri(i, k)], lo[tri(j, k)]));
      lo[tri(i, j)] = O::mul(e, inv_d);
    }
  }
}

// _solve_entries: L y = b from the top, then L^T x = y from the bottom, each
// sum taken in increasing k.  v holds b on entry and x on exit; l_at(i, j)
// reads L below the diagonal and inv_at(i) its reciprocal diagonal.
template <typename T, typename LAt, typename InvAt>
__device__ void substitute(const LAt& l_at, const InvAt& inv_at, int n, Scratch<T> v) {
  using O = Ieee<T>;
  for (int i = 0; i < n; ++i) {
    T s = v[i];
    for (int k = 0; k < i; ++k) s = O::sub(s, O::mul(l_at(i, k), v[k]));
    v[i] = O::mul(s, inv_at(i));
  }
  for (int i = n - 1; i >= 0; --i) {
    T s = v[i];
    for (int k = i + 1; k < n; ++k) s = O::sub(s, O::mul(l_at(k, i), v[k]));
    v[i] = O::mul(s, inv_at(i));
  }
}

// K2e, one thread a member (launched FROM_J only: K2b is factor_lanes_kernel).
template <typename T, bool FROM_J>
__global__ void factor_kernel(const T* __restrict__ src, T* __restrict__ low,
                              long long batch, int n, int m) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const long long per = FROM_J ? static_cast<long long>(m) * n : static_cast<long long>(n) * n;
  const Scratch<T> lo = scratch<T>(0);
  stage_k<T, FROM_J>(src + b * per, n, m, lo, scratch<T>(n * (n + 1) / 2));
  factor<T, false>(n, lo);
  T* out = low + b * n * n;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) out[i * n + j] = j <= i ? lo[tri(i, j)] : T(0);
}

template <typename T, bool FROM_J>
__global__ void factor_solve_kernel(const T* __restrict__ src, const T* __restrict__ rhs,
                                    T* __restrict__ x, long long batch, int n, int m) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const long long per = FROM_J ? static_cast<long long>(m) * n : static_cast<long long>(n) * n;
  const Scratch<T> lo = scratch<T>(0);
  const Scratch<T> v = scratch<T>(n * (n + 1) / 2);  // J's rows first, then b and x
  stage_k<T, FROM_J>(src + b * per, n, m, lo, v);
  factor<T, true>(n, lo);
  for (int i = 0; i < n; ++i) v[i] = rhs[b * n + i];
  substitute<T>([&](int i, int j) { return lo[tri(i, j)]; },
                [&](int i) { return lo[tri(i, i)]; }, n, v);
  for (int i = 0; i < n; ++i) x[b * n + i] = v[i];
}

// ---------------------------------------------------------------------------
// K2b and K2c: a tile of members a block, one thread or G lanes a member.

// Lanes a member and threads a block (at most: a small batch takes fewer
// members a block) of K2b and K2c, by dtype (float, double) and n (n <= 8,
// n <= 24, n <= 32): the winners of scripts/k2_sweep.py at n = 3, 20 and 32
// on an H100 at B = 16384 (PERF.md).
struct Shape {
  int lanes, threads;
};
constexpr Shape kFactorShape[2][3] = {{{1, 64}, {1, 32}, {4, 32}}, {{1, 64}, {1, 32}, {4, 128}}};
constexpr Shape kSubstituteShape[2][3] = {{{1, 64}, {1, 32}, {1, 64}},
                                          {{1, 64}, {1, 32}, {32, 32}}};
constexpr int kMaxTileThreads = 256;
// rows a thread or lane carries through one pass over a column of the factor
constexpr int kRows = 4;

// A member's class by n (the tables' column), and the largest n of each
constexpr int n_class(int n) { return n <= 8 ? 0 : n <= 24 ? 1 : 2; }
constexpr int kClassMaxN[3] = {8, 24, 32};

// The square root and the reciprocal of K2b and K2c: in float the
// straight-line versions (libm_fast.cuh) where the input is in their range,
// which every member of an SPD batch is, the IEEE routines outside it (a
// member that is not SPD: the square root of a negative number, NaN); in
// double the IEEE routines.
__device__ __forceinline__ float sqrt_rn(float x) {
  return sqrt_fast_range(x) ? sqrt_fast(x) : __fsqrt_rn(x);
}
__device__ __forceinline__ float rcp_rn(float x) {
  return rcp_fast_range(x) ? rcp_fast(x) : __fdiv_rn(1.0f, x);
}
__device__ __forceinline__ double sqrt_rn(double x) { return __dsqrt_rn(x); }
__device__ __forceinline__ double rcp_rn(double x) { return __ddiv_rn(1.0, x); }

// 16 bytes of T, and setting value k of them
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static __device__ __forceinline__ void set(float4& v, int k, float x) {
    if (k == 0) v.x = x;
    else if (k == 1) v.y = x;
    else if (k == 2) v.z = x;
    else v.w = x;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static __device__ __forceinline__ void set(double2& v, int k, double x) {
    if (k == 0) v.x = x;
    else v.y = x;
  }
};

// The values a member's matrix or vector of `values` takes in shared memory:
// an odd number, so that 32 members' copies of one entry fall in 32 banks.
__host__ __device__ constexpr int odd(int values) { return values | 1; }

// Where a tile's values sit in shared memory: value e of the tile (member
// e / per, entry e % per) at e + (e / per) * pad, each member `per + pad`
// values after the last, an odd stride (pad 1 when per is even).  e / per is
// __umulhi(e, magic) with magic = ceil(2^32 / per), exact while e times
// (magic * per - 2^32) stays under 2^32: for every e below 2^16 (a block's
// shared memory holds fewer values) and per <= 1024.
struct TileMap {
  unsigned per, pad, magic;
  __device__ explicit TileMap(int n_per)
      : per(n_per), pad(odd(n_per) - n_per), magic(0xffffffffu / n_per + 1u) {}
  __device__ __forceinline__ unsigned at(unsigned e) const {
    return pad ? e + __umulhi(e, magic) : e;
  }
  __device__ __forceinline__ unsigned stride() const { return per + pad; }
};

// Values before the first 16-byte boundary at p, at most count.
template <typename T>
__device__ __forceinline__ int aligned_head(const T* p, int count) {
  const int skew = static_cast<int>(reinterpret_cast<unsigned long long>(p) & 15);
  const int head = ((16 - skew) & 15) / static_cast<int>(sizeof(T));
  return head < count ? head : count;
}

// One value from global src to shared dst, asynchronously (cp.async; on a
// host build, at once), and the wait for every such copy of this thread.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(to), "l"(src),
               "n"(static_cast<int>(sizeof(T))));
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copy_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Start the copy of the tile's `count` values from global src into shared
// dst (laid out by map), by every thread of the block: value e by thread
// e mod blockDim.x, so a warp reads contiguous memory, and every value of
// the tile in flight at once (no registers hold them).  The block waits with
// copy_async_wait() and __syncthreads().
template <typename T>
__device__ void stage_in(const T* __restrict__ src, int count, TileMap map, T* dst) {
#pragma unroll 4
  for (int e = threadIdx.x; e < count; e += blockDim.x) copy_async(dst + map.at(e), src + e);
}

// The tile's `count` values from shared src (laid out by map) to global dst,
// by every thread of the block: 16-byte stores of the aligned middle.
template <typename T>
__device__ void stage_out(const T* src, int count, TileMap map, T* __restrict__ dst) {
  using V = typename Vec16<T>::type;
  constexpr int kW = 16 / sizeof(T);
  const int head = aligned_head(dst, count);
  const int vecs = (count - head) / kW;
  const int nthreads = blockDim.x;
  for (int e = threadIdx.x; e < head; e += nthreads) dst[e] = src[map.at(e)];
  for (int e = head + vecs * kW + threadIdx.x; e < count; e += nthreads)
    dst[e] = src[map.at(e)];
  V* body = reinterpret_cast<V*>(dst + head);
  for (int v = threadIdx.x; v < vecs; v += nthreads) {
    V out;
#pragma unroll
    for (int k = 0; k < kW; ++k) Vec16<T>::set(out, k, src[map.at(head + v * kW + k)]);
    body[v] = out;
  }
}

// The G lanes of a warp that share a member: this lane's index g among them,
// their mask, a value from one of them, and a barrier among them.
template <int G>
struct Lanes {
  int g;
  unsigned mask;
  __device__ Lanes()
      : g(static_cast<int>(threadIdx.x) & (G - 1)),
        mask(G == 32 ? 0xffffffffu
                     : ((1u << (G % 32)) - 1u) << (threadIdx.x & 31u & ~(G - 1u))) {}
  template <typename T>
  __device__ __forceinline__ T from(T v, int lane) const {
    if constexpr (G == 1) {
      return v;
    } else {
      return __shfl_sync(mask, v, lane, G);
    }
  }
  __device__ __forceinline__ void sync() const {
    if constexpr (G > 1) __syncwarp(mask);
  }
};

// _chol_entries on one member's staged K (n x n, row-major), in place, on G
// lanes: column j's rows j, j + 1, ... go to the lanes in turn, each lane
// carrying kRows of them at a time through the sums over k from 0 (L[j][k]
// read once for them); the lane with row j forms d and 1/d, and hands 1/d
// to the others.  Then zeros above the diagonal.  Every lane of the block
// runs it (a lane of a member past the batch on what its slot holds), so
// that the lanes of a warp meet at every shuffle and barrier.
template <typename T, int G>
__device__ void factor_member(T* a, int n, const Lanes<G>& lanes) {
  using O = Ieee<T>;
  for (int j = 0; j < n; ++j) {
    const T* lj = a + j * n;
    for (int i0 = j + lanes.g; i0 < n; i0 += kRows * G) {
      const T* li[kRows];
      T s[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int i = i0 + u * G < n ? i0 + u * G : n - 1;  // past the end: a row again, unstored
        li[u] = a + i * n;
        s[u] = li[u][j];
      }
#pragma unroll 4
      for (int k = 0; k < j; ++k) {
        const T ljk = lj[k];
#pragma unroll
        for (int u = 0; u < kRows; ++u) s[u] = O::sub(s[u], O::mul(li[u][k], ljk));
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (i0 + u * G < n) a[(i0 + u * G) * n + j] = s[u];
    }
    T inv_d = T(0);
    if (lanes.g == 0) {  // row j is this lane's first
      const T d = sqrt_rn(a[j * n + j]);
      inv_d = rcp_rn(d);
      a[j * n + j] = d;
    }
    inv_d = lanes.from(inv_d, 0);
    for (int i = j + (lanes.g == 0 ? G : lanes.g); i < n; i += G)
      a[i * n + j] = O::mul(a[i * n + j], inv_d);
    lanes.sync();
  }
  for (int i = lanes.g; i < n; i += G)
    for (int k = i + 1; k < n; ++k) a[i * n + k] = T(0);
}

// _solve_entries on one member's staged L (n x n, row-major) and b (v: b on
// entry, x on exit), on G lanes, lane r mod G owning row r.  Forward: y_i =
// v_i / L[i][i] by its owner, shuffled to the lanes, which take L[r][i] y_i
// from their rows r > i.  Back: x_c = (v_c - sum_{k>c} L[k][c] x_k) / L[c][c]
// by its owner, the sum in increasing k from the products L[k][c] x_k that
// the owner formed in L's place as each x_k arrived.  Every lane of the
// block runs it, as factor_member.
template <typename T, int G>
__device__ void substitute_member(T* l, T* v, int n, const Lanes<G>& lanes) {
  using O = Ieee<T>;
  for (int i = 0; i < n; ++i) {
    const int owner = i & (G - 1);
    T y = T(0);
    if (lanes.g == owner) {
      y = O::mul(v[i], rcp_rn(l[i * n + i]));
      v[i] = y;
    }
    y = lanes.from(y, owner);
#pragma unroll 4
    for (int r = i + 1 + ((lanes.g - i - 1) & (G - 1)); r < n; r += G)
      v[r] = O::sub(v[r], O::mul(l[r * n + i], y));
  }
  for (int c = n - 1; c >= 0; --c) {
    const int owner = c & (G - 1);
    T x = T(0);
    if (lanes.g == owner) {
      T s = v[c];
#pragma unroll 4
      for (int k = c + 1; k < n; ++k) s = O::sub(s, l[k * n + c]);
      x = O::mul(s, rcp_rn(l[c * n + c]));
      v[c] = x;
    }
    x = lanes.from(x, owner);
#pragma unroll 4
    for (int i = lanes.g; i < c; i += G) l[c * n + i] = O::mul(l[c * n + i], x);
  }
}

// The one-thread forms (G = 1), templated on the largest n of the member's
// class (NMAX: 8, 24 or 32, kClassMaxN), so that the loops over a member's
// columns unroll and its vectors and row j live in registers.

// _chol_entries on one member's staged K, in place, one thread: column j's
// row j of L read into registers, d and 1/d from its diagonal first, then
// the rows below kRows at a time, each sum from k = 0, stored scaled by 1/d.
template <typename T, int NMAX>
__device__ __forceinline__ void factor_regs(T* a, int n) {
  using O = Ieee<T>;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j >= n) break;
    T lj[NMAX];
#pragma unroll
    for (int k = 0; k < j; ++k) lj[k] = a[j * n + k];
    T s = a[j * n + j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = O::sub(s, O::mul(lj[k], lj[k]));
    const T d = sqrt_rn(s);
    const T inv_d = rcp_rn(d);
    a[j * n + j] = d;
    for (int i0 = j + 1; i0 < n; i0 += kRows) {
      const T* li[kRows];
      T e[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        li[u] = a + (i0 + u < n ? i0 + u : n - 1) * n;  // past the end: a row again, unstored
        e[u] = li[u][j];
      }
#pragma unroll
      for (int k = 0; k < j; ++k) {
#pragma unroll
        for (int u = 0; u < kRows; ++u) e[u] = O::sub(e[u], O::mul(li[u][k], lj[k]));
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (i0 + u < n) a[(i0 + u) * n + j] = O::mul(e[u], inv_d);
    }
  }
  for (int i = 0; i < n; ++i)
    for (int k = i + 1; k < n; ++k) a[i * n + k] = T(0);
}

// _solve_entries on one member's staged L and b (v: b on entry, x on exit),
// one thread, the vector in registers: entries past n run on the last row
// again and are never kept (and never enter a kept entry's sum), so that no
// loop depends on n.
template <typename T, int NMAX>
__device__ __forceinline__ void substitute_regs(const T* l, T* vs, int n) {
  using O = Ieee<T>;
  T v[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) v[i] = vs[i < n ? i : n - 1];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    const int c = i < n ? i : n - 1;
    v[i] = O::mul(v[i], rcp_rn(l[c * n + c]));
#pragma unroll
    for (int r = i + 1; r < NMAX; ++r)
      v[r] = O::sub(v[r], O::mul(l[(r < n ? r : n - 1) * n + c], v[i]));
  }
  // the back sweep reads the forward sweep's entries of L again: from shared
  // memory, not held in registers from there (as registers they spill)
  asm volatile("" ::: "memory");
#pragma unroll
  for (int c = NMAX - 1; c >= 0; --c) {
    const int cc = c < n ? c : n - 1;
    T s = v[c];
#pragma unroll
    for (int k = c + 1; k < NMAX; ++k) {
      const T t = O::sub(s, O::mul(l[(k < n ? k : n - 1) * n + cc], v[k]));
      s = k < n ? t : s;
    }
    v[c] = O::mul(s, rcp_rn(l[cc * n + cc]));
  }
#pragma unroll
  for (int i = 0; i < NMAX; ++i)
    if (i < n) vs[i] = v[i];
}

// K2b: members [blockIdx.x * members, ...) of K (B, n, n) -> L, on G lanes a
// member, or (G = 1) one thread a member with n <= NMAX.
template <typename T, int G, int NMAX>
__global__ void __launch_bounds__(kMaxTileThreads)
    factor_lanes_kernel(const T* __restrict__ k, T* __restrict__ low, long long batch, int n,
                        int members) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const TileMap map(n * n);
  const long long first = static_cast<long long>(blockIdx.x) * members;
  const long long here = batch - first < members ? batch - first : members;
  const int count = static_cast<int>(here) * n * n;
  stage_in(k + first * n * n, count, map, tile);
  copy_async_wait();
  __syncthreads();
  const Lanes<G> lanes;
  if constexpr (G == 1) {
    factor_regs<T, NMAX>(tile + threadIdx.x * map.stride(), n);
  } else {
    factor_member<T, G>(tile + (threadIdx.x / G) * map.stride(), n, lanes);
  }
  __syncthreads();
  stage_out(tile, count, map, low + first * n * n);
}

// K2c: members [blockIdx.x * members, ...) of L (B, n, n) and b (B, n) -> x,
// on G lanes a member, or (G = 1) one thread a member with n <= NMAX.
template <typename T, int G, int NMAX>
__global__ void __launch_bounds__(kMaxTileThreads)
    substitute_lanes_kernel(const T* __restrict__ low, const T* __restrict__ rhs,
                            T* __restrict__ x, long long batch, int n, int members) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileMap lmap(n * n), vmap(n);
  T* ltile = reinterpret_cast<T*>(smem_raw);
  T* vtile = ltile + members * lmap.stride();
  const long long first = static_cast<long long>(blockIdx.x) * members;
  const int here = static_cast<int>(batch - first < members ? batch - first : members);
  stage_in(low + first * n * n, here * n * n, lmap, ltile);
  stage_in(rhs + first * n, here * n, vmap, vtile);
  copy_async_wait();
  __syncthreads();
  const Lanes<G> lanes;
  const int m = threadIdx.x / G;
  if constexpr (G == 1) {
    substitute_regs<T, NMAX>(ltile + m * lmap.stride(), vtile + m * vmap.stride(), n);
  } else {
    substitute_member<T, G>(ltile + m * lmap.stride(), vtile + m * vmap.stride(), n, lanes);
  }
  __syncthreads();
  stage_out(vtile, here * n, vmap, x + first * n);
}

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms > 0 ? sms : 1;
}

// Launch a tile kernel of G lanes a member: `threads` / G members a block,
// fewer where a block's shared memory (member_bytes each) or the batch asks
// (no more than leave every SM a block); the kernel takes the members a
// block as its last argument.
template <int G, typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, int threads, long long member_bytes, long long batch,
                 cudaStream_t stream, Args... args) {
  const long long sms = sm_count();
  long long members = threads / G;
  if (members > kSmemPerBlockMax / member_bytes) members = kSmemPerBlockMax / member_bytes;
  if (members > batch / sms) members = batch / sms;
  if (members < 1) members = 1;
  const long long bytes = members * member_bytes;
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks = static_cast<unsigned int>((batch + members - 1) / members);
  const int tile_threads = static_cast<int>(members) * G;
  const int tile_members = static_cast<int>(members);
  kernel<<<blocks, tile_threads, static_cast<size_t>(bytes), stream>>>(args..., tile_members);
  return static_cast<int>(cudaGetLastError());
}

// Launch K2b or K2c for a member class C of dtype T as its table says: G
// lanes a member (the one-thread kernel of the class's largest n if G = 1)
// and at most the table's threads a block.
template <typename T, int C>
int factor_class(const T* k, T* low, long long batch, int n, cudaStream_t st) {
  constexpr Shape shape = kFactorShape[std::is_same<T, double>::value][C];
  constexpr int nmax = shape.lanes == 1 ? kClassMaxN[C] : 0;
  return launch_tiles<shape.lanes>(factor_lanes_kernel<T, shape.lanes, nmax>, shape.threads,
                                   static_cast<long long>(odd(n * n)) * sizeof(T), batch, st,
                                   k, low, batch, n);
}

template <typename T, int C>
int substitute_class(const T* low, const T* rhs, T* x, long long batch, int n,
                     cudaStream_t st) {
  constexpr Shape shape = kSubstituteShape[std::is_same<T, double>::value][C];
  constexpr int nmax = shape.lanes == 1 ? kClassMaxN[C] : 0;
  return launch_tiles<shape.lanes>(substitute_lanes_kernel<T, shape.lanes, nmax>,
                                   shape.threads,
                                   static_cast<long long>(odd(n * n) + odd(n)) * sizeof(T),
                                   batch, st, low, rhs, x, batch, n);
}

// Threads per block for a kernel holding `per_thread` bytes of shared memory
// per thread: the size (a whole number of warps, at most 256) that keeps the
// most threads resident on an SM, the larger on a tie.
int threads_for(long long per_thread) {
  int best = 32;
  long long best_resident = -1;
  for (int tpb = 256; tpb >= 32; tpb /= 2) {
    const long long bytes = tpb * per_thread;
    if (bytes > kSmemPerBlockMax) continue;
    long long blocks = kSmemPerSm / (bytes + kSmemReserved);
    if (blocks > 2048 / tpb) blocks = 2048 / tpb;
    if (blocks * tpb > best_resident) {
      best_resident = blocks * tpb;
      best = tpb;
    }
  }
  return best;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long per_thread, long long batch, cudaStream_t stream,
           Args... args) {
  const int tpb = threads_for(per_thread);
  const long long bytes = tpb * per_thread;
  if (bytes > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (batch + tpb - 1) / tpb;
  kernel<<<static_cast<unsigned int>(blocks), tpb, static_cast<size_t>(bytes), stream>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(long long batch, int n, int from_j, int m) {
  return batch < 1 || n < 1 || n > kMaxN || (from_j && m < 1);
}

template <typename T>
int factor_t(int from_j, const void* src, void* low, long long batch, int n, int m,
             cudaStream_t st) {
  const T* s = static_cast<const T*>(src);
  T* l = static_cast<T*>(low);
  if (from_j) {
    const long long per = (static_cast<long long>(n) * (n + 1) / 2 + n) * sizeof(T);
    return launch(factor_kernel<T, true>, per, batch, st, s, l, batch, n, m);
  }
  switch (n_class(n)) {
    case 0: return factor_class<T, 0>(s, l, batch, n, st);
    case 1: return factor_class<T, 1>(s, l, batch, n, st);
    default: return factor_class<T, 2>(s, l, batch, n, st);
  }
}

template <typename T>
int factor_solve_t(int from_j, const void* src, const void* rhs, void* x, long long batch,
                   int n, int m, cudaStream_t st) {
  const long long per = (static_cast<long long>(n) * (n + 1) / 2 + n) * sizeof(T);
  const T* s = static_cast<const T*>(src);
  const T* r = static_cast<const T*>(rhs);
  T* out = static_cast<T*>(x);
  return from_j
             ? launch(factor_solve_kernel<T, true>, per, batch, st, s, r, out, batch, n, m)
             : launch(factor_solve_kernel<T, false>, per, batch, st, s, r, out, batch, n, m);
}

template <typename T>
int substitute_t(const void* low, const void* rhs, void* x, long long batch, int n,
                 cudaStream_t st) {
  const T* l = static_cast<const T*>(low);
  const T* r = static_cast<const T*>(rhs);
  T* out = static_cast<T*>(x);
  switch (n_class(n)) {
    case 0: return substitute_class<T, 0>(l, r, out, batch, n, st);
    case 1: return substitute_class<T, 1>(l, r, out, batch, n, st);
    default: return substitute_class<T, 2>(l, r, out, batch, n, st);
  }
}

}  // namespace

extern "C" {

// Each entry launches on the given stream without synchronizing.  dtype_code:
// 0 float32, 1 float64.  Returns 0, -1 for an unknown dtype code, -2 for a
// bad argument, or the CUDA error code of the launch.

// L (B, n, n) from K (B, n, n), or (from_j) from sqrt(M) J (B, m, n).
int hamilton_spd_factor(int dtype_code, int from_j, const void* src, void* low,
                        long long batch, int n, int m, void* stream) {
  if (bad_args(batch, n, from_j, m)) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return factor_t<float>(from_j, src, low, batch, n, m, st);
  if (dtype_code == 1) return factor_t<double>(from_j, src, low, batch, n, m, st);
  return -1;
}

// x (B, n) with L L^T x = b, from a factor L (B, n, n).
int hamilton_spd_substitute(int dtype_code, const void* low, const void* rhs, void* x,
                            long long batch, int n, void* stream) {
  if (bad_args(batch, n, 0, 0)) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return substitute_t<float>(low, rhs, x, batch, n, st);
  if (dtype_code == 1) return substitute_t<double>(low, rhs, x, batch, n, st);
  return -1;
}

// x (B, n) with K x = b, K from K (B, n, n) or (from_j) from sqrt(M) J (B, m, n).
int hamilton_spd_solve(int dtype_code, int from_j, const void* src, const void* rhs,
                       void* x, long long batch, int n, int m, void* stream) {
  if (bad_args(batch, n, from_j, m)) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return factor_solve_t<float>(from_j, src, rhs, x, batch, n, m, st);
  if (dtype_code == 1) return factor_solve_t<double>(from_j, src, rhs, x, batch, n, m, st);
  return -1;
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
