// Batched tiny-SPD Cholesky factor and solves for NVIDIA Hopper (sm_90a).
//
// Replaces the five TPU kernels of hamilton_tpu/ops/pallas_solve.py, which are
// two bodies (_chol_entries :75, _solve_entries :100) combined three ways, with
// an optional accessor that forms K = (sqrt(M) J)^T (sqrt(M) J) on demand
// (_k_at_from_jac :304).  Here:
//   solve_tile_kernel<S, G, NMAX>              K2a _solve_kernel (:117)      K, b -> x
//   factor_lanes_kernel<S, G, NMAX>            K2b _chol_kernel (:124)       K -> L
//   substitute_lanes_kernel<S, G, NMAX>        K2c _chosolve_kernel (:131)   L, b -> x
//   jac_tile_kernel<S, G, F, NMAX, true>       K2d _jac_solve_kernel (:316)  sqrt(M) J, b -> x
//   jac_tile_kernel<S, G, F, NMAX, false>      K2e _jac_chol_kernel (:323)   sqrt(M) J -> L
// each for float32, float64 and bfloat16, any 1 <= n <= 32 at run time, any
// batch.
// Operands are member-major and contiguous: K and L (B, n, n), sqrt(M) J
// (B, m, n), b and x (B, n).  L is written with zeros above the diagonal.
//
// Arithmetic: the left-looking Cholesky of _chol_entries and the forward and
// back substitutions of _solve_entries, in the same operation order as the
// plain PyTorch versions beside the wrappers
// (hamilton_tpu_torch/ops/batched_spd.py), and K's entries as sums over the
// rows r of sqrt(M) J from r = 0 (_k_from_jac).  Every multiply, add and
// subtract goes through the round-to-nearest intrinsics, which nvcc never
// contracts into an FMA (no tensor cores either: they would round JᵀJ in
// another order), and the square root and the reciprocal are correctly
// rounded (in float the straight-line equals of libm_fast.cuh), so a
// member's result is the plain version's bit for bit.  A matrix that is not
// SPD takes the square root of a negative number (or divides by a zero
// diagonal) and gives NaN in that member only, as in the reference.
//
// One design for all five: a block takes a tile of members, contiguous in
// memory, and stages their operands into shared memory with cp.async, a
// warp's reads contiguous and every copy in flight at once (each member at
// an odd stride, so that the lanes reading one entry of 32 members fall in
// 32 banks); it factors or solves each member there and writes L or x back
// from shared memory with 16-byte stores.  A tile holds as many members as
// the tables below give (kSolveShape, kFactorShape, kSubstituteShape,
// kJacSolveShape, kJacFactorShape, by dtype and n: the winners of
// scripts/k2_sweep.py), fewer
// where shared memory or the batch asks, so that a small batch still
// spreads over every SM.  A member's factor and solve run on one thread or
// on G lanes of a warp:
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
// K2a factors and solves in one launch: L never leaves shared memory, and
// the factor leaves 1/d on the diagonal for the solve (a division a column
// where K2c, which reads L, takes two).
// K2d and K2e stream sqrt(M) J through two buffers of a few rows a member
// (chunk c + 1 in flight while chunk c's products run) and form K's lower
// triangle on G lanes a member: lane g holds the sums of the entries (i, j)
// with j = g mod G in registers (JacSums), reads row i's value once for the
// member's lanes (a broadcast) and holds its own columns' values for the
// row.  K is then written once into the member's slot where the buffers
// were, factored there on one thread or on the same G lanes, and solved
// (K2d) or written out (K2e).
//
// What bounds them on this card: by count, bytes (16384 x 20: K2b reads and
// writes 26 MB each way, K2d in float64 reads 105 MB of sqrt(M) J; under
// one operation a byte against the card's 20, 67 TFLOP/s over 3.35 TB/s);
// as measured, the latency of each member's chain of ~n^2/2 dependent
// operations through shared memory, with a few warps a scheduler to hide
// it: every K2 kernel takes the same time on operands that the L2 holds and
// on four sets that it does not, and K2a in float64 takes about K2b's and
// K2c's times together (0.104 ms against 0.070 + 0.044 on an H100 80GB
// HBM3 at 700 W, PERF.md).
//
// bfloat16 is a storage type only (the reference's kernels take bf16
// operands, pallas_solve.py:252): a tile's bf16 values are read as they lie
// in global memory, 16 bytes at a time (a member of n = 3 is 18 bytes, so a
// tile starts anywhere within a 16-byte line: the reads take the lines that
// hold the tile, and the first value's place in the first line is the
// shift), widened to float32 into the member slots the float32 kernel uses,
// factored and solved there by the float32 member chain unchanged, and each
// result rounded to bf16 once, at the store.  So a bf16 entry is its float32
// plain version on the widened operands, rounded to nearest even: bit for
// bit.  K2d and K2e stage a tile's whole sqrt(M) J with cp.async where its K
// slots are (no chunks) and form K from the bf16 values as they read them.
//
// Build (no fast-math, so sqrt and division stay IEEE):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libbatched_spd.so batched_spd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>
#include <type_traits>

#include "libm_fast.cuh"

namespace {

constexpr int kMaxN = 32;
// shared memory a block can take
constexpr long long kSmemPerBlockMax = 232448;
constexpr long long kDefaultSmem = 48 * 1024;

// One IEEE operation each, rounded to nearest, never fused.
template <typename T>
struct Ieee;

template <>
struct Ieee<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fadd_rn(a, -b); }
};

template <>
struct Ieee<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dadd_rn(a, -b); }
};

// The type a stored value S is computed in: float and double in themselves,
// bfloat16 in float.  widen reads a stored value exactly; narrow rounds a
// result to S once (to nearest even).
template <typename S>
struct Compute {
  using type = S;
};
template <>
struct Compute<__nv_bfloat16> {
  using type = float;
};
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename S>
__device__ __forceinline__ S narrow(typename Compute<S>::type x) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

// ---------------------------------------------------------------------------
// Tiles of members a block, one thread or G lanes a member.

// Lanes a member and threads a block (at most: a small batch takes fewer
// members a block) of K2a, K2b and K2c, by dtype (float, double) and n
// (n <= 8, n <= 24, n <= 32): the winners of scripts/k2_sweep.py at n = 3, 20
// and 32 on an H100 at B = 16384 (PERF.md).
struct Shape {
  int lanes, threads;
};
constexpr Shape kSolveShape[2][3] = {{{1, 64}, {1, 32}, {4, 32}}, {{1, 64}, {8, 32}, {8, 256}}};
constexpr Shape kFactorShape[2][3] = {{{1, 64}, {1, 32}, {4, 32}}, {{1, 64}, {1, 32}, {4, 128}}};
constexpr Shape kSubstituteShape[2][3] = {{{1, 64}, {1, 32}, {1, 64}},
                                          {{1, 64}, {1, 32}, {32, 32}}};
// K2d's (kJacSolveShape) and K2e's (kJacFactorShape): lanes a member that
// form K, lanes that factor (and solve) it (1: one thread, or the same
// lanes), threads a block; the sweep's winners at n = 3, 20 and 32 with
// m = n and 2n.  A class's lanes keep a lane's sums within kMaxJacSums.
struct JacShape {
  int lanes, factor_lanes, threads;
};
constexpr JacShape kJacSolveShape[2][3] = {{{1, 1, 64}, {4, 4, 32}, {8, 8, 32}},
                                           {{1, 1, 64}, {4, 4, 32}, {8, 8, 256}}};
constexpr JacShape kJacFactorShape[2][3] = {{{1, 1, 64}, {4, 1, 256}, {8, 8, 32}},
                                            {{1, 1, 64}, {8, 1, 128}, {8, 8, 256}}};
constexpr int kMaxJacSums = 96;
// values of sqrt(M) J a member's chunk of rows holds (at least one row)
constexpr int kChunkValues = 128;
constexpr int kMaxTileThreads = 256;
// rows a thread or lane carries through one pass over a column of the factor
constexpr int kRows = 4;

// A member's class by n (the tables' column), and the largest n of each
constexpr int n_class(int n) { return n <= 8 ? 0 : n <= 24 ? 1 : 2; }
constexpr int kClassMaxN[3] = {8, 24, 32};

// The square root and the reciprocal of every K2 kernel: in float the
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
template <>
struct Vec16<__nv_bfloat16> {
  using type = uint4;
  static __device__ __forceinline__ void set(uint4& v, int k, __nv_bfloat16 x) {
    const unsigned bits = __bfloat16_as_ushort(x);
    unsigned& w = k < 2 ? v.x : k < 4 ? v.y : k < 6 ? v.z : v.w;
    w = (k & 1) ? ((w & 0xffffu) | (bits << 16)) : ((w & 0xffff0000u) | bits);
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
  // the member of value e (magic wraps to 0 for per = 1)
  __device__ __forceinline__ unsigned member(unsigned e) const {
    return per == 1 ? e : __umulhi(e, magic);
  }
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
// Close this thread's group of copies, and wait until at most N of its
// groups are still in flight.
__device__ __forceinline__ void copy_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void copy_async_wait_groups() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Start the copy of a chunk of `map.per` values from each of the tile's
// `here` members, member t's at src + t * src_stride in global memory, into
// shared dst laid out by map: value e of the chunk by thread e mod
// blockDim.x, so that a warp reads contiguous memory within a member.
template <typename T>
__device__ void stage_chunk_in(const T* __restrict__ src, long long src_stride, int here,
                               TileMap map, T* dst) {
  const int count = here * static_cast<int>(map.per);
#pragma unroll 4
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const unsigned t = map.member(e);
    copy_async(dst + e + t * map.pad, src + t * src_stride + (e - t * map.per));
  }
}

// The tile's `count` values from shared src (laid out by map) to global dst,
// by every thread of the block, each rounded to dst's type (narrow): 16-byte
// stores of the aligned middle.
template <typename S, typename T>
__device__ void stage_out(const T* src, int count, TileMap map, S* __restrict__ dst) {
  using V = typename Vec16<S>::type;
  constexpr int kW = 16 / sizeof(S);
  const int head = aligned_head(dst, count);
  const int vecs = (count - head) / kW;
  const int nthreads = blockDim.x;
  for (int e = threadIdx.x; e < head; e += nthreads) dst[e] = narrow<S>(src[map.at(e)]);
  for (int e = head + vecs * kW + threadIdx.x; e < count; e += nthreads)
    dst[e] = narrow<S>(src[map.at(e)]);
  V* body = reinterpret_cast<V*>(dst + head);
  for (int v = threadIdx.x; v < vecs; v += nthreads) {
    V out{};
#pragma unroll
    for (int k = 0; k < kW; ++k)
      Vec16<S>::set(out, k, narrow<S>(src[map.at(head + v * kW + k)]));
    body[v] = out;
  }
}

// bfloat16 staging.  K, L and the vectors are widened on their way in:
// each thread reads whole 16-byte lines of the tile (8 values, from the line
// that holds the tile's first value: a tile of n = 3 members starts anywhere
// within a line) and writes each value of the tile, widened, to its member
// slot, so a bf16 tile takes the float32 kernel's shared memory and no more
// (a staging buffer beside the slots halved the blocks an SM).  A line is
// never split between two allocations, so its bytes beyond the tile are the
// allocation's.
template <typename S, typename T>
__device__ void widen_in(const S* __restrict__ src, int count, TileMap map, T* dst) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(S));
  // lines a thread has in flight at once: all read before any is written
  constexpr int kBatch = 8;
  const unsigned long long at = reinterpret_cast<unsigned long long>(src);
  const uint4* line = reinterpret_cast<const uint4*>(at & ~15ULL);
  const int shift = static_cast<int>((at & 15) / sizeof(S));
  const int lines = (shift + count + kPer - 1) / kPer;
  const int stride = blockDim.x;
  for (int c0 = threadIdx.x; c0 < lines; c0 += kBatch * stride) {
    uint4 bits[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (c0 + u * stride < lines) bits[u] = __ldg(line + c0 + u * stride);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * stride;
      if (c >= lines) break;
      S vals[kPer];
      memcpy(vals, &bits[u], 16);
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = c * kPer + k - shift;
        if (e >= 0 && e < count) dst[map.at(e)] = widen(vals[k]);
      }
    }
  }
}

// Shared memory rounded up to 16 bytes; and the slack a bf16 sqrt(M) J
// staging (stage_raw) takes beyond its values: a late start within a line,
// and the lines' ends.
__host__ __device__ constexpr long long align16(long long bytes) { return (bytes + 15) & ~15LL; }
constexpr long long kRawSlack = 64;

// One 16-byte line from global src to shared dst, asynchronously (on a host
// build, at once).
__device__ __forceinline__ void copy_line_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to), "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}

// Start the copy of the 16-byte lines of global memory that hold `count`
// values from src into raw (16-byte aligned shared memory), by every thread
// of the block, all in flight at once; returns where src's first value lands
// in raw (the shift, in values).
template <typename S>
__device__ int stage_raw(const S* __restrict__ src, int count, unsigned char* raw) {
  const unsigned long long at = reinterpret_cast<unsigned long long>(src);
  const unsigned char* line = reinterpret_cast<const unsigned char*>(at & ~15ULL);
  const int shift = static_cast<int>((at & 15) / sizeof(S));
  const int lines = static_cast<int>(((shift + count) * sizeof(S) + 15) / 16);
  for (int c = threadIdx.x; c < lines; c += blockDim.x) copy_line_async(raw + 16 * c, line + 16 * c);
  return shift;
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
// to the others.  Then zeros above the diagonal; or, where only the solve
// reads the factor (FOR_SOLVE), 1/d on the diagonal in d's place and no
// zeros.  Every lane of the block runs it (a lane of a member past the batch
// on what its slot holds), so that the lanes of a warp meet at every
// shuffle and barrier.
template <typename T, int G, bool FOR_SOLVE = false>
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
      a[j * n + j] = FOR_SOLVE ? inv_d : d;
    }
    inv_d = lanes.from(inv_d, 0);
    for (int i = j + (lanes.g == 0 ? G : lanes.g); i < n; i += G)
      a[i * n + j] = O::mul(a[i * n + j], inv_d);
    lanes.sync();
  }
  if constexpr (!FOR_SOLVE)
    for (int i = lanes.g; i < n; i += G)
      for (int k = i + 1; k < n; ++k) a[i * n + k] = T(0);
}

// _solve_entries on one member's staged L (n x n, row-major) and b (v: b on
// entry, x on exit), on G lanes, lane r mod G owning row r.  Forward: y_i =
// v_i / L[i][i] by its owner, shuffled to the lanes, which take L[r][i] y_i
// from their rows r > i.  Back: x_c = (v_c - sum_{k>c} L[k][c] x_k) / L[c][c]
// by its owner, the sum in increasing k from the products L[k][c] x_k that
// the owner formed in L's place as each x_k arrived.  With INV the
// diagonal holds 1/L[i][i] (factor_member's FOR_SOLVE).  Every lane of the
// block runs it, as factor_member.
template <typename T, int G, bool INV = false>
__device__ void substitute_member(T* l, T* v, int n, const Lanes<G>& lanes) {
  using O = Ieee<T>;
  const auto inv = [&](int i) { return INV ? l[i * n + i] : rcp_rn(l[i * n + i]); };
  for (int i = 0; i < n; ++i) {
    const int owner = i & (G - 1);
    T y = T(0);
    if (lanes.g == owner) {
      y = O::mul(v[i], inv(i));
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
      x = O::mul(s, inv(c));
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
// the rows below kRows at a time, each sum from k = 0, stored scaled by 1/d;
// then zeros above the diagonal, or (FOR_SOLVE) 1/d in d's place and no
// zeros, as factor_member.
template <typename T, int NMAX, bool FOR_SOLVE = false>
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
    a[j * n + j] = FOR_SOLVE ? inv_d : d;
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
  if constexpr (!FOR_SOLVE)
    for (int i = 0; i < n; ++i)
      for (int k = i + 1; k < n; ++k) a[i * n + k] = T(0);
}

// _solve_entries on one member's staged L and b (v: b on entry, x on exit),
// one thread, the vector in registers: entries past n run on the last row
// again and are never kept (and never enter a kept entry's sum), so that no
// loop depends on n.  With INV the diagonal holds 1/L[i][i].
template <typename T, int NMAX, bool INV = false>
__device__ __forceinline__ void substitute_regs(const T* l, T* vs, int n) {
  using O = Ieee<T>;
  const auto inv = [&](int i) { return INV ? l[i * n + i] : rcp_rn(l[i * n + i]); };
  T v[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) v[i] = vs[i < n ? i : n - 1];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    const int c = i < n ? i : n - 1;
    v[i] = O::mul(v[i], inv(c));
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
    v[c] = O::mul(s, inv(cc));
  }
#pragma unroll
  for (int i = 0; i < NMAX; ++i)
    if (i < n) vs[i] = v[i];
}

// K2b: members [blockIdx.x * members, ...) of K (B, n, n) -> L, on G lanes a
// member, or (G = 1) one thread a member with n <= NMAX; S the stored type.
template <typename S, int G, int NMAX>
__global__ void __launch_bounds__(kMaxTileThreads)
    factor_lanes_kernel(const S* __restrict__ k, S* __restrict__ low, long long batch, int n,
                        int members) {
  using T = typename Compute<S>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const TileMap map(n * n);
  const long long first = static_cast<long long>(blockIdx.x) * members;
  const long long here = batch - first < members ? batch - first : members;
  const int count = static_cast<int>(here) * n * n;
  if constexpr (std::is_same<S, T>::value) {
    stage_in(k + first * n * n, count, map, tile);
    copy_async_wait();
  } else {
    widen_in(k + first * n * n, count, map, tile);
  }
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

// The operands of K2a and K2c in shared memory: the matrices (K or L) at a,
// the vectors at v, each staged (S = T) or widened (bf16) into its member
// slots.
template <typename S, typename T>
__device__ void stage_pair(const S* mats, const S* vecs, int here, TileMap mmap, TileMap vmap,
                           T* a, T* v) {
  const int n = static_cast<int>(vmap.per);
  if constexpr (std::is_same<S, T>::value) {
    stage_in(mats, here * n * n, mmap, a);
    stage_in(vecs, here * n, vmap, v);
    copy_async_wait();
  } else {
    widen_in(mats, here * n * n, mmap, a);
    widen_in(vecs, here * n, vmap, v);
  }
  __syncthreads();
}

// K2c: members [blockIdx.x * members, ...) of L (B, n, n) and b (B, n) -> x,
// on G lanes a member, or (G = 1) one thread a member with n <= NMAX.
template <typename S, int G, int NMAX>
__global__ void __launch_bounds__(kMaxTileThreads)
    substitute_lanes_kernel(const S* __restrict__ low, const S* __restrict__ rhs,
                            S* __restrict__ x, long long batch, int n, int members) {
  using T = typename Compute<S>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileMap lmap(n * n), vmap(n);
  T* ltile = reinterpret_cast<T*>(smem_raw);
  T* vtile = ltile + members * lmap.stride();
  const long long first = static_cast<long long>(blockIdx.x) * members;
  const int here = static_cast<int>(batch - first < members ? batch - first : members);
  stage_pair(low + first * n * n, rhs + first * n, here, lmap, vmap, ltile, vtile);
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

// K2a: members [blockIdx.x * members, ...) of K (B, n, n) and b (B, n) -> x,
// factored and solved in place, on G lanes a member, or (G = 1) one thread a
// member with n <= NMAX.
template <typename S, int G, int NMAX>
__global__ void __launch_bounds__(kMaxTileThreads)
    solve_tile_kernel(const S* __restrict__ k, const S* __restrict__ rhs, S* __restrict__ x,
                      long long batch, int n, int members) {
  using T = typename Compute<S>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileMap kmap(n * n), vmap(n);
  T* ktile = reinterpret_cast<T*>(smem_raw);
  T* vtile = ktile + members * kmap.stride();
  const long long first = static_cast<long long>(blockIdx.x) * members;
  const int here = static_cast<int>(batch - first < members ? batch - first : members);
  stage_pair(k + first * n * n, rhs + first * n, here, kmap, vmap, ktile, vtile);
  const Lanes<G> lanes;
  T* a = ktile + (threadIdx.x / G) * kmap.stride();
  T* v = vtile + (threadIdx.x / G) * vmap.stride();
  if constexpr (G == 1) {
    factor_regs<T, NMAX, true>(a, n);
    substitute_regs<T, NMAX, true>(a, v, n);
  } else {
    factor_member<T, G, true>(a, n, lanes);
    substitute_member<T, G, true>(a, v, n, lanes);
  }
  __syncthreads();
  stage_out(vtile, here * n, vmap, x + first * n);
}

// The sums of K = (sqrt(M) J)^T (sqrt(M) J) that lane g of a member's G holds
// in registers: the lower triangle's entries (i, j) with j = g + c G, c <
// kCols, slot by slot in order of i, then c (row i has a slot c where c G <= i,
// used by the lanes with g + c G <= i), for n <= NMAX.  Each sum runs over
// the rows r of sqrt(M) J from r = 0 as _k_from_jac's: the product
// J[r][i] J[r][j] rounded, then the sum; from -0, which adds to the first
// product exactly.
__host__ __device__ constexpr int jac_sums(int nmax, int lanes) {
  int s = 0;
  for (int i = 0; i < nmax; ++i) s += i / lanes + 1;
  return s;
}

template <typename T, int G, int NMAX>
struct JacSums {
  static constexpr int kCols = (NMAX + G - 1) / G;
  static constexpr int kCount = jac_sums(NMAX, G);
  static_assert(kCount <= kMaxJacSums, "too many sums a lane: more lanes for this class");
  T acc[kCount];

  __device__ JacSums() {
#pragma unroll
    for (int s = 0; s < kCount; ++s) acc[s] = T(-0.0);
  }

  // Add the products of `rows` rows of one member's sqrt(M) J (row r at
  // j + r * n in shared memory), each value widened from its stored type.
  template <typename S>
  __device__ __forceinline__ void add_rows(const S* j, int rows, int n, int g) {
    using O = Ieee<T>;
    for (int r = 0; r < rows; ++r, j += n) {
      T mine[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) mine[c] = g + c * G < n ? widen(j[g + c * G]) : T(0);
      int s = 0;
#pragma unroll
      for (int i = 0; i < NMAX; ++i) {
        if (i >= n) break;
        T ji;
        if constexpr (G == 1) {
          ji = mine[i];
        } else {
          ji = widen(j[i]);
        }
#pragma unroll
        for (int c = 0; c <= i / G; ++c, ++s)
          if (g + c * G <= i) acc[s] = O::add(acc[s], O::mul(ji, mine[c]));
      }
    }
  }

  // K's lower triangle into a member's slot (n x n, row-major).
  __device__ __forceinline__ void store(T* a, int n, int g) const {
    int s = 0;
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      if (i >= n) break;
#pragma unroll
      for (int c = 0; c <= i / G; ++c, ++s)
        if (g + c * G <= i) a[i * n + g + c * G] = acc[s];
    }
  }
};

// K2d (SOLVE) and K2e: members [blockIdx.x * members, ...) of sqrt(M) J
// (B, m, n) and b (B, n) -> x, or -> L.  The rows of sqrt(M) J pass through
// two buffers, `rows` rows a member at a time, chunk c + 1's copy in flight
// while G lanes a member add chunk c's products to their sums; K is written
// into the member's slot (over the buffers), then factored and solved on
// one thread a member with n <= NMAX (F = 1) or on the G lanes (F = G).
// bf16 (S != T): the tile's whole sqrt(M) J staged at once where the K
// slots are (K is written after every product is read), K formed from the
// staged values; b widened into its slots.
template <typename S, int G, int F, int NMAX, bool SOLVE>
__global__ void __launch_bounds__(kMaxTileThreads)
    jac_tile_kernel(const S* __restrict__ js, const S* __restrict__ rhs, S* __restrict__ out,
                    long long batch, int n, int m, int rows, int members) {
  static_assert(F == 1 || F == G, "the factor runs on one thread or on the formation's lanes");
  using T = typename Compute<S>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TileMap kmap(n * n), vmap(n), cmap(rows * n);
  T* vtile = reinterpret_cast<T*>(smem_raw);  // b and x (SOLVE)
  T* ktile = vtile + (SOLVE ? members * vmap.stride() : 0);
  const long long first = static_cast<long long>(blockIdx.x) * members;
  const int here = static_cast<int>(batch - first < members ? batch - first : members);
  const long long per = static_cast<long long>(m) * n;
  const S* src = js + first * per;
  const Lanes<G> lanes;
  const int t = threadIdx.x / G;
  JacSums<T, G, NMAX> sums;
  if constexpr (std::is_same<S, T>::value) {
    const int buffer = members * cmap.stride();  // chunk c at ktile + (c & 1) * buffer
    if constexpr (SOLVE) stage_in(rhs + first * n, here * n, vmap, vtile);
    stage_chunk_in(src, per, here, cmap, ktile);
    copy_async_commit();
    for (int r0 = 0, c = 0; r0 < m; r0 += rows, ++c) {
      const int next = m - r0 - rows < rows ? m - r0 - rows : rows;
      if (next > 0) {
        stage_chunk_in(src + (r0 + rows) * n, per, here, TileMap(next * n),
                       ktile + ((c + 1) & 1) * buffer);
        copy_async_commit();
        copy_async_wait_groups<1>();
      } else {
        copy_async_wait_groups<0>();
      }
      __syncthreads();
      const int count = m - r0 < rows ? m - r0 : rows;
      sums.add_rows(ktile + (c & 1) * buffer + t * odd(count * n), count, n, lanes.g);
      __syncthreads();
    }
  } else {
    // the staging spans every member's values (a lane of a member past the
    // batch reads what its part holds, unstored)
    unsigned char* raw_j = smem_raw + align16((SOLVE ? members * vmap.stride() : 0) * sizeof(T));
    const int shift_j = stage_raw(src, static_cast<int>(here * per), raw_j);
    if constexpr (SOLVE) widen_in(rhs + first * n, here * n, vmap, vtile);
    copy_async_wait();
    __syncthreads();
    sums.add_rows(reinterpret_cast<const S*>(raw_j) + shift_j + t * per, m, n, lanes.g);
    __syncthreads();
  }
  sums.store(ktile + t * kmap.stride(), n, lanes.g);
  __syncthreads();
  if constexpr (F == 1) {
    if (threadIdx.x < members) {
      T* a = ktile + threadIdx.x * kmap.stride();
      factor_regs<T, NMAX, SOLVE>(a, n);
      if constexpr (SOLVE)
        substitute_regs<T, NMAX, true>(a, vtile + threadIdx.x * vmap.stride(), n);
    }
  } else {
    T* a = ktile + t * kmap.stride();
    factor_member<T, G, SOLVE>(a, n, lanes);
    if constexpr (SOLVE) substitute_member<T, G, true>(a, vtile + t * vmap.stride(), n, lanes);
  }
  __syncthreads();
  if constexpr (SOLVE) {
    stage_out(vtile, here * n, vmap, out + first * n);
  } else {
    stage_out(ktile, here * n * n, kmap, out + first * n * n);
  }
}

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms > 0 ? sms : 1;
}

// Launch a tile kernel of G lanes a member: `threads` / G members a block,
// fewer where a block's shared memory (member_bytes each, and `extra` a
// block) or the batch asks (no more than leave every SM a block); the kernel
// takes the members a block as its last argument.
template <int G, typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, int threads, long long member_bytes, long long extra,
                 long long batch, cudaStream_t stream, Args... args) {
  const long long sms = sm_count();
  long long members = threads / G;
  if (members > (kSmemPerBlockMax - extra) / member_bytes)
    members = (kSmemPerBlockMax - extra) / member_bytes;
  if (members > batch / sms) members = batch / sms;
  if (members < 1) members = 1;
  const long long bytes = members * member_bytes + extra;
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

// A member's bytes of shared memory: `values` slots of its compute type.
template <typename S>
constexpr long long slot_bytes(long long values) {
  return values * static_cast<long long>(sizeof(typename Compute<S>::type));
}

// The tables' row of a stored type: float's for float and bf16.
template <typename S>
constexpr int table_row() {
  return std::is_same<typename Compute<S>::type, double>::value;
}

// Launch K2b or K2c for a member class C of stored type S as its table says:
// G lanes a member (the one-thread kernel of the class's largest n if G = 1)
// and at most the table's threads a block.
template <typename S, int C>
int factor_class(const S* k, S* low, long long batch, int n, cudaStream_t st) {
  constexpr Shape shape = kFactorShape[table_row<S>()][C];
  constexpr int nmax = shape.lanes == 1 ? kClassMaxN[C] : 0;
  return launch_tiles<shape.lanes>(factor_lanes_kernel<S, shape.lanes, nmax>, shape.threads,
                                   slot_bytes<S>(odd(n * n)), 0, batch, st, k, low, batch, n);
}

template <typename S, int C>
int substitute_class(const S* low, const S* rhs, S* x, long long batch, int n,
                     cudaStream_t st) {
  constexpr Shape shape = kSubstituteShape[table_row<S>()][C];
  constexpr int nmax = shape.lanes == 1 ? kClassMaxN[C] : 0;
  return launch_tiles<shape.lanes>(substitute_lanes_kernel<S, shape.lanes, nmax>,
                                   shape.threads,
                                   slot_bytes<S>(odd(n * n) + odd(n)), 0, batch, st, low, rhs,
                                   x, batch, n);
}

template <typename S, int C>
int solve_class(const S* k, const S* rhs, S* x, long long batch, int n, cudaStream_t st) {
  constexpr Shape shape = kSolveShape[table_row<S>()][C];
  constexpr int nmax = shape.lanes == 1 ? kClassMaxN[C] : 0;
  return launch_tiles<shape.lanes>(solve_tile_kernel<S, shape.lanes, nmax>, shape.threads,
                                   slot_bytes<S>(odd(n * n) + odd(n)), 0, batch, st, k, rhs, x,
                                   batch, n);
}

// K2d (SOLVE) or K2e for a member class C of stored type S, as its table
// says: a member's slot holds K, or first its two buffers of `rows` rows of
// sqrt(M) J, and (SOLVE) b; in bf16 its K slot or its m rows of sqrt(M) J
// staged there, whichever is larger, and (SOLVE) b.
template <typename S, int C, bool SOLVE>
int jac_class(const S* js, const S* rhs, S* out, long long batch, int n, int m,
              cudaStream_t st) {
  constexpr JacShape shape = (SOLVE ? kJacSolveShape : kJacFactorShape)[table_row<S>()][C];
  constexpr bool kStaged = !std::is_same<S, typename Compute<S>::type>::value;
  int rows = kChunkValues / n;
  rows = rows < 1 ? 1 : rows > m ? m : rows;
  const long long k_bytes = slot_bytes<S>(odd(n * n));
  const long long j_bytes = kStaged ? static_cast<long long>(m) * n * sizeof(S)
                                    : slot_bytes<S>(2LL * odd(rows * n));
  const long long member_bytes =
      (k_bytes > j_bytes ? k_bytes : j_bytes) + (SOLVE ? slot_bytes<S>(odd(n)) : 0);
  return launch_tiles<shape.lanes>(
      jac_tile_kernel<S, shape.lanes, shape.factor_lanes, kClassMaxN[C], SOLVE>, shape.threads,
      member_bytes, kStaged ? kRawSlack : 0, batch, st, js, rhs, out, batch, n, m, rows);
}

bool bad_args(long long batch, int n, int from_j, int m) {
  return batch < 1 || n < 1 || n > kMaxN || (from_j && m < 1);
}

template <typename S>
int factor_t(int from_j, const void* src, void* low, long long batch, int n, int m,
             cudaStream_t st) {
  const S* s = static_cast<const S*>(src);
  S* l = static_cast<S*>(low);
  if (from_j) {
    switch (n_class(n)) {
      case 0: return jac_class<S, 0, false>(s, nullptr, l, batch, n, m, st);
      case 1: return jac_class<S, 1, false>(s, nullptr, l, batch, n, m, st);
      default: return jac_class<S, 2, false>(s, nullptr, l, batch, n, m, st);
    }
  }
  switch (n_class(n)) {
    case 0: return factor_class<S, 0>(s, l, batch, n, st);
    case 1: return factor_class<S, 1>(s, l, batch, n, st);
    default: return factor_class<S, 2>(s, l, batch, n, st);
  }
}

template <typename S>
int factor_solve_t(int from_j, const void* src, const void* rhs, void* x, long long batch,
                   int n, int m, cudaStream_t st) {
  const S* s = static_cast<const S*>(src);
  const S* r = static_cast<const S*>(rhs);
  S* out = static_cast<S*>(x);
  if (from_j) {
    switch (n_class(n)) {
      case 0: return jac_class<S, 0, true>(s, r, out, batch, n, m, st);
      case 1: return jac_class<S, 1, true>(s, r, out, batch, n, m, st);
      default: return jac_class<S, 2, true>(s, r, out, batch, n, m, st);
    }
  }
  switch (n_class(n)) {
    case 0: return solve_class<S, 0>(s, r, out, batch, n, st);
    case 1: return solve_class<S, 1>(s, r, out, batch, n, st);
    default: return solve_class<S, 2>(s, r, out, batch, n, st);
  }
}

template <typename S>
int substitute_t(const void* low, const void* rhs, void* x, long long batch, int n,
                 cudaStream_t st) {
  const S* l = static_cast<const S*>(low);
  const S* r = static_cast<const S*>(rhs);
  S* out = static_cast<S*>(x);
  switch (n_class(n)) {
    case 0: return substitute_class<S, 0>(l, r, out, batch, n, st);
    case 1: return substitute_class<S, 1>(l, r, out, batch, n, st);
    default: return substitute_class<S, 2>(l, r, out, batch, n, st);
  }
}

}  // namespace

extern "C" {

// Each entry launches on the given stream without synchronizing.  dtype_code:
// 0 float32, 1 float64, 2 bfloat16.  Returns 0, -1 for an unknown dtype code,
// -2 for a bad argument, or the CUDA error code of the launch.

// L (B, n, n) from K (B, n, n), or (from_j) from sqrt(M) J (B, m, n).
int hamilton_spd_factor(int dtype_code, int from_j, const void* src, void* low,
                        long long batch, int n, int m, void* stream) {
  if (bad_args(batch, n, from_j, m)) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return factor_t<float>(from_j, src, low, batch, n, m, st);
  if (dtype_code == 1) return factor_t<double>(from_j, src, low, batch, n, m, st);
  if (dtype_code == 2) return factor_t<__nv_bfloat16>(from_j, src, low, batch, n, m, st);
  return -1;
}

// x (B, n) with L L^T x = b, from a factor L (B, n, n).
int hamilton_spd_substitute(int dtype_code, const void* low, const void* rhs, void* x,
                            long long batch, int n, void* stream) {
  if (bad_args(batch, n, 0, 0)) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return substitute_t<float>(low, rhs, x, batch, n, st);
  if (dtype_code == 1) return substitute_t<double>(low, rhs, x, batch, n, st);
  if (dtype_code == 2) return substitute_t<__nv_bfloat16>(low, rhs, x, batch, n, st);
  return -1;
}

// x (B, n) with K x = b, K from K (B, n, n) or (from_j) from sqrt(M) J (B, m, n).
int hamilton_spd_solve(int dtype_code, int from_j, const void* src, const void* rhs,
                       void* x, long long batch, int n, int m, void* stream) {
  if (bad_args(batch, n, from_j, m)) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return factor_solve_t<float>(from_j, src, rhs, x, batch, n, m, st);
  if (dtype_code == 1) return factor_solve_t<double>(from_j, src, rhs, x, batch, n, m, st);
  if (dtype_code == 2)
    return factor_solve_t<__nv_bfloat16>(from_j, src, rhs, x, batch, n, m, st);
  return -1;
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
