// Batched tiny-SPD Cholesky factor and solves for NVIDIA Hopper (sm_90a).
//
// Replaces the five TPU kernels of hamilton_tpu/ops/pallas_solve.py, which are
// two bodies (_chol_entries :75, _solve_entries :100) combined three ways, with
// an optional accessor that forms K = (sqrt(M) J)^T (sqrt(M) J) on demand
// (_k_at_from_jac :304).  Here that is three templated kernels:
//   factor_kernel<T, false>        K2b _chol_kernel (:124)        K -> L
//   factor_kernel<T, true>         K2e _jac_chol_kernel (:323)    sqrt(M) J -> L
//   substitute_kernel<T>           K2c _chosolve_kernel (:131)    L, b -> x
//   factor_solve_kernel<T, false>  K2a _solve_kernel (:117)       K, b -> x
//   factor_solve_kernel<T, true>   K2d _jac_solve_kernel (:316)   sqrt(M) J, b -> x
// each for float32 and float64, any 1 <= n <= 32 at run time, any batch.
// Operands are member-major and contiguous: K and L (B, n, n), sqrt(M) J
// (B, m, n), b and x (B, n).  L is written with zeros above the diagonal.
//
// Each thread stages its member's K (copied, or formed from sqrt(M) J) in
// shared memory and factors it there in place.
//
// Arithmetic: the left-looking Cholesky of _chol_entries and the forward and
// back substitutions of _solve_entries, in the same operation order as the
// plain PyTorch versions beside the wrappers
// (hamilton_tpu_torch/ops/batched_spd.py).  Every multiply, add and subtract
// goes through the round-to-nearest intrinsics, which nvcc never contracts
// into an FMA, and the square root and the reciprocal are the IEEE ones, so a
// member's result is the plain version's bit for bit.  A matrix that is not
// SPD takes the square root of a negative number and gives NaN in that member
// only, as in the reference.
//
// What bounds it on this card: latency.  One thread per member walks O(n^3)
// dependent multiply-subtracts (n^3/6 for the factor at n=20: ~1,300) with
// nothing to hide their latency but the ~4 warps per SM that 16k members
// make.  The factor (n(n+1)/2 values, 210 at n=20) does not fit a thread's
// registers at run-time n, so it lives in dynamic shared memory, entry-major
// and thread-minor (entry e of thread t at e * blockDim.x + t), so a warp's
// 32 accesses to one entry fall in distinct banks and nothing spills to local
// memory.  The member-major loads of K, sqrt(M) J and L do not coalesce
// (neighbouring threads are n^2 or m*n values apart); they are served
// through L1 and L2 (16384 x 20 x 20 float32 is 26 MB, under the 50 MB L2).
// A batch-minor layout and several threads per member are the first things a
// redesign takes on.
//
// Build (no fast-math, so sqrt and division stay IEEE):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libbatched_spd.so batched_spd.cu

#include <cuda_runtime.h>

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

template <typename T>
__global__ void substitute_kernel(const T* __restrict__ low, const T* __restrict__ rhs,
                                  T* __restrict__ x, long long batch, int n) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const T* l = low + b * n * n;
  const Scratch<T> v = scratch<T>(0);
  const Scratch<T> inv = scratch<T>(n);
  for (int i = 0; i < n; ++i) {
    inv[i] = Ieee<T>::rcp(l[i * n + i]);
    v[i] = rhs[b * n + i];
  }
  substitute<T>([&](int i, int j) { return l[i * n + j]; }, [&](int i) { return inv[i]; },
                n, v);
  for (int i = 0; i < n; ++i) x[b * n + i] = v[i];
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
  const long long per = (static_cast<long long>(n) * (n + 1) / 2 + (from_j ? n : 0)) * sizeof(T);
  const T* s = static_cast<const T*>(src);
  T* l = static_cast<T*>(low);
  return from_j ? launch(factor_kernel<T, true>, per, batch, st, s, l, batch, n, m)
                : launch(factor_kernel<T, false>, per, batch, st, s, l, batch, n, m);
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
  const long long per = 2LL * n * sizeof(T);
  return launch(substitute_kernel<T>, per, batch, st, static_cast<const T*>(low),
                static_cast<const T*>(rhs), static_cast<T*>(x), batch, n);
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
