// Fused whole-step generalized Stormer-Verlet kernel for NVIDIA Hopper
// (sm_90a): the planar serial chain.
//
// Replaces the TPU kernel hamilton_tpu/ops/pallas_step.py::fused_stepper.kernel
// (launched by its _call through pl.pallas_call) for the serial chain.  One
// launch advances every ensemble member by steps_per_call dt-steps of the
// fused leapfrog: the step template step_member in fused_step.cuh (shared
// with the model families' kernel, family_step.cu) under one of two policies
// of the chain's closed forms, SEMISEP (the O(n) semiseparable factorization,
// serial_chain_forms_on) and dense (the in-register Cholesky of
// serial_chain_forms).  In float32 the within-step aux re-evaluations rotate
// the trig aux to first order (the reference's aux_shift); in float64 they
// re-evaluate it.
//
// What bounds it on this card: it is latency- and register-bound.  Each
// member reads and writes 4 or 6 vectors of n values per launch (O(100)
// bytes in and out per member per 50 steps) against thousands of dependent
// flops and 2n-4n transcendentals per step, and 16k members are only ~4
// warps per SM, one per scheduler, so nothing hides instruction latency.
// What the design does about it: one thread per member, everything over N
// unrolled at compile time so the per-member lists live in registers (the
// live set still exceeds 255 registers at N=20, so some of it spills to
// L1-backed local memory), the factor and aux carried in registers across
// the steps of a launch, and batch-minor x[i*B + b] loads and stores that
// coalesce.  A per-member table is read where each entry is used rather
// than held in registers (the n=20 live set already exceeds 255 registers).
// Making it faster (fewer live values, several threads per member) is later
// work.
//
// Build (no fast-math: it would reassociate the Kahan compensation away and
// swap sinf/cosf for approximations whose error shows in the drift):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_step.so fused_step.cu
// FMA contraction (nvcc's default) stays on; it changes rounding only.

#include "fused_step.cuh"

namespace {

// The flat coefficient table: semiseparable (l_i, S_i, g*l_i*S_i), 3N
// entries; dense (C_ij = l_i*l_j*S_max(i,j) row-major, g*l_i*S_i), N*N+N.
template <int N, bool SEMISEP>
struct CoefLen {
  static constexpr int value = SEMISEP ? 3 * N : N * N + N;
};

template <typename T, int N>
struct SemisepFactor {
  T zx[N], zy[N], id[N], ux[N], uy[N];  // per link in tip-to-base order
};

template <typename T, int N>
__device__ __forceinline__ void trig(const T (&q)[N], T (&s)[N], T (&c)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = dsin(q[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) c[i] = dcos(q[i]);
}

// First-order rotation of the trig aux to q_new (float32 only): s' = s+dq*c,
// c' = c-dq*s with dq = q_new - q_base; in float64 the aux is re-evaluated.
template <typename T, int N>
__device__ __forceinline__ void aux_at(const T (&q_new)[N], const T (&q_base)[N],
                                       T (&s)[N], T (&c)[N]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T dq = q_new[i] - q_base[i];
      const T s0 = s[i], c0 = c[i];
      s[i] = s0 + dq * c0;
      c[i] = c0 - dq * s0;
    }
  } else {
    trig<T, N>(q_new, s, c);
  }
}

// ---- semiseparable family (serial_chain_forms_on) ----------------------

template <typename T, int N, class C>
__device__ __forceinline__ void factor(const C& cf, const T (&s)[N], const T (&c)[N],
                                       SemisepFactor<T, N>& f) {
  T pxx = T(0), pxy = T(0), pyy = T(0);
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const int i = N - 1 - a;
    const T ux = cf[i] * c[i];
    const T uy = cf[i] * s[i];
    const T si = cf[N + i];
    T yx, yy;
    if (a == 0) {
      yx = si * ux;
      yy = si * uy;
    } else {
      yx = si * ux - (pxx * ux + pxy * uy);
      yy = si * uy - (pxy * ux + pyy * uy);
    }
    const T d = dsqrt(ux * yx + uy * yy);
    const T inv_d = T(1) / d;
    const T zx = yx * inv_d;
    const T zy = yy * inv_d;
    if (a == 0) {
      pxx = zx * zx;
      pxy = zx * zy;
      pyy = zy * zy;
    } else {
      pxx = pxx + zx * zx;
      pxy = pxy + zx * zy;
      pyy = pyy + zy * zy;
    }
    f.zx[a] = zx;
    f.zy[a] = zy;
    f.id[a] = inv_d;
    f.ux[a] = ux;
    f.uy[a] = uy;
  }
}

template <typename T, int N>
__device__ __forceinline__ void solve(const SemisepFactor<T, N>& f, const T (&b)[N],
                                      T (&x)[N]) {
  T y[N];
  T sx = T(0), sy = T(0);
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const T bi = b[N - 1 - a];
    const T t = (a == 0) ? bi : bi - (f.ux[a] * sx + f.uy[a] * sy);
    const T ya = t * f.id[a];
    y[a] = ya;
    if (a == 0) {
      sx = f.zx[a] * ya;
      sy = f.zy[a] * ya;
    } else {
      sx = sx + f.zx[a] * ya;
      sy = sy + f.zy[a] * ya;
    }
  }
  T tx = T(0), ty = T(0);
#pragma unroll
  for (int a = N - 1; a >= 0; --a) {
    const T t = (a == N - 1) ? y[a] : y[a] - (f.zx[a] * tx + f.zy[a] * ty);
    const T xa = t * f.id[a];
    x[N - 1 - a] = xa;
    if (a == N - 1) {
      tx = f.ux[a] * xa;
      ty = f.uy[a] * xa;
    } else {
      tx = tx + f.ux[a] * xa;
      ty = ty + f.uy[a] * xa;
    }
  }
}

template <typename T, int N, class C>
__device__ __forceinline__ void dhdq(const C& cf, const T (&s)[N], const T (&c)[N],
                                     const T (&w)[N], T (&out)[N],
                                     std::integral_constant<bool, true>) {
  T lcw[N], lsw[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T lw = cf[j] * w[j];
    lcw[j] = lw * c[j];
    lsw[j] = lw * s[j];
  }
  T qc[N], qs[N];
  qc[N - 1] = cf[N + N - 1] * lcw[N - 1];
  qs[N - 1] = cf[N + N - 1] * lsw[N - 1];
#pragma unroll
  for (int k = N - 2; k >= 0; --k) {
    qc[k] = qc[k + 1] + cf[N + k] * lcw[k];
    qs[k] = qs[k + 1] + cf[N + k] * lsw[k];
  }
  T pc = T(0), ps = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T ak, bk;
    if (k == 0) {
      ak = qc[k];
      bk = qs[k];
    } else {
      ak = cf[N + k] * pc + qc[k];
      bk = cf[N + k] * ps + qs[k];
    }
    out[k] = cf[2 * N + k] * s[k] + w[k] * cf[k] * (s[k] * ak - c[k] * bk);
    if (k == 0) {
      pc = lcw[k];
      ps = lsw[k];
    } else {
      pc = pc + lcw[k];
      ps = ps + lsw[k];
    }
  }
}

// ---- dense family (serial_chain_forms) --------------------------------

template <typename T, int N, class C>
__device__ __forceinline__ void factor(const C& cf, const T (&s)[N], const T (&c)[N],
                                       DenseFactor<T, N>& f) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T acc = cf[j * N + j];  // K_jj = C_jj exactly
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - f.low[j][k] * f.low[j][k];
    const T d = dsqrt(acc);
    f.low[j][j] = d;
    const T inv_d = T(1) / d;
    f.id[j] = inv_d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      T e = cf[i * N + j] * (c[i] * c[j] + s[i] * s[j]);
#pragma unroll
      for (int k = 0; k < j; ++k) e = e - f.low[i][k] * f.low[j][k];
      f.low[i][j] = e * inv_d;
    }
  }
}

template <typename T, int N, class C>
__device__ __forceinline__ void dhdq(const C& cf, const T (&s)[N], const T (&c)[N],
                                     const T (&w)[N], T (&out)[N],
                                     std::integral_constant<bool, false>) {
  T cw[N], sw[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    cw[j] = c[j] * w[j];
    sw[j] = s[j] * w[j];
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T acc_c = cf[k * N] * cw[0];
    T acc_s = cf[k * N] * sw[0];
#pragma unroll
    for (int j = 1; j < N; ++j) {
      acc_c = acc_c + cf[k * N + j] * cw[j];
      acc_s = acc_s + cf[k * N + j] * sw[j];
    }
    out[k] = cf[N * N + k] * s[k] + w[k] * (s[k] * acc_c - c[k] * acc_s);
  }
}

// ---- the chain's policy --------------------------------------------------

// The serial chain's forms for step_member: the trig aux (sin, cos of every
// link angle), its shift in float32, and the semiseparable or dense factor.
// The chain's K and dH/dq read only the aux, never q.
template <typename T, int N_, bool SEMISEP>
struct ChainPolicy {
  static constexpr int N = N_;
  struct Aux {
    T s[N], c[N];
  };
  using Factor = typename std::conditional<SEMISEP, SemisepFactor<T, N>,
                                           DenseFactor<T, N>>::type;

  template <class C>
  static __device__ __forceinline__ void aux(const C&, const T (&q)[N], Aux& a) {
    trig<T, N>(q, a.s, a.c);
  }
  template <class C>
  static __device__ __forceinline__ void aux_at(const C&, const T (&q_new)[N],
                                                const T (&q_base)[N], Aux& a) {
    ::aux_at<T, N>(q_new, q_base, a.s, a.c);
  }
  template <class C>
  static __device__ __forceinline__ void factor(const C& cf, const Aux& a, const T (&)[N],
                                                Factor& f) {
    ::factor<T, N>(cf, a.s, a.c, f);
  }
  static __device__ __forceinline__ void solve(const Factor& f, const T (&b)[N],
                                               T (&x)[N]) {
    ::solve<T, N>(f, b, x);
  }
  template <class C>
  static __device__ __forceinline__ void dhdq(const C& cf, const Aux& a, const T (&)[N],
                                              const T (&w)[N], T (&out)[N]) {
    ::dhdq<T, N>(cf, a.s, a.c, w, out, std::integral_constant<bool, SEMISEP>{});
  }
};

template <typename T, int N, bool SEMISEP, bool COMP, bool PM, bool COMPOSED>
__global__ void __launch_bounds__(kThreads)
    fused_step_kernel(const T* __restrict__ coef, const T* __restrict__ in,
                      T* __restrict__ out, long long batch,
                      const __grid_constant__ Substeps<T> subs, int iters_p,
                      int iters_q, int steps_per_call) {
  using P = ChainPolicy<T, N, SEMISEP>;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (PM) {
    if (b >= batch) return;
    step_member<T, P, COMP, COMPOSED>(MemberTable<T>{coef + b, batch}, in, out, batch, b,
                                      subs, iters_p, iters_q, steps_per_call);
  } else {
    constexpr int L = CoefLen<N, SEMISEP>::value;
    __shared__ T cf[L];
    for (int k = threadIdx.x; k < L; k += blockDim.x) cf[k] = coef[k];
    __syncthreads();
    if (b >= batch) return;
    step_member<T, P, COMP, COMPOSED>(SharedTable<T>{cf}, in, out, batch, b, subs,
                                      iters_p, iters_q, steps_per_call);
  }
}

template <typename T, int N, bool SEMISEP, bool COMP, bool PM, bool COMPOSED>
int launch(const Args& a) {
  const long long blocks = (a.batch + kThreads - 1) / kThreads;
  fused_step_kernel<T, N, SEMISEP, COMP, PM, COMPOSED>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.coef), static_cast<const T*>(a.in),
          static_cast<T*>(a.out), a.batch,
          make_substeps<T>(a.weights, a.n_weights, a.dt), a.iters_p, a.iters_q,
          a.steps_per_call);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N, bool SEMISEP, bool COMP, bool PM>
int launch_composed(const Args& a) {
  return a.n_weights > 1 ? launch<T, N, SEMISEP, COMP, PM, true>(a)
                         : launch<T, N, SEMISEP, COMP, PM, false>(a);
}

template <typename T, int N, bool SEMISEP>
int launch_modes(int compensated, int per_member, const Args& a) {
  if (compensated)
    return per_member ? launch_composed<T, N, SEMISEP, true, true>(a)
                      : launch_composed<T, N, SEMISEP, true, false>(a);
  return per_member ? launch_composed<T, N, SEMISEP, false, true>(a)
                    : launch_composed<T, N, SEMISEP, false, false>(a);
}

// The instantiated (variant, N) set; KERNEL_INSTANTIATIONS in
// hamilton_tpu_torch/ops/fused_step.py lists the same pairs.
template <typename T>
int dispatch(int n, int semiseparable, int compensated, int per_member, const Args& a) {
  if (semiseparable && n == 20)
    return launch_modes<T, 20, true>(compensated, per_member, a);
  if (semiseparable && n == 5)
    return launch_modes<T, 5, true>(compensated, per_member, a);
  if (!semiseparable && n == 2)
    return launch_modes<T, 2, false>(compensated, per_member, a);
  return -1;
}

}  // namespace

extern "C" {

// Launches steps_per_call fused steps of a (4 or 6, n, batch) state from
// state_in into state_out on the given stream, without synchronizing.
// dtype_code: 0 float32, 1 float64.  flags: bit 0 semiseparable (else
// dense), bit 1 compensated, bit 2 per-member table.  coef is the flat
// shared table, or the (L, batch) per-member one.  weights points to the
// n_weights (1 to 5) composition weights in host memory, read before this
// returns.  Returns 0, -1 when the combination is not instantiated, -2 for
// a bad argument, or cudaGetLastError()'s code.  (Few arguments: each one
// costs the caller's ctypes marshalling on every launch.)
int hamilton_fused_step(int dtype_code, int n, int flags, const void* coef,
                        const void* state_in, void* state_out, long long batch, double dt,
                        int iters_p, int iters_q, int steps_per_call, int n_weights,
                        const double* weights, void* stream) {
  if (!valid_args(batch, iters_p, iters_q, steps_per_call, n_weights) || flags < 0 ||
      flags > 7)
    return -2;
  Args a{coef, state_in, state_out, batch, dt, iters_p, iters_q, steps_per_call,
         {}, n_weights, static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < n_weights; ++k) a.weights[k] = weights[k];
  const int semiseparable = flags & 1, compensated = (flags >> 1) & 1,
            per_member = (flags >> 2) & 1;
  if (dtype_code == 0)
    return dispatch<float>(n, semiseparable, compensated, per_member, a);
  if (dtype_code == 1)
    return dispatch<double>(n, semiseparable, compensated, per_member, a);
  return -1;
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
