// Fused whole-step generalized Stormer-Verlet kernel for NVIDIA Hopper
// (sm_90a): any family's closed forms, generated at first use.
//
// Replaces the TPU kernel hamilton_tpu/ops/pallas_step.py::fused_stepper.kernel
// (launched by its _call through pl.pallas_call) for a family that is not
// compiled into fused_step.cu, chain_variants.cu or family_step.cu: a user's
// own FusedForms, or a bundled family at another size.  Pallas traces the
// family's Python forms into its kernel (pallas_step.py:594); here
// hamilton_tpu_torch/ops/fused_codegen.py runs the forms once on symbolic
// values and prints them as the header user_family.h: the struct
// UserForms<T, CONST_TABLE> with N, NAUX, NF, L and the straight-line forms
// aux, kmat (the mass-matrix entries, j <= i) or factor/solve, dhdq and
// aux_shift, in the plain version's operation order and rounding.
// kernels.build_user_family writes the header into its own directory of
// hamilton_tpu_torch/_build/ and compiles this file with -I there.
//
// This file is the policy that runs those forms under the step template of
// fused_step.cuh (dense families: the in-register Cholesky of factor_entries
// and solve, as family_step.cu's DensePolicy; families with factor_solve:
// their own factor and solve), the kernel, its launches and the C entry.
//
// Tables, one of three:
//   - the float64 constant table (CONST_TABLE): the shared parameters as
//     the plain version's Python floats, staged in shared memory as double;
//     the forms fold constant-only subexpressions in double, as Python folds
//     them, and round to T where a constant meets a member value, so the
//     one build serves any parameter values;
//   - a run-time shared table of T entries (parameters that need a
//     gradient), staged in shared memory;
//   - a per-member (L, batch) table of a sweep, read through the read-only
//     cache.
// A family without a table (L = 0) has the constant mode only, with a null
// coef.  aux_shift is the float32 path's within-step re-evaluation, as in
// the plain version; float64 re-evaluates aux.
//
// What bounds it on this card: latency, as family_step.cu: one thread a
// member, everything unrolled, a few hundred dependent flops a member-step
// at n <= 3.  A simple kernel that is right; speed is later work.
//
// Build: as family_step.cu, with -fmad=false: no FMA contraction, so each
// product and sum rounds as in the plain version (kernels.SOURCE_FLAGS).

#include "fused_step.cuh"

namespace {

__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

}  // namespace

#include "user_family.h"

namespace {

// The generated forms F under the step template, with table accessor C.
template <typename T, class F, class C>
struct UserPolicy {
  static constexpr int N = F::N;
  static constexpr int SA = F::NAUX > 0 ? F::NAUX : 1;
  static constexpr int SF = F::NF > 0 ? F::NF : 1;
  struct Aux {
    T v[SA];
  };
  // A family's own factor carries the table accessor for its solve.
  struct OwnFactor {
    T v[SF];
    C cf;
  };
  using Factor = typename std::conditional<F::kDense, DenseFactor<T, N>, OwnFactor>::type;

  static __device__ __forceinline__ void aux(const C& cf, const T (&q)[N], Aux& a) {
    F::aux(cf, q, a.v);
  }
  static __device__ __forceinline__ void aux_at(const C& cf, const T (&q_new)[N],
                                                const T (&q_base)[N], Aux& a) {
    if constexpr (F::kShift && std::is_same<T, float>::value) {
      T dq[N], out[SA];
#pragma unroll
      for (int i = 0; i < N; ++i) dq[i] = q_new[i] - q_base[i];
      F::aux_shift(cf, a.v, dq, out);
#pragma unroll
      for (int k = 0; k < SA; ++k) a.v[k] = out[k];
    } else {
      F::aux(cf, q_new, a.v);
    }
  }
  static __device__ __forceinline__ void factor(const C& cf, const Aux& a, const T (&q)[N],
                                                Factor& f) {
    if constexpr (F::kDense) {
      T k[N * (N + 1) / 2];
      F::kmat(cf, a.v, q, k);
      factor_entries<T, N>([&](int i, int j) { return k[i * (i + 1) / 2 + j]; }, f);
    } else {
      F::factor(cf, a.v, q, f.v);
      f.cf = cf;
    }
  }
  static __device__ __forceinline__ void solve(const Factor& f, const T (&b)[N], T (&x)[N]) {
    if constexpr (F::kDense) {
      ::solve<T, N>(f, b, x);
    } else {
      F::solve(f.cf, f.v, b, x);
    }
  }
  static __device__ __forceinline__ void dhdq(const C& cf, const Aux& a, const T (&q)[N],
                                              const T (&w)[N], T (&out)[N]) {
    F::dhdq(cf, a.v, q, w, out);
  }
};

// TABLE: 0 the float64 constant table, 1 a run-time shared table, 2 per member.
template <typename T, int TABLE, bool COMP, bool COMPOSED>
__global__ void __launch_bounds__(kThreads)
    user_family_kernel(const void* __restrict__ coef, const T* __restrict__ in,
                       T* __restrict__ out, long long batch,
                       const __grid_constant__ Substeps<T> subs, int iters_p, int iters_q,
                       int steps_per_call) {
  using F = UserForms<T, TABLE == 0>;
  constexpr int L = F::L;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (TABLE == 2) {
    if (b >= batch) return;
    using C = MemberTable<T>;
    step_member<T, UserPolicy<T, F, C>, COMP, COMPOSED>(
        C{static_cast<const T*>(coef) + b, batch}, in, out, batch, b, subs, iters_p, iters_q,
        steps_per_call);
  } else {
    using E = typename std::conditional<TABLE == 0, double, T>::type;
    __shared__ E cf[L > 0 ? L : 1];  // no table: a null coef
    for (int k = threadIdx.x; k < L; k += blockDim.x) cf[k] = static_cast<const E*>(coef)[k];
    __syncthreads();
    if (b >= batch) return;
    using C = SharedTable<E>;
    step_member<T, UserPolicy<T, F, C>, COMP, COMPOSED>(C{cf}, in, out, batch, b, subs,
                                                        iters_p, iters_q, steps_per_call);
  }
}

template <typename T, int TABLE, bool COMP, bool COMPOSED>
int launch(const Args& a) {
  if (UserForms<T, TABLE == 0>::L > 0 && a.coef == nullptr) return -2;
  const long long blocks = (a.batch + kThreads - 1) / kThreads;
  user_family_kernel<T, TABLE, COMP, COMPOSED>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, a.stream>>>(
          a.coef, static_cast<const T*>(a.in), static_cast<T*>(a.out), a.batch,
          make_substeps<T>(a.weights, a.n_weights, a.dt), a.iters_p, a.iters_q,
          a.steps_per_call);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TABLE>
int launch_modes(int compensated, const Args& a) {
  if (compensated)
    return a.n_weights > 1 ? launch<T, TABLE, true, true>(a) : launch<T, TABLE, true, false>(a);
  return a.n_weights > 1 ? launch<T, TABLE, false, true>(a) : launch<T, TABLE, false, false>(a);
}

// The constant table when the forms were generated for it; the run-time
// modes when the family has a table.
template <typename T>
int dispatch(int table, int compensated, const Args& a) {
  if (table == 0) {
    if constexpr (UserForms<T, true>::kAvailable) return launch_modes<T, 0>(compensated, a);
    return -1;
  }
  if constexpr (UserForms<T, false>::L == 0) {
    return -1;
  } else {
    if (table == 1) return launch_modes<T, 1>(compensated, a);
    if (table == 2) return launch_modes<T, 2>(compensated, a);
    return -1;
  }
}

}  // namespace

extern "C" {

// Launches steps_per_call fused steps of the generated family's (4 or 6, N,
// batch) state from state_in into state_out on the given stream, without
// synchronizing.  dtype_code: 0 float32, 1 float64.  table: 0 the flat
// float64 constant table (null when L = 0), 1 a flat run-time shared table
// of the state's dtype; with flags bit 2 (per-member) the (L, batch) table
// of a sweep (table must then be 1).  flags: bit 1 compensated (bit 0, the
// chain's semiseparable flag, must be 0).  weights points to the n_weights
// (1 to 5) composition weights in host memory, read before this returns.
// Returns 0, -1 when the combination is not instantiated, -2 for a bad
// argument, or cudaGetLastError()'s code.  The fourteen arguments of the
// other K1 entries.
int hamilton_user_family_step(int dtype_code, int table, int flags, const void* coef,
                              const void* state_in, void* state_out, long long batch,
                              double dt, int iters_p, int iters_q, int steps_per_call,
                              int n_weights, const double* weights, void* stream) {
  if (!valid_args(batch, iters_p, iters_q, steps_per_call, n_weights) || flags < 0 ||
      flags > 7 || (flags & 1) || table < 0 || table > 1 || ((flags & 4) && table != 1))
    return -2;
  Args a{coef, state_in, state_out, batch, dt, iters_p, iters_q, steps_per_call,
         {}, n_weights, static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < n_weights; ++k) a.weights[k] = weights[k];
  const int compensated = (flags >> 1) & 1;
  const int mode = (flags & 4) ? 2 : table;
  if (dtype_code == 0) return dispatch<float>(mode, compensated, a);
  if (dtype_code == 1) return dispatch<double>(mode, compensated, a);
  return -1;
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
