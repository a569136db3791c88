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
// Built as six parts at once (kernels.PARTS): part 2*v + dtype_code, with
// -DHAMILTON_PART set to it, holds variant v (0 semiseparable n=20, 1
// semiseparable n=5, 2 dense n=2) in one dtype; without it, one library
// holds all.

#include "chain_forms.cuh"

namespace {

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

#ifndef HAMILTON_PART
#define HAMILTON_PART -1
#endif

// Whether this build holds variant v in float64 (or float32).
constexpr bool in_part(int v, bool is_double) {
  return HAMILTON_PART < 0 || HAMILTON_PART == 2 * v + (is_double ? 1 : 0);
}

template <typename T, int V, int N, bool SEMISEP>
int launch_variant(int compensated, int per_member, const Args& a) {
  if constexpr (in_part(V, std::is_same<T, double>::value))
    return launch_modes<T, N, SEMISEP>(compensated, per_member, a);
  else
    return -1;
}

// The instantiated (variant, N) set; KERNEL_INSTANTIATIONS in
// hamilton_tpu_torch/ops/fused_step.py lists the same pairs.
template <typename T>
int dispatch(int n, int semiseparable, int compensated, int per_member, const Args& a) {
  if (semiseparable && n == 20)
    return launch_variant<T, 0, 20, true>(compensated, per_member, a);
  if (semiseparable && n == 5)
    return launch_variant<T, 1, 5, true>(compensated, per_member, a);
  if (!semiseparable && n == 2)
    return launch_variant<T, 2, 2, false>(compensated, per_member, a);
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
// returns.  Returns 0, -1 when the combination is not instantiated (or not
// in this part), -2 for a bad argument, or cudaGetLastError()'s code.  (Few arguments: each one
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
