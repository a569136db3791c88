// Fused whole-step generalized Stormer-Verlet kernel for NVIDIA Hopper
// (sm_90a): the planar serial chain's Moebius and L^-1 forms, and its dense
// forms at n = 4.
//
// Replaces the TPU kernel hamilton_tpu/ops/pallas_step.py::fused_stepper.kernel
// (launched by its _call through pl.pallas_call) traced with the chain's
// other closed forms, serial_chain_forms_mobius (pallas_step.py:1194) and
// serial_chain_forms_linv (:1329), and with serial_chain_forms at n = 4 (the
// chain that examples/fit_masses.py differentiates).  The step is the
// template step_member of fused_step.cuh; the aux, its float32 shift, the
// semiseparable solves and dH/dq, and the dense policy come from
// chain_forms.cuh, shared with fused_step.cu.  Two policies are new here:
//
//   Moebius  the semiseparable factor with its 2x2 Riccati recursion
//            collapsed to the homogeneous scalar pair p' = p + m q,
//            q' = (sigma/m) p + q (two multiply-adds a link on the critical
//            path); beta = p/q, y, 1/d and z are per-link work off it.  The
//            factor has the semiseparable layout, so the solves and dH/dq
//            are the base family's.  Table: (l, S, g l S, m, 1/m), 5n.
//   L^-1     the semiseparable factor, then the n(n+1)/2 entries of L^-1,
//            column by column (n independent recursions); each solve is two
//            triangular mat-vecs whose sums are balanced pairwise trees,
//            paired exactly as the plain version's _tree_sum pairs them.
//            Table: the base family's 3n.
//
// What bounds it on this card: latency and registers, as the chain's other
// kernel (fused_step.cu).  Per member a launch moves O(100) bytes against
// thousands of dependent flops.  L^-1's factor is 210 values at n = 20,
// carried across the steps of a launch beside the state: far past the 255
// registers a thread has, so it lives in L1-backed local memory (-Xptxas -v
// reports the spills), and its columns and mat-vecs are loops over it that
// are not unrolled.  The design is the simple one: one thread per member,
// the rest unrolled over N, batch-minor loads and stores that coalesce.
// Fewer live values (recomputing the columns per solve) or several threads a
// member is later work.
//
// Build: as fused_step.cu (no fast-math), with -fmad=false: no FMA
// contraction, so each product and sum rounds as in the plain version
// (kernels.SOURCE_FLAGS says why).  Built as ten parts at once
// (kernels.PARTS): part 2*code + dtype_code, compiled with -DHAMILTON_PART
// set to it, holds one case in one dtype; without it, one library holds all.

#include <type_traits>

#include "chain_forms.cuh"

namespace {

// ---- the Moebius factor (serial_chain_forms_mobius) -----------------------

// The semiseparable factor's entries (z_x, z_y, 1/d, u_x, u_y per link in
// tip-to-base order) from the Moebius chain.  Table entries: l_i at i,
// m_i at 3N + i, 1/m_i at 4N + i.
template <typename T, int N, class C>
__device__ __forceinline__ void mobius_factor(const C& cf, const T (&s)[N], const T (&c)[N],
                                              SemisepFactor<T, N>& f) {
  T ux[N], uy[N], cross[N], sig[N];
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const int i = N - 1 - a;
    ux[a] = cf[i] * c[i];
    uy[a] = cf[i] * s[i];
  }
#pragma unroll
  for (int a = 1; a < N; ++a) {
    const int i = N - 1 - a;  // link of step a; link i + 1 is step a - 1's
    cross[a] = c[i + 1] * s[i] - s[i + 1] * c[i];
    sig[a] = cross[a] * cross[a];
  }
  // the critical-path chain: the homogeneous pair after each link
  T ps[N], qs[N];
  ps[0] = cf[3 * N + N - 1];
  qs[0] = T(1);
#pragma unroll
  for (int a = 1; a < N; ++a) {
    const int i = N - 1 - a;
    const T da = cf[3 * N + i];
    const T ida = cf[4 * N + i];
    ps[a] = ps[a - 1] + da * qs[a - 1];
    qs[a] = (sig[a] * ida) * ps[a - 1] + qs[a - 1];
  }
  // off-chain reconstruction, independent per link
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const int i = N - 1 - a;
    const T da = cf[3 * N + i];
    T yx, yy;
    if (a == 0) {
      yx = da * ux[0];
      yy = da * uy[0];
    } else {
      const T beta = ps[a - 1] / qs[a - 1];
      const T bfu = beta * (cf[i] * cross[a]);
      yx = da * ux[a] - bfu * s[i + 1];
      yy = da * uy[a] + bfu * c[i + 1];
    }
    const T d2 = ux[a] * yx + uy[a] * yy;
    const T inv_d = T(1) / dsqrt(d2);
    f.zx[a] = yx * inv_d;
    f.zy[a] = yy * inv_d;
    f.id[a] = inv_d;
    f.ux[a] = ux[a];
    f.uy[a] = uy[a];
  }
}

// ---- the L^-1 factor and solve (serial_chain_forms_linv) ------------------
//
// The columns and the mat-vecs are loops that are not unrolled, over arrays
// indexed at run time: the factor (210 values at n = 20) lives in local
// memory either way, and unrolled the two mat-vecs' 420 products a solve and
// their trees made the source take minutes to build.

template <typename T, int N>
struct LinvFactor {
  T e[N * (N + 1) / 2];  // column-major lower triangle of L^-1, processing order
};

// Entry (i, a), i >= a, of the column-major lower triangle.
template <int N>
__device__ __forceinline__ int linv_at(int i, int a) {
  return a * N - a * (a - 1) / 2 + (i - a);
}

// The balanced pairwise sum of t[0..len) in place, in the plain version's
// pairing (ops/fused_step.py::_tree_sum): each level adds neighbours
// (0,1), (2,3), ... and carries an odd last term to the next level.
template <typename T>
__device__ __forceinline__ T tree_sum(T* t, int len) {
#pragma unroll 1
  while (len > 1) {
    const int h = len / 2;
#pragma unroll 1
    for (int i = 0; i < h; ++i) t[i] = t[2 * i] + t[2 * i + 1];
    if (len & 1) t[h] = t[len - 1];
    len = h + (len & 1);
  }
  return t[0];
}

template <typename T, int N, class C>
__device__ __forceinline__ void linv_factor(const C& cf, const T (&s)[N], const T (&c)[N],
                                            LinvFactor<T, N>& f) {
  SemisepFactor<T, N> g;
  ::factor<T, N>(cf, s, c, g);
#pragma unroll 1
  for (int a = 0; a < N; ++a) {
    const T xa = g.id[a];
    f.e[linv_at<N>(a, a)] = xa;
    T sx = g.zx[a] * xa;
    T sy = g.zy[a] * xa;
#pragma unroll 1
    for (int i = a + 1; i < N; ++i) {
      const T xi = -(g.id[i] * (g.ux[i] * sx + g.uy[i] * sy));
      f.e[linv_at<N>(i, a)] = xi;
      if (i < N - 1) {
        sx = sx + g.zx[i] * xi;
        sy = sy + g.zy[i] * xi;
      }
    }
  }
}

// x = L^-T (L^-1 b~), b~ the right-hand side in processing order.
template <typename T, int N>
__device__ __forceinline__ void linv_solve(const LinvFactor<T, N>& f, const T (&b)[N],
                                           T (&x)[N]) {
  T bt[N], y[N], xt[N], t[N];
#pragma unroll
  for (int a = 0; a < N; ++a) bt[a] = b[N - 1 - a];
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
#pragma unroll 1
    for (int a = 0; a <= i; ++a) t[a] = f.e[linv_at<N>(i, a)] * bt[a];
    y[i] = tree_sum(t, i + 1);
  }
#pragma unroll 1
  for (int a = 0; a < N; ++a) {
#pragma unroll 1
    for (int i = a; i < N; ++i) t[i - a] = f.e[linv_at<N>(i, a)] * y[i];
    xt[a] = tree_sum(t, N - a);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = xt[N - 1 - j];
}

// ---- the policies ----------------------------------------------------------

// The chain's aux, shift, semiseparable solves and dH/dq with the Moebius
// factor; L, the flat table length.
template <typename T, int N_>
struct MobiusPolicy : ChainPolicy<T, N_, true> {
  static constexpr int L = 5 * N_;
  using Aux = typename ChainPolicy<T, N_, true>::Aux;
  using Factor = SemisepFactor<T, N_>;

  template <class C>
  static __device__ __forceinline__ void factor(const C& cf, const Aux& a, const T (&)[N_],
                                                Factor& f) {
    mobius_factor<T, N_>(cf, a.s, a.c, f);
  }
};

// The chain's aux, shift and semiseparable dH/dq with the L^-1 factor and
// its mat-vec solves.
template <typename T, int N_>
struct LinvPolicy : ChainPolicy<T, N_, true> {
  static constexpr int L = 3 * N_;
  using Aux = typename ChainPolicy<T, N_, true>::Aux;
  using Factor = LinvFactor<T, N_>;

  template <class C>
  static __device__ __forceinline__ void factor(const C& cf, const Aux& a, const T (&)[N_],
                                                Factor& f) {
    linv_factor<T, N_>(cf, a.s, a.c, f);
  }
  static __device__ __forceinline__ void solve(const Factor& f, const T (&b)[N_],
                                               T (&x)[N_]) {
    linv_solve<T, N_>(f, b, x);
  }
};

// The dense forms (the in-register Cholesky of serial_chain_forms).
template <typename T, int N_>
struct DenseChainPolicy : ChainPolicy<T, N_, false> {
  static constexpr int L = CoefLen<N_, false>::value;
};

// The instantiated cases; KERNEL_INSTANTIATIONS in
// hamilton_tpu_torch/ops/fused_step.py lists the same codes.
template <typename T, int CASE>
struct Variant;
template <typename T>
struct Variant<T, 0> { using P = MobiusPolicy<T, 20>; };
template <typename T>
struct Variant<T, 1> { using P = MobiusPolicy<T, 5>; };
template <typename T>
struct Variant<T, 2> { using P = LinvPolicy<T, 20>; };
template <typename T>
struct Variant<T, 3> { using P = LinvPolicy<T, 5>; };
template <typename T>
struct Variant<T, 4> { using P = DenseChainPolicy<T, 4>; };

template <typename T, int CASE, bool COMP, bool PM, bool COMPOSED>
__global__ void __launch_bounds__(kThreads)
    chain_variant_kernel(const T* __restrict__ coef, const T* __restrict__ in,
                         T* __restrict__ out, long long batch,
                         const __grid_constant__ Substeps<T> subs, int iters_p,
                         int iters_q, int steps_per_call) {
  using P = typename Variant<T, CASE>::P;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (PM) {
    if (b >= batch) return;
    step_member<T, P, COMP, COMPOSED>(MemberTable<T>{coef + b, batch}, in, out, batch, b,
                                      subs, iters_p, iters_q, steps_per_call);
  } else {
    __shared__ T cf[P::L];
    for (int k = threadIdx.x; k < P::L; k += blockDim.x) cf[k] = coef[k];
    __syncthreads();
    if (b >= batch) return;
    step_member<T, P, COMP, COMPOSED>(SharedTable<T>{cf}, in, out, batch, b, subs,
                                      iters_p, iters_q, steps_per_call);
  }
}

template <typename T, int CASE, bool COMP, bool PM, bool COMPOSED>
int launch(const Args& a) {
  const long long blocks = (a.batch + kThreads - 1) / kThreads;
  chain_variant_kernel<T, CASE, COMP, PM, COMPOSED>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.coef), static_cast<const T*>(a.in),
          static_cast<T*>(a.out), a.batch,
          make_substeps<T>(a.weights, a.n_weights, a.dt), a.iters_p, a.iters_q,
          a.steps_per_call);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CASE, bool COMP, bool PM>
int launch_composed(const Args& a) {
  return a.n_weights > 1 ? launch<T, CASE, COMP, PM, true>(a)
                         : launch<T, CASE, COMP, PM, false>(a);
}

template <typename T, int CASE>
int launch_modes(int compensated, int per_member, const Args& a) {
  if (compensated)
    return per_member ? launch_composed<T, CASE, true, true>(a)
                      : launch_composed<T, CASE, true, false>(a);
  return per_member ? launch_composed<T, CASE, false, true>(a)
                    : launch_composed<T, CASE, false, false>(a);
}

#ifndef HAMILTON_PART
#define HAMILTON_PART -1
#endif

// Whether this build holds case `code` in float64 (or float32).
constexpr bool in_part(int code, bool is_double) {
  return HAMILTON_PART < 0 || HAMILTON_PART == 2 * code + (is_double ? 1 : 0);
}

template <typename T, int CASE>
int launch_case(int compensated, int per_member, const Args& a) {
  if constexpr (in_part(CASE, std::is_same<T, double>::value))
    return launch_modes<T, CASE>(compensated, per_member, a);
  else
    return -1;
}

template <typename T>
int dispatch(int code, int compensated, int per_member, const Args& a) {
  switch (code) {
    case 0: return launch_case<T, 0>(compensated, per_member, a);
    case 1: return launch_case<T, 1>(compensated, per_member, a);
    case 2: return launch_case<T, 2>(compensated, per_member, a);
    case 3: return launch_case<T, 3>(compensated, per_member, a);
    case 4: return launch_case<T, 4>(compensated, per_member, a);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Launches steps_per_call fused steps of case `code`'s (4 or 6, n, batch)
// state from state_in into state_out on the given stream, without
// synchronizing.  Cases: 0 Moebius n=20, 1 Moebius n=5, 2 L^-1 n=20, 3 L^-1
// n=5, 4 dense n=4.  dtype_code: 0 float32, 1 float64.  flags: bit 1
// compensated, bit 2 per-member table (bit 0, the chain's semiseparable
// flag of fused_step.cu, must be 0).  coef is the flat shared table, or the
// (L, batch) per-member one.  weights points to the n_weights (1 to 5)
// composition weights in host memory, read before this returns.  Returns 0,
// -1 when the combination is not instantiated (or not in this part), -2 for
// a bad argument, or cudaGetLastError()'s code.  Fourteen arguments, as the
// chain's entry.
int hamilton_chain_variant_step(int dtype_code, int code, int flags, const void* coef,
                                const void* state_in, void* state_out, long long batch,
                                double dt, int iters_p, int iters_q, int steps_per_call,
                                int n_weights, const double* weights, void* stream) {
  if (!valid_args(batch, iters_p, iters_q, steps_per_call, n_weights) || flags < 0 ||
      flags > 7 || (flags & 1) || coef == nullptr)
    return -2;
  Args a{coef, state_in, state_out, batch, dt, iters_p, iters_q, steps_per_call,
         {}, n_weights, static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < n_weights; ++k) a.weights[k] = weights[k];
  const int compensated = (flags >> 1) & 1, per_member = (flags >> 2) & 1;
  if (dtype_code == 0) return dispatch<float>(code, compensated, per_member, a);
  if (dtype_code == 1) return dispatch<double>(code, compensated, per_member, a);
  return -1;
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
