// Fused whole-step generalized Stormer-Verlet kernel for NVIDIA Hopper
// (sm_90a): the planar serial chain's Moebius and L^-1 forms, and its dense
// forms at n = 4.
//
// Replaces the TPU kernel hamilton_tpu/ops/pallas_step.py::fused_stepper.kernel
// (launched by its _call through pl.pallas_call) traced with the chain's
// other closed forms, serial_chain_forms_mobius (pallas_step.py:1194) and
// serial_chain_forms_linv (:1329), and with serial_chain_forms at n = 4 (the
// chain that examples/fit_masses.py differentiates).  The L^-1 form runs on
// the lane step template lane_step of chain_lanes.cuh; the Moebius and
// dense forms on the one-thread template step_member of fused_step.cuh with
// the chain's straight-line sin/cos, square roots and reciprocals
// (fused_step.cu says why): the Moebius form with its table (5n entries)
// staged in shared memory, the dense form at n = 4 (chain_forms.cuh's dense
// policy) with its 20 in registers and its callers' counts as constants, as
// fused_step.cu's dense form at n = 2.  The two forms new here:
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
// What bounds them on this card: latency and issue.  Per member a launch
// moves O(100) bytes against thousands of dependent flops, and 16384
// members are 124 a streaming multiprocessor: one thread a member leaves 4
// warps an SM, one a scheduler.  L^-1's factor, 210 values at n = 20, does
// not fit a thread's registers beside the state, and its solves are O(n^2)
// work that splits: it runs a member on G lanes of a warp (G = 4 at n = 20,
// 2 at n = 5), 16 warps an SM in one wave at <= 128 registers, the factor
// and the vectors the lanes exchange in shared memory.  The Moebius form's
// work is O(n) sequential scans that every lane would repeat: on lanes it
// ran slower than on one thread at every G (PERF.md section 6).
//
// Build: as fused_step.cu (no fast-math), with -fmad=false: no FMA
// contraction, so each product and sum rounds as in the plain version
// (kernels.SOURCE_FLAGS says why).  Built as ten parts at once
// (kernels.PARTS): part 2*code + dtype_code, compiled with -DHAMILTON_PART
// set to it, holds one case in one dtype; without it, one library holds all.

#include <type_traits>

#include "chain_lanes.cuh"

namespace {

// The lanes a member of the L^-1 form at n > 8 and at n <= 8: the fastest
// of the sweep of scripts/lane_sweep.py (PERF.md section 6), which builds
// copies of this source with others.
constexpr int kLinvLanesLong = 4, kLinvLanesShort = 2;

// ---- the Moebius factor (serial_chain_forms_mobius) -----------------------

// The semiseparable factor's entries (z_x, z_y, 1/d, u_x, u_y per link in
// tip-to-base order) from the Moebius chain.  Table entries: l_i at i,
// m_i at 3N + i, 1/m_i at 4N + i.
template <bool STRAIGHT, typename T, int N, class C>
__device__ __forceinline__ bool mobius_pass(const C& cf, const T (&s)[N], const T (&c)[N],
                                            SemisepFactor<T, N>& f) {
  bool ok = true;
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
    const T inv_d = line_rcp<STRAIGHT>(line_sqrt<STRAIGHT>(d2, &ok), &ok);
    f.zx[a] = yx * inv_d;
    f.zy[a] = yy * inv_d;
    f.id[a] = inv_d;
    f.ux[a] = ux[a];
    f.uy[a] = uy[a];
  }
  return ok;
}

// The Moebius factor: in float with the straight-line square roots and
// reciprocals (fused_step.cuh's line_sqrt), again with the library's
// where an input left their range.
template <typename T, int N, class C>
__device__ __forceinline__ void mobius_factor(const C& cf, const T (&s)[N], const T (&c)[N],
                                              SemisepFactor<T, N>& f) {
  if constexpr (std::is_same<T, float>::value) {
    if (!mobius_pass<true>(cf, s, c, f)) mobius_pass<false>(cf, s, c, f);
  } else {
    mobius_pass<false>(cf, s, c, f);
  }
}

// ---- the policies ----------------------------------------------------------

// The chain's aux, shift, semiseparable solves and dH/dq with the Moebius
// factor (the one-thread step); L, the flat table length.
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

// The dense forms (the in-register Cholesky of serial_chain_forms).
template <typename T, int N_>
struct DenseChainPolicy : ChainPolicy<T, N_, false> {
  static constexpr int L = CoefLen<N_, false>::value;
};

// The instantiated cases; KERNEL_INSTANTIATIONS in
// hamilton_tpu_torch/ops/fused_step.py lists the same codes.  G is the
// lanes a member of an L^-1 case (the lane kernel of chain_lanes.cuh), 0
// for a case that runs on step_member under the one-thread policy P;
// kStaged, whether that kernel stages its table in shared memory (Moebius:
// 5n entries; the dense form at n = 4 holds its 20 in registers).
template <typename T, int CASE>
struct Variant;
template <typename T>
struct Variant<T, 0> {
  using P = MobiusPolicy<T, 20>;
  static constexpr int N = 20, G = 0;
  static constexpr bool kStaged = true;
};
template <typename T>
struct Variant<T, 1> {
  using P = MobiusPolicy<T, 5>;
  static constexpr int N = 5, G = 0;
  static constexpr bool kStaged = true;
};
template <typename T>
struct Variant<T, 2> {
  static constexpr int N = 20, G = kLinvLanesLong;
};
template <typename T>
struct Variant<T, 3> {
  static constexpr int N = 5, G = kLinvLanesShort;
};
template <typename T>
struct Variant<T, 4> {
  using P = DenseChainPolicy<T, 4>;
  static constexpr int N = 4, G = 0;
  static constexpr bool kStaged = false;
};

template <typename T, int CASE, bool COMP, bool PM, bool COMPOSED, int IP = 0, int IQ = 0>
__global__ void __launch_bounds__(kThreads)
    chain_variant_kernel(const T* __restrict__ coef, const T* __restrict__ in,
                         T* __restrict__ out, long long batch,
                         const __grid_constant__ Substeps<T> subs, int iters_p,
                         int iters_q, int steps_per_call) {
  using P = typename Variant<T, CASE>::P;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (!Variant<T, CASE>::kStaged) {
    // the dense form's table in registers: this member's column, or the
    // shared entries
    if (b >= batch) return;
    const DenseChainTable<T, P::L, PM> cf(PM ? coef + b : coef, PM ? batch : 1);
    step_member<T, P, COMP, COMPOSED, IP, IQ>(cf, in, out, batch, b, subs, iters_p, iters_q,
                                              steps_per_call);
  } else if constexpr (PM) {
    if (b >= batch) return;
    stage_column<T, P::L>(coef, batch, b);
    step_member<T, P, COMP, COMPOSED>(StagedColumn<T>{}, in, out, batch, b, subs, iters_p,
                                      iters_q, steps_per_call);
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
  using V = Variant<T, CASE>;
  if constexpr (V::G > 0) {
    return lane_launch<T, V::N, V::G, COMP, PM, COMPOSED, kLinvForm>(a);
  } else {
    unsigned bytes;  // Moebius's per-member table, staged
    const cudaError_t attr = staged_prepare<T, V::P::L, PM && V::kStaged,
                                            chain_variant_kernel<T, CASE, COMP, PM, COMPOSED>>(
        &bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const long long blocks = (a.batch + kThreads - 1) / kThreads;
    auto go = [&](auto it) {
      using I = decltype(it);
      chain_variant_kernel<T, CASE, COMP, PM, COMPOSED, I::kP, I::kQ>
          <<<static_cast<unsigned int>(blocks), kThreads, bytes, a.stream>>>(
              static_cast<const T*>(a.coef), static_cast<const T*>(a.in),
              static_cast<T*>(a.out), a.batch,
              make_substeps<T>(a.weights, a.n_weights, a.dt), a.iters_p, a.iters_q,
              a.steps_per_call);
      return static_cast<int>(cudaGetLastError());
    };
    if constexpr (V::kStaged) {
      return go(IterCounts<0, 0>{});
    } else {  // the dense form with the callers' counts as constants
      return with_iters(a.iters_p, a.iters_q, go);
    }
  }
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

// The layout (kernel_layout's out) of case CASE's kernel in these modes, not
// composed; 0 blocks an SM where this build does not hold it.
template <typename T, int CASE>
int layout_case(int compensated, int per_member, int* out) {
  using V = Variant<T, CASE>;
  constexpr bool held = in_part(CASE, std::is_same<T, double>::value);
  if constexpr (V::G > 0) {
    return lane_layout<T, V::N, V::G, held, kLinvForm>(compensated, per_member, out);
  } else {
    constexpr int L = V::P::L;
    out[0] = 1;
    out[1] = kThreads;
    out[2] = per_member && V::kStaged ? sizeof(T) * L * kThreads : 0;
    out[3] = 0;
    if constexpr (held) {
      auto one = [out](auto comp, auto pm) {
        constexpr bool kComp = decltype(comp)::value, kPm = decltype(pm)::value;
        constexpr auto kernel = chain_variant_kernel<T, CASE, kComp, kPm, false>;
        unsigned bytes;
        const cudaError_t attr = staged_prepare<T, L, kPm && V::kStaged, kernel>(&bytes);
        return attr != cudaSuccess ? static_cast<int>(attr)
                                   : kernel_layout(kernel, 1, kThreads, bytes, out);
      };
      using Y = std::true_type;
      using No = std::false_type;
      if (compensated) return per_member ? one(Y{}, Y{}) : one(Y{}, No{});
      return per_member ? one(No{}, Y{}) : one(No{}, No{});
    }
    return 0;
  }
}

// f(std::integral_constant<int, code>{}) for an instantiated case, -1 for
// another.
template <class F>
int dispatch(int code, F&& f) {
  switch (code) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return -1;
  }
}

template <typename T>
int launch_dispatch(int code, int compensated, int per_member, const Args& a) {
  return dispatch(code, [&](auto c) {
    return launch_case<T, decltype(c)::value>(compensated, per_member, a);
  });
}

template <typename T>
int layout_dispatch(int code, int compensated, int per_member, int* out) {
  return dispatch(code, [&](auto c) {
    return layout_case<T, decltype(c)::value>(compensated, per_member, out);
  });
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
  if (dtype_code == 0) return launch_dispatch<float>(code, compensated, per_member, a);
  if (dtype_code == 1) return launch_dispatch<double>(code, compensated, per_member, a);
  return -1;
}

// The layout of the kernel that launches case `code` in dtype_code into
// out[0..4): lanes a member (1 for the one-thread kernel), threads a block,
// dynamic shared bytes a block, and the blocks an SM the card holds at once
// of its instantiation with `flags` (bits as above), not composed:
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, 0 where this part does not
// hold that case.  Returns 0, -1 for another case or dtype, -2 for bad
// flags, or a CUDA error's code.
int hamilton_lane_layout(int dtype_code, int code, int flags, int* out) {
  if (flags < 0 || flags > 7 || (flags & 1) || out == nullptr) return -2;
  const int compensated = (flags >> 1) & 1, per_member = (flags >> 2) & 1;
  if (dtype_code == 0) return layout_dispatch<float>(code, compensated, per_member, out);
  if (dtype_code == 1) return layout_dispatch<double>(code, compensated, per_member, out);
  return -1;
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
