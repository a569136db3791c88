// Fused whole-step generalized Stormer-Verlet kernel for NVIDIA Hopper
// (sm_90a): the planar serial chain.
//
// Replaces the TPU kernel hamilton_tpu/ops/pallas_step.py::fused_stepper.kernel
// (launched by its _call through pl.pallas_call) for the serial chain.  One
// launch advances every ensemble member by steps_per_call dt-steps of the
// fused leapfrog under one of two policies of the chain's closed forms,
// SEMISEP (the O(n) semiseparable factorization, serial_chain_forms_on) and
// dense (the Cholesky of serial_chain_forms): the semiseparable form and the
// dense form at n = 2 on the one-thread step template step_member of
// fused_step.cuh (shared with the model families' kernel, family_step.cu),
// the dense form at n = 20 and 40 on G lanes a member (dense_lanes.cuh, on
// chain_lanes.cuh's lane template: its header says what bounds it and what
// its design does about it).  In float32 the within-step aux
// re-evaluations rotate the trig aux to first order (the reference's
// aux_shift); in float64 they re-evaluate it.
//
// What bounds the one-thread step on this card: latency.  Each member reads
// and writes 4 or 6 vectors of n values per launch (O(100) bytes in and out
// per member per 50 steps) against thousands of dependent flops and 2n-4n
// transcendentals per step, 16384 members are ~4 warps an SM, one a
// scheduler, so a launch lasts as long as one member's chain of steps; the
// semiseparable step is a chain of O(n) sequential scans, its factor with a
// square root and a reciprocal a link.  What the design does about it: one
// thread a member, everything over N unrolled at compile time so the
// per-member lists live in registers (the semiseparable form's at n = 20
// exceeds 255 registers and spills ~2 KB: it runs on the link split below),
// batch-minor
// x[i*B + b] loads and stores that coalesce, and (chain_forms.cuh):
//   - each link's sin and cos from one straight-line reduction, and the
//     factor's square roots and reciprocals straight-line, the library's
//     expansions without their branches to the slow paths (which serialized
//     them), bit for bit sinf, cosf, sqrtf and 1/x (csrc/libm_check.cu);
//     the library's functions only for a member with an input outside
//     their ranges;
//   - the semiseparable form's per-member table (3n entries) staged in
//     shared memory once a launch; the dense form's at n = 2 (6 entries,
//     shared or the member's column) in registers, read once a launch, with
//     the factor's first pivot (K_00 = C_00: its square root and reciprocal,
//     chain_forms.cuh's DenseChainTable) taken once a launch too;
//   - the dense form's p-half and q-refinement counts its callers use, (2,1)
//     and (3,1), as compile-time constants (fused_step.cuh's with_iters), so
//     their loops unroll; any other count read at run time.
// The semiseparable form at n = 20 runs, where WideRoute sends it, on
// semisep_wide.cuh's link split: a member's links on G lanes in G warps,
// each scan handed from lane to lane, a lane's vectors in registers (ten
// same-call pairs, PERF.md section 6).  On G lanes of one warp, as the L^-1
// form runs (chain_lanes.cuh: the factor in shared memory), this form had
// measured slower than one thread a member at every G from 1 to 8, because
// there every lane repeats the O(n) scans.  The dense form has no such
// scan: its O(n^3) factor and O(n^2) products split by rows, and on lanes it
// measured 0.63x the generated kernel at n = 20 and 0.18x the one-thread
// template (its loops rolled, the factor in local memory) at n = 40
// (PERF.md section 6).
//
// Build (no fast-math: it would reassociate the Kahan compensation away and
// swap sinf/cosf for approximations whose error shows in the drift):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_step.so fused_step.cu
// FMA contraction (nvcc's default) stays on; it changes rounding only.  The
// dense parts at n = 20 and 40 build with -fmad=false (kernels.PART_FLAGS),
// as the dense form at n = 4 in chain_variants.cu and the generated kernel,
// so that they round each product and sum as the plain version does (with
// FMA the velocities, good to cond(K) ulps, drift apart from the plain
// version's as n grows: at n = 40 the float32 semiseparable vdot_est read
// 0.33 of its largest magnitude off over one step).
// Parts 0 and 1 (the semiseparable form at n = 20, on the link split) keep
// the contraction and are held to chip_smoke.TOL; semisep_wide.cu builds the
// same link split without it.  Built as ten parts at once (kernels.PARTS):
// part 2*v + dtype_code, with -DHAMILTON_PART set to it, holds variant v (0
// semiseparable n=20, 1 semiseparable n=5, 2 dense n=2, 3 dense n=40 on
// lanes, 4 dense n=20 on lanes) in one dtype; without it, one library holds
// all.  The semiseparable chain at n = 40 runs on csrc/semisep_wide.cu (its
// member's working set on the chip), which measured 0.17x this template
// there (PERF.md section 6).

#include "dense_lanes.cuh"
#include "semisep_wide.cuh"

namespace {

template <typename T, int N, bool SEMISEP, bool COMP, bool PM, bool COMPOSED, int IP = 0,
          int IQ = 0>
__global__ void __launch_bounds__(kThreads)
    fused_step_kernel(const T* __restrict__ coef, const T* __restrict__ in,
                      T* __restrict__ out, long long batch,
                      const __grid_constant__ Substeps<T> subs, int iters_p,
                      int iters_q, int steps_per_call) {
  using P = ChainPolicy<T, N, SEMISEP>;
  constexpr int L = CoefLen<N, SEMISEP>::value;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (!SEMISEP) {
    // the dense form's table in registers: this member's column, or the
    // shared entries
    if (b >= batch) return;
    const DenseChainTable<T, L, PM> cf(PM ? coef + b : coef, PM ? batch : 1);
    step_member<T, P, COMP, COMPOSED, IP, IQ>(cf, in, out, batch, b, subs, iters_p, iters_q,
                                              steps_per_call);
  } else if constexpr (PM) {
    if (b >= batch) return;
    stage_column<T, L>(coef, batch, b);
    step_member<T, P, COMP, COMPOSED>(StagedColumn<T>{}, in, out, batch, b, subs, iters_p,
                                      iters_q, steps_per_call);
  } else {
    __shared__ T cf[L];
    for (int k = threadIdx.x; k < L; k += blockDim.x) cf[k] = coef[k];
    __syncthreads();
    if (b >= batch) return;
    step_member<T, P, COMP, COMPOSED>(SharedTable<T>{cf}, in, out, batch, b, subs,
                                      iters_p, iters_q, steps_per_call);
  }
}

// Whether the variant at (N, SEMISEP) runs on the dense lane step
// (dense_lanes.cuh) rather than the one-thread step_member.
template <int N, bool SEMISEP>
constexpr bool kDenseOnLanes = !SEMISEP && N >= 20;

// The semiseparable chain at n = 20 on semisep_wide.cuh's link split, in
// float (F) and double (D), every table mode and composition: the lanes a
// member (0: the one-thread step_member); the links a scan unrolls (0: all
// of a lane's, its vectors in registers).  The fastest of
// scripts/k1_route_ab.py's ten same-call pairs (PERF.md section 6), which
// builds copies of the source with others: on an H100 at 16384 members, 50
// steps, G = 2 read 0.83x the one-thread template's time (float, Kahan
// (2,0)), 0.79x (its per-member tables) and 0.84x (suzuki4); in double,
// where the one-thread build spills 23 KB, 0.093x, 0.33x and 0.094x.
constexpr int kWide20LanesF = 2, kWide20LanesD = 2;
constexpr int kWide20Unroll = 0;

// The link split's lanes a member (G) and unroll (U) for the variant at (N,
// SEMISEP); G = 0 where it runs on the one-thread template.
template <typename T, int N, bool SEMISEP>
struct WideRoute {
  static constexpr bool kFloat = std::is_same<T, float>::value;
  static constexpr int G = SEMISEP && N == 20 ? (kFloat ? kWide20LanesF : kWide20LanesD) : 0;
  static constexpr int U = kWide20Unroll;
};

template <typename T, int N, bool SEMISEP, bool COMP, bool PM, bool COMPOSED>
int launch(const Args& a) {
  using W = WideRoute<T, N, SEMISEP>;
  if constexpr (kDenseOnLanes<N, SEMISEP>) {
    return lane_launch<T, N, DenseLanes<T, N>::value, COMP, PM, COMPOSED, kDenseForm>(a);
  } else if constexpr (W::G > 0) {
    return wide_launch<T, N, W::G, W::U, COMP, PM, COMPOSED>(a);
  } else {
    unsigned bytes;  // the semiseparable form's per-member table, staged
    const cudaError_t attr =
        staged_prepare<T, CoefLen<N, true>::value, PM && SEMISEP,
                       fused_step_kernel<T, N, SEMISEP, COMP, PM, COMPOSED>>(&bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const long long blocks = (a.batch + kThreads - 1) / kThreads;
    auto go = [&](auto it) {
      using I = decltype(it);
      fused_step_kernel<T, N, SEMISEP, COMP, PM, COMPOSED, I::kP, I::kQ>
          <<<static_cast<unsigned int>(blocks), kThreads, bytes, a.stream>>>(
              static_cast<const T*>(a.coef), static_cast<const T*>(a.in),
              static_cast<T*>(a.out), a.batch,
              make_substeps<T>(a.weights, a.n_weights, a.dt), a.iters_p, a.iters_q,
              a.steps_per_call);
      return static_cast<int>(cudaGetLastError());
    };
    if constexpr (SEMISEP) {
      return go(IterCounts<0, 0>{});
    } else {  // the dense form with the callers' counts as constants
      return with_iters(a.iters_p, a.iters_q, go);
    }
  }
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

// The layout (kernel_layout's out) of variant V's kernel in these modes, not
// composed; 0 blocks an SM where this build does not hold it.
template <typename T, int V, int N, bool SEMISEP>
int layout_variant(int compensated, int per_member, int* out) {
  constexpr bool held = in_part(V, std::is_same<T, double>::value);
  if constexpr (kDenseOnLanes<N, SEMISEP>) {
    return lane_layout<T, N, DenseLanes<T, N>::value, held, kDenseForm>(compensated, per_member,
                                                                        out);
  } else {
    auto one = [out](auto comp, auto pm) {
      constexpr bool kComp = decltype(comp)::value, kPm = decltype(pm)::value;
      using W = WideRoute<T, N, SEMISEP>;
      if constexpr (W::G > 0) {
        return wide_layout<T, N, W::G, W::U, kComp, kPm, held>(out);
      } else {
        out[0] = 1;
        out[1] = kThreads;
        out[2] = kPm && SEMISEP ? sizeof(T) * CoefLen<N, true>::value * kThreads : 0;
        out[3] = 0;
        if constexpr (held) {
          constexpr auto kernel = fused_step_kernel<T, N, SEMISEP, kComp, kPm, false>;
          unsigned bytes;
          const cudaError_t attr =
              staged_prepare<T, CoefLen<N, true>::value, kPm && SEMISEP, kernel>(&bytes);
          return attr != cudaSuccess ? static_cast<int>(attr)
                                     : kernel_layout(kernel, 1, kThreads, bytes, out);
        } else {
          return 0;
        }
      }
    };
    using Y = std::true_type;
    using No = std::false_type;
    if (compensated) return per_member ? one(Y{}, Y{}) : one(Y{}, No{});
    return per_member ? one(No{}, Y{}) : one(No{}, No{});
  }
}

template <int V, int N, bool SEMISEP>
struct Variant {
  static constexpr int kV = V, kN = N;
  static constexpr bool kSemisep = SEMISEP;
};

// f(Variant<v, N, semiseparable>{}) for the instantiated (variant, N) set,
// -1 for another; KERNEL_INSTANTIATIONS in hamilton_tpu_torch/ops/
// fused_step.py lists the same pairs.
template <class F>
int dispatch(int n, int semiseparable, F&& f) {
  if (semiseparable && n == 20) return f(Variant<0, 20, true>{});
  if (semiseparable && n == 5) return f(Variant<1, 5, true>{});
  if (!semiseparable && n == 2) return f(Variant<2, 2, false>{});
  if (!semiseparable && n == 40) return f(Variant<3, 40, false>{});
  if (!semiseparable && n == 20) return f(Variant<4, 20, false>{});
  return -1;
}

template <typename T>
int launch_dispatch(int n, int semiseparable, int compensated, int per_member,
                    const Args& a) {
  return dispatch(n, semiseparable, [&](auto v) {
    using V = decltype(v);
    return launch_variant<T, V::kV, V::kN, V::kSemisep>(compensated, per_member, a);
  });
}

template <typename T>
int layout_dispatch(int n, int semiseparable, int compensated, int per_member, int* out) {
  return dispatch(n, semiseparable, [&](auto v) {
    using V = decltype(v);
    return layout_variant<T, V::kV, V::kN, V::kSemisep>(compensated, per_member, out);
  });
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
    return launch_dispatch<float>(n, semiseparable, compensated, per_member, a);
  if (dtype_code == 1)
    return launch_dispatch<double>(n, semiseparable, compensated, per_member, a);
  return -1;
}

// The layout of the kernel that launches a (dtype_code, n, flags) step (flags
// as above) into out[0..4): lanes a member (1: one thread a member),
// threads a block, dynamic shared bytes a block, and the blocks an SM the
// card holds at once of its instantiation in these modes, not composed
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 where this part does not
// hold it).  Returns 0, -1 for a combination not instantiated, -2 for bad
// flags, or a CUDA error's code.
int hamilton_lane_layout(int dtype_code, int n, int flags, int* out) {
  if (flags < 0 || flags > 7 || out == nullptr) return -2;
  const int semiseparable = flags & 1, compensated = (flags >> 1) & 1,
            per_member = (flags >> 2) & 1;
  if (dtype_code == 0)
    return layout_dispatch<float>(n, semiseparable, compensated, per_member, out);
  if (dtype_code == 1)
    return layout_dispatch<double>(n, semiseparable, compensated, per_member, out);
  return -1;
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
