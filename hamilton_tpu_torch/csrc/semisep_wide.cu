// Fused whole-step generalized Stormer-Verlet kernel for NVIDIA Hopper
// (sm_90a): the planar serial chain's semiseparable form at n = 40 (the
// reference's stress chain), its member's working set kept on the chip.
//
// Replaces the TPU kernel hamilton_tpu/ops/pallas_step.py::fused_stepper.kernel
// (launched by its _call through pl.pallas_call) traced with
// serial_chain_forms_on (pallas_step.py:991) at n = 40, on semisep_wide.cuh's
// link-split step (its header says what bounds it and what the design does
// about it).  At n = 40 a member's vectors, ~3.5 KB in float, do not fit a
// lane's registers: they live in dynamic shared memory (1600 B a member in
// float, 128 members a block, one block and 8 warps an SM: 16384 members in
// one wave; in double its aux too, 64 members a block: two waves), and the
// scans' loops roll, unrolled a few links at a time (kScanUnrollF,
// kScanUnrollD); loading a chunk of links ahead explicitly, double buffered,
// measured slower (PERF.md section 6).  A lane waits at the barriers ~0.05 %
// of its step.

// Build: as fused_step.cu (no fast-math), with -fmad=false
// (kernels.SOURCE_FLAGS): with FMA the velocities, good to cond(K) ulps,
// drifted apart from the plain version's at n = 40 (the float32 vdot_est
// 0.33 of its largest magnitude off over one step).  Built as two parts at
// once (kernels.PARTS): part dtype_code, with -DHAMILTON_PART set to it,
// holds one dtype's instantiations; without it, one library holds both.

#include <type_traits>

#include "semisep_wide.cuh"

namespace {

// The chain's size this source holds.
constexpr int kWideN = 40;

// The lanes a member and the links a scan's loop unrolls at a time, in
// float (F) and double (D): the fastest of scripts/k1_route_ab.py's sweep
// (PERF.md section 6), which builds copies of the source with others.  A
// lane holds its links' q, p, v0 and q1 in registers, so float64 needs
// G >= 2 (WideShape).
constexpr int kWideLanesF = 2, kWideLanesD = 4;
constexpr int kScanUnrollF = 4, kScanUnrollD = 2;

// The member's layout in T.
template <typename T>
using WideShapeOf = std::conditional_t<std::is_same<T, double>::value,
                                       WideShape<T, kWideN, kWideLanesD, kScanUnrollD>,
                                       WideShape<T, kWideN, kWideLanesF, kScanUnrollF>>;

#ifndef HAMILTON_PART
#define HAMILTON_PART -1
#endif

// Whether this build holds the float64 (or float32) instantiations.
constexpr bool in_part(bool is_double) {
  return HAMILTON_PART < 0 || HAMILTON_PART == (is_double ? 1 : 0);
}

// f(comp, pm) with the modes as types.
template <class F>
int by_modes(int compensated, int per_member, F&& f) {
  using Y = std::true_type;
  using No = std::false_type;
  if (compensated) return per_member ? f(Y{}, Y{}) : f(Y{}, No{});
  return per_member ? f(No{}, Y{}) : f(No{}, No{});
}

template <typename T>
int launch_dtype(int compensated, int per_member, const Args& a) {
  using Sh = WideShapeOf<T>;
  if constexpr (in_part(std::is_same<T, double>::value)) {
    return by_modes(compensated, per_member, [&](auto comp, auto pm) {
      constexpr bool kComp = decltype(comp)::value, kPm = decltype(pm)::value;
      return a.n_weights > 1 ? wide_launch<T, kWideN, Sh::G, Sh::U, kComp, kPm, true>(a)
                             : wide_launch<T, kWideN, Sh::G, Sh::U, kComp, kPm, false>(a);
    });
  } else {
    return -1;
  }
}

// The layout (hamilton_lane_layout's out) in these modes, not composed; 0
// blocks an SM where this build does not hold the dtype.
template <typename T>
int layout_dtype(int compensated, int per_member, int* out) {
  using Sh = WideShapeOf<T>;
  return by_modes(compensated, per_member, [&](auto comp, auto pm) {
    return wide_layout<T, kWideN, Sh::G, Sh::U, decltype(comp)::value,
                       decltype(pm)::value, in_part(std::is_same<T, double>::value)>(out);
  });
}

}  // namespace

extern "C" {

// Launches steps_per_call fused steps of a (4 or 6, 40, batch) state of the
// semiseparable chain from state_in into state_out on the given stream,
// without synchronizing; the arguments as hamilton_fused_step's
// (fused_step.cu), n = 40 and flags bit 0 (semiseparable) set.  Returns 0, -1
// when the combination is not instantiated (or not in this part), -2 for a
// bad argument, or cudaGetLastError()'s code.
int hamilton_semisep_wide_step(int dtype_code, int n, int flags, const void* coef,
                               const void* state_in, void* state_out, long long batch,
                               double dt, int iters_p, int iters_q, int steps_per_call,
                               int n_weights, const double* weights, void* stream) {
  if (!valid_args(batch, iters_p, iters_q, steps_per_call, n_weights) || flags < 0 ||
      flags > 7)
    return -2;
  if (n != kWideN || !(flags & 1)) return -1;
  Args a{coef, state_in, state_out, batch, dt, iters_p, iters_q, steps_per_call,
         {}, n_weights, static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < n_weights; ++k) a.weights[k] = weights[k];
  const int compensated = (flags >> 1) & 1, per_member = (flags >> 2) & 1;
  if (dtype_code == 0) return launch_dtype<float>(compensated, per_member, a);
  if (dtype_code == 1) return launch_dtype<double>(compensated, per_member, a);
  return -1;
}

// The layout of the kernel of a (dtype_code, n, flags) step (flags as
// above) into out[0..4): lanes a member, threads a block, dynamic shared
// bytes a block, and the blocks an SM the card holds at once of its
// instantiation in these modes, not composed
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 where this part does not
// hold it).  Returns 0, -1 for a combination not instantiated, -2 for bad
// flags, or a CUDA error's code.
int hamilton_lane_layout(int dtype_code, int n, int flags, int* out) {
  if (flags < 0 || flags > 7 || out == nullptr) return -2;
  if (n != kWideN || !(flags & 1)) return -1;
  const int compensated = (flags >> 1) & 1, per_member = (flags >> 2) & 1;
  if (dtype_code == 0) return layout_dtype<float>(compensated, per_member, out);
  if (dtype_code == 1) return layout_dtype<double>(compensated, per_member, out);
  return -1;
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
