// Fused whole-step generalized Stormer-Verlet kernel for NVIDIA Hopper
// (sm_90a): the bundled model families.
//
// Replaces the TPU kernel hamilton_tpu/ops/pallas_step.py::fused_stepper.kernel
// (launched by its _call through pl.pallas_call) for the families whose
// closed forms sit beside their models in hamilton_tpu/models/*.py:
// spherical pendulum, two-body, room, spring, ellipse and Bezier.  Pallas
// traces a family's Python forms into the kernel; here each family's forms
// are written out as a struct (aux, k_at, dhdq over the coefficient entries
// cf[k], in the operation order of the Python forms) and run by the step
// template of fused_step.cuh through one generic dense policy: the
// in-register Cholesky over k_at in the order of the reference's
// pallas_solve.py::_chol_entries and _solve_entries.  None of these families
// shifts its aux: every within-step aux evaluation is fresh.
//
// Python-float constants of the forms (the walls' beta = log 9 / width and
// height*beta) are folded in double, as Python folds them, and rounded once
// to T where they meet a member value, as JAX rounds a Python scalar against
// a tile.  Bezier's shared table holds each entry times its binomial,
// folded in double (the wrapper builds it: FusedForms.kernel_consts); its
// per-member path multiplies T(binomial) * entry, as the forms do there.
// exp is expf/exp without fast-math: far from a wall it overflows to inf,
// and 1/(1+inf) = 0 stays exact (inf is outside rcp_fast's range, so the
// reciprocal takes the library's path there).
//
// What bounds it on this card: latency.  At n <= 3 a member-step is a few
// hundred dependent flops and 1-4 transcendentals against 16-72 bytes of
// state per member per launch; 16384 members are ~4 warps per SM, one a
// scheduler, so a launch lasts as long as one member's chain of steps.  The
// design shortens that chain.  One thread per member, everything unrolled at
// compile time.  In float each aux, factor and dH/dq runs as one
// straight-line pass (straight_or_library): the sine and cosine of an angle
// from one range reduction, the square roots and reciprocals of the factor,
// the walls' and two-body's 1/x, each the library's fast path without its
// branch (csrc/libm_fast.cuh, equal bit for bit, csrc/libm_check.cu), so a
// member's walls and pairs interleave; the pass runs again with the
// library's functions only where an input left their range.  The table sits
// in registers, read once a launch (RegTable); the factor and aux stay in
// registers across the steps of a launch; loads and stores are batch-minor
// and coalesce.  The aux stays fresh at every within-step point, as in the
// reference: two sine-cosine pairs a step at (2,0).  A launch of 50 steps is
// short enough that the host's issue cost (~20 us) sits near it.
//
// Build: as fused_step.cu (no fast-math), with -fmad=false: no FMA
// contraction, so each product and sum rounds as in the plain version
// (kernels.SOURCE_FLAGS says why).

#include "fused_step.cuh"

namespace {

__host__ __device__ constexpr int binomial(int n, int k) {
  int r = 1;
  for (int i = 1; i <= k; ++i) r = r * (n - k + i) / i;
  return r;
}

// The logistic 1/(1 + exp(-z)) of a pass (fused_step.cuh's line_rcp).
template <bool STRAIGHT, typename T>
__device__ __forceinline__ T sigma(T z, bool* ok) {
  return line_rcp<STRAIGHT>(T(1) + dexp(T(0) - z), ok);
}

// The logistic walls' constants, as Python computes them in double:
// beta = log(9)/width and height*beta.
constexpr double kRoomBeta = 0x1.5f8e5195843cdp+4;       // log(9)/0.1 = 21.972245773362193
constexpr double kRoomHb = 0x1.b771e5fae54c0p+7;         // 10*beta = 219.72245773362192
constexpr double kSpringBeta = 0x1.5f8e5195843cdp+4;     // log(9)/0.1
constexpr double kSpringHb = 0x1.12a72fbccf4f8p+9;       // 25*beta = 549.3061443340548
constexpr double kBezierBeta = 0x1.5f8e5195843cdp+5;     // log(9)/0.05 = 43.944491546724386
constexpr double kBezierHb = 0x1.b771e5fae54c0p+7;       // 5*beta = 219.72245773362192

// ---- the families' closed forms --------------------------------------------
// Each: N, NAUX, the table length L, and aux / k_at / dhdq over the
// coefficient accessor cf (RegTable), in the Python forms' operation order.
// k_at(i, j) is consulted for j <= i only.  aux and dhdq are passes
// (STRAIGHT, ok: fused_step.cuh's straight_or_library) where they take a
// sine and cosine or a reciprocal.

// models/spherical.py: table (m, g*m); aux (sin th, cos th); K = diag(m, m s^2).
template <typename T>
struct Spherical {
  static constexpr int N = 2, NAUX = 2, L = 2;
  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void aux(const C&, const T (&q)[N], T (&a)[NAUX],
                                             bool* ok) {
    line_sincos<STRAIGHT>(q[0], &a[0], &a[1], ok);
  }
  template <class C>
  static __device__ __forceinline__ T k_at(const C& cf, const T (&a)[NAUX], const T (&)[N],
                                           int i, int j) {
    if (i == 0 && j == 0) return cf[0];
    if (i == 1 && j == 1) return cf[0] * (a[0] * a[0]);
    return T(0);
  }
  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void dhdq(const C& cf, const T (&a)[NAUX], const T (&)[N],
                                              const T (&w)[N], T (&out)[N], bool*) {
    const T s = a[0], c = a[1];
    out[0] = cf[1] * s - cf[0] * (s * c) * (w[1] * w[1]);
    out[1] = T(0);
  }
};

// models/two_body.py: table (mu, m1*m2); aux 1/r; K = diag(mu, mu r^2).
template <typename T>
struct TwoBody {
  static constexpr int N = 2, NAUX = 1, L = 2;
  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void aux(const C&, const T (&q)[N], T (&a)[NAUX],
                                             bool* ok) {
    a[0] = line_rcp<STRAIGHT>(q[0], ok);
  }
  template <class C>
  static __device__ __forceinline__ T k_at(const C& cf, const T (&)[NAUX], const T (&q)[N],
                                           int i, int j) {
    if (i == 0 && j == 0) return cf[0];
    if (i == 1 && j == 1) return cf[0] * (q[0] * q[0]);
    return T(0);
  }
  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void dhdq(const C& cf, const T (&a)[NAUX], const T (&q)[N],
                                              const T (&w)[N], T (&out)[N], bool*) {
    const T inv_r = a[0];
    out[0] = cf[1] * (inv_r * inv_r) - cf[0] * q[0] * (w[1] * w[1]);
    out[1] = T(0);
  }
};

// -lo'(v) + hi'(v) for a pair of logistic walls at v = -pos and v = +pos.
template <bool STRAIGHT, typename T>
__device__ __forceinline__ T wall_grad(T v, T pos, double beta, double hb_d, bool* ok) {
  const T sl = sigma<STRAIGHT>(T(beta) * (v + pos), ok);
  const T sh = sigma<STRAIGHT>(T(beta) * (v - pos), ok);
  const T hb = T(hb_d);
  return hb * (sh * (T(1) - sh)) - hb * (sl * (T(1) - sl));
}

// models/room.py: no table, no aux; K = I; dH/dq = the walls plus gravity 2 in y.
template <typename T>
struct Room {
  static constexpr int N = 2, NAUX = 0, L = 0;
  static constexpr bool kConstantK = true;
  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void aux(const C&, const T (&)[N], T (&)[1], bool*) {}
  template <class C>
  static __device__ __forceinline__ T k_at(const C&, const T (&)[1], const T (&)[N], int i,
                                           int j) {
    return i == j ? T(1) : T(0);
  }
  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void dhdq(const C&, const T (&)[1], const T (&q)[N],
                                              const T (&)[N], T (&out)[N], bool* ok) {
    out[0] = wall_grad<STRAIGHT>(q[0], T(2), kRoomBeta, kRoomHb, ok);
    out[1] = T(2) + wall_grad<STRAIGHT>(q[1], T(1), kRoomBeta, kRoomHb, ok);
  }
};

// models/spring.py: table (mB + mW, mW, k, mB); aux (sin th, cos th) of q[2];
// K with its structural zero K_21.
template <typename T>
struct Spring {
  static constexpr int N = 3, NAUX = 2, L = 4;
  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void aux(const C&, const T (&q)[N], T (&a)[NAUX],
                                             bool* ok) {
    line_sincos<STRAIGHT>(q[2], &a[0], &a[1], ok);
  }
  template <class C>
  static __device__ __forceinline__ T k_at(const C& cf, const T (&a)[NAUX], const T (&q)[N],
                                           int i, int j) {
    const T s = a[0], c = a[1];
    const T opx = T(1) + q[1];
    if (i == 0 && j == 0) return cf[0];
    if (i == 1 && j == 0) return cf[1] * s;
    if (i == 1 && j == 1) return cf[1];
    if (i == 2 && j == 0) return cf[1] * (opx * c);
    if (i == 2 && j == 2) return cf[1] * (opx * opx);
    return T(0);
  }
  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void dhdq(const C& cf, const T (&a)[NAUX], const T (&q)[N],
                                              const T (&w)[N], T (&out)[N], bool* ok) {
    const T s = a[0], c = a[1];
    const T opx = T(1) + q[1];
    out[0] = wall_grad<STRAIGHT>(q[0], T(1.5), kSpringBeta, kSpringHb, ok);
    out[1] = cf[2] * q[1] - cf[3] * c - cf[1] * (c * (w[0] * w[2]) + opx * (w[2] * w[2]));
    out[2] = cf[3] * (opx * s) - cf[1] * (w[0] * (c * w[1] - (opx * s) * w[2]));
  }
};

// models/ellipse.py: table (m a^2, m b^2, g m b, m (b^2 - a^2)); aux (sin, cos).
template <typename T>
struct Ellipse {
  static constexpr int N = 1, NAUX = 2, L = 4;
  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void aux(const C&, const T (&q)[N], T (&a)[NAUX],
                                             bool* ok) {
    line_sincos<STRAIGHT>(q[0], &a[0], &a[1], ok);
  }
  template <class C>
  static __device__ __forceinline__ T k_at(const C& cf, const T (&a)[NAUX], const T (&)[N],
                                           int, int) {
    const T s = a[0], c = a[1];
    return cf[0] * (c * c) + cf[1] * (s * s);
  }
  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void dhdq(const C& cf, const T (&a)[NAUX], const T (&)[N],
                                              const T (&w)[N], T (&out)[N], bool*) {
    const T s = a[0], c = a[1];
    out[0] = cf[2] * s - cf[3] * ((s * c) * (w[0] * w[0]));
  }
};

// models/bezier.py with DEG + 1 control points: the table holds the
// first-derivative control points (2 DEG entries) and, for DEG >= 2, the
// second's (2 (DEG - 1)); aux (x', y', x'', y'') in Bernstein form; K = x'^2 + y'^2.
template <typename T, int DEG>
struct Bezier {
  static constexpr int N = 1, NAUX = 4, L = 2 * DEG + (DEG >= 2 ? 2 * (DEG - 1) : 0);

  // Entry k with its binomial c: folded in the shared table, T(c) * v per member.
  template <class C>
  static __device__ __forceinline__ T weighted(const C& cf, int k, int c) {
    if constexpr (C::kPerMember) {
      return T(static_cast<double>(c)) * cf[k];
    } else {
      return cf[k];
    }
  }

  // sum_i C(D,i) (1-t)^(D-i) t^i (x_i, y_i) over entries BASE + 2i (+1).
  template <int D, int BASE, class C>
  static __device__ __forceinline__ void bernstein(const C& cf, T t, T one_t, T& x, T& y) {
    T tp[D + 1], up[D + 1];  // t^i and (1-t)^i by repeated products, i >= 1
    T cur = t;
#pragma unroll
    for (int i = 1; i <= D; ++i) {
      tp[i] = cur;
      cur = cur * t;
    }
    cur = one_t;
#pragma unroll
    for (int i = 1; i <= D; ++i) {
      up[i] = cur;
      cur = cur * one_t;
    }
    T term[2][D + 1];
#pragma unroll
    for (int i = 0; i <= D; ++i) {
#pragma unroll
      for (int off = 0; off < 2; ++off) {
        T w = weighted(cf, BASE + 2 * i + off, binomial(D, i));
        if (i > 0) w = w * tp[i];
        if (D - i > 0) w = w * up[D - i];
        term[off][i] = w;
      }
    }
    x = term[0][0];
    y = term[1][0];
#pragma unroll
    for (int i = 1; i <= D; ++i) {
      x = x + term[0][i];
      y = y + term[1][i];
    }
  }

  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void aux(const C& cf, const T (&q)[N], T (&a)[NAUX],
                                             bool*) {
    const T t = q[0];
    const T one_t = T(1) - t;
    bernstein<DEG - 1, 0>(cf, t, one_t, a[0], a[1]);
    if constexpr (DEG >= 2) {
      bernstein<DEG - 2, 2 * DEG>(cf, t, one_t, a[2], a[3]);
    } else {
      a[2] = T(0);
      a[3] = T(0);
    }
  }
  template <class C>
  static __device__ __forceinline__ T k_at(const C&, const T (&a)[NAUX], const T (&)[N], int,
                                           int) {
    return a[0] * a[0] + a[1] * a[1];
  }
  template <bool STRAIGHT, class C>
  static __device__ __forceinline__ void dhdq(const C&, const T (&a)[NAUX], const T (&q)[N],
                                              const T (&w)[N], T (&out)[N], bool* ok) {
    const T sl = sigma<STRAIGHT>(T(kBezierBeta) * q[0], ok);
    const T sr = sigma<STRAIGHT>(T(kBezierBeta) * (q[0] - T(1)), ok);
    const T hb = T(kBezierHb);
    const T du = hb * (sr * (T(1) - sr)) - hb * (sl * (T(1) - sl));
    out[0] = du - (a[0] * a[2] + a[1] * a[3]) * (w[0] * w[0]);
  }
};

// ---- the generic dense policy ------------------------------------------------

// Whether a family declares its K constant (kConstantK: room's K = I).  Its
// factor takes the library's functions, which fold at compile time, as the
// straight-line ones (inline assembly) cannot.
template <class F, class = void>
struct ConstantK : std::false_type {};
template <class F>
struct ConstantK<F, std::void_t<decltype(F::kConstantK)>>
    : std::integral_constant<bool, F::kConstantK> {};

// A family's forms F for step_member: the aux re-evaluated at every point,
// the dense Cholesky over F::k_at, the dense solve.
template <typename T, class F>
struct DensePolicy {
  static constexpr int N = F::N;
  static constexpr int L = F::L;
  struct Aux {
    T v[F::NAUX > 0 ? F::NAUX : 1];
  };
  using Factor = DenseFactor<T, N>;

  template <class C>
  static __device__ __forceinline__ void aux(const C& cf, const T (&q)[N], Aux& a) {
    straight_or_library<T>([&](auto line, bool* ok) {
      F::template aux<decltype(line)::value>(cf, q, a.v, ok);
    });
  }
  template <class C>
  static __device__ __forceinline__ void aux_at(const C& cf, const T (&q_new)[N],
                                                const T (&)[N], Aux& a) {
    aux(cf, q_new, a);
  }
  template <class C>
  static __device__ __forceinline__ void factor(const C& cf, const Aux& a, const T (&q)[N],
                                                Factor& f) {
    const auto k_at = [&](int i, int j) { return F::k_at(cf, a.v, q, i, j); };
    if constexpr (ConstantK<F>::value) {
      bool ok = true;
      dense_factor_pass<false>(k_at, f, &ok);
    } else {
      factor_entries<T, N>(k_at, f);
    }
  }
  static __device__ __forceinline__ void solve(const Factor& f, const T (&b)[N], T (&x)[N]) {
    ::solve<T, N>(f, b, x);
  }
  template <class C>
  static __device__ __forceinline__ void dhdq(const C& cf, const Aux& a, const T (&q)[N],
                                              const T (&w)[N], T (&out)[N]) {
    straight_or_library<T>([&](auto line, bool* ok) {
      F::template dhdq<decltype(line)::value>(cf, a.v, q, w, out, ok);
    });
  }
};

// The family codes of the C entry; KERNEL_INSTANTIATIONS in
// hamilton_tpu_torch/ops/fused_step.py maps (family, n, table length) to them.
template <typename T, int FAM>
struct FamilyForms;
template <typename T> struct FamilyForms<T, 0> { using type = Spherical<T>; };
template <typename T> struct FamilyForms<T, 1> { using type = TwoBody<T>; };
template <typename T> struct FamilyForms<T, 2> { using type = Room<T>; };
template <typename T> struct FamilyForms<T, 3> { using type = Spring<T>; };
template <typename T> struct FamilyForms<T, 4> { using type = Ellipse<T>; };
template <typename T> struct FamilyForms<T, 5> { using type = Bezier<T, 4>; };  // 5 points
template <typename T> struct FamilyForms<T, 6> { using type = Bezier<T, 1>; };  // 2 points

template <typename T, int FAM>
using FamilyPolicy = DensePolicy<T, typename FamilyForms<T, FAM>::type>;

template <typename T, int FAM, bool COMP, bool PM, bool COMPOSED>
__global__ void __launch_bounds__(kThreads)
    family_step_kernel(const T* __restrict__ coef, const T* __restrict__ in,
                       T* __restrict__ out, long long batch,
                       const __grid_constant__ Substeps<T> subs, int iters_p,
                       int iters_q, int steps_per_call) {
  using P = FamilyPolicy<T, FAM>;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  // the table in registers: this member's column, or the shared entries
  // (room has none, and a null coef)
  const RegTable<T, P::L, PM> cf(PM ? coef + b : coef, PM ? batch : 1);
  step_member<T, P, COMP, COMPOSED>(cf, in, out, batch, b, subs, iters_p, iters_q,
                                    steps_per_call);
}

template <typename T, int FAM, bool COMP, bool PM, bool COMPOSED>
int launch(const Args& a) {
  if (FamilyPolicy<T, FAM>::L > 0 && a.coef == nullptr) return -2;
  const long long blocks = (a.batch + kThreads - 1) / kThreads;
  family_step_kernel<T, FAM, COMP, PM, COMPOSED>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.coef), static_cast<const T*>(a.in),
          static_cast<T*>(a.out), a.batch,
          make_substeps<T>(a.weights, a.n_weights, a.dt), a.iters_p, a.iters_q,
          a.steps_per_call);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int FAM, bool COMP, bool PM>
int launch_composed(const Args& a) {
  return a.n_weights > 1 ? launch<T, FAM, COMP, PM, true>(a)
                         : launch<T, FAM, COMP, PM, false>(a);
}

// Compensated or not, shared or per-member table; a family without a table
// (room) has only the shared mode.
template <typename T, int FAM>
int launch_modes(int compensated, int per_member, const Args& a) {
  if constexpr (FamilyPolicy<T, FAM>::L == 0) {
    if (per_member) return -1;
    return compensated ? launch_composed<T, FAM, true, false>(a)
                       : launch_composed<T, FAM, false, false>(a);
  } else {
    if (compensated)
      return per_member ? launch_composed<T, FAM, true, true>(a)
                        : launch_composed<T, FAM, true, false>(a);
    return per_member ? launch_composed<T, FAM, false, true>(a)
                      : launch_composed<T, FAM, false, false>(a);
  }
}

template <typename T>
int dispatch(int family, int compensated, int per_member, const Args& a) {
  switch (family) {
    case 0: return launch_modes<T, 0>(compensated, per_member, a);
    case 1: return launch_modes<T, 1>(compensated, per_member, a);
    case 2: return launch_modes<T, 2>(compensated, per_member, a);
    case 3: return launch_modes<T, 3>(compensated, per_member, a);
    case 4: return launch_modes<T, 4>(compensated, per_member, a);
    case 5: return launch_modes<T, 5>(compensated, per_member, a);
    case 6: return launch_modes<T, 6>(compensated, per_member, a);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Launches steps_per_call fused steps of family `family`'s (4 or 6, n, batch)
// state from state_in into state_out on the given stream, without
// synchronizing.  dtype_code: 0 float32, 1 float64.  flags: bit 1
// compensated, bit 2 per-member table (bit 0, the chain's semiseparable
// flag, must be 0).  coef is the flat shared table (null for room), or the
// (L, batch) per-member one.  weights points to the n_weights (1 to 5)
// composition weights in host memory, read before this returns.  Returns 0,
// -1 when the combination is not instantiated, -2 for a bad argument, or
// cudaGetLastError()'s code.  Fourteen arguments, as the chain's entry: each
// one costs the caller's ctypes marshalling on every launch.
int hamilton_family_step(int dtype_code, int family, int flags, const void* coef,
                         const void* state_in, void* state_out, long long batch, double dt,
                         int iters_p, int iters_q, int steps_per_call, int n_weights,
                         const double* weights, void* stream) {
  if (!valid_args(batch, iters_p, iters_q, steps_per_call, n_weights) || flags < 0 ||
      flags > 7 || (flags & 1))
    return -2;
  Args a{coef, state_in, state_out, batch, dt, iters_p, iters_q, steps_per_call,
         {}, n_weights, static_cast<cudaStream_t>(stream)};
  for (int k = 0; k < n_weights; ++k) a.weights[k] = weights[k];
  const int compensated = (flags >> 1) & 1, per_member = (flags >> 2) & 1;
  if (dtype_code == 0) return dispatch<float>(family, compensated, per_member, a);
  if (dtype_code == 1) return dispatch<double>(family, compensated, per_member, a);
  return -1;
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
