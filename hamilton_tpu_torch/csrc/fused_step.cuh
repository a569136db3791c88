// The fused whole-step generalized Stormer-Verlet step, shared by the serial
// chain's kernel (fused_step.cu) and the model families' (family_step.cu).
//
// Both replace the TPU kernel hamilton_tpu/ops/pallas_step.py::
// fused_stepper.kernel, which traces any family's closed forms.  Here a
// family is a *policy*: a struct naming its size N, its aux and factor
// storage, and its closed forms
//   aux(cf, q, aux)                the auxiliary values at q (sin/cos, 1/r, ...)
//   aux_at(cf, q_new, q_base, aux) aux at q_new for a within-step
//                                  re-evaluation (a fresh aux, or the chain's
//                                  first-order shift from q_base in float32)
//   factor(cf, aux, q, fac)        the factorization of K(q)
//   solve(fac, b, x)               x = K^-1 b
//   dhdq(cf, aux, q, w, out)       dH/dq at q with velocity w
// with coefficient entries read from cf[k].  step_member runs the step on
// them with the same arithmetic in the same order as the reference and as the
// plain PyTorch version (hamilton_tpu_torch/ops/fused_step.py):
//   - the p-half fixed point on the cached factor (iters_p solves + dH/dq),
//   - v0 and the warm predictor q1 = q0 + dt*v0 + (dt*dt/2)*vdot,
//   - the q-refinement: iters_q fresh factorizations, or (iters_q == 0) the
//     predictor-factor mode with one factor at the predictor,
//   - the end-of-step force, the increments (Kahan-compensated when COMP),
//     and the warm-start carries (a_est, vdot_est).
// q is an argument of the forms, not only aux: as in the reference, dH/dq in
// the p-half loop reads the carried aux (from the previous step's end) with
// this step's q, and each factorization reads the q its aux was taken at.
// Each dt-step runs the composition's substeps (1 to 5 weights w; (1.0) is
// plain Verlet, the Yoshida/Suzuki weights are order 4), each at T(w)*dt and
// T(w)*half, the weight rounded to T first as the reference rounds a Python
// float against a tile of the state's dtype.  The entry point computes each
// substep's step sizes once on the host and passes them by value (a
// __grid_constant__ read through the constant cache).  The first substep of
// a launch factorizes afresh; every later one reuses the previous substep's
// end-of-step factor and aux (the factor never crosses launches).
//
// The coefficient table is shared by every member or, for a parameter
// sweep, one column per member of a batch-minor (L, batch) table: thread b
// reads entry k at coef[k * batch + b], so a warp's reads coalesce.  The
// dense chain at n = 2 and 4, the families and the generated kernels hold
// either in registers (RegTable), read once a launch; the semiseparable and
// Moebius forms (3n and 5n entries) stage it in shared memory.
//
// One thread per member; everything over N unrolled at compile time so the
// per-member lists live in registers; batch-minor x[i*B + b] loads and
// stores that coalesce.  Built without fast-math (see fused_step.cu).

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "libm_fast.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWeights = 5;

__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ double dsin(double x) { return sin(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }

// The square root, the reciprocal, and the sine and cosine of one value of
// a pass over a member's forms: STRAIGHT (float only) libm_fast.cuh's
// straight-line expansions, clearing *ok where an input is outside their
// range; else the library's functions (in float the sine and cosine from
// sincosf's one range reduction).
template <bool STRAIGHT, typename T>
__device__ __forceinline__ T line_sqrt(T x, bool* ok) {
  if constexpr (STRAIGHT) {
    *ok = *ok && sqrt_fast_range(x);
    return sqrt_fast(x);
  } else {
    return dsqrt(x);
  }
}
template <bool STRAIGHT, typename T>
__device__ __forceinline__ T line_rcp(T x, bool* ok) {
  if constexpr (STRAIGHT) {
    *ok = *ok && rcp_fast_range(x);
    return rcp_fast(x);
  } else {
    return drcp(x);
  }
}
template <bool STRAIGHT, typename T>
__device__ __forceinline__ void line_sincos(T x, T* s, T* c, bool* ok) {
  if constexpr (STRAIGHT) {
    *ok = *ok && sincos_fast_range(x);
    sincos_fast(x, s, c);
  } else if constexpr (std::is_same<T, float>::value) {
    dsincos(x, s, c);
  } else {
    *s = dsin(x);
    *c = dcos(x);
  }
}

// pass(std::true_type, &ok) in float, the straight-line functions, and again
// pass(std::false_type, &ok), the library's, where an input left their range
// (ok false: a rare member, a NaN); in double only the latter.  One branch
// after the pass, so a member's straight-line work interleaves.
template <typename T, class Pass>
__device__ __forceinline__ void straight_or_library(const Pass& pass) {
  bool ok = true;
  if constexpr (std::is_same<T, float>::value) {
    pass(std::true_type{}, &ok);
    if (ok) return;
  }
  pass(std::false_type{}, &ok);
}

// Entry k of the shared table (staged in shared memory).
template <typename T>
struct SharedTable {
  static constexpr bool kPerMember = false;
  const T* cf;
  __device__ __forceinline__ T operator[](int k) const { return cf[k]; }
};

// Entry k of this member's column of the (L, batch) per-member table.
template <typename T>
struct MemberTable {
  static constexpr bool kPerMember = true;
  const T* __restrict__ col;
  long long batch;
  __device__ __forceinline__ T operator[](int k) const { return __ldg(col + k * batch); }
};

// The table in registers, read once a launch: the L entries of the shared
// table (every thread reads the same ones, broadcast through the read-only
// cache; stride 1) or of this member's column of the (L, batch) per-member
// table (stride batch).  The forms index it at compile-time constants once
// unrolled, so no step of the launch loads an entry again.
template <typename T, int L, bool PM>
struct RegTable {
  static constexpr bool kPerMember = PM;
  T v[L > 0 ? L : 1];
  __device__ __forceinline__ RegTable(const T* __restrict__ src, long long stride) {
#pragma unroll
    for (int k = 0; k < L; ++k) v[k] = __ldg(src + k * stride);
  }
  __device__ __forceinline__ T operator[](int k) const { return v[k]; }
};

// The step sizes of each composition substep k in T, from its weight w_k:
// h = T(w_k)*T(dt), half = T(w_k)*(T(dt)*0.5), dth = h*half, inv_h = 1/h
// (round to nearest, as the plain version computes them).
template <typename T>
struct Substeps {
  T h[kMaxWeights], half[kMaxWeights], dth[kMaxWeights], inv_h[kMaxWeights];
  int count;
};

template <typename T>
Substeps<T> make_substeps(const double (&w)[kMaxWeights], int count, double dt) {
  Substeps<T> s{};
  const T dt_t = static_cast<T>(dt);
  const T half0 = dt_t * T(0.5);
  for (int k = 0; k < count; ++k) {
    const T wk = static_cast<T>(w[k]);
    s.h[k] = wk * dt_t;
    s.half[k] = wk * half0;
    s.dth[k] = s.h[k] * s.half[k];
    s.inv_h[k] = T(1) / s.h[k];
  }
  s.count = count;
  return s;
}

// ---- the dense in-register Cholesky ---------------------------------------

template <typename T, int N>
struct DenseFactor {
  T low[N][N];  // lower Cholesky factor (j <= i used)
  T id[N];      // reciprocal diagonal
};

// A pivot of the dense factor, d = sqrt(a) and 1/d, with STRAIGHT's square
// root and reciprocal (otherwise the library's sqrt and the division 1/d).
template <typename T>
struct Pivot {
  T d, inv_d;
};
template <bool STRAIGHT, typename T>
__device__ __forceinline__ Pivot<T> pivot_pass(T a, bool* ok) {
  const T d = line_sqrt<STRAIGHT>(a, ok);
  if constexpr (STRAIGHT) {
    return {d, line_rcp<true>(d, ok)};
  } else {
    return {d, T(1) / d};
  }
}

// The Cholesky factor of the entries k_at(i, j), j <= i, in the order of
// the reference's pallas_solve.py::_chol_entries (and the plain version's),
// with STRAIGHT's square roots and reciprocals (otherwise the library's
// sqrt and the division 1/d); `first`, where given, the first column's
// pivot of K_00 = k_at(0, 0) taken before (a K_00 that holds over a launch).
// Unrolled: the one-thread dense forms are small (n = 2 and 4); the chain
// at n = 20 and 40 runs on lanes (dense_lanes.cuh).
template <bool STRAIGHT, typename T, int N, class K>
__device__ __forceinline__ void dense_factor_pass(const K& k_at, DenseFactor<T, N>& f,
                                                  bool* ok, const Pivot<T>* first = nullptr) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T acc = k_at(j, j);
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - f.low[j][k] * f.low[j][k];
    const Pivot<T> piv = j == 0 && first ? *first : pivot_pass<STRAIGHT>(acc, ok);
    const T d = piv.d, inv_d = piv.inv_d;
    f.low[j][j] = d;
    f.id[j] = inv_d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      T e = k_at(i, j);
#pragma unroll
      for (int k = 0; k < j; ++k) e = e - f.low[i][k] * f.low[j][k];
      f.low[i][j] = e * inv_d;
    }
  }
}

// The dense factor: in float by the straight line, again by the library's
// functions where an input left its range (a K that is not positive
// definite, a NaN); in double by the library's.  `first`: as
// dense_factor_pass's.
template <typename T, int N, class K>
__device__ __forceinline__ void factor_entries(const K& k_at, DenseFactor<T, N>& f,
                                               const Pivot<T>* first = nullptr) {
  straight_or_library<T>([&](auto line, bool* ok) {
    dense_factor_pass<decltype(line)::value>(k_at, f, ok, first);
  });
}

// The pivot of a, as factor_entries would take it.
template <typename T>
__device__ __forceinline__ Pivot<T> pivot_of(T a) {
  Pivot<T> piv;
  straight_or_library<T>([&](auto line, bool* ok) {
    piv = pivot_pass<decltype(line)::value>(a, ok);
  });
  return piv;
}

// L L^T x = b in the order of _solve_entries.
template <typename T, int N>
__device__ __forceinline__ void solve(const DenseFactor<T, N>& f, const T (&b)[N],
                                      T (&x)[N]) {
  T y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T acc = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc - f.low[i][k] * y[k];
    y[i] = acc * f.id[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) acc = acc - f.low[k][i] * x[k];
    x[i] = acc * f.id[i];
  }
}

// ---- the step ----------------------------------------------------------

template <typename T>
__device__ __forceinline__ void kahan_add(T& x, T& c, T d) {
  const T y = d + c;
  const T t = x + y;
  c = y - (t - x);
  x = t;
}

// The p-half and q-refinement counts (iters_p, iters_q) as compile-time
// constants P >= 1 and Q >= 0; IterCounts<0, 0>, the counts read at run time.
template <int P, int Q>
struct IterCounts {
  static constexpr int kP = P, kQ = Q;
};

// f(IterCounts<P, Q>{}) for the counts the dense chain's callers use, (2,1)
// (the double pendulum) and (3,1) (chaos_scan, fit_masses), else
// f(IterCounts<0, 0>{}).
template <class F>
int with_iters(int iters_p, int iters_q, F&& f) {
  if (iters_p == 2 && iters_q == 1) return f(IterCounts<2, 1>{});
  if (iters_p == 3 && iters_q == 1) return f(IterCounts<3, 1>{});
  return f(IterCounts<0, 0>{});
}

// steps_per_call dt-steps of member b under policy P, reading its state from
// `in` and writing it to `out`, with coefficient entries from `cf`.  Without
// COMPOSED the one substep's sizes are compile-time indices into `subs`, so
// plain Verlet keeps no substep loop and reads them as kernel parameters.
// IP > 0: the counts are IP and IQ, not iters_p and iters_q, so the loops
// over them unroll.
template <typename T, class P, bool COMP, bool COMPOSED, int IP = 0, int IQ = 0, class C>
__device__ __forceinline__ void step_member(const C& cf, const T* __restrict__ in,
                                            T* __restrict__ out, long long batch,
                                            long long b, const Substeps<T>& subs,
                                            int iters_p, int iters_q,
                                            int steps_per_call) {
  constexpr int N = P::N;
  constexpr int NSV = COMP ? 6 : 4;
  if constexpr (IP > 0) {
    iters_p = IP;
    iters_q = IQ;
  }

  // state vectors in the order of the reference's carry: q, p, [cq, cp,]
  // a_est, vdot_est
  T q[N], p[N], cq[N], cp[N], av[N], vd[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    q[i] = in[(0 * N + i) * batch + b];
    p[i] = in[(1 * N + i) * batch + b];
    if constexpr (COMP) {
      cq[i] = in[(2 * N + i) * batch + b];
      cp[i] = in[(3 * N + i) * batch + b];
    }
    av[i] = in[((NSV - 2) * N + i) * batch + b];
    vd[i] = in[((NSV - 1) * N + i) * batch + b];
  }

  typename P::Factor fac;
  typename P::Aux ax;  // aux at the factor's point

  for (int st = 0; st < steps_per_call; ++st) {
    for (int sub = 0; sub < (COMPOSED ? subs.count : 1); ++sub) {
      const T h = subs.h[sub];
      const T half = subs.half[sub];
      if (st == 0 && sub == 0) {  // peeled: no carried factor at launch entry
        P::aux(cf, q, ax);
        P::factor(cf, ax, q, fac);
      }
      T ph[N], a_last[N], v0[N], vl[N], q1[N], q1p[N], bt[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        ph[i] = p[i] - half * av[i];
        a_last[i] = av[i];
      }
      for (int it = 0; it < iters_p; ++it) {
        T wv[N];
        P::solve(fac, ph, wv);
        P::dhdq(cf, ax, q, wv, a_last);
#pragma unroll
        for (int i = 0; i < N; ++i) ph[i] = p[i] - half * a_last[i];
      }
      P::solve(fac, ph, v0);
      const T dth = subs.dth[sub];
#pragma unroll
      for (int i = 0; i < N; ++i) q1[i] = q[i] + h * v0[i] + dth * vd[i];

      if (iters_q == 0) {
        // predictor-factor placement: one factor at the predictor serves the
        // q-refinement and the end-of-step force
        P::aux(cf, q1, ax);
        P::factor(cf, ax, q1, fac);
        P::solve(fac, ph, vl);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          q1p[i] = q1[i];
          q1[i] = q[i] + half * (v0[i] + vl[i]);
        }
        P::aux_at(cf, q1, q1p, ax);
        P::dhdq(cf, ax, q1, vl, bt);
      } else {
        for (int it = 0; it < iters_q; ++it) {
          if (it == 0) {
            P::aux(cf, q1, ax);
          } else {
            P::aux_at(cf, q1, q1p, ax);
          }
#pragma unroll
          for (int i = 0; i < N; ++i) q1p[i] = q1[i];
          P::factor(cf, ax, q1, fac);
          P::solve(fac, ph, vl);
#pragma unroll
          for (int i = 0; i < N; ++i) q1[i] = q[i] + half * (v0[i] + vl[i]);
        }
        // exact end-of-step factor at the converged q1
        P::aux_at(cf, q1, q1p, ax);
        P::factor(cf, ax, q1, fac);
        T w1[N];
        P::solve(fac, ph, w1);
        P::dhdq(cf, ax, q1, w1, bt);
      }
      // increments, accumulation, and the warm-start carries
      const T inv_h = subs.inv_h[sub];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const T dq = half * (v0[i] + vl[i]);
        const T dp = -half * (a_last[i] + bt[i]);
        if constexpr (COMP) {
          kahan_add(q[i], cq[i], dq);
          kahan_add(p[i], cp[i], dp);
        } else {
          q[i] = q[i] + dq;
          p[i] = p[i] + dp;
        }
        vd[i] = (vl[i] - v0[i]) * inv_h;
        av[i] = bt[i];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) {
    out[(0 * N + i) * batch + b] = q[i];
    out[(1 * N + i) * batch + b] = p[i];
    if constexpr (COMP) {
      out[(2 * N + i) * batch + b] = cq[i];
      out[(3 * N + i) * batch + b] = cp[i];
    }
    out[((NSV - 2) * N + i) * batch + b] = av[i];
    out[((NSV - 1) * N + i) * batch + b] = vd[i];
  }
}

// The launch arguments after the template choices.
struct Args {
  const void* coef;
  const void* in;
  void* out;
  long long batch;
  double dt;
  int iters_p, iters_q, steps_per_call;
  double weights[kMaxWeights];
  int n_weights;
  cudaStream_t stream;
};

// Whether the entry's scalar arguments are ones the kernels take.
inline bool valid_args(long long batch, int iters_p, int iters_q, int steps_per_call,
                       int n_weights) {
  return batch >= 1 && steps_per_call >= 1 && iters_p >= 1 && iters_q >= 0 &&
         n_weights >= 1 && n_weights <= kMaxWeights;
}

}  // namespace
