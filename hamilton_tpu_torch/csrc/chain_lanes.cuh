// The lane step template (lane_step, lane_kernel: a member on G lanes of a
// warp, its factor in shared memory) with the serial chain's L^-1 form
// (chain_variants.cu; 4 lanes at n = 20, 2 at n = 5), the form that
// dense_lanes.cuh's dense chain also runs on it, and the one-thread chain
// kernels' staged per-member table (StagedColumn).  The semiseparable and
// Moebius forms do not run on these lanes: every lane would repeat their
// O(n) scans, and they measured slower at every G (PERF.md section 6).  The
// semiseparable form runs on semisep_wide.cuh's link split at n = 40 and
// 20 (G lanes a member in G warps, each scan handed from lane to lane), on
// the one-thread step_member elsewhere, as does the Moebius form.
//
// A member is a group of G consecutive lanes of a warp (LaneShape below);
// lane_step runs step_member's step (fused_step.cuh) on them with a form's
// routines (LinvLaneForms, DenseLaneForms), in the same operations and
// order.  What it splits across the group for L^-1:
//   - the member's n-vectors (q, p, their Kahan compensations, the
//     warm-start carries and the step's temporaries): lane g holds links
//     g, g+G, ... in registers, and runs the elementwise work on them, the
//     aux's sin and cos among it;
//   - the factor: the semiseparable generators (zx, zy, 1/d, ux, uy), a
//     sequential recursion over the links with a square root and a
//     reciprocal a link (in float straight-line, libm_fast.cuh), run by
//     every lane alike from the aux in shared memory, each lane storing its
//     links' share; then lane g computes the columns of L^-1 of the pairs
//     (p, n-1-p), p = g, g+G, ... (n+1 entries a pair);
//   - a solve: each of the 2n dots of its two triangular mat-vecs a balanced
//     tree over its terms zero-padded to a power of two (the least >= its
//     length, at least G).  That tree is bitwise the plain version's
//     _tree_sum: where _tree_sum carries an odd last term, the padded tree
//     adds it to 0, which is exact (but for the sign of a zero), and the
//     zeros pair among themselves.  With the padded length P, lane g sums
//     the aligned chunk [gc, gc+c), c = P/G, as a tree; a butterfly over the
//     group (__shfl_xor_sync at 1, 2, ..., G/2) adds the chunks as the tree
//     does;
//   - dH/dq: each lane forms its links' products, then every lane runs the
//     two sequential scans over them (from the tip, from the base) and forms
//     dH/dq at its links.
// The whole vectors that a sequential recursion or another lane reads (the
// aux, a solve's right-hand side and result, dH/dq, the generators, dH/dq's
// products) and the factor live in the member's slots of dynamic shared
// memory, member-minor at an odd stride so that the lanes of a warp's
// members fall on distinct banks, the shared table after them.  __syncwarp
// on the group's mask orders every write before another lane's read.  The
// factor never crosses launches.  The factor, solve and dH/dq are routines
// (lane_call) that find the member's slots and the table from threadIdx and
// the shared-memory symbol, so that they read them as shared memory also
// where they are out of line.
//
// The one-thread step's forms (generator recursion, solve, dH/dq) are in
// chain_forms.cuh: a change to one of them here is made there too.

#pragma once

#include <type_traits>

#include "chain_forms.cuh"

namespace {

// The blocks an SM the L^-1 kernel is built to hold (its __launch_bounds__),
// as far as shared memory allows, at every G: at n = 20 and G = 4, 4 blocks
// of 32 members hold 16384 members in one wave on 132 SMs, at <= 128
// registers a thread.
constexpr int kLinvMinBlocks = 4;
// The n up to which the factor, solve and dH/dq are inlined at each call
// site (lane_call): at n = 5 inlined they run 10 % faster than out of line
// for twice the build seconds (PERF.md section 6, H100); at n = 20 out of
// line keeps the build short.
constexpr int kLaneInlineUpTo = 8;
// The n up to which the L^-1 lane aux takes the straight-line sin/cos in
// float (beside the straight-line generators at every n): ten same-call
// pairs on an H100 80GB HBM3 at 700 W read it 0.953x the library's sin and
// cos at n = 5, and 1.009x at n = 20, where the routines run out of line
// (PERF.md section 6).
constexpr int kLinvStraightAuxUpTo = kLaneInlineUpTo;
constexpr unsigned kMaxShared = 232448;  // dynamic shared memory a block may have

// The least power of two >= n.
template <int N>
struct Pow2 {
  static constexpr int value = N <= 1 ? 1 : 2 * Pow2<(N + 1) / 2>::value;
};
template <>
struct Pow2<1> {
  static constexpr int value = 1;
};

// The block's dynamic shared memory.
template <typename T>
__device__ __forceinline__ T* dynamic_shared() {
  extern __shared__ __align__(16) unsigned char lane_shared[];
  return reinterpret_cast<T*>(lane_shared);
}

// The shared memory of a block of `threads` at G lanes a member: `slots`
// values of `item` bytes a member, and the shared table's `table`.
constexpr unsigned lane_bytes(unsigned item, int slots, int table, int threads, int g) {
  return item * (slots * (threads / g + 1) + table);
}

// A member's group of Sh::G consecutive lanes and its Sh::kSlots slots in
// the block's dynamic shared memory, member-minor at the stride Sh::S, the
// shared table after every member's slots (a lane shape derives from it).
template <class Sh>
struct LaneMember {
  // slot 0 of this lane's member, its lane in the group, the group's mask
  static __device__ __forceinline__ auto* member() { return shared() + threadIdx.x / Sh::G; }
  static __device__ __forceinline__ auto* table() { return shared() + Sh::kSlots * Sh::S; }
  static __device__ __forceinline__ auto* shared() { return dynamic_shared<typename Sh::T>(); }
  static __device__ __forceinline__ int lane() { return threadIdx.x % Sh::G; }
  static __device__ __forceinline__ unsigned mask() {
    constexpr int G = Sh::G;
    return G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
};

// The member's layout at size N_ on G_ lanes: kBlock threads a block
// (kThreads where its shared memory fits, else fewer), J links a lane.
template <typename T_, int N_, int G_>
struct LaneShape : LaneMember<LaneShape<T_, N_, G_>> {
  using T = T_;
  static constexpr int N = N_, G = G_;
  static constexpr int J = (N_ + G - 1) / G;  // links a lane: g, g+G, ...
  static constexpr int W = Pow2<N_>::value;
  static constexpr int C = W / G;  // a lane's chunk of the longest dot
  // slots: L^-1's column-major lower triangle, then b, y, x, the aux's sin
  // and cos, dH/dq, and the generators zx, zy, 1/d, ux, uy, n each (dH/dq's
  // four products reuse the generators' slots, free outside a factor)
  static constexpr int kB = N_ * (N_ + 1) / 2, kY = kB + N_, kX = kY + N_;
  static constexpr int kS = kX + N_, kC = kS + N_, kF = kC + N_, kGen = kF + N_;
  static constexpr int kProducts = kGen;
  static constexpr int kSlots = kGen + 5 * N_;
  static constexpr int kTable = 3 * N_;  // the shared table, after the members' slots
  static constexpr int kBlock =
      lane_bytes(sizeof(T), kSlots, kTable, kThreads, G) <= kMaxShared ? kThreads
      : lane_bytes(sizeof(T), kSlots, kTable, kThreads / 2, G) <= kMaxShared
          ? kThreads / 2
          : kThreads / 4;
  static constexpr int kMembers = kBlock / G;  // members a block
  static constexpr int S = kMembers + 1;       // stride between a member's slots (odd)
  static constexpr unsigned kBytes = lane_bytes(sizeof(T), kSlots, kTable, kBlock, G);
  static constexpr int kSmemBlocks = 233472 / (kBytes + 1024);  // 228 KB an SM, 1 KB a block
  static constexpr int kMinBlocks = kLinvMinBlocks < kSmemBlocks ? kLinvMinBlocks : kSmemBlocks;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0 && G <= W, "G: a power of two <= W");
  static_assert(kBytes <= kMaxShared && kMembers >= 1, "a member's slots fit a block");

  // the first entry of column a of the column-major lower triangle
  static __host__ __device__ constexpr int col(int a) { return a * N_ - a * (a - 1) / 2; }
};

// Entry k of the shared table, staged in the block's dynamic shared memory
// (addressed from it, so a __noinline__ function reads it as shared).
template <class Sh>
struct SharedSlots {
  __device__ __forceinline__ typename Sh::T operator[](int k) const { return Sh::table()[k]; }
};

// The balanced pairwise sum of a lane's chunk t[0..C), C a power of two,
// then of the group's chunks by the butterfly.
template <typename T, int C, int G>
__device__ __forceinline__ T group_tree(T (&t)[C], unsigned mask) {
#pragma unroll
  for (int w = C; w > 1; w /= 2) {
#pragma unroll
    for (int i = 0; i < w / 2; ++i) t[i] = t[2 * i] + t[2 * i + 1];
  }
  T v = t[0];
#pragma unroll
  for (int d = 1; d < G; d *= 2) v = v + __shfl_xor_sync(mask, v, d);
  return v;
}

// R::run(a...) through one out-of-line copy a (routine, shape, table).
template <class R, class... A>
__device__ __noinline__ void lane_outlined(A... a) {
  R::run(a...);
}

// R::run(a...), a routine of the lane step at size N: inlined at each call
// site up to n = kLaneInlineUpTo; above it out of line, emitted once per
// instantiation and not at each of the step's four to five call sites in
// each (the one-thread L^-1 kernel's unrolled solve, inlined at n = 20, took
// ~530 s to build).
template <class R, int N, class... A>
__device__ __forceinline__ void lane_call(A... a) {
  if constexpr (N <= kLaneInlineUpTo)
    R::run(a...);
  else
    lane_outlined<R>(a...);
}

// f(std::integral_constant<int, I>) for I = B, ..., E - 1: a loop whose index
// is a constant expression.
template <int B, int E, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    static_for<B + 1, E>(f);
  }
}

// A lane's chunk of a dot of `len` terms: the dot padded to the power of
// two >= len, at least G, split in G.
template <int LEN, int G>
struct Chunk {
  static constexpr int value = (Pow2<LEN>::value > G ? Pow2<LEN>::value : G) / G;
};

// ---- the factor ------------------------------------------------------------

// The semiseparable generators (chain_forms.cuh's factor_pass, in its order)
// from the aux in shared memory with STRAIGHT's square roots and reciprocals
// (the library's sqrt and 1/d otherwise), run by every lane alike and
// stored by link a's lane (a % G); whether every input was in their range
// (alike on every lane of the member).
template <bool STRAIGHT, class Sh, class C>
__device__ __forceinline__ bool lane_generators_pass(const C& cf) {
  using T = typename Sh::T;
  constexpr int N = Sh::N, S = Sh::S, G = Sh::G;
  T* mem = Sh::member();
  const int g = Sh::lane();
  T* gen = mem + Sh::kGen * S;
  bool ok = true;
  T pxx = T(0), pxy = T(0), pyy = T(0);
#pragma unroll
  for (int a = 0; a < N; ++a) {
    const int i = N - 1 - a;
    const T ux = cf[i] * mem[(Sh::kC + i) * S];
    const T uy = cf[i] * mem[(Sh::kS + i) * S];
    const T si = cf[N + i];
    T yx, yy;
    if (a == 0) {
      yx = si * ux;
      yy = si * uy;
    } else {
      yx = si * ux - (pxx * ux + pxy * uy);
      yy = si * uy - (pxy * ux + pyy * uy);
    }
    const T d = line_sqrt<STRAIGHT>(ux * yx + uy * yy, &ok);
    const T inv_d = line_rcp<STRAIGHT>(d, &ok);
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
    if (a % G == g) {
      gen[a * S] = zx;
      gen[(N + a) * S] = zy;
      gen[(2 * N + a) * S] = inv_d;
      gen[(3 * N + a) * S] = ux;
      gen[(4 * N + a) * S] = uy;
    }
  }
  return ok;
}

// The generators: in float by the straight line, again by the library's
// functions where an input of the member left their range (a NaN, a d^2
// below the straight-line sqrt's range); in double by the library's.
template <class Sh, class C>
__device__ __forceinline__ void lane_generators(const C& cf) {
  if constexpr (std::is_same<typename Sh::T, float>::value) {
    if (!lane_generators_pass<true, Sh>(cf)) lane_generators_pass<false, Sh>(cf);
  } else {
    lane_generators_pass<false, Sh>(cf);
  }
  __syncwarp(Sh::mask());
}

// Column a of L^-1 from the generators in shared memory, in the plain
// version's order: x_a = 1/d_a, s = z_a x_a; x_i = -(1/d_i)(u_i . s),
// s += z_i x_i for i > a.
template <class Sh>
__device__ __forceinline__ void linv_column(typename Sh::T* mem, int a) {
  using T = typename Sh::T;
  constexpr int N = Sh::N, S = Sh::S;
  const T* zx = mem + Sh::kGen * S;
  const T* zy = zx + N * S;
  const T* id = zy + N * S;
  const T* ux = id + N * S;
  const T* uy = ux + N * S;
  T* e = mem + Sh::col(a) * S;
  const T xa = id[a * S];
  e[0] = xa;
  T sx = zx[a * S] * xa;
  T sy = zy[a * S] * xa;
#pragma unroll 2
  for (int i = a + 1; i < N; ++i) {
    const T xi = -(id[i * S] * (ux[i * S] * sx + uy[i * S] * sy));
    e[(i - a) * S] = xi;
    sx = sx + zx[i * S] * xi;
    sy = sy + zy[i * S] * xi;
  }
}

// This lane's columns: the pairs (p, n-1-p), p = g, g+G, ...
template <class Sh>
struct LinvColumns {
  static __device__ __forceinline__ void run() {
    constexpr int N = Sh::N;
    typename Sh::T* mem = Sh::member();
    for (int p = Sh::lane(); p < (N + 1) / 2; p += Sh::G) {
      linv_column<Sh>(mem, p);
      if (N - 1 - p != p) linv_column<Sh>(mem, N - 1 - p);
    }
  }
};

// The L^-1 form's factor: the generators, then this lane's columns of L^-1.
template <class Sh, class C>
struct LinvFactorLanes {
  static __device__ __forceinline__ void run(C cf) {
    lane_generators<Sh>(cf);
    lane_call<LinvColumns<Sh>, Sh::N>();
    __syncwarp(Sh::mask());
  }
};

// ---- the solve: x = K^-1 b, b in its slots in link order, x into its slots --

// x = L^-T (L^-1 b~) (b~ = b reversed, the processing order): y in its
// slots, then x in its slots, in link order.
template <class Sh>
struct LinvSolveLanes {
  static __device__ __forceinline__ void run() {
    using T = typename Sh::T;
    constexpr int N = Sh::N, S = Sh::S, G = Sh::G, CM = Sh::C;
    T* mem = Sh::member();
    const int g = Sh::lane();
    const unsigned mask = Sh::mask();

    // y_i = sum_{a <= i} L(i, a) b~_a: at chunk c, the lane's terms are
    // a = g*c + k; their b~_a and entry (i, a) at off + i*S, slot c - 1 + k
    T bt[2 * CM - 1];
    int off[2 * CM - 1];
#pragma unroll
    for (int c = 1; c <= CM; c *= 2) {
#pragma unroll
      for (int k = 0; k < c; ++k) {
        const int a = g * c + k < N ? g * c + k : N - 1;  // in bounds where the term is zero
        bt[c - 1 + k] = mem[(Sh::kB + N - 1 - a) * S];
        off[c - 1 + k] = (Sh::col(a) - a) * S;
      }
    }
    static_for<0, N>([&](auto row) {
      constexpr int i = decltype(row)::value, c = Chunk<i + 1, G>::value;
      T t[c];
#pragma unroll
      for (int k = 0; k < c; ++k)
        t[k] = g * c + k <= i ? mem[off[c - 1 + k] + i * S] * bt[c - 1 + k] : T(0);
      const T yi = group_tree<T, c, G>(t, mask);
      if (i % G == g) mem[(Sh::kY + i) * S] = yi;
    });
    __syncwarp(mask);

    // x~_a = sum_{i >= a} L(i, a) y_i: the lane's terms i = a + g*c + k
    static_for<0, N>([&](auto column) {
      constexpr int a = decltype(column)::value, c = Chunk<N - a, G>::value;
      const T* la = mem + (Sh::col(a) + g * c) * S;  // in bounds where the term is zero
      const T* ya = mem + (Sh::kY + a + g * c) * S;
      T t[c];
#pragma unroll
      for (int k = 0; k < c; ++k) t[k] = g * c + k < N - a ? la[k * S] * ya[k * S] : T(0);
      const T xa = group_tree<T, c, G>(t, mask);
      if (a % G == g) mem[(Sh::kX + N - 1 - a) * S] = xa;
    });
    __syncwarp(mask);
  }
};

// ---- dH/dq -----------------------------------------------------------------

// dH/dq at the aux with w the last solve's x (chain_forms.cuh's dhdq), in
// its order: link k's lane (k % G) forms its products lcw_k, lsw_k and the
// scans' terms S_k lcw_k, S_k lsw_k in the product slots; every lane runs
// the scans from the tip and from the base over them, and forms dH/dq at
// its links into the dH/dq slots.
template <class Sh, class C>
struct LaneDhdq {
  static __device__ __forceinline__ void run(C cf) {
    using T = typename Sh::T;
    constexpr int N = Sh::N, S = Sh::S, G = Sh::G, J = Sh::J;
    T* mem = Sh::member();
    const int g = Sh::lane();
    const T* s = mem + Sh::kS * S;
    const T* c = mem + Sh::kC * S;
    const T* w = mem + Sh::kX * S;
    T* lcw = mem + Sh::kProducts * S;
    T* lsw = lcw + N * S;
    T* mcw = lsw + N * S;
    T* msw = mcw + N * S;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = g + G * j;
      if (k < N) {
        const T lw = cf[k] * w[k * S];
        const T lc = lw * c[k * S];
        const T ls = lw * s[k * S];
        lcw[k * S] = lc;
        lsw[k * S] = ls;
        mcw[k * S] = cf[N + k] * lc;
        msw[k * S] = cf[N + k] * ls;
      }
    }
    __syncwarp(Sh::mask());
    T qc[J], qs[J];  // the scans from the tip at this lane's links
    T rc = T(0), rs = T(0);
#pragma unroll
    for (int k = N - 1; k >= 0; --k) {
      if (k == N - 1) {
        rc = mcw[k * S];
        rs = msw[k * S];
      } else {
        rc = rc + mcw[k * S];
        rs = rs + msw[k * S];
      }
      if (k % G == g) {
        qc[k / G] = rc;
        qs[k / G] = rs;
      }
    }
    T pc = T(0), ps = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k % G == g) {
        T ak, bk;
        if (k == 0) {
          ak = qc[0];
          bk = qs[0];
        } else {
          ak = cf[N + k] * pc + qc[k / G];
          bk = cf[N + k] * ps + qs[k / G];
        }
        const T sk = s[k * S], ck = c[k * S], wk = w[k * S];
        mem[(Sh::kF + k) * S] = cf[2 * N + k] * sk + wk * cf[k] * (sk * ak - ck * bk);
      }
      if (k == 0) {
        pc = lcw[0];
        ps = lsw[0];
      } else {
        pc = pc + lcw[k * S];
        ps = ps + lsw[k * S];
      }
    }
    __syncwarp(Sh::mask());  // every lane is done with the product slots
  }
};

// ---- the step ------------------------------------------------------------

// The chain's trig aux on a member's lanes: each lane the sin and cos of its
// links into the member's aux slots (Sh::kS, Sh::kC), and their first-order
// shift to q_new from q_base in float32 (re-evaluated in float64).  With
// SINCOS (the dense form; L^-1 at small n), in float each lane's pairs
// through the straight-line sincos_fast where every angle of the lane is in
// its range, else through the library's one reduction (both are sinf and
// cosf bit for bit, csrc/libm_check.cu); otherwise, and in double, sin and
// cos one by one.
template <class Sh, bool SINCOS>
struct LaneTrig {
  using T = typename Sh::T;
  static constexpr int N = Sh::N, G = Sh::G, J = Sh::J, S = Sh::S;
  T* mem;
  int g;
  unsigned mask;

  __device__ __forceinline__ LaneTrig() : mem(Sh::member()), g(Sh::lane()), mask(Sh::mask()) {}
  __device__ __forceinline__ int link(int j) const { return g + G * j; }
  __device__ __forceinline__ bool mine(int j) const { return g + G * j < N; }

  __device__ __forceinline__ void aux(const T (&x)[J]) {
    __syncwarp(mask);
    if constexpr (SINCOS && std::is_same<T, float>::value) {
      bool fast = true;
#pragma unroll
      for (int j = 0; j < J; ++j) fast = fast && (!mine(j) || sincos_fast_range(x[j]));
      if (fast) {
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (mine(j))
            sincos_fast(x[j], &mem[(Sh::kS + link(j)) * S], &mem[(Sh::kC + link(j)) * S]);
      } else {
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (mine(j)) dsincos(x[j], &mem[(Sh::kS + link(j)) * S], &mem[(Sh::kC + link(j)) * S]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (mine(j)) {
          mem[(Sh::kS + link(j)) * S] = dsin(x[j]);
          mem[(Sh::kC + link(j)) * S] = dcos(x[j]);
        }
      }
    }
    __syncwarp(mask);
  }

  __device__ __forceinline__ void aux_at(const T (&q_new)[J], const T (&q_base)[J]) {
    if constexpr (std::is_same<T, float>::value) {
      __syncwarp(mask);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (mine(j)) {
          T& s = mem[(Sh::kS + link(j)) * S];
          T& c = mem[(Sh::kC + link(j)) * S];
          const T dq = q_new[j] - q_base[j];
          const T s0 = s, c0 = c;
          s = s0 + dq * c0;
          c = c0 - dq * s0;
        }
      }
      __syncwarp(mask);
    } else {
      aux(q_new);
    }
  }
};

// The L^-1 form's routines on the member's lanes, for lane_step: the aux (its
// sin and cos straight-line in float up to n = kLinvStraightAuxUpTo), the
// factor, a solve of rhs (this lane's links) into the x slots, the x slots at
// this lane's links, and dH/dq at them with w the last solve's x.
template <class Sh, class C>
struct LinvLaneForms : LaneTrig<Sh, (Sh::N <= kLinvStraightAuxUpTo)> {
  using T = typename Sh::T;
  static constexpr int N = Sh::N, J = Sh::J, S = Sh::S;
  C cf;

  __device__ __forceinline__ explicit LinvLaneForms(C c) : cf(c) {}
  __device__ __forceinline__ void factor() { lane_call<LinvFactorLanes<Sh, C>, N>(cf); }
  __device__ __forceinline__ void solve(const T (&rhs)[J]) {
    __syncwarp(this->mask);
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (this->mine(j)) this->mem[(Sh::kB + this->link(j)) * S] = rhs[j];
    __syncwarp(this->mask);
    lane_call<LinvSolveLanes<Sh>, N>();
  }
  __device__ __forceinline__ void read_x(T (&x)[J]) const {
#pragma unroll
    for (int j = 0; j < J; ++j)
      x[j] = this->mine(j) ? this->mem[(Sh::kX + this->link(j)) * S] : T(0);
  }
  __device__ __forceinline__ void dhdq(T (&res)[J]) {
    lane_call<LaneDhdq<Sh, C>, N>(cf);
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (this->mine(j)) res[j] = this->mem[(Sh::kF + this->link(j)) * S];
  }
};

// The member's step (step_member's, operation for operation) on the G lanes
// of the member with a lane form's routines (`forms`: LinvLaneForms, or the
// dense form's DenseLaneForms of dense_lanes.cuh): v[j] is link g + G*j of an
// n-vector.
template <class Sh, bool COMP, bool COMPOSED, class F>
__device__ __forceinline__ void lane_step(F& forms, const typename Sh::T* __restrict__ in,
                                          typename Sh::T* __restrict__ out, long long batch,
                                          long long b, const Substeps<typename Sh::T>& subs,
                                          int iters_p, int iters_q, int steps_per_call) {
  using T = typename Sh::T;
  constexpr int N = Sh::N, G = Sh::G, J = Sh::J, NSV = COMP ? 6 : 4;
  const int g = Sh::lane();
  auto link = [g](int j) { return g + G * j; };
  auto mine = [g](int j) { return g + G * j < N; };

  // state vectors in the order of the reference's carry: q, p, [cq, cp,]
  // a_est, vdot_est
  T q[J], p[J], cq[J], cp[J], av[J], vd[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = mine(j) ? link(j) : 0;  // a lane past the last link repeats link 0's
    q[j] = in[(0 * N + i) * batch + b];
    p[j] = in[(1 * N + i) * batch + b];
    if constexpr (COMP) {
      cq[j] = in[(2 * N + i) * batch + b];
      cp[j] = in[(3 * N + i) * batch + b];
    }
    av[j] = in[((NSV - 2) * N + i) * batch + b];
    vd[j] = in[((NSV - 1) * N + i) * batch + b];
  }

  for (int st = 0; st < steps_per_call; ++st) {
    for (int sub = 0; sub < (COMPOSED ? subs.count : 1); ++sub) {
      const T h = subs.h[sub];
      const T half = subs.half[sub];
      if (st == 0 && sub == 0) {  // peeled: no carried factor at launch entry
        forms.aux(q);
        forms.factor();
      }
      T ph[J], a_last[J], v0[J], vl[J], q1[J], q1p[J], bt[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        ph[j] = p[j] - half * av[j];
        a_last[j] = av[j];
      }
      for (int it = 0; it < iters_p; ++it) {
        forms.solve(ph);
        forms.dhdq(a_last);
#pragma unroll
        for (int j = 0; j < J; ++j) ph[j] = p[j] - half * a_last[j];
      }
      forms.solve(ph);
      forms.read_x(v0);
      const T dth = subs.dth[sub];
#pragma unroll
      for (int j = 0; j < J; ++j) q1[j] = q[j] + h * v0[j] + dth * vd[j];

      if (iters_q == 0) {
        // predictor-factor placement: one factor at the predictor serves the
        // q-refinement and the end-of-step force
        forms.aux(q1);
        forms.factor();
        forms.solve(ph);
        forms.read_x(vl);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          q1p[j] = q1[j];
          q1[j] = q[j] + half * (v0[j] + vl[j]);
        }
        forms.aux_at(q1, q1p);
        forms.dhdq(bt);
      } else {
        for (int it = 0; it < iters_q; ++it) {
          if (it == 0) {
            forms.aux(q1);
          } else {
            forms.aux_at(q1, q1p);
          }
#pragma unroll
          for (int j = 0; j < J; ++j) q1p[j] = q1[j];
          forms.factor();
          forms.solve(ph);
          forms.read_x(vl);
#pragma unroll
          for (int j = 0; j < J; ++j) q1[j] = q[j] + half * (v0[j] + vl[j]);
        }
        // exact end-of-step factor at the converged q1
        forms.aux_at(q1, q1p);
        forms.factor();
        forms.solve(ph);
        forms.dhdq(bt);
      }
      // increments, accumulation, and the warm-start carries
      const T inv_h = subs.inv_h[sub];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const T dq = half * (v0[j] + vl[j]);
        const T dp = -half * (a_last[j] + bt[j]);
        if constexpr (COMP) {
          kahan_add(q[j], cq[j], dq);
          kahan_add(p[j], cp[j], dp);
        } else {
          q[j] = q[j] + dq;
          p[j] = p[j] + dp;
        }
        vd[j] = (vl[j] - v0[j]) * inv_h;
        av[j] = bt[j];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (!mine(j)) continue;
    const int i = link(j);
    out[(0 * N + i) * batch + b] = q[j];
    out[(1 * N + i) * batch + b] = p[j];
    if constexpr (COMP) {
      out[(2 * N + i) * batch + b] = cq[j];
      out[(3 * N + i) * batch + b] = cp[j];
    }
    out[((NSV - 2) * N + i) * batch + b] = av[j];
    out[((NSV - 1) * N + i) * batch + b] = vd[j];
  }
}

// ---- one thread a member: the per-member table staged ----------------------

// Entry k of this thread's member's column of the per-member table, staged
// in the block's dynamic shared memory once a launch (stage_column): entry k
// of the block's thread t at k * kThreads + t, so that a warp's reads fall
// on distinct banks.
template <typename T>
struct StagedColumn {
  __device__ __forceinline__ T operator[](int k) const {
    return dynamic_shared<T>()[k * kThreads + threadIdx.x];
  }
};

// Member b's column of the (L, batch) table into the block's shared memory.
template <typename T, int L>
__device__ __forceinline__ void stage_column(const T* __restrict__ coef, long long batch,
                                             long long b) {
  T* col = dynamic_shared<T>();
#pragma unroll 4
  for (int k = 0; k < L; ++k) col[k * kThreads + threadIdx.x] = coef[k * batch + b];
}

// The dynamic shared bytes of the one-thread KERNEL where it stages (STAGED)
// a per-member table of L entries a member, else 0, into *bytes; sets the
// kernel's limit where that is more than the default 48 KB, once per
// kernel; cudaFuncSetAttribute's code.
template <typename T, int L, bool STAGED, auto KERNEL>
cudaError_t staged_prepare(unsigned* bytes) {
  constexpr unsigned kBytes = STAGED ? sizeof(T) * L * kThreads : 0;
  *bytes = kBytes;
  if constexpr (kBytes > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBytes));
    return attr;
  }
  return cudaSuccess;
}

// ---- the kernel, its launch and its layout ---------------------------------

// The forms a lane kernel runs (its FORM): LaneTraits<T, N, G, FORM> names
// the member's shape (Sh) and its routines on it (Forms<C>, C the table's
// accessor).  The dense form's traits are in dense_lanes.cuh.
constexpr int kLinvForm = 0, kDenseForm = 1;
template <typename T, int N, int G, int FORM>
struct LaneTraits;
template <typename T, int N, int G>
struct LaneTraits<T, N, G, kLinvForm> {
  using Sh = LaneShape<T, N, G>;
  template <class C>
  using Forms = LinvLaneForms<Sh, C>;
};

// The step of FORM at size N on G lanes a member: kMembers members a block.
template <typename T, int N, int G, bool COMP, bool PM, bool COMPOSED, int FORM>
__global__ void __launch_bounds__(LaneTraits<T, N, G, FORM>::Sh::kBlock,
                                  LaneTraits<T, N, G, FORM>::Sh::kMinBlocks)
    lane_kernel(const T* __restrict__ coef, const T* __restrict__ in, T* __restrict__ out,
                long long batch, const __grid_constant__ Substeps<T> subs, int iters_p,
                int iters_q, int steps_per_call) {
  using Tr = LaneTraits<T, N, G, FORM>;
  using Sh = typename Tr::Sh;
  const long long b =
      static_cast<long long>(blockIdx.x) * Sh::kMembers + threadIdx.x / G;
  if constexpr (PM) {
    if (b >= batch) return;
    typename Tr::template Forms<MemberTable<T>> forms(MemberTable<T>{coef + b, batch});
    lane_step<Sh, COMP, COMPOSED>(forms, in, out, batch, b, subs, iters_p, iters_q,
                                  steps_per_call);
  } else {
    T* cf = Sh::table();
    for (int k = threadIdx.x; k < Sh::kTable; k += blockDim.x) cf[k] = coef[k];
    __syncthreads();
    if (b >= batch) return;
    typename Tr::template Forms<SharedSlots<Sh>> forms(SharedSlots<Sh>{});
    lane_step<Sh, COMP, COMPOSED>(forms, in, out, batch, b, subs, iters_p, iters_q,
                                  steps_per_call);
  }
}

// Lets the lane kernel have its dynamic shared memory where that is more than
// the default 48 KB, once per instantiation; cudaFuncSetAttribute's code.
template <typename T, int N, int G, bool COMP, bool PM, bool COMPOSED, int FORM>
cudaError_t lane_prepare() {
  using Sh = typename LaneTraits<T, N, G, FORM>::Sh;
  if constexpr (Sh::kBytes > 48 * 1024) {
    static const cudaError_t attr =
        cudaFuncSetAttribute(lane_kernel<T, N, G, COMP, PM, COMPOSED, FORM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Sh::kBytes));
    return attr;
  }
  return cudaSuccess;
}

template <typename T, int N, int G, bool COMP, bool PM, bool COMPOSED, int FORM>
int lane_launch(const Args& a) {
  using Sh = typename LaneTraits<T, N, G, FORM>::Sh;
  const cudaError_t attr = lane_prepare<T, N, G, COMP, PM, COMPOSED, FORM>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = (a.batch + Sh::kMembers - 1) / Sh::kMembers;
  lane_kernel<T, N, G, COMP, PM, COMPOSED, FORM>
      <<<static_cast<unsigned int>(blocks), Sh::kBlock, Sh::kBytes, a.stream>>>(
          static_cast<const T*>(a.coef), static_cast<const T*>(a.in), static_cast<T*>(a.out),
          a.batch, make_substeps<T>(a.weights, a.n_weights, a.dt), a.iters_p, a.iters_q,
          a.steps_per_call);
  return static_cast<int>(cudaGetLastError());
}

// The layout of a kernel into out[0..4): lanes a member, threads a block,
// dynamic shared bytes a block, and the blocks an SM the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); cudaSuccess or the error.
template <class K>
int kernel_layout(K kernel, int lanes, int block, unsigned bytes, int* out) {
  out[0] = lanes;
  out[1] = block;
  out[2] = static_cast<int>(bytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, block, bytes));
}

// The lane kernel's layout in these modes, not composed; where the build
// does not hold it (HELD false), its shape with 0 blocks an SM.
template <typename T, int N, int G, bool HELD, int FORM>
int lane_layout(int compensated, int per_member, int* out) {
  auto one = [out](auto comp, auto pm) {
    constexpr bool kComp = decltype(comp)::value, kPm = decltype(pm)::value;
    using Sh = typename LaneTraits<T, N, G, FORM>::Sh;
    if constexpr (HELD) {
      const cudaError_t attr = lane_prepare<T, N, G, kComp, kPm, false, FORM>();
      if (attr != cudaSuccess) return static_cast<int>(attr);
      return kernel_layout(lane_kernel<T, N, G, kComp, kPm, false, FORM>, G, Sh::kBlock,
                           Sh::kBytes, out);
    } else {
      out[0] = G;
      out[1] = Sh::kBlock;
      out[2] = static_cast<int>(Sh::kBytes);
      out[3] = 0;
      return 0;
    }
  };
  using Y = std::true_type;
  using No = std::false_type;
  if (compensated) return per_member ? one(Y{}, Y{}) : one(Y{}, No{});
  return per_member ? one(No{}, Y{}) : one(No{}, No{});
}

}  // namespace
