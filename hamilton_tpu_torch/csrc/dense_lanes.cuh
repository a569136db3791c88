// The serial chain's dense form (serial_chain_forms: K(q) factored by the
// Cholesky of pallas_solve.py::_chol_entries, its solves those of
// _solve_entries) as a fused step on G lanes a member: fused_step.cu's
// dense chain at n = 20 (the reference's default chain) and n = 40 (its
// stress chain).  It runs the lane step template lane_step of
// chain_lanes.cuh, in step_member's operations and order
// (ChainPolicy<T, N, false> of chain_forms.cuh, the plain version's).
//
// What bounds it on this card: where the factor lives, then latency.  Per
// member a step takes two O(n^3/6) factors, four O(n^2) solves and two
// O(n^2) dH/dq mat-vecs, against O(100) bytes of state a launch.  One
// thread a member (step_member's DenseFactor, n^2 values a thread) put the
// factor in local memory: at n = 40 6.5 KB a thread, 107 MB across 16384
// members, more than the card's 50 MB of L2, so each step's factor traffic
// went out to HBM (144 ms a 50-step launch); at n = 20 the generated
// kernel spilled 9.7 KB a thread (7.8 ms).  What no lane count shortens:
// the back solve's n(n-1)/2 subtractions are one dependent chain in
// _solve_entries' order (x_i's first term needs x_{i+1}, the value found
// last): 780 at n = 40, 190 at n = 20.
//
// What the design does about it:
//   - a member is a group of G consecutive lanes of a warp (DenseShape);
//     lane g owns links and rows i = g, g+G, ...: its n-vectors in
//     registers, its links' sin and cos, its rows of K and of the factor;
//   - the member's slots in dynamic shared memory, member-minor at an odd
//     stride: the packed lower triangle of the factor (row-major, 1/d on
//     its diagonal), the aux's sin and cos, a solve's result x; the shared
//     coefficient table (C, n^2, then g l S, n) once a block after them; a
//     per-member table read batch-minor from device memory where used;
//   - the factor right-looking, column by column: the owner of row j takes
//     d and 1/d (fused_step.cuh's straight-line pass in float, again with
//     the library's functions where an input of a member left their range:
//     the group reduces the flag), broadcasts 1/d, each lane scales its
//     rows' entries of column j, then subtracts L_ij L_kj from its rows'
//     trailing entries: entry (i, k) takes its subtractions in ascending
//     column order, as in _chol_entries;
//   - the forward solve column by column (y_k broadcast, each lane's rows'
//     sums in registers, in ascending k); the back solve row by row on the
//     row's owner, in _solve_entries' ascending k, x_i into the x slots;
//   - dH/dq: each lane its rows of the two O(n^2) mat-vecs, each sum in
//     ascending j;
//   - loops over n rolled (nvcc built the one-thread template unrolled at
//     n = 40 for over 40 minutes; these parts build in under a minute).
// Built without FMA contraction (kernels.PART_FLAGS): every product and sum
// rounds as in the plain version, so the states are its bit for bit.

#pragma once

#include <type_traits>

#include "chain_lanes.cuh"

namespace {

// The lanes a member of the dense chain at n = 20 and n = 40, in float (F)
// and double (D): the fastest of scripts/k1_route_ab.py's sweep (PERF.md
// section 6), which builds copies of the source with others.
constexpr int kDenseLanes20F = 4, kDenseLanes20D = 4;
constexpr int kDenseLanes40F = 8, kDenseLanes40D = 8;

template <typename T, int N>
struct DenseLanes {
  static constexpr bool kDouble = std::is_same<T, double>::value;
  static constexpr int value = N <= 20 ? (kDouble ? kDenseLanes20D : kDenseLanes20F)
                                       : (kDouble ? kDenseLanes40D : kDenseLanes40F);
};

// The registers a thread of the dense lane kernel is built to fit
// (__launch_bounds__): in float a lane's n/G links of the step's thirteen
// vectors fit 128 at n/G <= 5; in double the most a thread can have.
constexpr int dense_registers(unsigned item) { return item == 4 ? 128 : 255; }

// The block of a lane kernel whose member takes `slots` values of `item`
// bytes and whose block takes the table's `table`, at `regs` registers a
// thread: of 32, 64, ..., 256 threads, the one whose blocks hold the most
// members an SM by shared memory (228 KB an SM, 1 KB of it a block) and
// registers (65536 an SM), the larger on a tie.
constexpr int lane_block(unsigned item, int slots, int table, int g, int regs) {
  int best = 0, most = 0;
  for (int t = 32; t <= 256; t += 32) {
    const unsigned bytes = lane_bytes(item, slots, table, t, g);
    if (t % g != 0 || bytes > kMaxShared) continue;
    int blocks = static_cast<int>(233472 / (bytes + 1024));
    if (blocks > 65536 / (regs * t)) blocks = 65536 / (regs * t);
    if (blocks * (t / g) >= most) {
      most = blocks * (t / g);
      best = t;
    }
  }
  return best;
}

// The member's layout of the dense form at size N_ on G_ lanes.
template <typename T_, int N_, int G_>
struct DenseShape : LaneMember<DenseShape<T_, N_, G_>> {
  using T = T_;
  static constexpr int N = N_, G = G_;
  static constexpr int J = (N_ + G_ - 1) / G_;  // rows a lane: g, g+G, ...
  // slots: the factor's packed lower triangle (entry (i, j) at tri(i, j),
  // 1/d_j at (j, j)), then the aux's sin and cos and a solve's x, n each
  static constexpr int kS = N_ * (N_ + 1) / 2, kC = kS + N_, kX = kC + N_;
  static constexpr int kSlots = kX + N_;
  static constexpr int kTable = N_ * N_ + N_;  // the shared table, after the members' slots
  static constexpr int kRegisters = dense_registers(sizeof(T_));
  static constexpr int kBlock = lane_block(sizeof(T_), kSlots, kTable, G_, kRegisters);
  static constexpr int kMembers = kBlock / G_;  // members a block
  static constexpr int S = kMembers + 1;        // stride between a member's slots (odd)
  static constexpr unsigned kBytes = lane_bytes(sizeof(T_), kSlots, kTable, kBlock, G_);
  static constexpr int kSmemBlocks = 233472 / (kBytes + 1024);
  // the blocks an SM the kernel is built for (__launch_bounds__): as shared
  // memory and kRegisters allow
  static constexpr int kRegBlocks = 65536 / (kRegisters * kBlock);
  static constexpr int kMinBlocks = kSmemBlocks < kRegBlocks ? kSmemBlocks : kRegBlocks;
  static_assert(G_ >= 1 && G_ <= 32 && (G_ & (G_ - 1)) == 0, "G: a power of two <= 32");
  static_assert(kBlock > 0 && kBytes <= kMaxShared && kMinBlocks >= 1,
                "a block of members' slots fits the SM");

  static __host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }
};

// ---- the factor ------------------------------------------------------------

// K at the aux in the member's slots into the triangle, then its factor in
// place, with STRAIGHT's square roots and reciprocals (the library's sqrt
// and 1/d otherwise); whether every input of the member was in their range.
template <bool STRAIGHT, class Sh, class C>
__device__ __forceinline__ bool dense_factor_pass(const C& cf) {
  using T = typename Sh::T;
  constexpr int N = Sh::N, G = Sh::G, J = Sh::J, S = Sh::S;
  T* mem = Sh::member();
  const int g = Sh::lane();
  const unsigned mask = Sh::mask();
  const T* s = mem + Sh::kS * S;
  const T* c = mem + Sh::kC * S;
  // K at this lane's rows: K_ii = C_ii exactly, K_ij = C_ij (c_i c_j + s_i s_j)
#pragma unroll
  for (int m = 0; m < J; ++m) {
    const int i = g + G * m;
    if (i < N) {
      T* row = mem + Sh::tri(i, 0) * S;
      const T si = s[i * S], ci = c[i * S];
#pragma unroll 2
      for (int j = 0; j < i; ++j) row[j * S] = cf[i * N + j] * (ci * c[j * S] + si * s[j * S]);
      row[i * S] = cf[i * N + i];
    }
  }
  bool ok = true;
#pragma unroll 1
  for (int j = 0; j < N; ++j) {
    const int owner = j % G;
    T inv_d = T(0);
    if (g == owner) {  // entry (j, j) has taken its j subtractions
      T* djj = mem + Sh::tri(j, j) * S;
      const T d = line_sqrt<STRAIGHT>(*djj, &ok);
      if constexpr (STRAIGHT) {
        inv_d = line_rcp<true>(d, &ok);
      } else {
        inv_d = T(1) / d;
      }
      *djj = inv_d;
    }
    inv_d = __shfl_sync(mask, inv_d, owner, G);
    T lij[J];  // L_ij at this lane's rows i > j
#pragma unroll
    for (int m = 0; m < J; ++m) {
      const int i = g + G * m;
      if (i > j && i < N) {
        T* e = mem + Sh::tri(i, j) * S;
        lij[m] = *e * inv_d;
        *e = lij[m];
      }
    }
    __syncwarp(mask);  // column j before the lanes read it
#pragma unroll
    for (int m = 0; m < J; ++m) {
      const int i = g + G * m;
      if (i > j && i < N) {
        T* row = mem + Sh::tri(i, 0) * S;
        const T* lkj = mem + Sh::tri(j + 1, j) * S;  // L_kj, k = j+1, ..., i
#pragma unroll 2
        for (int k = j + 1; k <= i; ++k) {
          row[k * S] = row[k * S] - lij[m] * *lkj;
          lkj += (k + 1) * S;
        }
      }
    }
  }
  int all = ok;
#pragma unroll
  for (int d = 1; d < G; d *= 2) all &= __shfl_xor_sync(mask, all, d);
  return all != 0;
}

// The factor: in float by the straight line, again by the library's
// functions where an input of the member left their range (a K that is not
// positive definite, a NaN); in double by the library's.
template <class Sh, class C>
struct DenseFactorLanes {
  static __device__ __forceinline__ void run(C cf) {
    __syncwarp(Sh::mask());  // every lane is done with the last factor
    if constexpr (std::is_same<typename Sh::T, float>::value) {
      const bool ok = dense_factor_pass<true, Sh>(cf);
      __syncwarp(Sh::mask());
      if (ok) return;
    }
    dense_factor_pass<false, Sh>(cf);
    __syncwarp(Sh::mask());
  }
};

// ---- the solve and dH/dq ---------------------------------------------------

// The forward half of x = K^-1 b in the order of _solve_entries, column by
// column: y_k = (b_k - sum_{j<k} L_kj y_j) / d_k, column k = G*jj + r on lane
// r; b and y at this lane's rows (y[m] is row g + G*m's).
template <class Sh>
__device__ __forceinline__ void dense_forward_lanes(const typename Sh::T (&b)[Sh::J],
                                                    typename Sh::T (&y)[Sh::J]) {
  using T = typename Sh::T;
  constexpr int N = Sh::N, G = Sh::G, J = Sh::J, S = Sh::S;
  const T* mem = Sh::member();
  const int g = Sh::lane();
  const unsigned mask = Sh::mask();
#pragma unroll
  for (int m = 0; m < J; ++m) y[m] = b[m];
#pragma unroll
  for (int jj = 0; jj < J; ++jj) {
#pragma unroll 1
    for (int r = 0; r < G; ++r) {
      const int k = G * jj + r;
      if (k >= N) break;
      T v = T(0);
      if (g == r) {
        y[jj] = y[jj] * mem[Sh::tri(k, k) * S];
        v = y[jj];
      }
      const T yk = __shfl_sync(mask, v, r, G);
#pragma unroll
      for (int m = 0; m < J; ++m) {
        const int i = g + G * m;
        if (i > k && i < N) y[m] = y[m] - mem[Sh::tri(i, k) * S] * yk;
      }
    }
  }
}

// The back half, row by row on the row's owner: x_i = (y_i - sum_{k>i}
// L_ki x_k) / d_i, the sum in ascending k (one dependent chain of n(n-1)/2
// subtractions); x at this lane's rows and into the member's x slots.
template <class Sh>
__device__ __forceinline__ void dense_back_lanes(const typename Sh::T (&y)[Sh::J],
                                                 typename Sh::T (&x)[Sh::J]) {
  using T = typename Sh::T;
  constexpr int N = Sh::N, G = Sh::G, J = Sh::J, S = Sh::S;
  T* mem = Sh::member();
  const int g = Sh::lane();
  const unsigned mask = Sh::mask();
  T* xs = mem + Sh::kX * S;
#pragma unroll
  for (int m = 0; m < J; ++m) x[m] = T(0);  // a row past the last stays 0
#pragma unroll
  for (int jj = J - 1; jj >= 0; --jj) {
#pragma unroll 1
    for (int r = G - 1; r >= 0; --r) {
      const int i = G * jj + r;
      if (i >= N) continue;
      if (g == r) {
        T t = y[jj];
        const T* lki = mem + Sh::tri(i + 1, i) * S;
#pragma unroll 4
        for (int k = i + 1; k < N; ++k) {
          t = t - *lki * xs[k * S];
          lki += (k + 1) * S;
        }
        t = t * mem[Sh::tri(i, i) * S];
        xs[i * S] = t;
        x[jj] = t;
      }
      __syncwarp(mask);  // x_i before the next row's owner reads it
    }
  }
}

// dH/dq at the aux with w the last solve's x (chain_forms.cuh's dense dhdq,
// in its order) at this lane's rows k: g l_k S_k s_k + w_k (s_k sum_j C_kj c_j w_j
// - c_k sum_j C_kj s_j w_j).
template <class Sh, class C>
__device__ __forceinline__ void dense_dhdq_lanes(const C& cf, const typename Sh::T (&w)[Sh::J],
                                                 typename Sh::T (&out)[Sh::J]) {
  using T = typename Sh::T;
  constexpr int N = Sh::N, G = Sh::G, J = Sh::J, S = Sh::S;
  const T* mem = Sh::member();
  const int g = Sh::lane();
  const T* s = mem + Sh::kS * S;
  const T* c = mem + Sh::kC * S;
  const T* xs = mem + Sh::kX * S;
  T acc_c[J], acc_s[J];
  {
    const T w0 = xs[0];
    const T cw = c[0] * w0, sw = s[0] * w0;
#pragma unroll
    for (int m = 0; m < J; ++m) {
      const int k = g + G * m;
      if (k < N) {
        const T ck = cf[k * N];
        acc_c[m] = ck * cw;
        acc_s[m] = ck * sw;
      }
    }
  }
#pragma unroll 2
  for (int j = 1; j < N; ++j) {
    const T wj = xs[j * S];
    const T cw = c[j * S] * wj, sw = s[j * S] * wj;
#pragma unroll
    for (int m = 0; m < J; ++m) {
      const int k = g + G * m;
      if (k < N) {
        const T ck = cf[k * N + j];
        acc_c[m] = acc_c[m] + ck * cw;
        acc_s[m] = acc_s[m] + ck * sw;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < J; ++m) {
    const int k = g + G * m;
    if (k < N) {
      const T sk = s[k * S], ck = c[k * S];
      out[m] = cf[N * N + k] * sk + w[m] * (sk * acc_c[m] - ck * acc_s[m]);
    }
  }
}

// The dense form's routines on the member's lanes, for lane_step (as
// LinvLaneForms): the aux (straight-line sin and cos in float), the factor,
// a solve into this lane's x (and the x slots), and dH/dq at its rows.
template <class Sh, class C>
struct DenseLaneForms : LaneTrig<Sh, true> {
  using T = typename Sh::T;
  static constexpr int N = Sh::N, J = Sh::J;
  C cf;
  T x[J];  // the last solve's x at this lane's rows

  __device__ __forceinline__ explicit DenseLaneForms(C c) : cf(c) {}
  // inlined at each call site, and it must stay so (as must the routines it
  // inlines): out of line (lane_call, as L^-1's routines at n = 20) at G = 2
  // nvcc 12.9 (V12.9.86, sm_90a) builds a factor that differs from the
  // inlined one on an H100, every member at n = 20 in float32, NaN at full
  // occupancy, different between two identical launches, also with one
  // member in its block, without spills, with a fence after each
  // __syncwarp, with whole-warp syncs and at ptxas -O1; out of line at
  // G = 4 and inlined at every G it is bit for bit the plain version.  No
  // hazard in this source explains it: every entry another lane reads is
  // written by its row's owner before a __syncwarp of the member's lanes.
  // scripts/dense_outlined_probe.py rebuilds the fault (FACTOR_ALONE, a
  // kernel of the aux and this factor alone) and dumps both SASS.
  __device__ __forceinline__ void factor() { DenseFactorLanes<Sh, C>::run(cf); }
  // x = K^-1 rhs (every lane done reading the x slots first)
  __device__ __forceinline__ void solve(const T (&rhs)[J]) {
    __syncwarp(this->mask);
    T y[J];
    dense_forward_lanes<Sh>(rhs, y);
    dense_back_lanes<Sh>(y, x);
  }
  __device__ __forceinline__ void read_x(T (&out)[J]) const {
#pragma unroll
    for (int m = 0; m < J; ++m) out[m] = x[m];
  }
  __device__ __forceinline__ void dhdq(T (&res)[J]) { dense_dhdq_lanes<Sh>(cf, x, res); }
};

template <typename T, int N, int G>
struct LaneTraits<T, N, G, kDenseForm> {
  using Sh = DenseShape<T, N, G>;
  template <class C>
  using Forms = DenseLaneForms<Sh, C>;
};

}  // namespace
