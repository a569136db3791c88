// Fused whole-step generalized Stormer-Verlet kernel for NVIDIA Hopper
// (sm_90a): the planar serial chain's Moebius and L^-1 forms, and its dense
// forms at n = 4.
//
// Replaces the TPU kernel hamilton_tpu/ops/pallas_step.py::fused_stepper.kernel
// (launched by its _call through pl.pallas_call) traced with the chain's
// other closed forms, serial_chain_forms_mobius (pallas_step.py:1194) and
// serial_chain_forms_linv (:1329), and with serial_chain_forms at n = 4 (the
// chain that examples/fit_masses.py differentiates).  The Moebius and dense
// steps are the template step_member of fused_step.cuh, one thread a member;
// the aux, its float32 shift, the semiseparable solves and dH/dq, and the
// dense policy come from chain_forms.cuh, shared with fused_step.cu.  Two
// forms are new here:
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
//            Table: the base family's 3n.  Its step is linv_step below, G
//            lanes a member.
//
// What bounds them on this card: latency and issue.  Per member a launch
// moves O(100) bytes against thousands of dependent flops, and 16384
// members are 124 a streaming multiprocessor.  One thread a member (Moebius,
// dense) leaves 4 warps an SM; L^-1's factor, 210 values at n = 20, does not
// fit a thread's registers beside the state.  So L^-1 runs a member on G = 4
// lanes (16 warps an SM, one wave at <= 128 registers): the factor and the
// vectors the lanes exchange in shared memory, the member's vectors split
// across the lanes' registers, the O(n^2) work split across them, the O(n)
// recursions run by every lane alike (see linv_step; PERF.md for the
// lanes-a-member sweep of scripts/linv_sweep.py).
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

// ---- the L^-1 step (serial_chain_forms_linv), G lanes a member -----------
//
// A member is a group of G consecutive lanes of a warp (LinvShape below);
// linv_step runs step_member's step with the L^-1 forms on them, in the
// same operations and order.  What it splits across the group:
//   - the member's n-vectors (q, p, their Kahan compensations, the
//     warm-start carries and the step's temporaries): lane g holds links
//     g, g+G, ... in registers, and runs the elementwise work on them;
//   - the factor: the semiseparable generators (zx, zy, 1/d, ux, uy), a
//     sequential recursion over the links, run by every lane alike from the
//     aux in shared memory, each lane storing its links' share; then lane g
//     computes the columns of L^-1 of the pairs (p, n-1-p), p = g, g+G, ...
//     (n+1 entries a pair);
//   - a solve: each of the 2n dots of its two triangular mat-vecs is a
//     balanced tree over its terms zero-padded to a power of two (the least
//     >= its length, at least G).  That tree is bitwise the plain version's
//     _tree_sum: where _tree_sum carries an odd last term, the padded tree
//     adds it to 0, which is exact (but for the sign of a zero), and the
//     zeros pair among themselves.  With the padded length P, lane g sums
//     the aligned chunk [gc, gc+c), c = P/G, as a tree; a butterfly over the
//     group (__shfl_xor_sync at 1, 2, ..., G/2) adds the chunks as the tree
//     does.  The chunk is a constant of each dot, so a solve is straight-line
//     code: 76 products a lane a mat-vec at n = 20 and G = 4, against 210;
//   - dH/dq: each lane forms its links' products, then every lane runs the
//     two sequential scans over them (from the tip, from the base) and
//     forms dH/dq at its links.
// The whole vectors that a sequential form or another lane reads (the aux,
// a solve's b, y and x, dH/dq, the generators) and the factor live in the
// member's slots of dynamic shared memory, member-minor at an odd stride so
// that the lanes of a warp's members fall on distinct banks, and the shared
// table after them; __syncwarp on the group's mask orders every write
// before another lane's read.  The factor never crosses launches.  The
// factor, the mat-vecs and dH/dq are routines (linv_call) that find the
// member's slots and the table from threadIdx and the shared-memory symbol,
// so that they read them as shared memory also where they are out of line.

// The least power of two >= n.
template <int N>
struct Pow2 {
  static constexpr int value = N <= 1 ? 1 : 2 * Pow2<(N + 1) / 2>::value;
};
template <>
struct Pow2<1> {
  static constexpr int value = 1;
};

// The lanes a member at n > 8 and at n <= 8: the fastest of the sweep of
// scripts/linv_sweep.py (PERF.md section 6), which builds copies of this
// source with others.
constexpr int kLinvLanesLong = 4, kLinvLanesShort = 2;
// The blocks an SM the kernel is built to hold (its __launch_bounds__), as
// far as shared memory allows: at n = 20 and G = 4, 4 blocks of 32 members
// hold 16384 members in one wave on 132 SMs, at <= 128 registers a thread.
constexpr int kLinvMinBlocks = 4;
// The n up to which the factor, solve and dH/dq are inlined at each call
// site (linv_call): at n = 5 inlined they run 10 % faster than out of line
// for twice the build seconds (PERF.md section 6, H100); at n = 20 out of
// line keeps the build short.
constexpr int kLinvInlineUpTo = 8;
constexpr unsigned kMaxShared = 232448;  // dynamic shared memory a block may have

// The shared memory of a block of `threads` at G lanes a member: `slots`
// values of `item` bytes a member, and the shared table's `table`.
constexpr unsigned linv_bytes(unsigned item, int slots, int table, int threads, int g) {
  return item * (slots * (threads / g + 1) + table);
}

// The member's layout: kBlock threads a block (kThreads where its shared
// memory fits, else fewer), G lanes a member, J links a lane.
template <typename T, int N_>
struct LinvShape {
  static constexpr int G = N_ > 8 ? kLinvLanesLong : kLinvLanesShort;
  static constexpr int J = (N_ + G - 1) / G;  // links a lane: g, g+G, ...
  static constexpr int W = Pow2<N_>::value;
  static constexpr int C = W / G;  // a lane's chunk of the longest dot
  // slots: L^-1's column-major lower triangle, then b, y, x, the aux's sin
  // and cos, dH/dq, and the generators zx, zy, 1/d, ux, uy, n each
  static constexpr int kB = N_ * (N_ + 1) / 2, kY = kB + N_, kX = kY + N_;
  static constexpr int kS = kX + N_, kC = kS + N_, kF = kC + N_, kGen = kF + N_;
  static constexpr int kSlots = kGen + 5 * N_;
  static constexpr int kTable = 3 * N_;  // the shared table, after the members' slots
  static constexpr int kBlock =
      linv_bytes(sizeof(T), kSlots, kTable, kThreads, G) <= kMaxShared ? kThreads
      : linv_bytes(sizeof(T), kSlots, kTable, kThreads / 2, G) <= kMaxShared
          ? kThreads / 2
          : kThreads / 4;
  static constexpr int kMembers = kBlock / G;  // members a block
  static constexpr int S = kMembers + 1;       // stride between a member's slots (odd)
  static constexpr unsigned kBytes = linv_bytes(sizeof(T), kSlots, kTable, kBlock, G);
  static constexpr int kSmemBlocks = 233472 / (kBytes + 1024);  // 228 KB an SM, 1 KB a block
  static constexpr int kMinBlocks = kLinvMinBlocks < kSmemBlocks ? kLinvMinBlocks : kSmemBlocks;
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0 && G <= W, "G: a power of two <= W");
  static_assert(kBytes <= kMaxShared && kMembers >= 1, "a member's slots fit a block");

  // slot 0 of this lane's member, its lane in the group, the group's mask
  static __device__ __forceinline__ T* member() { return shared() + threadIdx.x / G; }
  static __device__ __forceinline__ T* table() { return shared() + kSlots * S; }
  static __device__ __forceinline__ T* shared() {
    extern __shared__ __align__(16) unsigned char linv_shared[];
    return reinterpret_cast<T*>(linv_shared);
  }
  static __device__ __forceinline__ int lane() { return threadIdx.x % G; }
  static __device__ __forceinline__ unsigned mask() {
    return G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
  // the first entry of column a of the column-major lower triangle
  static __host__ __device__ constexpr int col(int a) { return a * N_ - a * (a - 1) / 2; }
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

// Column a of L^-1 from the generators in shared memory, in the plain
// version's order: x_a = 1/d_a, s = z_a x_a; x_i = -(1/d_i)(u_i . s),
// s += z_i x_i for i > a.
template <typename T, int N>
__device__ __forceinline__ void linv_column(T* mem, int a) {
  using Sh = LinvShape<T, N>;
  constexpr int S = Sh::S;
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

// R::run(a...) through one out-of-line copy a (routine, dtype, n, table).
template <class R, class... A>
__device__ __noinline__ void linv_outlined(A... a) {
  R::run(a...);
}

// R::run(a...), a routine of the L^-1 step at size N: inlined at each call
// site up to n = kLinvInlineUpTo; above it out of line, emitted once per
// instantiation and not at each of the step's four to five call sites in
// each (the one-thread kernel's unrolled solve, inlined at n = 20, took
// ~530 s to build).
template <class R, int N, class... A>
__device__ __forceinline__ void linv_call(A... a) {
  if constexpr (N <= kLinvInlineUpTo)
    R::run(a...);
  else
    linv_outlined<R>(a...);
}

// This lane's columns: the pairs (p, n-1-p), p = g, g+G, ...
template <typename T, int N>
struct LinvColumns {
  static __device__ __forceinline__ void run() {
    using Sh = LinvShape<T, N>;
    T* mem = Sh::member();
    for (int p = Sh::lane(); p < (N + 1) / 2; p += Sh::G) {
      linv_column<T, N>(mem, p);
      if (N - 1 - p != p) linv_column<T, N>(mem, N - 1 - p);
    }
  }
};

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

// x = L^-T (L^-1 b~), b in its slots in link order (b~ = b reversed, the
// processing order): y in its slots, then x in its slots, in link order.
template <typename T, int N>
struct LinvSolve {
  static __device__ __forceinline__ void run() {
    using Sh = LinvShape<T, N>;
    constexpr int S = Sh::S, G = Sh::G, CM = Sh::C;
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

// The semiseparable generators (chain_forms.cuh's factor) from the aux in
// shared memory, run by every lane alike and stored by link a's lane
// (a % G), then this lane's columns of L^-1.
template <typename T, int N, class C>
struct LinvFactor {
  static __device__ __forceinline__ void run(C cf) {
    using Sh = LinvShape<T, N>;
    constexpr int S = Sh::S, G = Sh::G;
    T* mem = Sh::member();
    const int g = Sh::lane();
    const unsigned mask = Sh::mask();
    T* gen = mem + Sh::kGen * S;
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
      const T d = dsqrt(ux * yx + uy * yy);
      const T inv_d = T(1) / d;
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
    __syncwarp(mask);
    linv_call<LinvColumns<T, N>, N>();
    __syncwarp(mask);
  }
};

// dH/dq at the aux with w the last solve's x (chain_forms.cuh's dhdq), in
// its order: link k's lane (k % G) forms its products lcw_k, lsw_k and the
// scans' terms S_k lcw_k, S_k lsw_k in the generators' slots (free outside
// a factor); every lane runs the scans from the tip and from the base over
// them, and forms dH/dq at its links into the dH/dq slots.
template <typename T, int N, class C>
struct LinvDhdq {
  static __device__ __forceinline__ void run(C cf) {
    using Sh = LinvShape<T, N>;
    constexpr int S = Sh::S, G = Sh::G, J = Sh::J;
    T* mem = Sh::member();
    const int g = Sh::lane();
    const T* s = mem + Sh::kS * S;
    const T* c = mem + Sh::kC * S;
    const T* w = mem + Sh::kX * S;
    T* lcw = mem + Sh::kGen * S;
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
    __syncwarp(Sh::mask());  // every lane is done with the generators' slots
  }
};

// The member's step (step_member's, operation for operation) with the
// chain's semiseparable aux and dH/dq and the L^-1 factor and solves, on
// the G lanes of the member: v[j] is link g + G*j of an n-vector.
template <typename T, int N, bool COMP, bool COMPOSED, class C>
__device__ __forceinline__ void linv_step(const C& cf, const T* __restrict__ in,
                                          T* __restrict__ out, long long batch, long long b,
                                          const Substeps<T>& subs, int iters_p, int iters_q,
                                          int steps_per_call) {
  using Sh = LinvShape<T, N>;
  constexpr int G = Sh::G, J = Sh::J, S = Sh::S, NSV = COMP ? 6 : 4;
  T* mem = Sh::member();
  const int g = Sh::lane();
  const unsigned mask = Sh::mask();
  auto link = [g](int j) { return g + G * j; };
  auto mine = [g](int j) { return g + G * j < N; };

  // the aux (sin, cos of each link) at q, each lane its links'
  auto aux = [&](const T (&x)[J]) {
    __syncwarp(mask);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (mine(j)) {
        mem[(Sh::kS + link(j)) * S] = dsin(x[j]);
        mem[(Sh::kC + link(j)) * S] = dcos(x[j]);
      }
    }
    __syncwarp(mask);
  };
  // the aux moved to q_new: the first-order shift from q_base in float32
  auto aux_at = [&](const T (&q_new)[J], const T (&q_base)[J]) {
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
  };
  auto factor = [&]() { linv_call<LinvFactor<T, N, C>, N>(cf); };
  // x = K^-1 b into the x slots
  auto solve = [&](const T (&rhs)[J]) {
    __syncwarp(mask);
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (mine(j)) mem[(Sh::kB + link(j)) * S] = rhs[j];
    __syncwarp(mask);
    linv_call<LinvSolve<T, N>, N>();
  };
  auto read_x = [&](T (&x)[J]) {
#pragma unroll
    for (int j = 0; j < J; ++j) x[j] = mine(j) ? mem[(Sh::kX + link(j)) * S] : T(0);
  };
  // dH/dq with w the last solve's x, this lane's links
  auto dhdq = [&](T (&res)[J]) {
    linv_call<LinvDhdq<T, N, C>, N>(cf);
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (mine(j)) res[j] = mem[(Sh::kF + link(j)) * S];
  };

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
        aux(q);
        factor();
      }
      T ph[J], a_last[J], v0[J], vl[J], q1[J], q1p[J], bt[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        ph[j] = p[j] - half * av[j];
        a_last[j] = av[j];
      }
      for (int it = 0; it < iters_p; ++it) {
        solve(ph);
        dhdq(a_last);
#pragma unroll
        for (int j = 0; j < J; ++j) ph[j] = p[j] - half * a_last[j];
      }
      solve(ph);
      read_x(v0);
      const T dth = subs.dth[sub];
#pragma unroll
      for (int j = 0; j < J; ++j) q1[j] = q[j] + h * v0[j] + dth * vd[j];

      if (iters_q == 0) {
        // predictor-factor placement: one factor at the predictor serves the
        // q-refinement and the end-of-step force
        aux(q1);
        factor();
        solve(ph);
        read_x(vl);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          q1p[j] = q1[j];
          q1[j] = q[j] + half * (v0[j] + vl[j]);
        }
        aux_at(q1, q1p);
        dhdq(bt);
      } else {
        for (int it = 0; it < iters_q; ++it) {
          if (it == 0) {
            aux(q1);
          } else {
            aux_at(q1, q1p);
          }
#pragma unroll
          for (int j = 0; j < J; ++j) q1p[j] = q1[j];
          factor();
          solve(ph);
          read_x(vl);
#pragma unroll
          for (int j = 0; j < J; ++j) q1[j] = q[j] + half * (v0[j] + vl[j]);
        }
        // exact end-of-step factor at the converged q1
        aux_at(q1, q1p);
        factor();
        solve(ph);
        dhdq(bt);
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

// The L^-1 forms at size N_, run by linv_step (table: the base family's 3n).
template <typename T, int N_>
struct LinvPolicy {
  static constexpr int N = N_;
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

// Entry k of the shared table, staged in the block's dynamic shared memory
// (addressed from it, so a __noinline__ function reads it as shared).
template <typename T, int N>
struct LinvSharedTable {
  static constexpr bool kPerMember = false;
  __device__ __forceinline__ T operator[](int k) const { return LinvShape<T, N>::table()[k]; }
};

// The L^-1 step's kernel: kMembers members a block, G lanes each.
template <typename T, int N, bool COMP, bool PM, bool COMPOSED>
__global__ void __launch_bounds__(LinvShape<T, N>::kBlock, LinvShape<T, N>::kMinBlocks)
    linv_kernel(const T* __restrict__ coef, const T* __restrict__ in, T* __restrict__ out,
                long long batch, const __grid_constant__ Substeps<T> subs, int iters_p,
                int iters_q, int steps_per_call) {
  using Sh = LinvShape<T, N>;
  const long long b =
      static_cast<long long>(blockIdx.x) * Sh::kMembers + threadIdx.x / Sh::G;
  if constexpr (PM) {
    if (b >= batch) return;
    linv_step<T, N, COMP, COMPOSED>(MemberTable<T>{coef + b, batch}, in, out, batch, b, subs,
                                    iters_p, iters_q, steps_per_call);
  } else {
    T* cf = Sh::table();
    for (int k = threadIdx.x; k < Sh::kTable; k += blockDim.x) cf[k] = coef[k];
    __syncthreads();
    if (b >= batch) return;
    linv_step<T, N, COMP, COMPOSED>(LinvSharedTable<T, N>{}, in, out, batch, b, subs, iters_p,
                                    iters_q, steps_per_call);
  }
}

// Lets the L^-1 kernel have its dynamic shared memory where that is more
// than the default 48 KB, once per instantiation; cudaFuncSetAttribute's
// code.
template <typename T, int N, bool COMP, bool PM, bool COMPOSED>
cudaError_t linv_prepare() {
  using Sh = LinvShape<T, N>;
  if constexpr (Sh::kBytes > 48 * 1024) {
    static const cudaError_t attr =
        cudaFuncSetAttribute(linv_kernel<T, N, COMP, PM, COMPOSED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Sh::kBytes));
    return attr;
  }
  return cudaSuccess;
}

template <typename T, int CASE>
constexpr bool is_linv = std::is_same<typename Variant<T, CASE>::P,
                                      LinvPolicy<T, Variant<T, CASE>::P::N>>::value;

template <typename T, int CASE, bool COMP, bool PM, bool COMPOSED>
int launch(const Args& a) {
  using P = typename Variant<T, CASE>::P;
  if constexpr (is_linv<T, CASE>) {
    using Sh = LinvShape<T, P::N>;
    const cudaError_t attr = linv_prepare<T, P::N, COMP, PM, COMPOSED>();
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const long long blocks = (a.batch + Sh::kMembers - 1) / Sh::kMembers;
    linv_kernel<T, P::N, COMP, PM, COMPOSED>
        <<<static_cast<unsigned int>(blocks), Sh::kBlock, Sh::kBytes, a.stream>>>(
            static_cast<const T*>(a.coef), static_cast<const T*>(a.in),
            static_cast<T*>(a.out), a.batch,
            make_substeps<T>(a.weights, a.n_weights, a.dt), a.iters_p, a.iters_q,
            a.steps_per_call);
  } else {
    const long long blocks = (a.batch + kThreads - 1) / kThreads;
    chain_variant_kernel<T, CASE, COMP, PM, COMPOSED>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, a.stream>>>(
            static_cast<const T*>(a.coef), static_cast<const T*>(a.in),
            static_cast<T*>(a.out), a.batch,
            make_substeps<T>(a.weights, a.n_weights, a.dt), a.iters_p, a.iters_q,
            a.steps_per_call);
  }
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

// The L^-1 kernel of case CASE: out[0..4) = lanes a member, threads a
// block, dynamic shared bytes a block, and the blocks an SM holds at once
// of its instantiation with these modes, not composed (0 where this build
// does not hold it).  0, -1 for another case, or a CUDA error's code.
template <typename T, int CASE>
int linv_layout(int compensated, int per_member, int* out) {
  if constexpr (!is_linv<T, CASE>) {
    return -1;
  } else {
    constexpr int N = Variant<T, CASE>::P::N;
    using Sh = LinvShape<T, N>;
    out[0] = Sh::G;
    out[1] = Sh::kBlock;
    out[2] = static_cast<int>(Sh::kBytes);
    out[3] = 0;
    if constexpr (in_part(CASE, std::is_same<T, double>::value)) {
      auto blocks = [out](auto kernel, cudaError_t attr) {
        return static_cast<int>(attr != cudaSuccess ? attr
                                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                      &out[3], kernel, Sh::kBlock, Sh::kBytes));
      };
      if (compensated)
        return per_member ? blocks(linv_kernel<T, N, true, true, false>,
                                   linv_prepare<T, N, true, true, false>())
                          : blocks(linv_kernel<T, N, true, false, false>,
                                   linv_prepare<T, N, true, false, false>());
      return per_member ? blocks(linv_kernel<T, N, false, true, false>,
                                 linv_prepare<T, N, false, true, false>())
                        : blocks(linv_kernel<T, N, false, false, false>,
                                 linv_prepare<T, N, false, false, false>());
    }
    return 0;
  }
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

// The layout of the L^-1 kernel of case `code` (2 or 3) in dtype_code into
// out[0..4): lanes a member, threads a block, dynamic shared bytes a block,
// and the blocks an SM holds at once of its instantiation with `flags`
// (bits as above), not composed: cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// 0 where this part does not hold that case.  Returns 0, -1 for another
// case or dtype, -2 for bad flags, or a CUDA error's code.
int hamilton_linv_layout(int dtype_code, int code, int flags, int* out) {
  if (flags < 0 || flags > 7 || (flags & 1) || out == nullptr) return -2;
  const int compensated = (flags >> 1) & 1, per_member = (flags >> 2) & 1;
  if (code != 2 && code != 3) return -1;
  if (dtype_code == 0)
    return code == 2 ? linv_layout<float, 2>(compensated, per_member, out)
                     : linv_layout<float, 3>(compensated, per_member, out);
  if (dtype_code == 1)
    return code == 2 ? linv_layout<double, 2>(compensated, per_member, out)
                     : linv_layout<double, 3>(compensated, per_member, out);
  return -1;
}

const char* hamilton_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
