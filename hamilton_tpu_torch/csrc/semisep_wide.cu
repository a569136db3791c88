// Fused whole-step generalized Stormer-Verlet kernel for NVIDIA Hopper
// (sm_90a): the planar serial chain's semiseparable form at n = 40 (the
// reference's stress chain), its member's working set kept on the chip.
//
// Replaces the TPU kernel hamilton_tpu/ops/pallas_step.py::fused_stepper.kernel
// (launched by its _call through pl.pallas_call) traced with
// serial_chain_forms_on (pallas_step.py:991) at n = 40.  It computes
// step_member's step (fused_step.cuh) with chain_forms.cuh's semiseparable
// forms (factor_pass, solve, dhdq), every product and sum in their order,
// so that built without FMA contraction (kernels.SOURCE_FLAGS) its states
// are the plain version's bit for bit.
//
// What bounds it on this card: where a member's working set lives, then
// latency.  A step is a chain of O(n) scans (the factor's recursion with a
// square root and a reciprocal a link, four solves of two scans each, three
// dH/dq of two) against O(100) bytes of state a launch, and 16384 members
// are 124 an SM, one warp a scheduler.  step_member keeps ~22n values a
// member live (the state, the factor's 5n, the aux, the step's vectors):
// at n = 40 ~3.5 KB in float, against 255 registers (~1 KB) a thread; the
// generated and the one-thread kernels spilled 3.6-5.3 KB a thread (float64:
// 9-12 KB), 58-87 MB over the batch, more than the 50 MB of L2, so their
// spills went out to device memory.
//
// What the design does about it:
//   - the member's n-vectors that the scans read live in dynamic shared
//     memory, member-minor (slot k of link i of member m at
//     ((k * n + i) * M + m), M members a block), so a warp's accesses fall
//     on distinct banks (WideSlot): a_est (a_last within a substep), the
//     factor's aux, its z_x, z_y and 1/d, p - half a_last (then the
//     end-of-step dH/dq), a solve's y and x (in place: y_a is stored at
//     link n-1-a, where x_{n-1-a} replaces it), dH/dq's first scan, and the
//     aux at q1 where it left the factor's: in float the shift dq (1600 B a
//     member, 128 members a block, one block and 8 warps an SM: 16384
//     members in one wave), in double its sin and cos (64 members a block:
//     two waves);
//   - the factor's u_x = l_i c_i and u_y = l_i s_i are recomputed from the
//     table and the factor's aux where a solve reads them (the same single
//     rounding), so the factor is 3n values, not 5n; the aux dH/dq reads
//     after the q-refinement (step_member's aux_at: in float a first-order
//     rotation of the factor's) is formed from the shift where it is read,
//     and settled into the factor's aux before a factor at it;
//   - the vectors no scan reads in registers, 4n values a lane (q, p, v0
//     and vdot_est, the predictor q1 within a substep), its loops unrolled,
//     and the Kahan compensations where they fit (else in the output's
//     rows, read and written once a substep);
//   - the scans' loops rolled, unrolled a few links at a time (kScanUnrollF,
//     kScanUnrollD); loading a chunk of links ahead explicitly, double
//     buffered, measured slower (PERF.md section 6);
//   - a member on G lanes (kWideLanesF and kWideLanesD: 2 and 4 of G = 1,
//     2 and 4 measured, PERF.md section 6), each in another warp (lane g of
//     member m is thread g * M + m): lane g owns links [g n/G, (g+1) n/G), the
//     elementwise work and the aux on them, and each scan runs through the
//     lanes in order, handing its two or three running values to the next
//     lane once a scan through the member's carry slots and a named barrier
//     of the member's G warps (bar.sync); the lane that has handed its
//     carry on starts the next scan on its own links, so a lane's part of
//     the solve after a factor overlaps another's part of the factor, and
//     dH/dq's two scans (from the tip, from the base) run at once on
//     different lanes: a lane waits at the barriers ~0.05 % of its step.
//     The float32 straight-line sin/cos, sqrt and 1/x (libm_fast.cuh) are
//     decided lane by lane: in their range they equal the library's bit for
//     bit, so a lane that falls back to the library takes the same values
//     (csrc/libm_check.cu).

// Build: as fused_step.cu (no fast-math), with -fmad=false
// (kernels.SOURCE_FLAGS): with FMA the velocities, good to cond(K) ulps,
// drifted apart from the plain version's at n = 40 (the float32 vdot_est
// 0.33 of its largest magnitude off over one step).  Built as two parts at
// once (kernels.PARTS): part dtype_code, with -DHAMILTON_PART set to it,
// holds one dtype's instantiations; without it, one library holds both.

#include <type_traits>

#include "chain_lanes.cuh"

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

// The member's n-vectors in shared memory, n slots each, by link.
enum WideSlot : int {
  kAv,     // a_est; within a substep the last dH/dq (a_last)
  kSin,    // the aux at the factor's point (its u_x = l c, u_y = l s)
  kCos,
  kZx,     // the factor: z_x, z_y and 1/d
  kZy,
  kId,
  kPh,     // p - half a_last, then the end-of-step dH/dq
  kX,      // a solve's y, then its x (v_last)
  kTmp,    // dH/dq's first scan (its second forms dH/dq from it)
  kShift,  // the aux at q1 where it left the factor's (float: the shift
           // q1 - q1'; double: sin q1), then (iters_q > 0) the last solve
  kShiftC  // double: cos q1
};
// The slots a member in T: float keeps the shift's dq, double the aux.
template <typename T>
constexpr int wide_vectors() {
  return std::is_same<T, double>::value ? kShiftC + 1 : kShift + 1;
}
// The running values each scan hands from lane to lane, after the vectors.
enum WideCarry : int { kFacCarry = 0, kFwdCarry = 3, kBwdCarry = 5, kTipCarry = 7,
                       kBaseCarry = 9, kCarries = 11 };

// Of 32, 64, 96 and 128 members a block (at most 256 threads), the one whose
// blocks hold the most members an SM by shared memory (228 KB an SM, 1 KB of
// it a block), the larger on a tie: `slots` values of `item` bytes a member
// and the shared table's `table`.
constexpr int wide_members(unsigned item, int slots, int table, int g) {
  int best = 0, most = 0;
  for (int m = 32; m <= 128 && m * g <= 256; m += 32) {
    const unsigned bytes = item * (slots * m + table);
    if (bytes > kMaxShared) continue;
    const int members = static_cast<int>(233472 / (bytes + 1024)) * m;
    if (members >= most) {
      most = members;
      best = m;
    }
  }
  return best;
}

// The member's layout at size N_ on G_ lanes.
template <typename T_, int N_, int G_>
struct WideShape {
  using T = T_;
  static constexpr int N = N_, G = G_;
  static constexpr int H = N_ / G_;  // links a lane
  static constexpr int kVectors = wide_vectors<T_>();
  static constexpr int kUnroll = std::is_same<T_, double>::value ? kScanUnrollD : kScanUnrollF;
  static constexpr int kSlots = kVectors * N_ + (G_ > 1 ? kCarries : 0);
  static constexpr int kTable = 3 * N_;  // the shared table, after the members' slots
  static constexpr int M = wide_members(sizeof(T_), kSlots, kTable, G_);  // members a block
  static constexpr int kBlock = M * G_;
  static constexpr unsigned kBytes = sizeof(T_) * (kSlots * M + kTable);
  static constexpr int kMinBlocks = 233472 / (kBytes + 1024);
  // the Kahan compensations in registers where a lane's six register
  // vectors fit 160 (else in the output's rows, read and written once a
  // substep)
  static constexpr bool kRegComp = 6 * H * sizeof(T_) <= 640;
  static_assert(G_ >= 1 && (G_ & (G_ - 1)) == 0 && N_ % G_ == 0, "G: a power of two dividing n");
  static_assert(M > 0 && kMinBlocks >= 1, "a block of members' slots fits the SM");
  // q, p, v0 and q1 at a lane's links in at most 160 registers
  static_assert(4 * H * sizeof(T_) <= 640, "a lane's register vectors fit");
};

// A member's lane: its slots in the block's dynamic shared memory and its
// links [g H, g H + H).
template <class Sh>
struct WideMember {
  using T = typename Sh::T;
  T* mem;  // slot 0 of the member
  int g;   // its lane

  __device__ __forceinline__ T& at(int slot, int i) const {
    return mem[(slot * Sh::N + i) * Sh::M];
  }
  __device__ __forceinline__ T& carry(int c) const {
    return mem[(Sh::kVectors * Sh::N + c) * Sh::M];
  }
  __device__ __forceinline__ int lo() const { return g * Sh::H; }
  // the member's G warps meet (a named barrier a group of members' warps)
  __device__ __forceinline__ void sync() const {
    if constexpr (Sh::G > 1) {
#ifdef __CUDA_ARCH__
      asm volatile("bar.sync %0, %1;"
                   :
                   : "r"(1 + static_cast<int>(threadIdx.x % Sh::M) / 32), "r"(32 * Sh::G)
                   : "memory");
#else
      __syncthreads();
#endif
    }
  }
  // the aux at q1 at link i: where SHIFTED, the factor's aux shifted to q1
  // (float: rotated to first order by the dq in kShift, as the reference's
  // aux_shift; double: sin and cos of q1 in kShift, kShiftC), else the
  // factor's aux
  template <bool SHIFTED>
  __device__ __forceinline__ void aux(int i, T* s, T* c) const {
    if constexpr (!SHIFTED) {
      *s = at(kSin, i);
      *c = at(kCos, i);
    } else if constexpr (std::is_same<T, float>::value) {
      const T dq = at(kShift, i);
      const T s0 = at(kSin, i), c0 = at(kCos, i);
      *s = s0 + dq * c0;
      *c = c0 - dq * s0;
    } else {
      *s = at(kShift, i);
      *c = at(kShiftC, i);
    }
  }
};

// A scan through the lanes from the tip (lane G-1 first) or from the base
// (lane 0 first): stage(start) on this lane at its turn, start on the
// scan's first lane; the member's warps meet between turns.
template <class Sh, class F>
__device__ __forceinline__ void through_lanes(const WideMember<Sh>& m, bool from_tip, F&& stage) {
#pragma unroll
  for (int s = 0; s < Sh::G; ++s) {
    if (m.g == (from_tip ? Sh::G - 1 - s : s)) stage(s == 0);
    if (s + 1 < Sh::G) m.sync();
  }
}

using First = std::true_type;
using Next = std::false_type;

// ---- the factor -------------------------------------------------------------

// The generator recursion (chain_forms.cuh's factor_pass) over this lane's
// links from the tip's side, from the running state (pxx, pxy, pyy),
// with STRAIGHT's square roots and reciprocals; false where one of their
// inputs was outside their range.
template <bool STRAIGHT, class Sh, class C>
__device__ __forceinline__ bool wide_factor_pass(const C& cf, const WideMember<Sh>& m, bool start,
                                                 typename Sh::T& pxx, typename Sh::T& pxy,
                                                 typename Sh::T& pyy) {
  using T = typename Sh::T;
  constexpr int N = Sh::N;
  bool ok = true;
  auto link = [&](int i, auto first) {
    const T ux = cf[i] * m.at(kCos, i);
    const T uy = cf[i] * m.at(kSin, i);
    const T si = cf[N + i];
    T yx, yy;
    if constexpr (decltype(first)::value) {
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
    if constexpr (decltype(first)::value) {
      pxx = zx * zx;
      pxy = zx * zy;
      pyy = zy * zy;
    } else {
      pxx = pxx + zx * zx;
      pxy = pxy + zx * zy;
      pyy = pyy + zy * zy;
    }
    m.at(kZx, i) = zx;
    m.at(kZy, i) = zy;
    m.at(kId, i) = inv_d;
  };
  int i = m.lo() + Sh::H - 1;
  if (start) link(i--, First{});
#pragma unroll (Sh::kUnroll)
  for (; i >= m.lo(); --i) link(i, Next{});
  return ok;
}

// The factor at the aux in kSin, kCos: each lane its links, tip to base; in
// float by the straight line, again by the library's functions where an
// input of the lane's links left their range.
template <class Sh, class C>
__device__ __forceinline__ void wide_factor(const C& cf, const WideMember<Sh>& m) {
  using T = typename Sh::T;
  through_lanes(m, true, [&](bool start) {
    T pxx = T(0), pxy = T(0), pyy = T(0);
    if (!start) {
      pxx = m.carry(kFacCarry);
      pxy = m.carry(kFacCarry + 1);
      pyy = m.carry(kFacCarry + 2);
    }
    T axx = pxx, axy = pxy, ayy = pyy;
    if constexpr (std::is_same<T, float>::value) {
      if (!wide_factor_pass<true>(cf, m, start, axx, axy, ayy)) {
        axx = pxx;
        axy = pxy;
        ayy = pyy;
        wide_factor_pass<false>(cf, m, start, axx, axy, ayy);
      }
    } else {
      wide_factor_pass<false>(cf, m, start, axx, axy, ayy);
    }
    if (m.g > 0) {
      m.carry(kFacCarry) = axx;
      m.carry(kFacCarry + 1) = axy;
      m.carry(kFacCarry + 2) = ayy;
    }
  });
}

// ---- the solve --------------------------------------------------------------

// x = K^-1 b (chain_forms.cuh's solve) on the factor: b in slot `bs`, y and
// then x in slot `xs`, both by link; the forward scan tip to base, the back
// scan base to tip; u_x, u_y from the factor's aux.
template <class Sh, class C>
__device__ __forceinline__ void wide_solve(const C& cf, const WideMember<Sh>& m, int bs, int xs) {
  using T = typename Sh::T;
  through_lanes(m, true, [&](bool start) {
    T sx = T(0), sy = T(0);
    if (!start) {
      sx = m.carry(kFwdCarry);
      sy = m.carry(kFwdCarry + 1);
    }
    auto link = [&](int i, auto first) {
      const T bi = m.at(bs, i);
      T t;
      if constexpr (decltype(first)::value) {
        t = bi;
      } else {
        const T ux = cf[i] * m.at(kCos, i);
        const T uy = cf[i] * m.at(kSin, i);
        t = bi - (ux * sx + uy * sy);
      }
      const T ya = t * m.at(kId, i);
      m.at(xs, i) = ya;
      if constexpr (decltype(first)::value) {
        sx = m.at(kZx, i) * ya;
        sy = m.at(kZy, i) * ya;
      } else {
        sx = sx + m.at(kZx, i) * ya;
        sy = sy + m.at(kZy, i) * ya;
      }
    };
    int i = m.lo() + Sh::H - 1;
    if (start) link(i--, First{});
#pragma unroll (Sh::kUnroll)
    for (; i >= m.lo(); --i) link(i, Next{});
    if (m.g > 0) {
      m.carry(kFwdCarry) = sx;
      m.carry(kFwdCarry + 1) = sy;
    }
  });
  through_lanes(m, false, [&](bool start) {
    T tx = T(0), ty = T(0);
    if (!start) {
      tx = m.carry(kBwdCarry);
      ty = m.carry(kBwdCarry + 1);
    }
    auto link = [&](int i, auto first) {
      const T yi = m.at(xs, i);
      T t;
      if constexpr (decltype(first)::value) {
        t = yi;
      } else {
        t = yi - (m.at(kZx, i) * tx + m.at(kZy, i) * ty);
      }
      const T xa = t * m.at(kId, i);
      m.at(xs, i) = xa;
      const T ux = cf[i] * m.at(kCos, i);
      const T uy = cf[i] * m.at(kSin, i);
      if constexpr (decltype(first)::value) {
        tx = ux * xa;
        ty = uy * xa;
      } else {
        tx = tx + ux * xa;
        ty = ty + uy * xa;
      }
    };
    int i = m.lo();
    if (start) link(i++, First{});
#pragma unroll (Sh::kUnroll)
    for (; i < m.lo() + Sh::H; ++i) link(i, Next{});
    if (m.g < Sh::G - 1) {
      m.carry(kBwdCarry) = tx;
      m.carry(kBwdCarry + 1) = ty;
    }
  });
}

// ---- dH/dq ------------------------------------------------------------------

// dH/dq at the aux (the factor's, or where SHIFTED the one at q1:
// WideMember::aux) with velocity w (slot `ws`) into slot `os`
// (chain_forms.cuh's dhdq, each sum in its order): the scan from the tip
// (qc_k = qc_{k+1} + S_k l_k c_k w_k, qs likewise) and the one from the base
// (pc, ps: the sums of l_j c_j w_j, l_j s_j w_j over j < k) are independent:
// a lane runs the one whose turn comes first storing its values at each link
// (in `os` and kTmp), then the other, forming dH/dq from them.  On one lane,
// the tip's first.
template <bool SHIFTED, class Sh, class C>
__device__ __forceinline__ void wide_dhdq(const C& cf, const WideMember<Sh>& m, int ws, int os) {
  using T = typename Sh::T;
  constexpr int N = Sh::N, G = Sh::G, H = Sh::H;
  // dH/dq at link k (aux sk, ck) from its scans' values (ak, bk as
  // chain_forms.cuh names them)
  auto form = [&](int k, T sk, T ck, T ak, T bk) {
    m.at(os, k) = cf[2 * N + k] * sk + m.at(ws, k) * cf[k] * (sk * ak - ck * bk);
  };
  auto tip = [&](bool start, bool forms) {
    T qc = T(0), qs = T(0);
    if (!start) {
      qc = m.carry(kTipCarry);
      qs = m.carry(kTipCarry + 1);
    }
    auto link = [&](int k, auto first) {
      T sk, ck;
      m.template aux<SHIFTED>(k, &sk, &ck);
      const T lw = cf[k] * m.at(ws, k);
      const T lcw = lw * ck;
      const T lsw = lw * sk;
      if constexpr (decltype(first)::value) {
        qc = cf[N + k] * lcw;
        qs = cf[N + k] * lsw;
      } else {
        qc = qc + cf[N + k] * lcw;
        qs = qs + cf[N + k] * lsw;
      }
      if (forms) {  // the base's sums before k are in os and kTmp
        if (k == 0) {
          form(k, sk, ck, qc, qs);
        } else {
          form(k, sk, ck, cf[N + k] * m.at(os, k) + qc, cf[N + k] * m.at(kTmp, k) + qs);
        }
      } else {
        m.at(os, k) = qc;
        m.at(kTmp, k) = qs;
      }
    };
    int k = m.lo() + H - 1;
    if (start) link(k--, First{});
#pragma unroll (Sh::kUnroll)
    for (; k >= m.lo(); --k) link(k, Next{});
    if (m.g > 0) {
      m.carry(kTipCarry) = qc;
      m.carry(kTipCarry + 1) = qs;
    }
  };
  auto base = [&](bool start, bool forms) {
    T pc = T(0), ps = T(0);
    if (!start) {
      pc = m.carry(kBaseCarry);
      ps = m.carry(kBaseCarry + 1);
    }
    auto link = [&](int k, auto first) {
      T sk, ck;
      m.template aux<SHIFTED>(k, &sk, &ck);
      const T lw = cf[k] * m.at(ws, k);
      const T lcw = lw * ck;
      const T lsw = lw * sk;
      if (forms) {  // the tip's sums from k are in os and kTmp
        if constexpr (decltype(first)::value) {
          form(k, sk, ck, m.at(os, k), m.at(kTmp, k));
        } else {
          form(k, sk, ck, cf[N + k] * pc + m.at(os, k), cf[N + k] * ps + m.at(kTmp, k));
        }
      } else {
        m.at(os, k) = pc;
        m.at(kTmp, k) = ps;
      }
      if constexpr (decltype(first)::value) {
        pc = lcw;
        ps = lsw;
      } else {
        pc = pc + lcw;
        ps = ps + lsw;
      }
    };
    int k = m.lo();
    if (start) link(k++, First{});
#pragma unroll (Sh::kUnroll)
    for (; k < m.lo() + H; ++k) link(k, Next{});
    if (m.g < G - 1) {
      m.carry(kBaseCarry) = pc;
      m.carry(kBaseCarry + 1) = ps;
    }
  };
  // lane g's turn from the tip is G-1-g, from the base g
  const bool tip_first = G - 1 - m.g <= m.g;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const bool tip_turn = m.g == G - 1 - s, base_turn = m.g == s;
    if (tip_turn && tip_first) tip(s == 0, false);
    if (base_turn) base(s == 0, tip_first);
    if (tip_turn && !tip_first) tip(s == 0, true);
    if (s + 1 < G) m.sync();
  }
}

// ---- the aux ------------------------------------------------------------------

// The sin and cos of this lane's angles x into slots ss, cs: in float
// through the straight-line reduction where every angle of the lane is in
// its range, else through the library's one reduction (both sinf and cosf
// bit for bit, csrc/libm_check.cu); in double sin and cos.
template <class Sh>
__device__ __forceinline__ void wide_trig(const WideMember<Sh>& m,
                                          const typename Sh::T (&x)[Sh::H], int ss, int cs) {
  using T = typename Sh::T;
  constexpr int H = Sh::H;
  const int lo = m.lo();
  if constexpr (std::is_same<T, float>::value) {
    bool fast = true;
#pragma unroll
    for (int j = 0; j < H; ++j) fast = fast && sincos_fast_range(x[j]);
    if (fast) {
#pragma unroll
      for (int j = 0; j < H; ++j) sincos_fast(x[j], &m.at(ss, lo + j), &m.at(cs, lo + j));
    } else {
#pragma unroll
      for (int j = 0; j < H; ++j) dsincos(x[j], &m.at(ss, lo + j), &m.at(cs, lo + j));
    }
  } else {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      m.at(ss, lo + j) = dsin(x[j]);
      m.at(cs, lo + j) = dcos(x[j]);
    }
  }
}

// q1 = q + half (v0 + x) (x in kX) at this lane's links, and the aux at it
// (step_member's q-refinement and aux_at): in float the shift q1 - q1' from
// the previous q1 into kShift, in double sin and cos of q1 into kShift and
// kShiftC; WideMember::aux<true> reads them.
template <class Sh>
__device__ __forceinline__ void wide_q1_update(const WideMember<Sh>& m,
                                               const typename Sh::T (&q)[Sh::H],
                                               const typename Sh::T (&v0)[Sh::H],
                                               typename Sh::T (&q1)[Sh::H],
                                               typename Sh::T half) {
  using T = typename Sh::T;
  constexpr int H = Sh::H;
  const int lo = m.lo();
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const T qn = q[j] + half * (v0[j] + m.at(kX, lo + j));
    if constexpr (std::is_same<T, float>::value) m.at(kShift, lo + j) = qn - q1[j];
    q1[j] = qn;
  }
  if constexpr (!std::is_same<T, float>::value) wide_trig(m, q1, kShift, kShiftC);
}

// The aux at q1 as the factor's aux (before a factor at it): in float the
// shift applied (the reference's aux_shift), in double sin and cos of q1.
template <class Sh>
__device__ __forceinline__ void wide_settle(const WideMember<Sh>& m) {
  using T = typename Sh::T;
  const int lo = m.lo();
#pragma unroll (Sh::kUnroll)
  for (int j = 0; j < Sh::H; ++j) {
    T s, c;
    m.template aux<true>(lo + j, &s, &c);
    m.at(kSin, lo + j) = s;
    m.at(kCos, lo + j) = c;
  }
}

// ---- the step -----------------------------------------------------------------

// A lane's Kahan compensation (cq or cp) at its links: registers where
// Sh::kRegComp, else row `row` of the output (written once a substep; a lane
// past the batch's last member reads it and writes nothing).
template <class Sh, bool REG>
struct WideComp {
  using T = typename Sh::T;
  T v[Sh::H];
  __device__ __forceinline__ WideComp(const T* in, T*, long long batch, long long b, int row,
                                      int lo, bool) {
#pragma unroll
    for (int j = 0; j < Sh::H; ++j) v[j] = in[(row * Sh::N + lo + j) * batch + b];
  }
  __device__ __forceinline__ T get(int j) const { return v[j]; }
  __device__ __forceinline__ void set(int j, T x) { v[j] = x; }
  __device__ __forceinline__ void store(T* out, long long batch, long long b, int row, int lo) {
#pragma unroll
    for (int j = 0; j < Sh::H; ++j) out[(row * Sh::N + lo + j) * batch + b] = v[j];
  }
};
template <class Sh>
struct WideComp<Sh, false> {
  using T = typename Sh::T;
  T* at;  // link lo's entry of the row
  long long stride;
  bool active;
  __device__ __forceinline__ WideComp(const T* in, T* out, long long batch, long long b, int row,
                                      int lo, bool act)
      : at(out + (row * Sh::N + lo) * batch + b), stride(batch), active(act) {
    if (active) {
#pragma unroll
      for (int j = 0; j < Sh::H; ++j) at[j * stride] = in[(row * Sh::N + lo + j) * batch + b];
    }
  }
  __device__ __forceinline__ T get(int j) const { return at[j * stride]; }
  __device__ __forceinline__ void set(int j, T x) {
    if (active) at[j * stride] = x;
  }
  __device__ __forceinline__ void store(T*, long long, long long, int, int) {}
};

// steps_per_call dt-steps of member b (step_member's, operation for
// operation) on this lane's links, reading its state from `in` and writing
// it to `out` (where `active`: a lane past the batch's last member steps
// that member's copy and writes nothing), with coefficient entries from `cf`.
template <class Sh, bool COMP, bool COMPOSED, class C>
__device__ __forceinline__ void wide_step(const C& cf, const WideMember<Sh>& m,
                                          const typename Sh::T* __restrict__ in,
                                          typename Sh::T* __restrict__ out, long long batch,
                                          long long b, bool active,
                                          const Substeps<typename Sh::T>& subs, int iters_p,
                                          int iters_q, int steps_per_call) {
  using T = typename Sh::T;
  constexpr int N = Sh::N, H = Sh::H, NSV = COMP ? 6 : 4;
  const int lo = m.lo();

  // the vectors no scan reads, in registers: q, p, v0, and vdot_est (the
  // predictor q1 from it to the substep's end); the Kahan compensations
  T q[H], p[H], v0[H], q1[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const int i = lo + j;
    q[j] = in[(0 * N + i) * batch + b];
    p[j] = in[(1 * N + i) * batch + b];
    m.at(kAv, i) = in[((NSV - 2) * N + i) * batch + b];
    q1[j] = in[((NSV - 1) * N + i) * batch + b];
  }
  WideComp<Sh, Sh::kRegComp> cq(in, out, batch, b, COMP ? 2 : 0, lo, COMP && active);
  WideComp<Sh, Sh::kRegComp> cp(in, out, batch, b, COMP ? 3 : 1, lo, COMP && active);
  bool shifted = false;  // the aux at q1 is WideMember::aux<true>'s

  for (int st = 0; st < steps_per_call; ++st) {
    for (int sub = 0; sub < (COMPOSED ? subs.count : 1); ++sub) {
      const T h = subs.h[sub];
      const T half = subs.half[sub];
      if (st == 0 && sub == 0) {  // peeled: no carried factor at launch entry
        wide_trig(m, q, kSin, kCos);
        wide_factor(cf, m);
      }
#pragma unroll
      for (int j = 0; j < H; ++j) m.at(kPh, lo + j) = p[j] - half * m.at(kAv, lo + j);
      for (int it = 0; it < iters_p; ++it) {
        wide_solve(cf, m, kPh, kX);
        if (shifted) {
          wide_dhdq<true>(cf, m, kX, kAv);
        } else {
          wide_dhdq<false>(cf, m, kX, kAv);
        }
#pragma unroll
        for (int j = 0; j < H; ++j) m.at(kPh, lo + j) = p[j] - half * m.at(kAv, lo + j);
      }
      wide_solve(cf, m, kPh, kX);
      const T dth = subs.dth[sub];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        v0[j] = m.at(kX, lo + j);
        q1[j] = q[j] + h * v0[j] + dth * q1[j];
      }

      if (iters_q == 0) {
        // predictor-factor placement: one factor at the predictor serves the
        // q-refinement and the end-of-step force
        wide_trig(m, q1, kSin, kCos);
        wide_factor(cf, m);
        wide_solve(cf, m, kPh, kX);
        wide_q1_update(m, q, v0, q1, half);
        shifted = true;
        wide_dhdq<true>(cf, m, kX, kPh);
      } else {
        for (int it = 0; it < iters_q; ++it) {
          if (it == 0) {
            wide_trig(m, q1, kSin, kCos);
          } else {
            wide_settle(m);
          }
          wide_factor(cf, m);
          wide_solve(cf, m, kPh, kX);
          wide_q1_update(m, q, v0, q1, half);
        }
        // exact end-of-step factor at the converged q1 (the last solve in the
        // shift's slot, free once settled)
        wide_settle(m);
        shifted = false;
        wide_factor(cf, m);
        wide_solve(cf, m, kPh, kShift);
        wide_dhdq<false>(cf, m, kShift, kPh);
      }
      // increments, accumulation, and the warm-start carries
      const T inv_h = subs.inv_h[sub];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const int i = lo + j;
        const T vl = m.at(kX, i), bt = m.at(kPh, i);
        const T dq = half * (v0[j] + vl);
        const T dp = -half * (m.at(kAv, i) + bt);
        if constexpr (COMP) {
          T x = q[j], c = cq.get(j);
          kahan_add(x, c, dq);
          q[j] = x;
          cq.set(j, c);
          x = p[j];
          c = cp.get(j);
          kahan_add(x, c, dp);
          p[j] = x;
          cp.set(j, c);
        } else {
          q[j] = q[j] + dq;
          p[j] = p[j] + dp;
        }
        q1[j] = (vl - v0[j]) * inv_h;
        m.at(kAv, i) = bt;
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const int i = lo + j;
    out[(0 * N + i) * batch + b] = q[j];
    out[(1 * N + i) * batch + b] = p[j];
    out[((NSV - 2) * N + i) * batch + b] = m.at(kAv, i);
    out[((NSV - 1) * N + i) * batch + b] = q1[j];
  }
  if constexpr (COMP) {
    cq.store(out, batch, b, 2, lo);
    cp.store(out, batch, b, 3, lo);
  }
}

template <typename T>
struct WideLanes {
  static constexpr int value = std::is_same<T, double>::value ? kWideLanesD : kWideLanesF;
};

template <typename T, bool COMP, bool PM, bool COMPOSED>
__global__ void __launch_bounds__(WideShape<T, kWideN, WideLanes<T>::value>::kBlock,
                                  WideShape<T, kWideN, WideLanes<T>::value>::kMinBlocks)
    semisep_wide_kernel(const T* __restrict__ coef, const T* __restrict__ in,
                        T* __restrict__ out, long long batch,
                        const __grid_constant__ Substeps<T> subs, int iters_p, int iters_q,
                        int steps_per_call) {
  using Sh = WideShape<T, kWideN, WideLanes<T>::value>;
  T* shared = dynamic_shared<T>();
  const int member = threadIdx.x % Sh::M;
  const long long first = static_cast<long long>(blockIdx.x) * Sh::M + member;
  const bool active = first < batch;
  const long long b = active ? first : batch - 1;
  const WideMember<Sh> m{shared + member, Sh::G > 1 ? static_cast<int>(threadIdx.x) / Sh::M : 0};
  if constexpr (PM) {
    wide_step<Sh, COMP, COMPOSED>(MemberTable<T>{coef + b, batch}, m, in, out, batch, b, active,
                                  subs, iters_p, iters_q, steps_per_call);
  } else {
    T* cf = shared + Sh::kSlots * Sh::M;
    for (int k = threadIdx.x; k < Sh::kTable; k += blockDim.x) cf[k] = coef[k];
    __syncthreads();
    wide_step<Sh, COMP, COMPOSED>(SharedTable<T>{cf}, m, in, out, batch, b, active, subs,
                                  iters_p, iters_q, steps_per_call);
  }
}

// Lets the kernel have its dynamic shared memory (more than the default 48
// KB), once per instantiation; cudaFuncSetAttribute's code.
template <typename T, bool COMP, bool PM, bool COMPOSED>
cudaError_t wide_prepare() {
  using Sh = WideShape<T, kWideN, WideLanes<T>::value>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(semisep_wide_kernel<T, COMP, PM, COMPOSED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Sh::kBytes));
  return attr;
}

template <typename T, bool COMP, bool PM, bool COMPOSED>
int wide_launch(const Args& a) {
  using Sh = WideShape<T, kWideN, WideLanes<T>::value>;
  const cudaError_t attr = wide_prepare<T, COMP, PM, COMPOSED>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = (a.batch + Sh::M - 1) / Sh::M;
  semisep_wide_kernel<T, COMP, PM, COMPOSED>
      <<<static_cast<unsigned int>(blocks), Sh::kBlock, Sh::kBytes, a.stream>>>(
          static_cast<const T*>(a.coef), static_cast<const T*>(a.in), static_cast<T*>(a.out),
          a.batch, make_substeps<T>(a.weights, a.n_weights, a.dt), a.iters_p, a.iters_q,
          a.steps_per_call);
  return static_cast<int>(cudaGetLastError());
}

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
  if constexpr (in_part(std::is_same<T, double>::value)) {
    return by_modes(compensated, per_member, [&](auto comp, auto pm) {
      constexpr bool kComp = decltype(comp)::value, kPm = decltype(pm)::value;
      return a.n_weights > 1 ? wide_launch<T, kComp, kPm, true>(a)
                             : wide_launch<T, kComp, kPm, false>(a);
    });
  } else {
    return -1;
  }
}

// The layout (hamilton_lane_layout's out) in these modes, not composed; 0
// blocks an SM where this build does not hold the dtype.
template <typename T>
int layout_dtype(int compensated, int per_member, int* out) {
  using Sh = WideShape<T, kWideN, WideLanes<T>::value>;
  if constexpr (in_part(std::is_same<T, double>::value)) {
    return by_modes(compensated, per_member, [&](auto comp, auto pm) {
      constexpr bool kComp = decltype(comp)::value, kPm = decltype(pm)::value;
      const cudaError_t attr = wide_prepare<T, kComp, kPm, false>();
      if (attr != cudaSuccess) return static_cast<int>(attr);
      return kernel_layout(semisep_wide_kernel<T, kComp, kPm, false>, Sh::G, Sh::kBlock,
                           Sh::kBytes, out);
    });
  } else {
    out[0] = Sh::G;
    out[1] = Sh::kBlock;
    out[2] = static_cast<int>(Sh::kBytes);
    out[3] = 0;
    return 0;
  }
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
