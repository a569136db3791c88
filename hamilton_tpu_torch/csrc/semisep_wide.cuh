// The planar serial chain's semiseparable step with a member's links split
// over G lanes, each lane in another warp (semisep_wide_kernel): the
// semiseparable chain at n = 40 (csrc/semisep_wide.cu) and at n = 20
// (csrc/fused_step.cu's variant 0, where routed there).
//
// Replaces the TPU kernel hamilton_tpu/ops/pallas_step.py::fused_stepper.kernel
// (launched by its _call through pl.pallas_call) traced with
// serial_chain_forms_on (pallas_step.py:991).  It computes step_member's step
// (fused_step.cuh) with chain_forms.cuh's semiseparable forms (factor_pass,
// solve, dhdq), every product and sum in their order, so that built without
// FMA contraction its states are the plain version's bit for bit.
//
// What bounds it on this card: latency, and where a member's working set
// lives.  A step is a chain of O(n) scans (the factor's recursion with a
// square root and a reciprocal a link, four solves of two scans each, three
// dH/dq of two) against O(100) bytes of state a launch, and one thread a
// member leaves 16384 members at one warp a scheduler: a launch lasts as long
// as one member's chain of steps, its elementwise third issued by that one
// warp.  step_member keeps ~22n values a member live: at n = 20 that
// exceeds 255 registers (the one-thread kernel spilled ~2 KB a thread), at
// n = 40 (~3.5 KB in float) it spilled 3.6-5.3 KB a thread past the L2.
//
// What the design does about it:
//   - a member on G lanes, each in another warp (lane g of member m is thread
//     g * M + m): lane g owns links [g n/G, (g+1) n/G), the elementwise work,
//     the aux (one sine-cosine reduction a link) and the Kahan updates on
//     them, so a scheduler holds G times the warps and each thread half (G =
//     2) the live set;
//   - each scan runs through the lanes in order, handing its two or three
//     running values to the next lane once a scan through the member's carry
//     slots and a named barrier of the member's G warps (bar.sync); the lane
//     that has handed its carry on starts the next scan on its own links, so
//     a lane's part of the solve after a factor overlaps another's part of
//     the factor, and dH/dq's two scans (from the tip, from the base) run at
//     once on different lanes;
//   - where a scan's loop unrolls all of a lane's links (WideShape's U: 0),
//     the lane's n-vectors live in registers at constant indices, and shared
//     memory holds only the carries and the table (n = 20: a lane's 10 links
//     in float); else they live in dynamic shared memory, member-minor (slot
//     k of link i of member m at ((k * n + i) * M + m), M members a block),
//     so a warp's accesses fall on distinct banks (WideSlot), and the scans'
//     loops roll, unrolled U links at a time (n = 40: 1600 B a member in
//     float);
//   - the factor's u_x = l_i c_i and u_y = l_i s_i are recomputed from the
//     table and the factor's aux where a solve reads them (the same single
//     rounding), so the factor is 3n values, not 5n; the aux dH/dq reads
//     after the q-refinement (step_member's aux_at: in float a first-order
//     rotation of the factor's) is formed from the shift where it is read,
//     and settled into the factor's aux before a factor at it;
//   - q, p, v0 and vdot_est (the predictor q1 within a substep) in registers,
//     and the Kahan compensations where they fit (else in the output's rows,
//     read and written once a substep).
// The float32 straight-line sin/cos, sqrt and 1/x (libm_fast.cuh) are decided
// lane by lane: in their range they equal the library's bit for bit, so a
// lane that falls back to the library takes the same values
// (csrc/libm_check.cu).
// At n = 20 in float (2 lanes, 8 warps an SM, the table in registers too) a
// lane's step read 12272 cycles, 43 % of them in the solves, its barrier
// waits 0.8 % (scripts/k1_phases.py): the lanes overlap, yet the launch took
// 0.83x the one-thread template's time, not the half that splitting its
// elementwise work would give (PERF.md section 6).

#pragma once

#include <type_traits>

#include "chain_lanes.cuh"

namespace {

// The member's n-vectors, n slots each, by link.
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

// The ensemble a kernel with its vectors in registers is built to hold in
// one wave (its __launch_bounds__' blocks an SM): the headline's 16384
// members on the H100's 132 SMs.
constexpr int kWaveMembers = 16384, kWaveSms = 132;

// The member's layout at size N_ on G_ lanes, the scans' loops unrolled U_
// links at a time (0: all of a lane's links, its vectors in registers).
template <typename T_, int N_, int G_, int U_>
struct WideShape {
  using T = T_;
  static constexpr int N = N_, G = G_;
  static constexpr int H = N_ / G_;  // links a lane
  static constexpr int U = U_;
  static constexpr int kUnroll = U_ == 0 ? H : U_;
  static constexpr bool kInRegisters = U_ == 0;
  static constexpr int kVectors = wide_vectors<T_>();
  // the slots a member in shared memory: its vectors (unless in registers)
  // and, on lanes, the carries after them
  static constexpr int kShared = kInRegisters ? 0 : kVectors;
  static constexpr int kSlots = kShared * N_ + (G_ > 1 ? kCarries : 0);
  static constexpr int kTable = 3 * N_;  // the shared table, after the members' slots
  static constexpr int M = wide_members(sizeof(T_), kSlots, kTable, G_);  // members a block
  static constexpr int kBlock = M * G_;
  static constexpr unsigned kBytes = sizeof(T_) * (kSlots * M + kTable);
  static constexpr int kMinBlocks = kInRegisters
                                        ? (kWaveMembers + kWaveSms * M - 1) / (kWaveSms * M)
                                        : 233472 / (kBytes + 1024);
  // the Kahan compensations in registers where a lane's six register
  // vectors fit 160 (else in the output's rows, read and written once a
  // substep)
  static constexpr bool kRegComp = 6 * H * sizeof(T_) <= 640;
  static_assert(G_ >= 1 && (G_ & (G_ - 1)) == 0 && N_ % G_ == 0, "G: a power of two dividing n");
  static_assert(U_ >= 0 && H % kUnroll == 0, "U divides a lane's links");
  static_assert(M > 0 && kMinBlocks >= 1, "a block of members' slots fits the SM");
  // q, p, v0 and q1 at a lane's links in at most 160 registers
  static_assert(4 * H * sizeof(T_) <= 640, "a lane's register vectors fit");
};

// A member's lane: its vectors (in registers, or its slots in the block's
// dynamic shared memory), its carry slots, and its links [g H, g H + H),
// addressed by j = 0 .. H-1 from link g H.
template <class Sh>
struct WideMember {
  using T = typename Sh::T;
  T* mem;     // slot 0 of the member
  int g;      // its lane
  int group;  // its group of 32 members in the block
  T v[Sh::kInRegisters ? Sh::kVectors : 1][Sh::kInRegisters ? Sh::H : 1];

  __device__ __forceinline__ WideMember(T* shared, int member, int lane)
      : mem(shared + member), g(lane), group(member / 32) {}
  __device__ __forceinline__ T& at(int slot, int j) {
    if constexpr (Sh::kInRegisters) {
      return v[slot][j];
    } else {
      return mem[(slot * Sh::N + lo() + j) * Sh::M];
    }
  }
  __device__ __forceinline__ T& carry(int c) const {
    return mem[(Sh::kShared * Sh::N + c) * Sh::M];
  }
  __device__ __forceinline__ int lo() const { return g * Sh::H; }
  // the member's G warps meet (a named barrier a group of members' warps)
  __device__ __forceinline__ void sync() const {
    if constexpr (Sh::G > 1) {
#ifdef __CUDA_ARCH__
      asm volatile("bar.sync %0, %1;"
                   :
                   : "r"(1 + group), "r"(32 * Sh::G)
                   : "memory");
#else
      __syncthreads();
#endif
    }
  }
  // `count` meetings in a row
  __device__ __forceinline__ void syncs(int count) const {
    for (int s = 0; s < count; ++s) sync();
  }
  // the aux at q1 at link j: where SHIFTED, the factor's aux shifted to q1
  // (float: rotated to first order by the dq in kShift, as the reference's
  // aux_shift; double: sin and cos of q1 in kShift, kShiftC), else the
  // factor's aux
  template <bool SHIFTED>
  __device__ __forceinline__ void aux(int j, T* s, T* c) {
    if constexpr (!SHIFTED) {
      *s = at(kSin, j);
      *c = at(kCos, j);
    } else if constexpr (std::is_same<T, float>::value) {
      const T dq = at(kShift, j);
      const T s0 = at(kSin, j), c0 = at(kCos, j);
      *s = s0 + dq * c0;
      *c = c0 - dq * s0;
    } else {
      *s = at(kShift, j);
      *c = at(kShiftC, j);
    }
  }
};

using First = std::true_type;
using Next = std::false_type;

// The table's entries at this lane's links (j = 0 .. H-1 from link lo): l(j)
// the length l_i, s(j) S_i, gls(j) g l_i S_i (chain_forms.cuh's CoefLen),
// read through the table's accessor C at each use.
template <class Sh, class C, bool REG>
struct WideTable {
  using T = typename Sh::T;
  C cf;
  int lo;
  __device__ __forceinline__ WideTable(const C& c, int lane_lo) : cf(c), lo(lane_lo) {}
  __device__ __forceinline__ T l(int j) const { return cf[lo + j]; }
  __device__ __forceinline__ T s(int j) const { return cf[Sh::N + lo + j]; }
  __device__ __forceinline__ T gls(int j) const { return cf[2 * Sh::N + lo + j]; }
};
// ... or in registers, read once a launch, where a lane's vectors live there
// (at n = 20 in float 0.96x the time of reading the table at each use).
template <class Sh, class C>
struct WideTable<Sh, C, true> {
  using T = typename Sh::T;
  T v[3][Sh::H];
  __device__ __forceinline__ WideTable(const C& c, int lane_lo) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int j = 0; j < Sh::H; ++j) v[r][j] = c[r * Sh::N + lane_lo + j];
    }
  }
  __device__ __forceinline__ T l(int j) const { return v[0][j]; }
  __device__ __forceinline__ T s(int j) const { return v[1][j]; }
  __device__ __forceinline__ T gls(int j) const { return v[2][j]; }
};

// A scan through the lanes from the tip (lane G-1 first) or from the base
// (lane 0 first): stage(start) on this lane at its turn, start on the
// scan's first lane; the member's warps meet between turns.  Where a lane's
// vectors live in registers, its stage (every link unrolled) is one copy
// with `start` known at run time (two copies, `start` a constant in each,
// read 1.08x the time at n = 20: PERF.md section 6); else each turn its own
// copy, `start` a constant in each, so that a stage's rolled loop has a
// constant trip count (one copy read 1.06x the time at n = 40).
template <class Sh, class F>
__device__ __forceinline__ void through_lanes(const WideMember<Sh>& m, bool from_tip, F&& stage) {
  if constexpr (Sh::kInRegisters) {
    const int turn = from_tip ? Sh::G - 1 - m.g : m.g;
    m.syncs(turn);
    stage(turn == 0);
    m.syncs(Sh::G - 1 - turn);
  } else {
#pragma unroll
    for (int s = 0; s < Sh::G; ++s) {
      if (m.g == (from_tip ? Sh::G - 1 - s : s)) stage(s == 0);
      if (s + 1 < Sh::G) m.sync();
    }
  }
}

// link(j, First{} or Next{}) at this lane's links from the tip's side (j =
// H-1 down to 0) or from the base's (0 up to H-1), the first of them First
// where the scan starts on this lane (`start`): in registers each at a
// constant index, else in a loop unrolled Sh::kUnroll links at a time.
template <class Sh, bool FROM_TIP, class L>
__device__ __forceinline__ void lane_links(bool start, L&& link) {
  constexpr int H = Sh::H;
  auto at = [](int s) { return FROM_TIP ? H - 1 - s : s; };
  if constexpr (Sh::kInRegisters) {
    if (start) {
      link(at(0), First{});
    } else {
      link(at(0), Next{});
    }
#pragma unroll
    for (int s = 1; s < H; ++s) link(at(s), Next{});
  } else {
    int s = 0;
    if (start) link(at(s++), First{});
#pragma unroll (Sh::kUnroll)
    for (; s < H; ++s) link(at(s), Next{});
  }
}

// ---- the factor -------------------------------------------------------------

// The generator recursion (chain_forms.cuh's factor_pass) over this lane's
// links from the tip's side, from the running state (pxx, pxy, pyy),
// with STRAIGHT's square roots and reciprocals; false where one of their
// inputs was outside their range.
template <bool STRAIGHT, class Sh, class C>
__device__ __forceinline__ bool wide_factor_pass(const C& cf, WideMember<Sh>& m, bool start,
                                                 typename Sh::T& pxx, typename Sh::T& pxy,
                                                 typename Sh::T& pyy) {
  using T = typename Sh::T;
  bool ok = true;
  lane_links<Sh, true>(start, [&](int j, auto first) {
    const T ux = cf.l(j) * m.at(kCos, j);
    const T uy = cf.l(j) * m.at(kSin, j);
    const T si = cf.s(j);
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
    m.at(kZx, j) = zx;
    m.at(kZy, j) = zy;
    m.at(kId, j) = inv_d;
  });
  return ok;
}

// The factor at the aux in kSin, kCos: each lane its links, tip to base; in
// float by the straight line, again by the library's functions where an
// input of the lane's links left their range.
template <class Sh, class C>
__device__ __forceinline__ void wide_factor(const C& cf, WideMember<Sh>& m) {
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
__device__ __forceinline__ void wide_solve(const C& cf, WideMember<Sh>& m, int bs, int xs) {
  using T = typename Sh::T;
  through_lanes(m, true, [&](bool start) {
    T sx = T(0), sy = T(0);
    if (!start) {
      sx = m.carry(kFwdCarry);
      sy = m.carry(kFwdCarry + 1);
    }
    lane_links<Sh, true>(start, [&](int j, auto first) {
      const T bi = m.at(bs, j);
      T t;
      if constexpr (decltype(first)::value) {
        t = bi;
      } else {
        const T ux = cf.l(j) * m.at(kCos, j);
        const T uy = cf.l(j) * m.at(kSin, j);
        t = bi - (ux * sx + uy * sy);
      }
      const T ya = t * m.at(kId, j);
      m.at(xs, j) = ya;
      if constexpr (decltype(first)::value) {
        sx = m.at(kZx, j) * ya;
        sy = m.at(kZy, j) * ya;
      } else {
        sx = sx + m.at(kZx, j) * ya;
        sy = sy + m.at(kZy, j) * ya;
      }
    });
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
    lane_links<Sh, false>(start, [&](int j, auto first) {
      const T yi = m.at(xs, j);
      T t;
      if constexpr (decltype(first)::value) {
        t = yi;
      } else {
        t = yi - (m.at(kZx, j) * tx + m.at(kZy, j) * ty);
      }
      const T xa = t * m.at(kId, j);
      m.at(xs, j) = xa;
      const T ux = cf.l(j) * m.at(kCos, j);
      const T uy = cf.l(j) * m.at(kSin, j);
      if constexpr (decltype(first)::value) {
        tx = ux * xa;
        ty = uy * xa;
      } else {
        tx = tx + ux * xa;
        ty = ty + uy * xa;
      }
    });
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
__device__ __forceinline__ void wide_dhdq(const C& cf, WideMember<Sh>& m, int ws, int os) {
  using T = typename Sh::T;
  constexpr int G = Sh::G;
  // dH/dq at link j (aux sk, ck) from its scans' values (ak, bk as
  // chain_forms.cuh names them)
  auto form = [&](int j, T sk, T ck, T ak, T bk) {
    m.at(os, j) = cf.gls(j) * sk + m.at(ws, j) * cf.l(j) * (sk * ak - ck * bk);
  };
  // `forms`: the base's sums are in os and kTmp, so this scan forms dH/dq
  auto tip = [&](bool start, bool forms) {
    T qc = T(0), qs = T(0);
    if (!start) {
      qc = m.carry(kTipCarry);
      qs = m.carry(kTipCarry + 1);
    }
    lane_links<Sh, true>(start, [&](int j, auto first) {
      T sk, ck;
      m.template aux<SHIFTED>(j, &sk, &ck);
      const T lw = cf.l(j) * m.at(ws, j);
      const T lcw = lw * ck;
      const T lsw = lw * sk;
      if constexpr (decltype(first)::value) {
        qc = cf.s(j) * lcw;
        qs = cf.s(j) * lsw;
      } else {
        qc = qc + cf.s(j) * lcw;
        qs = qs + cf.s(j) * lsw;
      }
      if (forms) {
        if (j == 0 && m.g == 0) {
          form(j, sk, ck, qc, qs);
        } else {
          form(j, sk, ck, cf.s(j) * m.at(os, j) + qc, cf.s(j) * m.at(kTmp, j) + qs);
        }
      } else {
        m.at(os, j) = qc;
        m.at(kTmp, j) = qs;
      }
    });
    if (m.g > 0) {
      m.carry(kTipCarry) = qc;
      m.carry(kTipCarry + 1) = qs;
    }
  };
  // `forms`: the tip's sums from k are in os and kTmp
  auto base = [&](bool start, bool forms) {
    T pc = T(0), ps = T(0);
    if (!start) {
      pc = m.carry(kBaseCarry);
      ps = m.carry(kBaseCarry + 1);
    }
    lane_links<Sh, false>(start, [&](int j, auto first) {
      T sk, ck;
      m.template aux<SHIFTED>(j, &sk, &ck);
      const T lw = cf.l(j) * m.at(ws, j);
      const T lcw = lw * ck;
      const T lsw = lw * sk;
      if (forms) {
        if constexpr (decltype(first)::value) {
          form(j, sk, ck, m.at(os, j), m.at(kTmp, j));
        } else {
          form(j, sk, ck, cf.s(j) * pc + m.at(os, j), cf.s(j) * ps + m.at(kTmp, j));
        }
      } else {
        m.at(os, j) = pc;
        m.at(kTmp, j) = ps;
      }
      if constexpr (decltype(first)::value) {
        pc = lcw;
        ps = lsw;
      } else {
        pc = pc + lcw;
        ps = ps + lsw;
      }
    });
    if (m.g < G - 1) {
      m.carry(kBaseCarry) = pc;
      m.carry(kBaseCarry + 1) = ps;
    }
  };
  // lane g's turn from the tip is G-1-g, from the base g (each scan's stage
  // copied as through_lanes copies it)
  if constexpr (Sh::kInRegisters) {
    const int tip_turn = G - 1 - m.g, base_turn = m.g;
    if (tip_turn <= base_turn) {
      m.syncs(tip_turn);
      tip(tip_turn == 0, false);
      m.syncs(base_turn - tip_turn);
      base(base_turn == 0, true);
      m.syncs(G - 1 - base_turn);
    } else {
      m.syncs(base_turn);
      base(base_turn == 0, false);
      m.syncs(tip_turn - base_turn);
      tip(tip_turn == 0, true);
      m.syncs(G - 1 - tip_turn);
    }
  } else {
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
}

// ---- the aux ------------------------------------------------------------------

// The sin and cos of this lane's angles x into slots ss, cs: in float
// through the straight-line reduction where every angle of the lane is in
// its range, else through the library's one reduction (both sinf and cosf
// bit for bit, csrc/libm_check.cu); in double sin and cos.
template <class Sh>
__device__ __forceinline__ void wide_trig(WideMember<Sh>& m, const typename Sh::T (&x)[Sh::H],
                                          int ss, int cs) {
  using T = typename Sh::T;
  constexpr int H = Sh::H;
  if constexpr (std::is_same<T, float>::value) {
    bool fast = true;
#pragma unroll
    for (int j = 0; j < H; ++j) fast = fast && sincos_fast_range(x[j]);
    if (fast) {
#pragma unroll
      for (int j = 0; j < H; ++j) sincos_fast(x[j], &m.at(ss, j), &m.at(cs, j));
    } else {
#pragma unroll
      for (int j = 0; j < H; ++j) dsincos(x[j], &m.at(ss, j), &m.at(cs, j));
    }
  } else {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      m.at(ss, j) = dsin(x[j]);
      m.at(cs, j) = dcos(x[j]);
    }
  }
}

// q1 = q + half (v0 + x) (x in kX) at this lane's links, and the aux at it
// (step_member's q-refinement and aux_at): in float the shift q1 - q1' from
// the previous q1 into kShift, in double sin and cos of q1 into kShift and
// kShiftC; WideMember::aux<true> reads them.
template <class Sh>
__device__ __forceinline__ void wide_q1_update(WideMember<Sh>& m,
                                               const typename Sh::T (&q)[Sh::H],
                                               const typename Sh::T (&v0)[Sh::H],
                                               typename Sh::T (&q1)[Sh::H],
                                               typename Sh::T half) {
  using T = typename Sh::T;
  constexpr int H = Sh::H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const T qn = q[j] + half * (v0[j] + m.at(kX, j));
    if constexpr (std::is_same<T, float>::value) m.at(kShift, j) = qn - q1[j];
    q1[j] = qn;
  }
  if constexpr (!std::is_same<T, float>::value) wide_trig(m, q1, kShift, kShiftC);
}

// The aux at q1 as the factor's aux (before a factor at it): in float the
// shift applied (the reference's aux_shift), in double sin and cos of q1.
template <class Sh>
__device__ __forceinline__ void wide_settle(WideMember<Sh>& m) {
  using T = typename Sh::T;
#pragma unroll (Sh::kUnroll)
  for (int j = 0; j < Sh::H; ++j) {
    T s, c;
    m.template aux<true>(j, &s, &c);
    m.at(kSin, j) = s;
    m.at(kCos, j) = c;
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
__device__ __forceinline__ void wide_step(const C& table, WideMember<Sh>& m,
                                          const typename Sh::T* __restrict__ in,
                                          typename Sh::T* __restrict__ out, long long batch,
                                          long long b, bool active,
                                          const Substeps<typename Sh::T>& subs, int iters_p,
                                          int iters_q, int steps_per_call) {
  using T = typename Sh::T;
  constexpr int N = Sh::N, H = Sh::H, NSV = COMP ? 6 : 4;
  const int lo = m.lo();
  const WideTable<Sh, C, Sh::kInRegisters> cf(table, lo);

  // q, p, v0, and vdot_est (the predictor q1 from it to the substep's end)
  // in registers; the Kahan compensations
  T q[H], p[H], v0[H], q1[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const int i = lo + j;
    q[j] = in[(0 * N + i) * batch + b];
    p[j] = in[(1 * N + i) * batch + b];
    m.at(kAv, j) = in[((NSV - 2) * N + i) * batch + b];
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
      for (int j = 0; j < H; ++j) m.at(kPh, j) = p[j] - half * m.at(kAv, j);
      for (int it = 0; it < iters_p; ++it) {
        wide_solve(cf, m, kPh, kX);
        if (shifted) {
          wide_dhdq<true>(cf, m, kX, kAv);
        } else {
          wide_dhdq<false>(cf, m, kX, kAv);
        }
#pragma unroll
        for (int j = 0; j < H; ++j) m.at(kPh, j) = p[j] - half * m.at(kAv, j);
      }
      wide_solve(cf, m, kPh, kX);
      const T dth = subs.dth[sub];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        v0[j] = m.at(kX, j);
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
        const T vl = m.at(kX, j), bt = m.at(kPh, j);
        const T dq = half * (v0[j] + vl);
        const T dp = -half * (m.at(kAv, j) + bt);
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
        m.at(kAv, j) = bt;
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const int i = lo + j;
    out[(0 * N + i) * batch + b] = q[j];
    out[(1 * N + i) * batch + b] = p[j];
    out[((NSV - 2) * N + i) * batch + b] = m.at(kAv, j);
    out[((NSV - 1) * N + i) * batch + b] = q1[j];
  }
  if constexpr (COMP) {
    cq.store(out, batch, b, 2, lo);
    cp.store(out, batch, b, 3, lo);
  }
}

// ---- the kernel, its launch and its layout ---------------------------------

// The step of the semiseparable chain at size N on G lanes a member, its
// scans unrolled U links at a time (WideShape): M members a block.
template <typename T, int N, int G, int U, bool COMP, bool PM, bool COMPOSED>
__global__ void __launch_bounds__(WideShape<T, N, G, U>::kBlock,
                                  WideShape<T, N, G, U>::kMinBlocks)
    semisep_wide_kernel(const T* __restrict__ coef, const T* __restrict__ in,
                        T* __restrict__ out, long long batch,
                        const __grid_constant__ Substeps<T> subs, int iters_p, int iters_q,
                        int steps_per_call) {
  using Sh = WideShape<T, N, G, U>;
  T* shared = dynamic_shared<T>();
  const int member = threadIdx.x % Sh::M;
  const long long first = static_cast<long long>(blockIdx.x) * Sh::M + member;
  const bool active = first < batch;
  const long long b = active ? first : batch - 1;
  WideMember<Sh> m(shared, member, Sh::G > 1 ? static_cast<int>(threadIdx.x) / Sh::M : 0);
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
// KB at n = 40), once per instantiation; cudaFuncSetAttribute's code.
template <typename T, int N, int G, int U, bool COMP, bool PM, bool COMPOSED>
cudaError_t wide_prepare() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(semisep_wide_kernel<T, N, G, U, COMP, PM, COMPOSED>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(WideShape<T, N, G, U>::kBytes));
  return attr;
}

template <typename T, int N, int G, int U, bool COMP, bool PM, bool COMPOSED>
int wide_launch(const Args& a) {
  using Sh = WideShape<T, N, G, U>;
  const cudaError_t attr = wide_prepare<T, N, G, U, COMP, PM, COMPOSED>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = (a.batch + Sh::M - 1) / Sh::M;
  semisep_wide_kernel<T, N, G, U, COMP, PM, COMPOSED>
      <<<static_cast<unsigned int>(blocks), Sh::kBlock, Sh::kBytes, a.stream>>>(
          static_cast<const T*>(a.coef), static_cast<const T*>(a.in), static_cast<T*>(a.out),
          a.batch, make_substeps<T>(a.weights, a.n_weights, a.dt), a.iters_p, a.iters_q,
          a.steps_per_call);
  return static_cast<int>(cudaGetLastError());
}

// The layout (kernel_layout's out) of the kernel in modes COMP, PM, not
// composed; where the build does not hold it (HELD false), its shape with 0
// blocks an SM.
template <typename T, int N, int G, int U, bool COMP, bool PM, bool HELD>
int wide_layout(int* out) {
  using Sh = WideShape<T, N, G, U>;
  if constexpr (HELD) {
    const cudaError_t attr = wide_prepare<T, N, G, U, COMP, PM, false>();
    if (attr != cudaSuccess) return static_cast<int>(attr);
    return kernel_layout(semisep_wide_kernel<T, N, G, U, COMP, PM, false>, Sh::G, Sh::kBlock,
                         Sh::kBytes, out);
  } else {
    out[0] = Sh::G;
    out[1] = Sh::kBlock;
    out[2] = static_cast<int>(Sh::kBytes);
    out[3] = 0;
    return 0;
  }
}

}  // namespace
