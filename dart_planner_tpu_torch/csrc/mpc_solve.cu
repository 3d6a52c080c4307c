// Fused projected-Newton solve of the condensed SE(3) MPC, one launch per
// batch, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dart_planner_tpu/ops/pallas_mpc.py
// (solve_thrusts_fused :806, body _solver_kernel :149, constants
// _static_operands :71). It computes what that kernel computes, per
// scenario and per Newton round:
//   - an exact fp32 rollout through S_p/m and S_v/m;
//   - the gradient of the quadratic terms and of the hinges (obstacle
//     sphere, ground, velocity envelope with an optional per-scenario cap,
//     tilt cone, thrust norm), pulled back to thrust space;
//   - an active-set mask on the thrust box;
//   - Jacobi-preconditioned CG with Steihaug truncation, the Hessian applied
//     matrix-free (Gauss-Newton hinge blocks for n_gn rounds, then full
//     curvature with a clamped, floored Jacobi diagonal);
//   - a projected line search over the given alphas that keeps the current
//     iterate unless a candidate is strictly better (earliest alpha on
//     ties);
//   - the running minimum of the relative improvement (the ftol input),
//     restarted at +inf when the full-curvature stage begins;
// then a final exact rollout and cost pass and, where the launch asks for it,
// the projected-gradient norm ||clamp(u - g, lb, ub) - u|| of the final
// iterate (the gradient code of a round's start, without its curvature: a
// sphere pass, a pull-back and a butterfly; 1-2% of a 12-round launch at
// N = 20 and 100 on an H100, by CUDA events against the launch without
// it). Everything runs in exact fp32 (the TPU kernel ran the CG matvec and
// the line-search deltas in bf16).
//
// Layout: one warp per scenario, lane k = horizon step k; a lane holds S =
// ceil(N / 32) steps, k, k+32, k+64, ..., in slots 0..S-1, so any N >= 1
// runs (as the JAX kernel takes any N). At one or two steps a lane every
// per-step vector lives in registers. At three or four, the per-step data
// that a CG step only reads (the curvature blocks and free, 21 floats a
// step) and the goal and c0 live in the warp's shared memory, laid out
// [slot][field][lane]: each lane reads and writes only its own column, so a
// warp's access is 32 consecutive words (no bank conflict) and needs no
// barrier. From five steps a lane on, one instantiation (S = kDyn) reads
// the step count at run time and keeps every per-step vector in that
// layout: the thrusts, the gradient, the CG vectors, the rollouts and their
// scans' temporaries as well, 73 floats a step (kDynFields, reckoned from
// the code below), in blocks of one warp. That arena lies in dynamic shared
// memory while the block's 4K + 32 x 73 x S floats fit the card's opt-in
// maximum a block (read at launch: 232,448 B on an H100, so S <= 24, N <=
// 768 for K <= 512), else in a global scratch of B x 32 x 73 x S floats
// that the wrapper allocates (from N = 769); one float* serves both. Lanes
// with k >= N hold exact zeros and free = 0. Per-scenario sums use a
// __shfl_xor_sync butterfly, which leaves a bit-identical value on every
// lane, so every branch decision is warp-uniform. The line search's alphas,
// any count of them, follow the two step vectors in the constant block.
//
// The packed arm (S = kPack + s): up to N = 32, once the batch passes one
// wave of one scenario a warp, a warp holds four scenarios, each on a
// segment of 8 lanes, and lane j of a segment holds s = ceil(N / 8)
// consecutive steps, s j .. s j + s - 1 (at N=20, s=3: 24 slots for 20
// steps, where one scenario a warp fills 20 of 32 lanes). Its sums are
// butterflies over the segment (xor 4, 2, 1), which never leave it, so
// every decision is segment-uniform: the CG's negative-curvature exit
// freezes the segment's d, r, p and rz, and the warp leaves the loop once
// all four of its scenarios are frozen (__ballot_sync); the steepest-descent
// fallback and the line search's strict improvement are per-lane selects;
// each segment compacts its own live spheres; a segment past the batch runs
// the last scenario's inputs and writes nothing (it may not return: its
// warp-mates meet it at every shuffle). No value crosses a segment, so a
// scenario's outputs do not depend on its warp-mates. At three and four
// steps a lane its read-mostly data lies in the warp's shared memory as the
// S = 3 and 4 arms'.
//
// The constant maps are structured (ops/dynamics.py): S_v[k,j] = dt and
// S_p[k,j] = dt^2 (k - j - 1/2) for j < k. So every map is applied as warp
// scans over the lanes (a shift and 5 __shfl_up_sync / __shfl_down_sync
// levels; on the packed arm a serial sum over a lane's steps, 3 levels over
// the segment and a shuffle for the carry from the lane below: 4 shuffles
// an axis serve four scenarios where 6 served one), and no N x N map is
// read anywhere. With E the exclusive prefix sum and F the exclusive
// suffix sum,
//   S_v x = dt E(x),   S_p x = dt^2 (E(x)/2 + E(E(x))),
//   S_p^T a + S_v^T b = dt^2 (R/2 + F(R)) + dt F(b),  R = F(a),
// so a map pair is two chained scans per axis, a chain of 12 shuffle levels
// where the dense maps took 20 dependent FMAs each. Every weight in these
// sums is positive, so no step subtracts large partial sums. The rollout
// sums accelerations a = u/m + g, as the plain loop does (pos = p0 + t v0 +
// S_p a), so hover thrust and gravity cancel before they are summed; the CG
// matvec and the gradient pull-back use S/m. The quadratic Hessian
// H = 2/m^2 [w_p S_p^T W S_p + w_v S_v^T S_v] + 2(w_a/m^2 + w_T) I never
// exists as a matrix: one CG matvec is
//   (S_p/m)^T [(2 wp_k I + h_k) yp_k] + (S_v/m)^T [(2 w_v + hv_k) yv_k]
//   + 2 (w_a/m^2 + w_T) dv + the per-step tilt and thrust-norm blocks,
// yp = (S_p/m) dv, yv = (S_v/m) dv: two forward and two backward scans per
// axis in place of five dense maps. The Jacobi diagonal's
// sum_k (S_p/m)[k,j]^2 h_k uses
//   sum_{k>j} (k-j-1/2)^2 h_k = F(h/4 + 2 (R1 + F(R1)))_j,  R1 = F(h),
// three suffix scans once a round, again with positive weights only. Lanes
// k >= N hold zeros, so suffix sums are unaffected; prefix sums run on past
// N and are masked. Each warp keeps its scenario's live spheres, compacted
// in order when it loads them (a masked sphere adds exactly 0 to every sum),
// and the sphere loops are unrolled by 4 so that their square roots and
// divisions overlap. The only constants left are two step vectors (t and
// diag H) and the alphas.
//
// What bounds it (N=20, K=8 with 4 live spheres, the default budget of 12
// rounds at CG-10 and 6 alphas). The work the function needs, counted in
// chip_smoke.py::b1_bound (the scans, the sphere passes, precise square
// roots and divisions), is ~56 us of fp32 issue at B=4096, and its traffic
// ~2 MB; so no peak binds. Each warp's dependent chain does: a CG step is
// four scans of 6 dependent shuffle levels and two dependent butterflies
// of 5 (~34 levels, ~90 shuffles), a round ~500 levels with the rollouts,
// pull-backs, Jacobi scans and the 6 candidate rollouts and cost passes,
// ~6k for the solve. On an H100 (700 W) the kernel alone takes ~0.22 ms
// for one scenario (B=1) and ~0.57 ms for B=4096 (chip_smoke.py phase 7):
// B=4096 runs as two waves of such chains, ~0.29 ms each, so the 16 warps
// of an SM slow each other's chain by only about a third. Throughput is
// then the scenarios an SM keeps in flight over one chain: the packed arm
// holds 48 an SM at N=20 (12 warps), against 16, and its chain is longer
// (0.41 ms alone: each lane does three steps' work in every per-step pass)
// but serves four scenarios; B=131,072 takes 11.3 ms against 18.4, ~0.55 ms
// a wave of 6,336 (an H100; PERF.md). A packed warp runs its sphere loops
// and CG steps until its longest segment is done, and a block's warps
// retire together, so a batch of mixed live spheres (the closed loop's 0-11
// of 11 slots) runs in an order by live spheres that the launch passes:
// B=16,384 takes 1.61-1.83 ms so, against 3.61-3.95 in the batch's own
// order (an H100; PERF.md).
//
// Occupancy: blocks of kWarps<S> warps. At one step a lane, 4 warps and
// __launch_bounds__ asks for 4 resident blocks (<= 128 registers): 528
// slots of 16 warps an SM, one wave of 2,112 scenarios on an H100's 132
// SMs. Up to one such wave (B=1 and the stacks that plan one vehicle) every
// scenario is in flight either way, and the shorter dependent chain of one
// scenario a warp is what counts, so N <= 32 takes the packed arm only past
// it. At two steps, 4 warps and 2 blocks (<= 255 registers); from three
// on, 2 warps and 4 blocks: 8 warps an SM, B=4096 in ~3.9 waves. The packed
// arm runs blocks of 2 warps (8 scenarios): ptxas reads 112 registers at
// one step a lane (8 blocks asked for), 168 at two (5), 162 at three (6:
// 12 warps, 48 scenarios an SM, each warp 10.4 KB of shared memory, 6
// blocks 131 KB of the 228 KB) and 203 at four (4), 0 spill bytes (an
// H100, CUDA 12.8).
//
// Registers bound the steps a lane. Every per-step vector costs S x 3
// registers, and ptxas read 118 registers at S=1 and 193 at S=2, ~75 more a
// slot: all in registers, S=3 would need ~268 and S=4 ~343, past the 255 a
// thread has, so the CG vectors and Hessian blocks would spill in every CG
// step. From S=3 on the 27 read-mostly floats a step (a round's curvature
// blocks and free, 21; the goal and c0, 6) live in the warp's shared
// memory instead: ptxas reads 167 registers at S=3 and 217 at S=4 (and,
// with the final norm's pass in the kernel, 123 at S=1 and 190 at S=2), 0
// spill bytes (an H100, CUDA 12.8), for 27 x 4 B x 32 x S of shared memory a
// warp (10.4 KB at S=3, 13.8 KB at S=4; a block of 2 warps 28 KB, 4
// blocks an SM 111 KB of the 228 KB). The work grows with N (each scan's
// shuffles with S, every other pass with the steps), and so does each
// warp's chain, by S-1 carries a scan: at B=4096 the kernel alone takes
// ~1.4 ms at N=40, ~2.4 ms at S=3 and ~3.1 ms at S=4 (chip_smoke.py
// phase 18d).
// From S = 5 on every vector access goes through the arena, and a warp's
// arena of 45.6 KB (S=5) to 219 KB (S=24) of shared memory leaves an SM 4
// to 1 resident warps. That instantiation is compiled apart, in
// mpc_solve_steps.cu, which includes this file with B1_RUN_TIME_STEPS
// defined: there its loops over a lane's slots stay rolled ("unroll 1"),
// where up to four steps a lane they unroll fully. nvcc unrolls a loop
// under `#pragma unroll` whose count is read at run time anyway, by a
// large factor behind a remainder loop, in every inlined call: built that
// way the kernels took 83-96 s to compile, rolled ~19 s (CUDA 12.8;
// chip_smoke.py's build line, PERF.md). It is right, not fast: at B=4096
// the kernel alone takes ~33 ms at N=160 and ~254 ms at N=769, its arena
// in global scratch (chip_smoke.py phase 18f).
//
// What it does not use, and why: no tensor cores (once the maps are scans no
// product is left large enough for an mma tile, and a TF32 product would
// break the exact-fp32 rollout); no TMA or cp.async pipeline (each scenario
// reads ~1.4 KB once); no shared memory for maps (there are none), only
// each scenario's obstacle spheres. Packing is by segments of 8 lanes and
// consecutive steps a lane, so that it serves every N <= 32 (the default
// N = 20 included), not only the N <= 16 that two scenarios of 16 lanes a
// step would fill; past 32 steps one scenario keeps a warp.

#include <cuda_runtime.h>
#include <math.h>

// How a loop over a lane's slots unrolls: fully up to four steps a lane,
// where the count is S; not at all in mpc_solve_steps.cu, where it is read
// at run time (see above).
#ifdef B1_RUN_TIME_STEPS
#define B1_UNROLL_SLOTS _Pragma("unroll 1")
#else
#define B1_UNROLL_SLOTS _Pragma("unroll")
#endif

namespace {

// S names an arm. S = 1..4: one scenario a warp, S = ceil(N / 32) steps a
// lane. S = kDyn stands for five or more horizon steps a lane: their count,
// ceil(N / 32), is read at run time (Arena::n). S = kPack + s (s = 1..4) is
// the packed arm, N <= 32: four scenarios a warp, each on a segment of
// kSegLanes lanes, s = ceil(N / 8) consecutive steps a lane.
constexpr int kDyn = 5;
constexpr int kPack = 8;
constexpr int kSegLanes = 8;
template <int S>
constexpr bool kPacked = S > kPack;
// Steps a lane (slots): S, or s on the packed arm.
template <int S>
constexpr int kSlots = kPacked<S> ? S - kPack : S;
// Scenarios a warp.
template <int S>
constexpr int kPerWarp = kPacked<S> ? 32 / kSegLanes : 1;

// Warps per block at S steps a lane: 4; 2 at three and four and on the
// packed arm, where each warp holds 10-14 KB of shared memory from three
// steps a lane on, so a block stays under the 48 KB every launch gets
// without cudaFuncSetAttribute; 1 from five on, where a warp's arena is
// 45.6 KB or more.
template <int S>
constexpr int kWarps = S == kDyn ? 1 : (S >= 3 ? 2 : 4);
// Resident blocks an SM __launch_bounds__ asks for: 4 at one step a lane
// (<= 128 registers), 2 at two (<= 255), 4 of 2 warps at three and four
// (<= 255), 16 of one warp from five on (<= 128: a lane keeps only a
// step's scalars in registers there). On the packed arm, blocks of 2
// warps: 8 at one step a lane (<= 128 registers), 5 at two (<= 200), 6 at
// three (<= 168: 12 warps, 48 scenarios an SM), 4 at four (<= 255).
constexpr int kPackedBlocks[4] = {8, 5, 6, 4};
template <int S>
constexpr int kMinBlocks =
    kPacked<S> ? kPackedBlocks[kSlots<S> - 1] : (S == kDyn ? 16 : (S == 2 ? 2 : 4));
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// Must match dart_planner_tpu_torch/ops/cuda_mpc.py::_Params field by field.
struct MpcParams {
  int B, N, K;
  int n_gn, n_full, cg_iters, n_alpha;
  int use_obstacles, use_ground, use_vel_hinge, use_tilt, use_tnorm;
  float inv_m, inv_m_lo, hover, g_z;
  float w_p, w_pN, w_v, w_a, w_T;
  float w_obs, w_g, z_min, w_vb, v_max, w_tilt, tan_max, w_tn, u_max;
  float lb[3], ub[3];
  float dt;
};

namespace {

// F floats for each of a lane's S steps, read as x[s][f]: registers at one
// or two steps a lane; from three on, this lane's column of a block of the
// warp's arena laid out [slot][field][lane].
template <int S, int F, bool Shared = (kSlots<S> >= 3)>
struct Steps {
  float v[kSlots<S>][F];
  __device__ __forceinline__ float (&operator[](int s))[F] { return v[s]; }
  __device__ __forceinline__ const float (&operator[](int s) const)[F] { return v[s]; }
};

template <int F>
struct SharedRow {
  float* p;
  __device__ __forceinline__ float& operator[](int f) const { return p[32 * f]; }
};

template <int S, int F>
struct Steps<S, F, true> {
  float* p;  // slot 0, field 0 of this lane's column
  __device__ __forceinline__ SharedRow<F> operator[](int s) const { return {p + 32 * F * s}; }
};

// From five steps a lane on, the slot count travels with the vector. No
// default constructor: every such vector is taken from the arena.
template <int F>
struct Steps<kDyn, F, true> {
  float* p;
  int n;  // slots, ceil(N / 32)
  __device__ __forceinline__ Steps(float* p_, int n_) : p(p_), n(n_) {}
  __device__ __forceinline__ SharedRow<F> operator[](int s) const { return {p + 32 * F * s}; }
};

// A per-step 3-vector (thrusts, gradients, CG vectors, rollouts): registers
// up to four steps a lane, the arena from five on.
template <int S>
using Vec = Steps<S, 3, S == kDyn>;

// Slots a lane holds: kSlots<S>, or at S = kDyn the count read at run time.
template <int S, class V>
__device__ __forceinline__ int slots(const V& x) {
  if constexpr (S == kDyn) {
    return x.n;
  } else {
    return kSlots<S>;
  }
}

// The horizon step in slot s of lane `lane`: k = lane + 32 s, or on the
// packed arm, where `lane` is the lane's place in its segment, k = s_n lane
// + s for s_n steps a lane.
template <int S>
__device__ __forceinline__ int step_at(int lane, int s) {
  return kPacked<S> ? kSlots<S> * lane + s : lane + 32 * s;
}

// A warp's arena: this lane's column of a region of shared or global memory
// laid out [slot][field][lane]. take() hands out the next F fields of every
// slot; a callee takes from its own copy, so what it took is free again
// when it returns: the arena is a stack. At S = kDyn a take past the
// arena's end traps.
struct Arena {
  float* p;  // this lane's next free float
  int n;     // slots a lane, ceil(N / 32)
  int left;  // floats of the warp's arena not yet taken
};

// The next F fields of every slot of the arena as a Steps<S, F, Shared>
// (registers take nothing from it).
template <int S, int F, bool Shared = (kSlots<S> >= 3)>
__device__ __forceinline__ Steps<S, F, Shared> take(Arena& ar) {
  if constexpr (!Shared) {
    return {};
  } else if constexpr (S == kDyn) {
    ar.left -= 32 * F * ar.n;
    if (ar.left < 0) __trap();
    const Steps<S, F, true> x(ar.p, ar.n);
    ar.p += 32 * F * ar.n;
    return x;
  } else {
    const Steps<S, F, true> x{ar.p};
    ar.p += 32 * F * kSlots<S>;
    return x;
  }
}

template <int S>
__device__ __forceinline__ Vec<S> vec(Arena& ar) {
  return take<S, 3, S == kDyn>(ar);
}

// A scenario's sum: a butterfly over the warp, or over the segment on the
// packed arm (xor 4, 2, 1 never leaves it).
template <int S>
__device__ __forceinline__ float wsum(float v) {
#pragma unroll
  for (int m = kPacked<S> ? kSegLanes / 2 : 16; m > 0; m >>= 1)
    v += __shfl_xor_sync(kFull, v, m);
  return v;
}

template <int S>
__device__ __forceinline__ float vsum(const Vec<S>& x) {
  float acc = 0.f;
B1_UNROLL_SLOTS
  for (int s = 0; s < slots<S>(x); ++s) acc += x[s][0] + x[s][1] + x[s][2];
  return wsum<S>(acc);
}

template <int S>
__device__ __forceinline__ float vdot(const Vec<S>& x, const Vec<S>& y) {
  float acc = 0.f;
B1_UNROLL_SLOTS
  for (int s = 0; s < slots<S>(x); ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) acc = fmaf(x[s][a], y[s][a], acc);
  return wsum<S>(acc);
}

template <int S>
__device__ __forceinline__ void copy(const Vec<S>& x, Vec<S>& y) {
B1_UNROLL_SLOTS
  for (int s = 0; s < slots<S>(x); ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) y[s][a] = x[s][a];
}

// The packed arm's x_k <- sum_{j<k} x_j, per axis, on a segment whose lane
// j holds steps n j .. n j + n - 1: a serial sum over the lane's own steps,
// a Kogge-Stone scan of the lanes' totals over the segment (3
// __shfl_up_sync levels of width kSegLanes), then the carry from the lane
// below (one more) added to each step's local sum: 4 shuffles an axis.
template <int S>
__device__ __forceinline__ void seg_prefix_excl(Vec<S>& x, int lane) {
  constexpr int n = kSlots<S>;
  float tot[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float run = 0.f;
#pragma unroll
    for (int s = 0; s < n; ++s) {
      const float v = x[s][a];
      x[s][a] = run;
      run += v;
    }
    tot[a] = run;
  }
#pragma unroll
  for (int off = 1; off < kSegLanes; off <<= 1)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t = __shfl_up_sync(kFull, tot[a], off, kSegLanes);
      if (lane >= off) tot[a] += t;
    }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float up = __shfl_up_sync(kFull, tot[a], 1, kSegLanes);
    const float carry = lane == 0 ? 0.f : up;
#pragma unroll
    for (int s = 0; s < n; ++s) x[s][a] += carry;
  }
}

// The packed arm's x_k <- sum_{j>k} x_j: the mirror of seg_prefix_excl,
// with __shfl_down_sync.
template <int S>
__device__ __forceinline__ void seg_suffix_excl(Vec<S>& x, int lane) {
  constexpr int n = kSlots<S>;
  float tot[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float run = 0.f;
#pragma unroll
    for (int s = n - 1; s >= 0; --s) {
      const float v = x[s][a];
      x[s][a] = run;
      run += v;
    }
    tot[a] = run;
  }
#pragma unroll
  for (int off = 1; off < kSegLanes; off <<= 1)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t = __shfl_down_sync(kFull, tot[a], off, kSegLanes);
      if (lane + off < kSegLanes) tot[a] += t;
    }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float dn = __shfl_down_sync(kFull, tot[a], 1, kSegLanes);
    const float carry = lane == kSegLanes - 1 ? 0.f : dn;
#pragma unroll
    for (int s = 0; s < n; ++s) x[s][a] += carry;
  }
}

// x_k <- sum_{j<k} x_j over the horizon (k = lane + 32 s), per axis: a
// shift by one step, then a Kogge-Stone scan of 5 __shfl_up_sync levels;
// from two steps a lane on, each slot adds the one before's total. The
// packed arm scans its segment (seg_prefix_excl).
template <int S>
__device__ __forceinline__ void prefix_excl(Vec<S>& x, int lane, Arena ar) {
  if constexpr (kPacked<S>) {
    seg_prefix_excl<S>(x, lane);
    return;
  }
  const int n = slots<S>(x);
  Vec<S> y = vec<S>(ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float up = __shfl_up_sync(kFull, x[s][a], 1);
      const float wrap = s > 0 ? __shfl_sync(kFull, x[s > 0 ? s - 1 : 0][a], 31) : 0.f;
      y[s][a] = lane == 0 ? wrap : up;
    }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
B1_UNROLL_SLOTS
    for (int s = 0; s < n; ++s)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t = __shfl_up_sync(kFull, y[s][a], off);
        if (lane >= off) y[s][a] += t;
      }
B1_UNROLL_SLOTS
  for (int s = 1; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) y[s][a] += __shfl_sync(kFull, y[s - 1][a], 31);
  copy<S>(y, x);
}

// x_k <- sum_{j>k} x_j over the horizon, per axis (the mirror of
// prefix_excl, with __shfl_down_sync).
template <int S>
__device__ __forceinline__ void suffix_excl(Vec<S>& x, int lane, Arena ar) {
  if constexpr (kPacked<S>) {
    seg_suffix_excl<S>(x, lane);
    return;
  }
  const int n = slots<S>(x);
  Vec<S> y = vec<S>(ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float dn = __shfl_down_sync(kFull, x[s][a], 1);
      const float wrap =
          s + 1 < n ? __shfl_sync(kFull, x[s + 1 < n ? s + 1 : s][a], 0) : 0.f;
      y[s][a] = lane == 31 ? wrap : dn;
    }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
B1_UNROLL_SLOTS
    for (int s = 0; s < n; ++s)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t = __shfl_down_sync(kFull, y[s][a], off);
        if (lane + off < 32) y[s][a] += t;
      }
B1_UNROLL_SLOTS
  for (int s = n - 2; s >= 0; --s)
#pragma unroll
    for (int a = 0; a < 3; ++a) y[s][a] += __shfl_sync(kFull, y[s + 1][a], 0);
  copy<S>(y, x);
}

// yp = (cp / dt^2) S_p x and yv = (cv / dt) S_v x: (S_p/m) x and (S_v/m) x
// for cp = dt^2/m, cv = dt/m; S_p x and S_v x for cp = dt^2, cv = dt.
// Lanes k >= N come out nonzero.
template <int S>
__device__ __forceinline__ void forward_maps(const Vec<S>& x, float cp, float cv, int lane,
                                             Vec<S>& yp, Vec<S>& yv, Arena ar) {
  Vec<S> e = vec<S>(ar);
  copy<S>(x, e);
  prefix_excl<S>(e, lane, ar);
  copy<S>(e, yp);
  prefix_excl<S>(yp, lane, ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < slots<S>(x); ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      yp[s][a] = cp * fmaf(0.5f, e[s][a], yp[s][a]);
      yv[s][a] = cv * e[s][a];
    }
}

// out = (S_p/m)^T zp + (S_v/m)^T zv = R/2 + F(R + cv zv) with R = F(cp zp).
// zp and zv must be zero at k >= N; so is out.
template <int S>
__device__ __forceinline__ void pullback(const Vec<S>& zp, const Vec<S>& zv, float cp, float cv,
                                         int lane, Vec<S>& out, Arena ar) {
  const int n = slots<S>(zp);
  Vec<S> r = vec<S>(ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) r[s][a] = cp * zp[s][a];
  suffix_excl<S>(r, lane, ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) out[s][a] = fmaf(cv, zv[s][a], r[s][a]);
  suffix_excl<S>(out, lane, ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) out[s][a] = fmaf(0.5f, r[s][a], out[s][a]);
}

// diag_j += sum_k (S_p/m)[k,j]^2 hp_k + (S_v/m)[k,j]^2 hv_k.
template <int S>
__device__ __forceinline__ void add_map_diagonal(const Vec<S>& hp, const Steps<S, 3>& hv, float cp,
                                                 float cv, int lane, Vec<S>& diag, Arena ar) {
  const int n = slots<S>(hp);
  Vec<S> h = vec<S>(ar), r1 = vec<S>(ar), r2 = vec<S>(ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) h[s][a] = (cp * cp) * hp[s][a];
  copy<S>(h, r1);
  suffix_excl<S>(r1, lane, ar);
  copy<S>(r1, r2);
  suffix_excl<S>(r2, lane, ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      r2[s][a] = fmaf(0.25f, h[s][a], fmaf(2.f, r1[s][a] + r2[s][a], (cv * cv) * hv[s][a]));
  suffix_excl<S>(r2, lane, ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) diag[s][a] += r2[s][a];
}

// u/m + g on axis a. inv_m_lo is what float32 rounding took off 1/m: without
// it every acceleration is off by the same ~3e-8 relative, and the positions
// drift by that times t^2 / 2 (5 um at 6.4 s, 24 um at 12.8 s), which the
// hinge weights turn into ~2e-5 of the cost at N > 64. At N <= 64 (t < 6.4
// s: one and two steps a lane, and the packed arm) the drift stays inside
// every tolerance, and those arms keep their arithmetic bit for bit.
template <int S>
__device__ __forceinline__ float accel(const MpcParams& P, float u, int a) {
  const float g = a == 2 ? P.g_z : 0.f;
  if constexpr (S >= 3 && !kPacked<S>) {
    return fmaf(u, P.inv_m_lo, fmaf(u, P.inv_m, g));
  } else {
    return fmaf(u, P.inv_m, g);
  }
}

// pos = p0 + t v0 + S_p a, vel = v0 + S_v a with a = u/m + g (the plain
// loop's form: the sums run over accelerations, so hover thrust and gravity
// cancel before they are summed); zeros at k >= N. c0 = p0 + t v0.
template <int S>
__device__ __forceinline__ void rollout(const MpcParams& P, int lane, const Steps<S, 3>& c0,
                                        const float (&v0)[3], const Vec<S>& u, Vec<S>& pos,
                                        Vec<S>& vel, Arena ar) {
  const int n = slots<S>(u);
  Vec<S> acc = vec<S>(ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s) {
    const bool valid = step_at<S>(lane, s) < P.N;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      acc[s][a] = valid ? accel<S>(P, u[s][a], a) : 0.f;
  }
  forward_maps<S>(acc, P.dt * P.dt, P.dt, lane, pos, vel, ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s) {
    const bool valid = step_at<S>(lane, s) < P.N;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pos[s][a] = valid ? pos[s][a] + c0[s][a] : 0.f;
      vel[s][a] = valid ? vel[s][a] + v0[a] : 0.f;
    }
  }
}

// A scenario's live spheres in shared memory, [n][4]: cx, cy, cz, r_safe.
struct Spheres {
  const float* s;
  int n;
};

// Position weight of step k (terminal at N-1), 0 past the horizon.
__device__ __forceinline__ float step_weight(const MpcParams& P, int k) {
  return k < P.N ? (k == P.N - 1 ? P.w_pN : P.w_p) : 0.f;
}

// Total cost of one scenario (identical on every lane).
template <int S>
__device__ __forceinline__ float cost(const MpcParams& P, Spheres sp, int lane, float vmax,
                                      const Vec<S>& u, const Vec<S>& pos, const Vec<S>& vel,
                                      const Steps<S, 3>& goal) {
  float D = 0.f;
B1_UNROLL_SLOTS
  for (int s = 0; s < slots<S>(u); ++s) {
    const int k = step_at<S>(lane, s);
    if (k >= P.N) continue;
    const float wp = step_weight(P, k);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pe = pos[s][a] - goal[s][a];
      const float acc = accel<S>(P, u[s][a], a);
      const float du = u[s][a] - (a == 2 ? P.hover : 0.f);
      D += wp * pe * pe + P.w_v * vel[s][a] * vel[s][a] + P.w_a * acc * acc +
           P.w_T * du * du;
      if (P.use_vel_hinge) {
        const float vv = fmaxf(fabsf(vel[s][a]) - vmax, 0.f);
        D += P.w_vb * vv * vv;
      }
    }
    if (P.use_ground) {
      const float gv = fmaxf(P.z_min - pos[s][2], 0.f);
      D += P.w_g * gv * gv;
    }
    if (P.use_obstacles) {
      float J = 0.f;
#pragma unroll 4
      for (int o = 0; o < sp.n; ++o) {
        const float* ob = sp.s + 4 * o;
        const float dx = pos[s][0] - ob[0], dy = pos[s][1] - ob[1], dz = pos[s][2] - ob[2];
        const float d = sqrtf(dx * dx + dy * dy + dz * dz + 1e-9f);
        const float viol = fmaxf(ob[3] - d, 0.f);
        J += viol * viol;
      }
      D += P.w_obs * J;
    }
    const float ux = u[s][0], uy = u[s][1], uz = u[s][2];
    if (P.use_tilt) {
      const float lat = sqrtf(ux * ux + uy * uy + 1e-9f);
      const float tv = fmaxf(lat - P.tan_max * uz, 0.f);
      D += P.w_tilt * tv * tv;
    }
    if (P.use_tnorm) {
      const float un = sqrtf(ux * ux + uy * uy + uz * uz + 1e-9f);
      const float nv = fmaxf(un - P.u_max, 0.f);
      D += P.w_tn * nv * nv;
    }
  }
  return wsum<S>(D);
}

// Per-round curvature data consumed by the CG matvec (21 floats a step).
template <int S>
struct Curv {
  Steps<S, 6> h;     // position-space block: xx, yy, zz, xy, xz, yz
  Steps<S, 3> hv;    // velocity-space diagonal
  Steps<S, 4> tl;    // tilt: at, jx, jy, ct
  Steps<S, 5> tn;    // thrust norm: an, nx, ny, nz, cn
  Steps<S, 3> free;
};
constexpr int kCurvFields = 6 + 3 + 4 + 5 + 3;

template <int S>
__device__ __forceinline__ Curv<S> take_curv(Arena& ar) {
  return {take<S, 6>(ar), take<S, 3>(ar), take<S, 4>(ar), take<S, 5>(ar), take<S, 3>(ar)};
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The arena's fields a step at S = kDyn, reckoned from the code: each
// function's own Vec temporaries (3 fields each) plus its deepest callee's,
// since the arena is a stack.
constexpr int kScanFields = 3;                  // prefix_excl, suffix_excl: y
constexpr int kMapFields = 3 + kScanFields;     // forward_maps: e; pullback: r
constexpr int kDiagFields = 9 + kScanFields;    // add_map_diagonal: h, r1, r2
constexpr int kRolloutFields = 3 + kMapFields;  // rollout: acc
constexpr int kMatvecFields = 9 + kMapFields;   // matvec: dv, zp, zv
// newton_round: a round's Curv, g and dg, then the largest of its blocks:
// the rollout and gradient (pos, vel, gpos, gvel), the Jacobi diagonal
// (minv, hpd), a CG step (minv, d, r, z0, p, ap) and a line-search
// candidate (minv, d, r, z0, p, bu, cand, pc, vc)
constexpr int kRoundFields =
    kCurvFields + 6 +
    cmax(cmax(12 + kRolloutFields, 6 + kDiagFields), cmax(18 + kMatvecFields, 27 + kRolloutFields));
// the kernel: the goal, c0, diag(H) and the thrusts, then a Newton round or
// the final rollout (pos, vel) and the final iterate's gradient (gpos,
// gvel, g, the pull-back)
constexpr int kDynFields =
    3 + 3 + 1 + 3 + cmax(kRoundFields, 6 + cmax(kRolloutFields, 9 + kMapFields));
static_assert(kDynFields == 73, "the header comment and PERF.md state 73 floats a step");

// Floats of a warp's arena at S steps a lane (n = ceil(N / 32)): none at
// one and two; at three and four a round's Curv, the goal and c0 (on the
// packed arm too); from five on kDynFields a step.
template <int S>
__host__ __device__ constexpr int arena_floats(int n) {
  return S == kDyn ? 32 * n * kDynFields
                   : (kSlots<S> >= 3 ? 32 * kSlots<S> * (kCurvFields + 3 + 3) : 0);
}

// out = free * (H + S_p^T h S_p + S_v^T hv S_v + tilt + thrust norm) (free * p)
template <int S>
__device__ __forceinline__ void matvec(const MpcParams& P, int lane, float cp, float cv,
                                       float wq, const Curv<S>& c, const Vec<S>& p,
                                       Vec<S>& out, Arena ar) {
  const int n = slots<S>(p);
  Vec<S> dv = vec<S>(ar), zp = vec<S>(ar), zv = vec<S>(ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) dv[s][a] = p[s][a] * c.free[s][a];
  forward_maps<S>(dv, cp, cv, lane, zp, zv, ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s) {
    const int k = step_at<S>(lane, s);
    const float w2p = 2.f * step_weight(P, k);
    const float w2v = k < P.N ? 2.f * P.w_v : 0.f;
    const auto h = c.h[s];
    const float y0 = zp[s][0], y1 = zp[s][1], y2 = zp[s][2];
    zp[s][0] = (w2p + h[0]) * y0 + h[3] * y1 + h[4] * y2;
    zp[s][1] = h[3] * y0 + (w2p + h[1]) * y1 + h[5] * y2;
    zp[s][2] = h[4] * y0 + h[5] * y1 + (w2p + h[2]) * y2;
#pragma unroll
    for (int a = 0; a < 3; ++a) zv[s][a] *= w2v + c.hv[s][a];
  }
  pullback<S>(zp, zv, cp, cv, lane, out, ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s) {
    const float dx = dv[s][0], dy = dv[s][1], dz = dv[s][2];
    out[s][0] = fmaf(wq, dx, out[s][0]);
    out[s][1] = fmaf(wq, dy, out[s][1]);
    out[s][2] = fmaf(wq, dz, out[s][2]);
    if (P.use_tilt) {
      const float at = c.tl[s][0], jx = c.tl[s][1], jy = c.tl[s][2], ct = c.tl[s][3];
      const float t = at * (jx * dx + jy * dy - P.tan_max * dz);
      out[s][0] += t * jx;
      out[s][1] += t * jy;
      out[s][2] -= P.tan_max * t;
      const float sq = jx * dx + jy * dy;
      out[s][0] += ct * (dx - jx * sq);
      out[s][1] += ct * (dy - jy * sq);
    }
    if (P.use_tnorm) {
      const float an = c.tn[s][0], nx = c.tn[s][1], ny = c.tn[s][2], nz = c.tn[s][3],
                  cn = c.tn[s][4];
      const float sn = nx * dx + ny * dy + nz * dz;
      const float t = an * sn;
      out[s][0] += t * nx + cn * (dx - nx * sn);
      out[s][1] += t * ny + cn * (dy - ny * sn);
      out[s][2] += t * nz + cn * (dz - nz * sn);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) out[s][a] *= c.free[s][a];
  }
}

// The gradient dJ/du at u, in two halves that a Newton round's start and
// the final iterate's norm share. A round asks for its curvature too
// (Curvature): the blocks into *c and the thrust-space blocks' Jacobi
// diagonal into *dg, with the full hinge curvature if `full`; the final
// iterate asks for none, and c and dg may be null.
//
// First half: the physical-space gradient at u's rollout (pos, vel) into
// gpos and gvel (position and goal, velocity, spheres, ground, velocity
// envelope), zero at k >= N.
template <int S, bool Curvature>
__device__ __forceinline__ void physical_gradient(const MpcParams& P, Spheres sp, int lane,
                                                  float vmax, bool full,
                                                  const Steps<S, 3>& goal, const Vec<S>& pos,
                                                  const Vec<S>& vel, Vec<S>& gpos,
                                                  Vec<S>& gvel, Curv<S>* c, Vec<S>* dg) {
  const int N = P.N, n = slots<S>(pos);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s) {
    const int k = step_at<S>(lane, s);
    const bool valid = k < N;
    const float wp = step_weight(P, k);
    // the step's curvature blocks, summed here and stored once
    float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, hv[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      gpos[s][a] = valid ? 2.f * wp * (pos[s][a] - goal[s][a]) : 0.f;
      gvel[s][a] = valid ? 2.f * P.w_v * vel[s][a] : 0.f;
      if constexpr (Curvature) (*dg)[s][a] = 0.f;
    }
    if (valid && P.use_obstacles) {
#pragma unroll 4
      for (int o = 0; o < sp.n; ++o) {
        const float* ob = sp.s + 4 * o;
        const float dx = pos[s][0] - ob[0], dy = pos[s][1] - ob[1], dz = pos[s][2] - ob[2];
        const float d = sqrtf(dx * dx + dy * dy + dz * dz + 1e-9f);
        const float viol = fmaxf(ob[3] - d, 0.f);
        const float coef = 2.f * P.w_obs * viol / d;
        gpos[s][0] -= coef * dx;
        gpos[s][1] -= coef * dy;
        gpos[s][2] -= coef * dz;
        if constexpr (Curvature) {
          const float act = ob[3] > d ? 2.f * P.w_obs : 0.f;
          float inv_d2;
          if (full) {
            const float hd = viol / d;
            inv_d2 = act * (1.f + hd) / (d * d);
            const float diag_c = act * hd;
            h[0] -= diag_c;
            h[1] -= diag_c;
            h[2] -= diag_c;
          } else {
            inv_d2 = act / (d * d);
          }
          h[0] += inv_d2 * dx * dx;
          h[1] += inv_d2 * dy * dy;
          h[2] += inv_d2 * dz * dz;
          h[3] += inv_d2 * dx * dy;
          h[4] += inv_d2 * dx * dz;
          h[5] += inv_d2 * dy * dz;
        }
      }
    }
    if (valid && P.use_ground) {
      const float gv = fmaxf(P.z_min - pos[s][2], 0.f);
      gpos[s][2] -= 2.f * P.w_g * gv;
      h[2] += (pos[s][2] < P.z_min) ? 2.f * P.w_g : 0.f;
    }
    if (valid && P.use_vel_hinge) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v = vel[s][a];
        const float vv = fmaxf(fabsf(v) - vmax, 0.f);
        const float sgn = (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
        gvel[s][a] += 2.f * P.w_vb * sgn * vv;
        hv[a] = (fabsf(v) > vmax) ? 2.f * P.w_vb : 0.f;
      }
    }
    if constexpr (Curvature) {
#pragma unroll
      for (int a = 0; a < 6; ++a) c->h[s][a] = h[a];
#pragma unroll
      for (int a = 0; a < 3; ++a) c->hv[s][a] = hv[a];
    }
  }
}

// Second half: g = the physical-space gradient pulled back to thrust space
// plus the thrust-space terms at u (acceleration, effort, tilt, thrust
// norm), zero at k >= N.
template <int S, bool Curvature>
__device__ __forceinline__ void thrust_gradient(const MpcParams& P, int lane, bool full,
                                                const Vec<S>& u, const Vec<S>& gpos,
                                                const Vec<S>& gvel, Vec<S>& g, Curv<S>* c,
                                                Vec<S>* dg, Arena ar) {
  const int N = P.N, n = slots<S>(u);
  const float cv = P.dt * P.inv_m, cp = P.dt * cv;
  // pull back to thrust space
  pullback<S>(gpos, gvel, cp, cv, lane, g, ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s) {
    const int k = step_at<S>(lane, s);
    if constexpr (Curvature) {
#pragma unroll
      for (int a = 0; a < 4; ++a) c->tl[s][a] = 0.f;
#pragma unroll
      for (int a = 0; a < 5; ++a) c->tn[s][a] = 0.f;
    }
    if (k >= N) {
      g[s][0] = g[s][1] = g[s][2] = 0.f;
      continue;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float acc = accel<S>(P, u[s][a], a);
      const float du = u[s][a] - (a == 2 ? P.hover : 0.f);
      g[s][a] += 2.f * P.w_a * P.inv_m * acc + 2.f * P.w_T * du;
    }
    const float ux = u[s][0], uy = u[s][1], uz = u[s][2];
    if (P.use_tilt) {
      const float lat = sqrtf(ux * ux + uy * uy + 1e-9f);
      const float tv = fmaxf(lat - P.tan_max * uz, 0.f);
      const float jx = ux / lat, jy = uy / lat;
      const float cc = 2.f * P.w_tilt * tv;
      g[s][0] += cc * jx;
      g[s][1] += cc * jy;
      g[s][2] -= P.tan_max * cc;
      if constexpr (Curvature) {
        Vec<S>& dgv = *dg;
        const float at = (lat - P.tan_max * uz > 0.f) ? 2.f * P.w_tilt : 0.f;
        dgv[s][0] += at * jx * jx;
        dgv[s][1] += at * jy * jy;
        dgv[s][2] += at * (P.tan_max * P.tan_max);
        float ct = 0.f;
        if (full) {
          ct = cc / lat;
          dgv[s][0] += ct * (1.f - jx * jx);
          dgv[s][1] += ct * (1.f - jy * jy);
        }
        c->tl[s][0] = at;
        c->tl[s][1] = jx;
        c->tl[s][2] = jy;
        c->tl[s][3] = ct;
      }
    }
    if (P.use_tnorm) {
      const float un = sqrtf(ux * ux + uy * uy + uz * uz + 1e-9f);
      const float nvv = fmaxf(un - P.u_max, 0.f);
      const float nx = ux / un, ny = uy / un, nz = uz / un;
      const float cng = 2.f * P.w_tn * nvv;
      g[s][0] += cng * nx;
      g[s][1] += cng * ny;
      g[s][2] += cng * nz;
      if constexpr (Curvature) {
        Vec<S>& dgv = *dg;
        const float an = (un > P.u_max) ? 2.f * P.w_tn : 0.f;
        dgv[s][0] += an * nx * nx;
        dgv[s][1] += an * ny * ny;
        dgv[s][2] += an * nz * nz;
        float cn = 0.f;
        if (full) {
          cn = cng / un;
          dgv[s][0] += cn * (1.f - nx * nx);
          dgv[s][1] += cn * (1.f - ny * ny);
          dgv[s][2] += cn * (1.f - nz * nz);
        }
        c->tn[s][0] = an;
        c->tn[s][1] = nx;
        c->tn[s][2] = ny;
        c->tn[s][3] = nz;
        c->tn[s][4] = cn;
      }
    }
  }
}

// One Newton round; updates u and min_imp in place.
template <int S>
__device__ __forceinline__ void newton_round(const MpcParams& P, Spheres sp, int lane,
                                             float vmax, bool full, const Steps<S, 3>& c0,
                                             const float (&v0)[3], const Steps<S, 3>& goal,
                                             const Steps<S, 1, S == kDyn>& dq,
                                             const float* __restrict__ alphas, Arena ar,
                                             Vec<S>& u, float& min_imp, int cg_iters) {
  const int N = P.N, n = slots<S>(u);
  const float cv = P.dt * P.inv_m, cp = P.dt * cv;
  const float wq = 2.f * (P.w_a * P.inv_m * P.inv_m + P.w_T);
  Curv<S> c = take_curv<S>(ar);
  Vec<S> g = vec<S>(ar), dg = vec<S>(ar);
  float cur;
  {
    Arena blk = ar;
    Vec<S> pos = vec<S>(blk), vel = vec<S>(blk), gpos = vec<S>(blk), gvel = vec<S>(blk);
    rollout<S>(P, lane, c0, v0, u, pos, vel, blk);
    physical_gradient<S, true>(P, sp, lane, vmax, full, goal, pos, vel, gpos, gvel, &c, &dg);
    // the line search's reference: the current iterate's cost
    cur = cost<S>(P, sp, lane, vmax, u, pos, vel, goal);
    thrust_gradient<S, true>(P, lane, full, u, gpos, gvel, g, &c, &dg, blk);
  }

  // active set: at a bound with the gradient pushing outward
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s) {
    const bool valid = step_at<S>(lane, s) < N;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const bool at_lo = (u[s][a] <= P.lb[a] + 1e-6f) && (g[s][a] > 0.f);
      const bool at_hi = (u[s][a] >= P.ub[a] - 1e-6f) && (g[s][a] < 0.f);
      c.free[s][a] = (valid && !(at_lo || at_hi)) ? 1.f : 0.f;
    }
  }

  // Jacobi preconditioner: diag(H) + diag(S_p^T h S_p + S_v^T hv S_v) + the
  // thrust-space blocks' diagonal
  Vec<S> minv = vec<S>(ar);
  {
    Arena blk = ar;
    Vec<S> hpd = vec<S>(blk);
B1_UNROLL_SLOTS
    for (int s = 0; s < n; ++s)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        hpd[s][a] = c.h[s][a];
        dg[s][a] += dq[s][0];
      }
    add_map_diagonal<S>(hpd, c.hv, cp, cv, lane, dg, blk);
B1_UNROLL_SLOTS
    for (int s = 0; s < n; ++s)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        // The absolute 1e-8 floor keeps idle lanes (dq == 0) at minv = 0
        // instead of 0 / 0 = NaN, which would poison every warp sum.
        const float den = full ? fmaxf(fmaxf(dg[s][a], 0.1f * dq[s][0]), 1e-8f)
                               : fmaxf(dg[s][a], 1e-8f);
        minv[s][a] = c.free[s][a] / den;
      }
  }

  // Steihaug-truncated preconditioned CG on the free subspace
  Vec<S> d = vec<S>(ar), r = vec<S>(ar), z0 = vec<S>(ar), p = vec<S>(ar);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      r[s][a] = -(g[s][a] * c.free[s][a]);
      z0[s][a] = minv[s][a] * r[s][a];
      p[s][a] = z0[s][a];
      d[s][a] = 0.f;
    }
  float rz = vdot<S>(r, z0);
  // packed arm: this segment's scenario has left the loop
  bool frozen = false;
  for (int it = 0; it < cg_iters; ++it) {
    Arena step = ar;
    Vec<S> ap = vec<S>(step);
    matvec<S>(P, lane, cp, cv, wq, c, p, ap, step);
    const float pap = vdot<S>(p, ap);
    const float pp = vdot<S>(p, p);
    // once a direction shows (near-)negative curvature the scenario's
    // step is frozen for the rest of the round: later iterations would
    // change nothing, so the warp leaves the loop. On the packed arm the
    // segment's d, r, p and rz stay as they are, and the warp leaves once
    // all four of its scenarios are frozen.
    if constexpr (kPacked<S>) {
      frozen = frozen || !(pap > 1e-8f * pp);
      if (__ballot_sync(kFull, frozen) == kFull) break;
    } else {
      if (!(pap > 1e-8f * pp)) break;
    }
    const float alpha = rz / fmaxf(pap, 1e-12f);
    Vec<S> z = vec<S>(step);
B1_UNROLL_SLOTS
    for (int s = 0; s < n; ++s)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (!frozen) {
          d[s][a] += alpha * p[s][a];
          r[s][a] -= alpha * ap[s][a];
        }
        z[s][a] = minv[s][a] * r[s][a];
      }
    const float rz_new = vdot<S>(r, z);
    const float beta = rz_new / fmaxf(rz, 1e-12f);
    if (!frozen) {
B1_UNROLL_SLOTS
      for (int s = 0; s < n; ++s)
#pragma unroll
        for (int a = 0; a < 3; ++a) p[s][a] = z[s][a] + beta * p[s][a];
      rz = rz_new;
    }
  }
  if (full) {
    // negative curvature on the first CG step leaves d = 0: fall back to
    // preconditioned steepest descent
    Arena blk = ar;
    Vec<S> dn = vec<S>(blk);
B1_UNROLL_SLOTS
    for (int s = 0; s < n; ++s)
#pragma unroll
      for (int a = 0; a < 3; ++a) dn[s][a] = fabsf(d[s][a]);
    if (!(vsum<S>(dn) > 0.f)) copy<S>(z0, d);
  }
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) d[s][a] *= c.free[s][a];

  // projected line search: keep the current iterate unless a candidate is
  // strictly better (earliest alpha on ties)
  float best = cur;
  Vec<S> bu = vec<S>(ar);
  copy<S>(u, bu);
  for (int ia = 0; ia < P.n_alpha; ++ia) {
    const float alpha = alphas[ia];
    Arena cand_ar = ar;
    Vec<S> cand = vec<S>(cand_ar), pc = vec<S>(cand_ar), vc = vec<S>(cand_ar);
B1_UNROLL_SLOTS
    for (int s = 0; s < n; ++s) {
      const bool valid = step_at<S>(lane, s) < N;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        cand[s][a] =
            valid ? fminf(fmaxf(u[s][a] + alpha * d[s][a], P.lb[a]), P.ub[a]) : 0.f;
    }
    rollout<S>(P, lane, c0, v0, cand, pc, vc, cand_ar);
    const float cj = cost<S>(P, sp, lane, vmax, cand, pc, vc, goal);
    if (cj < best) {
      best = cj;
      copy<S>(cand, bu);
    }
  }
  copy<S>(bu, u);
  const float imp = (cur - best) / (1.f + fabsf(best));
  min_imp = fminf(min_imp, imp);
}

// Ord: the launch passes an `order`, which only the packed arm takes; its
// Ord = false instantiations serve every launch without one, so that an
// order costs those launches nothing.
template <int S, bool Ord = false>
__global__ void __launch_bounds__(kWarps<S> * 32, kMinBlocks<S>)
    mpc_solve_kernel(const MpcParams P, const float* __restrict__ consts,
                     const float* __restrict__ u0, const float* __restrict__ p0,
                     const float* __restrict__ v0, const float* __restrict__ goal_in,
                     const float* __restrict__ obs_in, const float* __restrict__ mask_in,
                     const float* __restrict__ vcap, float* __restrict__ u_out,
                     float* __restrict__ pos_out, float* __restrict__ vel_out,
                     float* __restrict__ imp_out, float* __restrict__ cost_out,
                     float* __restrict__ gnorm_out, float* __restrict__ scratch,
                     const long long* __restrict__ order) {
  // [kWarps<S> x kPerWarp<S>][K][4]: each scenario's live spheres; then,
  // from three steps a lane on, each warp's arena of arena_floats<S>(n),
  // which at S = kDyn lies in `scratch` instead when the launch passes one
  extern __shared__ float smem[];
  const int N = P.N, K = P.K;
  const int n = S == kDyn ? (N + 31) / 32 : kSlots<S>;  // slots a lane
  // the constant block's step vectors are 32 ceil(N / 32) long
  const int LD = kPacked<S> ? 32 : 32 * n;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  // the lane's place among its scenario's lanes: in its segment on the
  // packed arm
  const int lane = kPacked<S> ? wl % kSegLanes : wl;
  const int w = blockIdx.x * kWarps<S> + warp;
  if (w * kPerWarp<S> >= P.B) return;  // each warp touches only its own shared memory
  // On the packed arm a segment past the batch runs the last scenario's
  // inputs and writes nothing: it may not return, since the warp's other
  // segments meet it at every shuffle.
  const int seg = kPacked<S> ? wl / kSegLanes : 0;
  const bool writes = !kPacked<S> || w * kPerWarp<S> + seg < P.B;
  const int at = writes ? w * kPerWarp<S> + seg : P.B - 1;
  // The scenario: where the launch passes an order, the order's at-th,
  // whose inputs it reads and whose outputs it writes (a scenario's outputs
  // depend on no other's), so that the scenarios of a warp and of a block
  // run alike long; else the at-th.
  static_assert(!Ord || kPacked<S>, "only the packed arm takes an order");
  const int b = Ord ? (int)order[at] : at;
  // Keep the live spheres, in order, at the front: a masked sphere adds
  // exactly 0 to every sum, so the loops skip it without a branch.
  float* live = smem + (warp * kPerWarp<S> + seg) * 4 * K;
  int n_live = 0;
  for (int base = 0; base < K; base += 32 / kPerWarp<S>) {
    const int o = base + lane;
    const bool on = o < K && mask_in[(size_t)b * K + o] != 0.f;
    unsigned m = __ballot_sync(kFull, on);
    if constexpr (kPacked<S>) m = (m >> (kSegLanes * seg)) & ((1u << kSegLanes) - 1u);
    if (on) {
      float* dst = live + 4 * (n_live + __popc(m & ((1u << lane) - 1u)));
#pragma unroll
      for (int f = 0; f < 4; ++f) dst[f] = obs_in[((size_t)b * K + o) * 4 + f];
    }
    n_live += __popc(m);
  }
  __syncwarp();
  const Spheres sp{live, P.use_obstacles ? n_live : 0};

  float* arena = smem + kWarps<S> * kPerWarp<S> * 4 * K + warp * arena_floats<S>(n);
  if constexpr (S == kDyn) {
    if (scratch != nullptr) arena = scratch + (size_t)b * arena_floats<S>(n);
  }
  Arena ar{arena + wl, n, arena_floats<S>(n)};
  // constants: t (k dt) and diag(H), each LD long, zero past N; then the
  // n_alpha alphas
  Steps<S, 3> goal = take<S, 3>(ar), c0 = take<S, 3>(ar);
  Steps<S, 1, S == kDyn> dq = take<S, 1, S == kDyn>(ar);
  Vec<S> u = vec<S>(ar);
  const float* alphas = consts + 2 * LD;
  const float vmax = vcap ? vcap[b] : P.v_max;
  const float vel0[3] = {v0[b * 3], v0[b * 3 + 1], v0[b * 3 + 2]};
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s) {
    const int k = step_at<S>(lane, s);
    const bool valid = k < N;
    dq[s][0] = consts[LD + k];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const size_t at = ((size_t)b * N + k) * 3 + a;
      u[s][a] = valid ? u0[at] : 0.f;
      goal[s][a] = valid ? goal_in[at] : 0.f;
      c0[s][a] = valid ? p0[b * 3 + a] + consts[k] * vel0[a] : 0.f;
    }
  }

  float min_imp = INFINITY;
  for (int i = 0; i < P.n_gn; ++i)
    newton_round<S>(P, sp, lane, vmax, false, c0, vel0, goal, dq, alphas, ar, u, min_imp,
                    P.cg_iters);
  if (P.n_full > 0) {
    min_imp = INFINITY;  // the stall tracker restarts with stage 2
    for (int i = 0; i < P.n_full; ++i)
      newton_round<S>(P, sp, lane, vmax, true, c0, vel0, goal, dq, alphas, ar, u, min_imp,
                      P.cg_iters);
  }

  Vec<S> pos = vec<S>(ar), vel = vec<S>(ar);
  rollout<S>(P, lane, c0, vel0, u, pos, vel, ar);
  const float J = cost<S>(P, sp, lane, vmax, u, pos, vel, goal);
B1_UNROLL_SLOTS
  for (int s = 0; s < n; ++s) {
    const int k = step_at<S>(lane, s);
    if (k >= N || !writes) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const size_t at = ((size_t)b * N + k) * 3 + a;
      u_out[at] = u[s][a];
      pos_out[at] = pos[s][a];
      vel_out[at] = vel[s][a];
    }
  }
  if (lane == 0 && writes) {
    imp_out[b] = min_imp;
    cost_out[b] = J;
  }
  // where the launch asks for it, the final iterate's projected-gradient
  // norm ||clamp(u - g, lb, ub) - u|| over the valid steps
  if (gnorm_out != nullptr) {
    Vec<S> gpos = vec<S>(ar), gvel = vec<S>(ar), g = vec<S>(ar);
    physical_gradient<S, false>(P, sp, lane, vmax, false, goal, pos, vel, gpos, gvel, nullptr,
                                nullptr);
    thrust_gradient<S, false>(P, lane, false, u, gpos, gvel, g, nullptr, nullptr, ar);
    float sq = 0.f;
B1_UNROLL_SLOTS
    for (int s = 0; s < n; ++s) {
      if (step_at<S>(lane, s) >= N) continue;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float pg = fminf(fmaxf(u[s][a] - g[s][a], P.lb[a]), P.ub[a]) - u[s][a];
        sq = fmaf(pg, pg, sq);
      }
    }
    const float norm = sqrtf(wsum<S>(sq));
    if (lane == 0 && writes) gnorm_out[b] = norm;
  }
}

// Whether a launch's arena lies in global scratch: from five steps a lane
// on, when the block's shared memory (the spheres and the warp's arena)
// passes the card's opt-in maximum a block, read here.
cudaError_t arena_in_scratch(const MpcParams& P, bool& spills) {
  spills = false;
  const int steps = (P.N + 31) / 32;
  if (steps < kDyn) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  spills = sizeof(float) * (4 * (size_t)P.K + (size_t)arena_floats<kDyn>(steps)) > (size_t)optin;
  return cudaSuccess;
}

// Dynamic shared memory of a block at arm S: its scenarios' spheres and,
// unless the arena lies in global scratch, its warps' arenas.
template <int S>
size_t shared_bytes(const MpcParams& P, bool in_scratch) {
  const int n = S == kDyn ? (P.N + 31) / 32 : kSlots<S>;
  return sizeof(float) * ((size_t)kWarps<S> * kPerWarp<S> * 4 * P.K +
                          (in_scratch ? 0 : (size_t)kWarps<S> * arena_floats<S>(n)));
}

template <int S, bool Ord = false>
cudaError_t launch(const MpcParams& P, const float* consts, const float* u0, const float* p0,
                   const float* v0, const float* goal, const float* obs, const float* mask,
                   const float* vcap, float* u_out, float* pos_out, float* vel_out,
                   float* imp_out, float* cost_out, float* gnorm_out, float* scratch,
                   const long long* order, cudaStream_t stream) {
  const size_t smem = shared_bytes<S>(P, scratch != nullptr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mpc_solve_kernel<S, Ord>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  constexpr int per_block = kWarps<S> * kPerWarp<S>;  // scenarios
  const dim3 grid((P.B + per_block - 1) / per_block), block(kWarps<S> * 32);
  mpc_solve_kernel<S, Ord><<<grid, block, smem, stream>>>(P, consts, u0, p0, v0, goal, obs,
                                                          mask, vcap, u_out, pos_out, vel_out,
                                                          imp_out, cost_out, gnorm_out, scratch,
                                                          order);
  return cudaGetLastError();
}

// Warps an SM keeps resident at arm S for `P` (the runtime's occupancy
// calculator), into `warps`.
template <int S>
cudaError_t resident(const MpcParams& P, bool in_scratch, int& warps) {
  int blocks = 0;
  const size_t smem = shared_bytes<S>(P, in_scratch);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(mpc_solve_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mpc_solve_kernel<S>,
                                                      kWarps<S> * 32, smem);
  warps = blocks * kWarps<S>;
  return e;
}

}  // namespace

// launch<kDyn> and resident<kDyn>, five or more steps a lane, defined in
// mpc_solve_steps.cu.
cudaError_t mpc_launch_run_time_steps(const MpcParams& P, const float* consts, const float* u0,
                                      const float* p0, const float* v0, const float* goal,
                                      const float* obs, const float* mask, const float* vcap,
                                      float* u_out, float* pos_out, float* vel_out,
                                      float* imp_out, float* cost_out, float* gnorm_out,
                                      float* scratch, const long long* order,
                                      cudaStream_t stream);
cudaError_t mpc_resident_run_time_steps(const MpcParams& P, bool in_scratch, int& warps);

#ifdef B1_RUN_TIME_STEPS

cudaError_t mpc_launch_run_time_steps(const MpcParams& P, const float* consts, const float* u0,
                                      const float* p0, const float* v0, const float* goal,
                                      const float* obs, const float* mask, const float* vcap,
                                      float* u_out, float* pos_out, float* vel_out,
                                      float* imp_out, float* cost_out, float* gnorm_out,
                                      float* scratch, const long long* order,
                                      cudaStream_t stream) {
  return launch<kDyn>(P, consts, u0, p0, v0, goal, obs, mask, vcap, u_out, pos_out, vel_out,
                      imp_out, cost_out, gnorm_out, scratch, order, stream);
}

cudaError_t mpc_resident_run_time_steps(const MpcParams& P, bool in_scratch, int& warps) {
  return resident<kDyn>(P, in_scratch, warps);
}

#else

namespace {

// An arm of the kernel: its launch, its occupancy, its scenarios a warp, and
// on the packed arm its launch in a given order.
using Launch = decltype(&launch<1>);
struct Arm {
  Launch launch;
  decltype(&resident<1>) resident;
  int per_warp;
  Launch ordered = nullptr;
};

// The arm a launch takes, into `arm`. Up to N = 32 the packed arm, by
// ceil(N / 8) steps a lane, unless the batch fits one wave of the
// one-scenario-a-warp arm (kWarps<1> x kMinBlocks<1> = 16 warps on each of
// the card's SMs, read here): there every scenario is in flight at once
// either way, and one scenario's shorter chain decides (B=1: 0.22 ms
// against 0.41 packed on an H100). Past N = 32 by ceil(N / 32) steps a
// lane, all from five on in one.
cudaError_t arm_of(const MpcParams& P, const Arm*& arm) {
  static constexpr Arm arms[] = {
      {launch<1>, resident<1>, 1},
      {launch<kPack + 1>, resident<kPack + 1>, kPerWarp<kPack + 1>, launch<kPack + 1, true>},
      {launch<kPack + 2>, resident<kPack + 2>, kPerWarp<kPack + 2>, launch<kPack + 2, true>},
      {launch<kPack + 3>, resident<kPack + 3>, kPerWarp<kPack + 3>, launch<kPack + 3, true>},
      {launch<kPack + 4>, resident<kPack + 4>, kPerWarp<kPack + 4>, launch<kPack + 4, true>},
      {launch<2>, resident<2>, 1},
      {launch<3>, resident<3>, 1},
      {launch<4>, resident<4>, 1},
      {mpc_launch_run_time_steps, mpc_resident_run_time_steps, 1}};
  const int steps = (P.N + 31) / 32;
  if (steps > 1) {
    arm = &arms[3 + (steps < kDyn ? steps : kDyn)];
    return cudaSuccess;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const bool one_wave = P.B <= sms * kWarps<1> * kMinBlocks<1>;
  arm = &arms[one_wave ? 0 : (P.N + kSegLanes - 1) / kSegLanes];
  return cudaSuccess;
}

}  // namespace

extern "C" int mpc_params_size() { return (int)sizeof(MpcParams); }

extern "C" const char* mpc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of global scratch that mpc_solve_launch needs for `params`: B
// warps' arenas when they do not fit shared memory (from five steps a lane
// on, see arena_in_scratch), else 0; minus the CUDA error code if the card
// cannot be queried.
extern "C" long long mpc_scratch_floats(const MpcParams* params) {
  const MpcParams P = *params;
  if (P.B <= 0 || P.N < 1 || P.K < 0) return 0;
  bool spills = false;
  const cudaError_t e = arena_in_scratch(P, spills);
  if (e != cudaSuccess) return -(long long)e;
  return spills ? (long long)P.B * arena_floats<kDyn>((P.N + 31) / 32) : 0;
}

// Launches the solve on `stream` (does not synchronize). `gnorm_out`, B
// floats, takes each scenario's projected-gradient norm at the final
// iterate, or is null for none (the kernel then skips that pass). `scratch`
// holds mpc_scratch_floats(params) floats, or is null when that is 0.
// `order`, B distinct indices of the batch or null, is the order in which
// the packed arm takes the scenarios (mpc_scenarios_per_warp > 1; the other
// arms take none), by instantiations of their own: its i-th scenario runs
// where the i-th of the batch would, and every input and output stays in
// the batch's own order.
// Returns the CUDA error code of the launch, 0 on success.
extern "C" int mpc_solve_launch(const MpcParams* params, const float* consts, const float* u0,
                                const float* p0, const float* v0, const float* goal,
                                const float* obs, const float* mask, const float* vcap,
                                float* u_out, float* pos_out, float* vel_out, float* imp_out,
                                float* cost_out, float* gnorm_out, float* scratch,
                                const long long* order, void* stream) {
  const MpcParams P = *params;
  if (P.B <= 0) return 0;
  if (P.N < 1 || P.K < 0 || P.n_alpha < 0) return (int)cudaErrorInvalidValue;
  bool spills = false;
  const cudaError_t e = arena_in_scratch(P, spills);
  if (e != cudaSuccess) return (int)e;
  if (spills != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  const Arm* arm = nullptr;
  const cudaError_t ea = arm_of(P, arm);
  if (ea != cudaSuccess) return (int)ea;
  const auto go = order != nullptr ? arm->ordered : arm->launch;
  if (go == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)go(P, consts, u0, p0, v0, goal, obs, mask, vcap, u_out, pos_out, vel_out, imp_out,
                 cost_out, gnorm_out, scratch, order, st);
}

// Scenarios a warp of the arm that mpc_solve_launch takes for `params`: 4
// on the packed arm (N <= 32, past one wave of one scenario a warp), else
// 1; minus the CUDA error code if the card cannot be queried.
extern "C" int mpc_scenarios_per_warp(const MpcParams* params) {
  if (params->N < 1) return -(int)cudaErrorInvalidValue;
  const Arm* arm = nullptr;
  const cudaError_t e = arm_of(*params, arm);
  return e == cudaSuccess ? arm->per_warp : -(int)e;
}

// Warps an SM keeps resident at the arm mpc_solve_launch takes for
// `params` (the runtime's occupancy calculator); minus the CUDA error code
// where it cannot say.
extern "C" int mpc_resident_warps(const MpcParams* params) {
  const MpcParams P = *params;
  if (P.N < 1 || P.K < 0) return -(int)cudaErrorInvalidValue;
  bool spills = false;
  int warps = 0;
  const Arm* arm = nullptr;
  cudaError_t e = arena_in_scratch(P, spills);
  if (e == cudaSuccess) e = arm_of(P, arm);
  if (e == cudaSuccess) e = arm->resident(P, spills, warps);
  return e == cudaSuccess ? warps : -(int)e;
}

#endif  // B1_RUN_TIME_STEPS
