// Closed-loop tick block of the Monte-Carlo simulator, one launch per
// replan, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dart_planner_tpu/ops/pallas_rollout.py
// (run_tick_block :357, body _tick_kernel :56). It computes what that
// kernel computes, per episode and per control tick:
//   - the geometric SE(3) controller: PID with clamping anti-windup
//     (per-axis and norm caps, decay near the caps), thrust clip, tilt
//     limit, the desired frame at yaw 0 with the yaw-singular and
//     straight-up fallbacks, e_R, torque with the gyroscopic term and
//     per-axis saturation, and the failsafe counter and latch;
//   - and the two arms of the JAX controller (dart_planner_tpu/control/
//     geometric.py) that the Pallas kernel does not take, each a
//     compile-time arm, so that a configuration pays only for its own:
//     back-calculation anti-windup (:231-252; the feedback of the last
//     tick's raw thrust and torque, carried in state rows 26-29) and the
//     "reference" yaw convention (:137-143, b1 = e1 x b3);
//   - the rigid-body plant over `substeps` substeps: body-z thrust, wind,
//     linear drag, Euler's equations, and a Rodrigues update of R (with the
//     JAX kernel's small-angle branch, written the same way);
//   - the per-tick metrics: minimum goal distance, summed squared tracking
//     error, minimum altitude, minimum surface clearance to the true spheres
//     (an inactive sphere carries r = -1e30, so its clearance is 1e30).
//
// What bounds it. Bytes and operations do not: per launch at B=2048, T=40,
// K=3 it moves ~3.7 MB (~1.1 us of HBM time) and does ~50 MFLOP. Each
// episode's T ticks are one dependent chain, and one thread runs it, so the
// kernel takes at least T times the latency of one tick's chain. Reckoned
// from the code, one tick with one substep holds 7 precise square roots
// (pe_mag, ve_mag, f_norm, the integral's norm, n1, np_, theta), 11 precise
// divisions (the integral's scale, inv_f, inv_n1, inv_np, three for the
// thrust acceleration, three for the angular acceleration, sin(theta) /
// theta and (1 - cos(theta)) / t2) and one sincosf. The longest path from
// a tick's state to the next one's runs f -> f_norm -> b3 -> the desired
// frame -> e_R -> torque -> omega -> theta -> R: 3 square roots (f_norm,
// n1, theta; np_ runs beside n1), 4 divisions (inv_f, inv_n1, the angular
// acceleration, sin(theta) / theta), the sincosf and ~51 dependent fp32
// operations, ~520 cycles with the instruction latencies assumed in
// `chip_smoke.py::B2_CHAIN_CYCLES` (not read from the SASS): at T=40 and
// 1.98 GHz a floor of ~10.5 us, whatever the batch. A tick takes several times that on the card
// (PERF.md): a warp issues in program order, and with one chain warp per
// scheduler nothing else issues while an instruction waits on the one
// before, so every stall in a tick's instruction stream is paid, whether or
// not the stalled value is on the chain. The design takes every such stall
// it can off the stream:
//   1. Setpoints one tick ahead: tick t loads tick t+1's nine setpoint
//      values into registers and uses the ones loaded a tick earlier, so a
//      load has a whole tick to arrive from L2.
//   2. Metrics off the chain: the chain keeps only the state. After each
//      tick it stores pos to shared memory (3 T floats an episode); after
//      the tick loop every warp of the block computes the four metrics
//      over the (tick, episode) pairs in parallel, each thread loading its
//      episode's goal and spheres once. The minima are exact in any order;
//      the tracking error is summed in tick order, as the chain summed it.
//   3. Exact hoists: wind / mass is divided once, not every substep (the
//      same operation on the same operands); one sincosf in place of sinf
//      and cosf; goal leaves the chain's registers.
//   4. Blocks of 32 episodes: one chain warp and kHelperWarps warps that
//      write the zero rows during the chain and share the metrics pass. At
//      B=2048 that is 64 blocks on 64 SMs, one chain warp each.
//   5. Fewer branches in a tick, so that the scheduler can overlap more of
//      it: the desired frame's two normalizations divide unconditionally
//      and select (the two fallbacks to e1 are rare and keep their values),
//      and the substep loop is a compile-time loop of one for the
//      closed loop's single substep (a second instantiation takes more).
// Nothing else of the arithmetic moved: every state update is written as
// before, in the same order.
//
// Layout: row r of an input is read at rows[r * B + b], so the 32 lanes of
// a warp read 32 neighbouring words. The ragged edge (B not a multiple of
// 32) runs the chain on the last episode's inputs and writes nothing. Shared
// memory is 4 * 32 * (3 T + 3 kWarps) bytes: the positions after each tick
// and each warp's partial minima. Above 48 KB the launcher raises the
// kernel's limit, and returns the error when the card cannot give it. The
// wrapper repeats the count (cuda_rollout.py::shared_bytes) and splits a
// block of more ticks than the card's shared memory holds (601 on an H100)
// into consecutive launches, the state chained through the output rows.
//
// Precision: exact IEEE fp32 throughout (no fast math, precise division,
// square root and sincosf); reduced-precision rotation chains broke the
// Monte-Carlo on the TPU (docs/kernel.md:172-208). nvcc contracts a*b+c into
// FMAs, so the kernel and its plain PyTorch version part by an ulp here and
// there, and an exact compare at a clip limit (thrust saturation, torque
// saturation, the failsafe test) can flip.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kEpisodes = 32;  // episodes per block: one lane each of the chain warp
constexpr int kHelperWarps = 3;
constexpr int kWarps = 1 + kHelperWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kDefaultSharedBytes = 48 * 1024;

}  // namespace

// Must match dart_planner_tpu_torch/ops/cuda_rollout.py::_Params field by
// field. Scalars are computed on the host in float64 and rounded to float32.
struct TickParams {
  int B, T, substeps, K, use_drag;
  int back_calc, ref_yaw;  // the anti-windup and yaw arms (0: clamping, Lee)
  float kp[3], ki[3], kd[3], kp_att[3], kd_att[3];
  float inertia[3];       // the controller's model of the inertia
  float max_tq[3];        // controller torque caps
  float per_axis_int[3];  // integral caps
  float near_int[3];      // per_axis_int * saturation_threshold
  float p_inertia[3];     // the plant's inertia
  float mass, g;          // the controller's mass and gravity
  float min_thrust;       // min_thrust * mass * g
  float max_thrust;
  float cos_max, sin_max;  // of the max tilt angle
  float max_integral_pos, decay, yaw_sing, track_thr, vel_thr, fs_trigger;
  float p_mass, pg, p_max_thrust, p_max_torque, drag;  // the plant's
  float control_dt, h;                                   // h = control_dt / substeps
  float kb;                                              // back_calculation_gain
};

namespace {

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The chain of one episode (lane `lane` of warp 0): T ticks of controller and
// plant on the state in registers. Stores pos after tick t at
// pos_s[(3 t + d) * kEpisodes + lane] and writes the state rows if b < B.
// kOneSubstep: P.substeps is 1, known at compile time. kBackCalc: the
// back-calculation anti-windup (else clamping). kRefYaw: the "reference"
// yaw convention (else Lee's).
template <bool kOneSubstep, bool kBackCalc, bool kRefYaw>
__device__ __forceinline__ void run_chain(const TickParams& P, int b, int bl, int lane,
                                          const float* __restrict__ S,
                                          const float* __restrict__ spp,
                                          const float* __restrict__ spv,
                                          const float* __restrict__ spa,
                                          const float* __restrict__ gw, float* pos_s,
                                          float* __restrict__ out) {
  const int B = P.B;
  float pos[3], vel[3], omega[3], R[3][3], integral[3], lt_sat[3], wind_m[3];
  for (int d = 0; d < 3; ++d) {
    pos[d] = S[(0 + d) * B + bl];
    vel[d] = S[(3 + d) * B + bl];
    omega[d] = S[(6 + d) * B + bl];
    integral[d] = S[(18 + d) * B + bl];
    lt_sat[d] = S[(21 + d) * B + bl];
    wind_m[d] = gw[(3 + d) * B + bl] / P.p_mass;
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[i][j] = S[(9 + 3 * i + j) * B + bl];
  float fcount = S[24 * B + bl];
  float last_valid = S[25 * B + bl];
  float u_thrust = 0.f, u_torque[3] = {0.f, 0.f, 0.f};  // the last tick's raw values
  if (kBackCalc) {
    u_thrust = S[26 * B + bl];
    for (int d = 0; d < 3; ++d) u_torque[d] = S[(27 + d) * B + bl];
  }

  float sp_p[3], sp_v[3], sp_a[3];
  for (int d = 0; d < 3; ++d) {
    sp_p[d] = spp[d * B + bl];
    sp_v[d] = spv[d * B + bl];
    sp_a[d] = spa[d * B + bl];
  }

  for (int t = 0; t < P.T; ++t) {
    // tick t+1's setpoints, used a tick from now (the last tick reloads its own)
    const int tn = t + 1 < P.T ? t + 1 : t;
    float nsp_p[3], nsp_v[3], nsp_a[3];
    for (int d = 0; d < 3; ++d) {
      const int r = (3 * tn + d) * B + bl;
      nsp_p[d] = spp[r];
      nsp_v[d] = spv[r];
      nsp_a[d] = spa[r];
    }

    // ---- geometric controller ----
    float pe[3], ve[3], f[3];
    for (int d = 0; d < 3; ++d) {
      pe[d] = sp_p[d] - pos[d];
      ve[d] = sp_v[d] - vel[d];
    }
    const float pe_mag = sqrtf(dot3(pe, pe));
    const float ve_mag = sqrtf(dot3(ve, ve));
    for (int d = 0; d < 3; ++d)
      f[d] = sp_a[d] + P.kp[d] * pe[d] + P.kd[d] * ve[d] + P.ki[d] * integral[d];
    f[2] = f[2] + P.g;  // f_world = acc_des - g_vec, ENU gravity (0, 0, -g)
    const float f_norm = sqrtf(dot3(f, f));
    const float thrust_raw = P.mass * f_norm;
    const float thrust_mag = clip(thrust_raw, P.min_thrust, P.max_thrust);
    const float thrust_sat = thrust_raw != thrust_mag ? 1.f : 0.f;

    // integral update
    float ni[3];
    if (kBackCalc) {
      // back-calculation: the last tick's raw thrust and torque beyond their
      // caps feed back, in the JAX controller's order, rounded op by op
      // (__fmul_rn / __fsub_rn / __fadd_rn are not contracted into FMAs), as
      // the plain version rounds them: a near-tie at the caps then parts the
      // two no more often than the clamping arm's
      const float thrust_fb = thrust_sat != 0.f ? __fmul_rn(u_thrust - P.max_thrust, P.kb) : 0.f;
      const float split[3] = {0.33f, 0.33f, 0.34f};
      for (int d = 0; d < 3; ++d) {
        const float torque_fb =
            lt_sat[d] != 0.f ? __fmul_rn(u_torque[d] - P.max_tq[d], P.kb) : 0.f;
        float upd = __fmul_rn(ve[d], P.control_dt);
        upd = __fsub_rn(upd, __fmul_rn(thrust_fb, split[d]));
        upd = __fsub_rn(upd, __fmul_rn(torque_fb, 0.5f));
        ni[d] = clip(__fadd_rn(integral[d], upd), -P.per_axis_int[d], P.per_axis_int[d]);
      }
      u_thrust = thrust_raw;
    } else {
      // clamping: saturated axes accumulate at 10%
      const float damp_t = 1.f - 0.9f * thrust_sat;
      for (int d = 0; d < 3; ++d) {
        const float damp = damp_t * (1.f - 0.9f * lt_sat[d]);
        const float v = integral[d] + ve[d] * P.control_dt * damp;
        ni[d] = clip(v, -P.per_axis_int[d], P.per_axis_int[d]);
      }
    }
    const float mag = sqrtf(dot3(ni, ni));
    const float scale = mag > P.max_integral_pos ? P.max_integral_pos / fmaxf(mag, 1e-9f) : 1.f;
    for (int d = 0; d < 3; ++d) {
      const float v = ni[d] * scale;
      integral[d] = fabsf(v) > P.near_int[d] ? v * P.decay : v;
    }

    // desired thrust direction, then the tilt limit
    const float inv_f = 1.f / fmaxf(f_norm, 1e-9f);
    float b3[3];
    for (int d = 0; d < 3; ++d) b3[d] = f[d] * inv_f;
    const float tm_ok = thrust_mag > 1e-6f ? 1.f : 0.f;
    b3[0] = b3[0] * tm_ok;
    b3[1] = b3[1] * tm_ok;
    b3[2] = b3[2] * tm_ok + (1.f - tm_ok);
    if (b3[2] < P.cos_max) {
      const float inv_xy = 1.f / fmaxf(sqrtf(b3[0] * b3[0] + b3[1] * b3[1]), 1e-9f);
      b3[0] = P.sin_max * b3[0] * inv_xy;
      b3[1] = P.sin_max * b3[1] * inv_xy;
      b3[2] = P.cos_max;
    }

    // desired frame at yaw 0 (c = e1): Lee's b1 = (b3 x c) x b3, or the
    // reference's c x b3
    const float e1[3] = {1.f, 0.f, 0.f};
    float b1n[3], b1s[3], b1[3], b2[3];
    if (kRefYaw) {
      cross3(e1, b3, b1n);
    } else {
      float bc[3];
      cross3(b3, e1, bc);
      cross3(bc, b3, b1n);
    }
    const float n1 = sqrtf(dot3(b1n, b1n));
    const float inv_n1 = 1.f / n1;  // unused where n1 is 0
    for (int d = 0; d < 3; ++d) b1n[d] = n1 > 1e-6f ? b1n[d] * inv_n1 : e1[d];
    const float proj[3] = {1.f - b3[0] * b3[0], -b3[0] * b3[1], -b3[0] * b3[2]};
    const float np_ = sqrtf(dot3(proj, proj));
    const bool straight = fabsf(b3[2]) >= 0.99f;
    const float inv_np = 1.f / np_;  // unused where np_ is 0
    for (int d = 0; d < 3; ++d) b1s[d] = !straight && np_ > 1e-9f ? proj[d] * inv_np : e1[d];
    const bool singular = fabsf(b3[0]) >= P.yaw_sing;
    for (int d = 0; d < 3; ++d) b1[d] = singular ? b1s[d] : b1n[d];
    cross3(b3, b1, b2);

    // e_R = 0.5 vee(Rd^T R - R^T Rd), with M[i][j] = col_i(Rd) . col_j(R)
    const float rd[3][3] = {{b1[0], b1[1], b1[2]}, {b2[0], b2[1], b2[2]}, {b3[0], b3[1], b3[2]}};
    float M[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        M[i][j] = rd[i][0] * R[0][j] + rd[i][1] * R[1][j] + rd[i][2] * R[2][j];
    const float eR[3] = {0.5f * (M[2][1] - M[1][2]), 0.5f * (M[0][2] - M[2][0]),
                         0.5f * (M[1][0] - M[0][1])};
    float iw[3], cor[3], tq[3];
    for (int d = 0; d < 3; ++d) iw[d] = P.inertia[d] * omega[d];
    cross3(omega, iw, cor);
    for (int d = 0; d < 3; ++d) {
      const float raw = -P.kp_att[d] * eR[d] - P.kd_att[d] * omega[d] + cor[d];
      tq[d] = clip(raw, -P.max_tq[d], P.max_tq[d]);
      lt_sat[d] = raw != tq[d] ? 1.f : 0.f;
      if (kBackCalc) u_torque[d] = raw;  // the raw torque, latch or not
    }

    // failsafe accounting
    const bool bad = (pe_mag > P.track_thr) && (ve_mag > P.vel_thr);
    fcount = bad ? fcount + 1.f : fmaxf(fcount - 1.f, 0.f);
    const bool failsafe = fcount > P.fs_trigger;
    const float thrust_out = failsafe ? last_valid : thrust_mag;
    if (failsafe) {
      for (int d = 0; d < 3; ++d) {
        tq[d] = 0.f;
        integral[d] = 0.f;
      }
    } else {
      last_valid = thrust_mag;
    }

    // ---- rigid-body plant over the substeps ----
    const float thr = clip(thrust_out, 0.f, P.p_max_thrust);
    float ptq[3];
    for (int d = 0; d < 3; ++d) ptq[d] = clip(tq[d], -P.p_max_torque, P.p_max_torque);
    const float h = P.h;
    const int substeps = kOneSubstep ? 1 : P.substeps;
    for (int s = 0; s < substeps; ++s) {
      for (int d = 0; d < 3; ++d) {
        float a = R[d][2] * thr / P.p_mass;
        if (d == 2) a = a - P.pg;
        a = a + wind_m[d];
        if (P.use_drag) a = a - P.drag * vel[d];
        vel[d] = vel[d] + a * h;
      }
      for (int d = 0; d < 3; ++d) pos[d] = pos[d] + vel[d] * h;
      float pw[3], gyro[3];
      for (int d = 0; d < 3; ++d) pw[d] = P.p_inertia[d] * omega[d];
      cross3(omega, pw, gyro);
      for (int d = 0; d < 3; ++d) omega[d] = omega[d] + (ptq[d] - gyro[d]) / P.p_inertia[d] * h;

      // R <- R exp(hat(omega h)) by Rodrigues
      const float wx = omega[0] * h, wy = omega[1] * h, wz = omega[2] * h;
      const float t2 = wx * wx + wy * wy + wz * wz;
      const float theta = sqrtf(t2);
      float a_c, b_c;
      if (theta < 1e-5f) {
        a_c = 1.f - t2 / 6.f;
        b_c = 0.5f - t2 / 24.f;
      } else {
        float s_th, c_th;
        sincosf(theta, &s_th, &c_th);
        a_c = s_th / theta;
        b_c = (1.f - c_th) / t2;
      }
      const float E[3][3] = {
          {1.f + b_c * (-(wy * wy + wz * wz)), -a_c * wz + b_c * wx * wy, a_c * wy + b_c * wx * wz},
          {a_c * wz + b_c * wx * wy, 1.f + b_c * (-(wx * wx + wz * wz)), -a_c * wx + b_c * wy * wz},
          {-a_c * wy + b_c * wx * wz, a_c * wx + b_c * wy * wz, 1.f + b_c * (-(wx * wx + wy * wy))},
      };
      float Rn[3][3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          Rn[i][j] = R[i][0] * E[0][j] + R[i][1] * E[1][j] + R[i][2] * E[2][j];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) R[i][j] = Rn[i][j];
    }

    // the position after tick t, for the metrics pass
    for (int d = 0; d < 3; ++d) pos_s[(3 * t + d) * kEpisodes + lane] = pos[d];
    for (int d = 0; d < 3; ++d) {
      sp_p[d] = nsp_p[d];
      sp_v[d] = nsp_v[d];
      sp_a[d] = nsp_a[d];
    }
  }

  if (b < B) {
    for (int d = 0; d < 3; ++d) {
      out[(0 + d) * B + b] = pos[d];
      out[(3 + d) * B + b] = vel[d];
      out[(6 + d) * B + b] = omega[d];
      out[(18 + d) * B + b] = integral[d];
      out[(21 + d) * B + b] = lt_sat[d];
    }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) out[(9 + 3 * i + j) * B + b] = R[i][j];
    out[24 * B + b] = fcount;
    out[25 * B + b] = last_valid;
    if (kBackCalc) {
      out[26 * B + b] = u_thrust;
      for (int d = 0; d < 3; ++d) out[(27 + d) * B + b] = u_torque[d];
    }
  }
}

template <bool kOneSubstep, bool kBackCalc, bool kRefYaw>
__global__ void __launch_bounds__(kThreads)
    tick_block_kernel(const TickParams P, const float* __restrict__ S,
                      const float* __restrict__ spp, const float* __restrict__ spv,
                      const float* __restrict__ spa, const float* __restrict__ gw,
                      const float* __restrict__ obs, float* __restrict__ out,
                      float* __restrict__ acc_out) {
  extern __shared__ float smem[];
  float* pos_s = smem;                            // [3 T][kEpisodes]
  float* min_s = smem + 3 * P.T * kEpisodes;      // [3][kWarps][kEpisodes]

  const int B = P.B, T = P.T;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x * kEpisodes + lane;
  const bool live = b < B;
  const int bl = live ? b : B - 1;  // the ragged edge computes on a real episode

  if (warp == 0) {
    run_chain<kOneSubstep, kBackCalc, kRefYaw>(P, b, bl, lane, S, spp, spv, spa, gw, pos_s,
                                               out);
  } else if (live) {
    // the zero rows, written while the chain runs (back-calculation's chain
    // writes rows 26-29 itself)
    for (int r = (kBackCalc ? 30 : 26) + (warp - 1); r < 32; r += kHelperWarps)
      out[r * B + b] = 0.f;
    for (int r = 4 + (warp - 1); r < 8; r += kHelperWarps) acc_out[r * B + b] = 0.f;
  }
  float goal[3];  // the helpers' loads land while the chain runs
  for (int d = 0; d < 3; ++d) goal[d] = gw[(0 + d) * B + bl];
  __syncthreads();

  // ---- metrics pass: warp w takes ticks w, w + kWarps, ... of its lane's episode
  float min_dist = 1e30f, min_alt = 1e30f, min_clear = 1e30f;
  if (live) {
    for (int k = 0; k < P.K; ++k) {
      float c[3];
      for (int d = 0; d < 3; ++d) c[d] = obs[(4 * k + d) * B + b];
      const float r = obs[(4 * k + 3) * B + b];
      for (int t = warp; t < T; t += kWarps) {
        float ov[3];
        for (int d = 0; d < 3; ++d) ov[d] = pos_s[(3 * t + d) * kEpisodes + lane] - c[d];
        min_clear = fminf(min_clear, sqrtf(dot3(ov, ov)) - r);
      }
    }
    for (int t = warp; t < T; t += kWarps) {
      float p[3], dv[3], te[3];
      for (int d = 0; d < 3; ++d) {
        p[d] = pos_s[(3 * t + d) * kEpisodes + lane];
        dv[d] = p[d] - goal[d];
        te[d] = p[d] - spp[(3 * t + d) * B + b];
      }
      min_dist = fminf(min_dist, sqrtf(dot3(dv, dv)));
      min_alt = fminf(min_alt, p[2]);
      // this thread alone reads (t, lane): its slot now holds the squared error
      pos_s[(3 * t) * kEpisodes + lane] = dot3(te, te);
    }
  }
  min_s[(0 * kWarps + warp) * kEpisodes + lane] = min_dist;
  min_s[(1 * kWarps + warp) * kEpisodes + lane] = min_alt;
  min_s[(2 * kWarps + warp) * kEpisodes + lane] = min_clear;
  __syncthreads();

  if (warp == 0 && live) {
    float track_sum = 0.f;
    for (int t = 0; t < T; ++t) track_sum = track_sum + pos_s[(3 * t) * kEpisodes + lane];
    for (int w = 1; w < kWarps; ++w) {
      min_dist = fminf(min_dist, min_s[(0 * kWarps + w) * kEpisodes + lane]);
      min_alt = fminf(min_alt, min_s[(1 * kWarps + w) * kEpisodes + lane]);
      min_clear = fminf(min_clear, min_s[(2 * kWarps + w) * kEpisodes + lane]);
    }
    acc_out[0 * B + b] = min_dist;
    acc_out[1 * B + b] = track_sum;
    acc_out[2 * B + b] = min_alt;
    acc_out[3 * B + b] = min_clear;
  }
}

using TickKernel = void (*)(const TickParams, const float*, const float*, const float*,
                           const float*, const float*, const float*, float*, float*);

// The instantiation of a launch: [one substep][back-calculation][reference yaw].
const TickKernel kTickKernels[2][2][2] = {
    {{tick_block_kernel<false, false, false>, tick_block_kernel<false, false, true>},
     {tick_block_kernel<false, true, false>, tick_block_kernel<false, true, true>}},
    {{tick_block_kernel<true, false, false>, tick_block_kernel<true, false, true>},
     {tick_block_kernel<true, true, false>, tick_block_kernel<true, true, true>}},
};

}  // namespace

extern "C" int tick_params_size() { return (int)sizeof(TickParams); }

extern "C" const char* tick_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one tick block on `stream` (does not synchronize). `obs` may be
// null when K == 0. Returns the CUDA error code of the launch, 0 on success.
extern "C" int tick_block_launch(const TickParams* params, const float* S, const float* spp,
                                 const float* spv, const float* spa, const float* gw,
                                 const float* obs, float* out, float* acc_out, void* stream) {
  const TickParams P = *params;
  if (P.B <= 0) return 0;
  if (P.T < 1 || P.substeps < 1 || P.K < 0 || (P.K > 0 && obs == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kEpisodes * (3 * (size_t)P.T + 3 * kWarps);
  const TickKernel kernel = kTickKernels[P.substeps == 1][P.back_calc != 0][P.ref_yaw != 0];
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (P.B + kEpisodes - 1) / kEpisodes;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      P, S, spp, spv, spa, gw, obs, out, acc_out);
  return (int)cudaGetLastError();
}
