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
//   - the rigid-body plant over `substeps` substeps: body-z thrust, wind,
//     linear drag, Euler's equations, and a Rodrigues update of R (with the
//     JAX kernel's small-angle branch, written the same way);
//   - the per-tick metrics: minimum goal distance, summed squared tracking
//     error, minimum altitude, minimum surface clearance to the true spheres
//     (an inactive sphere carries r = -1e30, so its clearance is 1e30).
//
// Layout: one thread per episode; the whole state (pos, vel, omega, R,
// integral, torque-saturation flags, failsafe count, last valid thrust) and
// the four running metrics stay in registers for all T ticks. Row r of an
// input is read at rows[r * B + b], so neighbouring threads read
// neighbouring words. Ticks, substeps and spheres are runtime loops. The
// Pallas kernel's padding of B to 128 lanes and its Python-unrolled tick
// loop do not carry over.
//
// Precision: exact IEEE fp32 throughout (no fast math, precise division,
// square root, sinf and cosf); reduced-precision rotation chains broke the
// Monte-Carlo on the TPU (docs/kernel.md:172-208). nvcc contracts a*b+c into
// FMAs, so the kernel and its plain PyTorch version part by an ulp here and
// there, and an exact compare at a clip limit (thrust saturation, torque
// saturation, the failsafe test) can flip.
//
// What bounds it (reckoned from the code, B=2048, T=40, K=3): per episode
// and launch it reads the state (128 B), the three setpoint arrays
// (3 * 3T * 4 = 1440 B), goal and wind (32 B) and the spheres (16K B), and
// writes 160 B: ~1.8 KB, ~3.7 MB per launch, ~1 us of HBM time. It does a
// few hundred flops per tick, ~25 kFLOP per episode per launch, ~50 MFLOP
// per launch. Neither bounds it: 2048 threads are 64 warps on 132 SMs, each
// running a chain of 40 dependent ticks, so it is bound by the latency of
// that chain at low occupancy. Expect tens of microseconds per launch. In
// the Monte-Carlo loop the per-replan host glue around the solve kernel
// sets the pace, not this kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;  // episodes per block

}  // namespace

// Must match dart_planner_tpu_torch/ops/cuda_rollout.py::_Params field by
// field. Scalars are computed on the host in float64 and rounded to float32.
struct TickParams {
  int B, T, substeps, K, use_drag;
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

__global__ void __launch_bounds__(kThreads)
    tick_block_kernel(const TickParams P, const float* __restrict__ S,
                      const float* __restrict__ spp, const float* __restrict__ spv,
                      const float* __restrict__ spa, const float* __restrict__ gw,
                      const float* __restrict__ obs, float* __restrict__ out,
                      float* __restrict__ acc_out) {
  const int B = P.B;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float pos[3], vel[3], omega[3], R[3][3], integral[3], lt_sat[3], goal[3], wind[3];
  for (int d = 0; d < 3; ++d) {
    pos[d] = S[(0 + d) * B + b];
    vel[d] = S[(3 + d) * B + b];
    omega[d] = S[(6 + d) * B + b];
    integral[d] = S[(18 + d) * B + b];
    lt_sat[d] = S[(21 + d) * B + b];
    goal[d] = gw[(0 + d) * B + b];
    wind[d] = gw[(3 + d) * B + b];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[i][j] = S[(9 + 3 * i + j) * B + b];
  float fcount = S[24 * B + b];
  float last_valid = S[25 * B + b];

  float min_dist = 1e30f, min_alt = 1e30f, min_clear = 1e30f, track_sum = 0.f;

  for (int t = 0; t < P.T; ++t) {
    float sp_p[3], sp_v[3], sp_a[3];
    for (int d = 0; d < 3; ++d) {
      const int r = (3 * t + d) * B + b;
      sp_p[d] = spp[r];
      sp_v[d] = spv[r];
      sp_a[d] = spa[r];
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

    // integral update, clamping anti-windup (saturated axes at 10%)
    const float damp_t = 1.f - 0.9f * thrust_sat;
    float ni[3];
    for (int d = 0; d < 3; ++d) {
      const float damp = damp_t * (1.f - 0.9f * lt_sat[d]);
      const float v = integral[d] + ve[d] * P.control_dt * damp;
      ni[d] = clip(v, -P.per_axis_int[d], P.per_axis_int[d]);
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

    // desired frame at yaw 0 (c = e1)
    const float e1[3] = {1.f, 0.f, 0.f};
    float bc[3], b1n[3], b1s[3], b1[3], b2[3];
    cross3(b3, e1, bc);
    cross3(bc, b3, b1n);
    const float n1 = sqrtf(dot3(b1n, b1n));
    if (n1 > 1e-6f) {
      const float inv_n1 = 1.f / n1;
      for (int d = 0; d < 3; ++d) b1n[d] = b1n[d] * inv_n1;
    } else {
      for (int d = 0; d < 3; ++d) b1n[d] = e1[d];
    }
    const float proj[3] = {1.f - b3[0] * b3[0], -b3[0] * b3[1], -b3[0] * b3[2]};
    const float np_ = sqrtf(dot3(proj, proj));
    const bool straight = fabsf(b3[2]) >= 0.99f;
    if (!straight && np_ > 1e-9f) {
      const float inv_np = 1.f / np_;
      for (int d = 0; d < 3; ++d) b1s[d] = proj[d] * inv_np;
    } else {
      for (int d = 0; d < 3; ++d) b1s[d] = e1[d];
    }
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
    for (int s = 0; s < P.substeps; ++s) {
      for (int d = 0; d < 3; ++d) {
        float a = R[d][2] * thr / P.p_mass;
        if (d == 2) a = a - P.pg;
        a = a + wind[d] / P.p_mass;
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
        a_c = sinf(theta) / theta;
        b_c = (1.f - cosf(theta)) / t2;
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

    // ---- per-tick episode metrics ----
    float dv[3], te[3];
    for (int d = 0; d < 3; ++d) {
      dv[d] = pos[d] - goal[d];
      te[d] = pos[d] - sp_p[d];
    }
    min_dist = fminf(min_dist, sqrtf(dot3(dv, dv)));
    min_alt = fminf(min_alt, pos[2]);
    track_sum = track_sum + dot3(te, te);
    for (int k = 0; k < P.K; ++k) {
      float ov[3];
      for (int d = 0; d < 3; ++d) ov[d] = pos[d] - __ldg(obs + (4 * k + d) * B + b);
      min_clear = fminf(min_clear, sqrtf(dot3(ov, ov)) - __ldg(obs + (4 * k + 3) * B + b));
    }
  }

  // ---- write back ----
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
  for (int r = 26; r < 32; ++r) out[r * B + b] = 0.f;
  acc_out[0 * B + b] = min_dist;
  acc_out[1 * B + b] = track_sum;
  acc_out[2 * B + b] = min_alt;
  acc_out[3 * B + b] = min_clear;
  for (int r = 4; r < 8; ++r) acc_out[r * B + b] = 0.f;
}

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
  const int blocks = (P.B + kThreads - 1) / kThreads;
  tick_block_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      P, S, spp, spv, spa, gw, obs, out, acc_out);
  return (int)cudaGetLastError();
}
