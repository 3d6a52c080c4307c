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
//   - Jacobi-preconditioned CG with Steihaug truncation, the penalty blocks
//     applied matrix-free (Gauss-Newton for n_gn rounds, then full
//     curvature with a clamped, floored Jacobi diagonal);
//   - a projected line search over the given alphas that keeps the current
//     iterate unless a candidate is strictly better (earliest alpha on
//     ties);
//   - the running minimum of the relative improvement (the ftol input),
//     restarted at +inf when the full-curvature stage begins;
// then a final exact rollout and cost pass. The CG matvec and the
// line-search rollouts run in exact fp32 (the TPU kernel ran them in bf16).
//
// Layout: one warp per scenario, lane k = horizon step k (a lane holds steps
// k, k+32 when N > 32). Every per-step vector (u, pos, vel, gradient, the CG
// vectors d/r/z/p, the 3x3 Gauss-Newton block, the thrust-hinge terms) lives
// in registers; lanes with k >= N hold exact zeros and free = 0. The
// constant N x N maps (H, S_p/m, S_v/m, in a "direct" and a "transposed"
// layout, so that lanes read consecutive shared-memory words) are staged in
// shared memory once per block and shared by its warps. A matvec stages its
// 3N-vector in per-warp shared memory, then each lane takes its row's dot
// products; per-scenario sums use a __shfl_xor_sync butterfly, which leaves
// a bit-identical value on every lane, so all branch decisions are
// warp-uniform.
//
// What bounds it (reckoned from the code, N=20, K=8, default budget): a CG
// matvec is ~6k FMA per scenario (H, S_p, S_v direct plus two pullbacks,
// 3 axes x 20 x 20 each), x 10 CG steps x 12 rounds, plus the line-search
// rollouts and the K-sphere cost passes: ~1.1M FMA per scenario for phase 1
// and ~0.35M more per scenario for the 25% tail at CG-25, so ~12 GFLOP per
// 4096-scenario two-phase solve over a working set of ~2 MB. That is fp32
// issue, shuffle and shared-memory bound, not HBM bound; every FMA of a
// matvec pairs with one shared-memory load. 12 of the 32 lanes idle at
// N=20. No tensor cores are used.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // scenarios per block
constexpr int kMaxAlphas = 8;
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// Must match dart_planner_tpu_torch/ops/cuda_mpc.py::_Params field by field.
struct MpcParams {
  int B, N, K;
  int n_gn, n_full, cg_iters, n_alpha;
  int use_obstacles, use_ground, use_vel_hinge, use_tilt, use_tnorm;
  float alphas[kMaxAlphas];
  float inv_m, hover, g_z;
  float w_p, w_pN, w_v, w_a, w_T;
  float w_obs, w_g, z_min, w_vb, v_max, w_tilt, tan_max, w_tn, u_max;
  float lb[3], ub[3];
};

namespace {

__device__ __forceinline__ float wsum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

template <int S>
__device__ __forceinline__ float vsum(const float (&x)[S][3]) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) acc += x[s][0] + x[s][1] + x[s][2];
  return wsum(acc);
}

template <int S>
__device__ __forceinline__ float vdot(const float (&x)[S][3], const float (&y)[S][3]) {
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) acc = fmaf(x[s][a], y[s][a], acc);
  return wsum(acc);
}

// Writes a per-step vector to the warp's staging buffer (3 rows of LD).
// The leading __syncwarp lets every lane finish reading the old contents.
template <int S>
__device__ __forceinline__ void stage(float* buf, const float (&x)[S][3], int lane) {
  constexpr int LD = 32 * S;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) buf[a * LD + lane + 32 * s] = x[s][a];
  __syncwarp();
}

// y[k] += sum_j M[j * LD + k] * buf[j] for each axis (SQ: M squared).
// With M in the "direct" layout this is (M @ x); in the "transposed"
// layout it is (M^T @ x). Columns k >= N of M are zero.
template <int S, bool SQ = false>
__device__ __forceinline__ void apply_map(const float* __restrict__ M, const float* buf,
                                          int N, int lane, float (&y)[S][3]) {
  constexpr int LD = 32 * S;
  for (int j = 0; j < N; ++j) {
    const float x0 = buf[j], x1 = buf[LD + j], x2 = buf[2 * LD + j];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float m = M[j * LD + lane + 32 * s];
      if (SQ) m = m * m;
      y[s][0] = fmaf(m, x0, y[s][0]);
      y[s][1] = fmaf(m, x1, y[s][1]);
      y[s][2] = fmaf(m, x2, y[s][2]);
    }
  }
}

template <int S>
__device__ __forceinline__ void zero(float (&x)[S][3]) {
#pragma unroll
  for (int s = 0; s < S; ++s) x[s][0] = x[s][1] = x[s][2] = 0.f;
}

struct Shared {
  const float *Hd, *Spd, *Svd, *Spt, *Svt, *tv, *spg, *svg, *dq;
  float* bufA;
  float* bufB;
  const float* obs;  // [K][5]: cx, cy, cz, r_safe, mask
};

// pos = C_pos + (S_p/m) u, vel = C_vel + (S_v/m) u
template <int S>
__device__ __forceinline__ void rollout(const Shared& sh, int N, int lane,
                                        const float (&cpos)[S][3], const float (&cvel)[S][3],
                                        const float (&u)[S][3], float (&pos)[S][3],
                                        float (&vel)[S][3]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pos[s][a] = cpos[s][a];
      vel[s][a] = cvel[s][a];
    }
  stage<S>(sh.bufA, u, lane);
  apply_map<S>(sh.Spd, sh.bufA, N, lane, pos);
  apply_map<S>(sh.Svd, sh.bufA, N, lane, vel);
}

// Total cost of one scenario (identical on every lane).
template <int S>
__device__ __forceinline__ float cost(const MpcParams& P, const Shared& sh, int lane, float vmax,
                                      const float (&u)[S][3], const float (&pos)[S][3],
                                      const float (&vel)[S][3], const float (&goal)[S][3]) {
  float D = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = lane + 32 * s;
    if (k >= P.N) continue;
    const float wp = (k == P.N - 1) ? P.w_pN : P.w_p;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pe = pos[s][a] - goal[s][a];
      const float acc = u[s][a] * P.inv_m + (a == 2 ? P.g_z : 0.f);
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
      for (int o = 0; o < P.K; ++o) {
        const float* ob = sh.obs + 5 * o;
        const float dx = pos[s][0] - ob[0], dy = pos[s][1] - ob[1], dz = pos[s][2] - ob[2];
        const float d = sqrtf(dx * dx + dy * dy + dz * dz + 1e-9f);
        const float viol = fmaxf(ob[3] - d, 0.f) * ob[4];
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
  return wsum(D);
}

// Per-round curvature data consumed by the CG matvec.
template <int S>
struct Curv {
  float h[S][6];    // position-space block: xx, yy, zz, xy, xz, yz
  float hv[S][3];   // velocity-space diagonal
  float tl[S][4];   // tilt: at, jx, jy, ct
  float tn[S][5];   // thrust norm: an, nx, ny, nz, cn
  float free[S][3];
};

template <int S>
__device__ __forceinline__ void matvec(const MpcParams& P, const Shared& sh, int lane, bool pen,
                                       const Curv<S>& c, const float (&p)[S][3],
                                       float (&out)[S][3]) {
  float dv[S][3];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) dv[s][a] = p[s][a] * c.free[s][a];
  zero<S>(out);
  stage<S>(sh.bufA, dv, lane);
  apply_map<S>(sh.Hd, sh.bufA, P.N, lane, out);
  if (pen) {
    float y[S][3], yv[S][3];
    zero<S>(y);
    apply_map<S>(sh.Spd, sh.bufA, P.N, lane, y);
    if (P.use_vel_hinge) {
      zero<S>(yv);
      apply_map<S>(sh.Svd, sh.bufA, P.N, lane, yv);
    }
    float zb[S][3];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* h = c.h[s];
      zb[s][0] = h[0] * y[s][0] + h[3] * y[s][1] + h[4] * y[s][2];
      zb[s][1] = h[3] * y[s][0] + h[1] * y[s][1] + h[5] * y[s][2];
      zb[s][2] = h[4] * y[s][0] + h[5] * y[s][1] + h[2] * y[s][2];
    }
    stage<S>(sh.bufA, zb, lane);
    apply_map<S>(sh.Spt, sh.bufA, P.N, lane, out);
    if (P.use_vel_hinge) {
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int a = 0; a < 3; ++a) yv[s][a] *= c.hv[s][a];
      stage<S>(sh.bufB, yv, lane);
      apply_map<S>(sh.Svt, sh.bufB, P.N, lane, out);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float dx = dv[s][0], dy = dv[s][1], dz = dv[s][2];
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

// One Newton round; updates u and min_imp in place.
template <int S>
__device__ __forceinline__ void newton_round(const MpcParams& P, const Shared& sh, int lane,
                                             float vmax, bool full, const float (&cpos)[S][3],
                                             const float (&cvel)[S][3],
                                             const float (&goal)[S][3], float (&u)[S][3],
                                             float& min_imp, int cg_iters) {
  const int N = P.N;
  const bool pen = P.use_obstacles || P.use_ground || P.use_vel_hinge;
  float pos[S][3], vel[S][3];
  rollout<S>(sh, N, lane, cpos, cvel, u, pos, vel);

  // physical-space gradient and curvature blocks
  Curv<S> c;
  float gpos[S][3], gvel[S][3], g[S][3], dg[S][3];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = lane + 32 * s;
    const bool valid = k < N;
    const float wp = (k == N - 1) ? P.w_pN : P.w_p;
#pragma unroll
    for (int a = 0; a < 6; ++a) c.h[s][a] = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      gpos[s][a] = valid ? 2.f * wp * (pos[s][a] - goal[s][a]) : 0.f;
      gvel[s][a] = valid ? 2.f * P.w_v * vel[s][a] : 0.f;
      c.hv[s][a] = 0.f;
      dg[s][a] = 0.f;
    }
    if (!valid) continue;
    if (P.use_obstacles) {
      for (int o = 0; o < P.K; ++o) {
        const float* ob = sh.obs + 5 * o;
        const float dx = pos[s][0] - ob[0], dy = pos[s][1] - ob[1], dz = pos[s][2] - ob[2];
        const float d = sqrtf(dx * dx + dy * dy + dz * dz + 1e-9f);
        const float viol = fmaxf(ob[3] - d, 0.f) * ob[4];
        const float coef = 2.f * P.w_obs * viol / d;
        gpos[s][0] -= coef * dx;
        gpos[s][1] -= coef * dy;
        gpos[s][2] -= coef * dz;
        const float act = (ob[3] > d ? 1.f : 0.f) * ob[4] * (2.f * P.w_obs);
        float inv_d2;
        if (full) {
          const float hd = viol / d;
          inv_d2 = act * (1.f + hd) / (d * d);
          const float diag_c = act * hd;
          c.h[s][0] -= diag_c;
          c.h[s][1] -= diag_c;
          c.h[s][2] -= diag_c;
        } else {
          inv_d2 = act / (d * d);
        }
        c.h[s][0] += inv_d2 * dx * dx;
        c.h[s][1] += inv_d2 * dy * dy;
        c.h[s][2] += inv_d2 * dz * dz;
        c.h[s][3] += inv_d2 * dx * dy;
        c.h[s][4] += inv_d2 * dx * dz;
        c.h[s][5] += inv_d2 * dy * dz;
      }
    }
    if (P.use_ground) {
      const float gv = fmaxf(P.z_min - pos[s][2], 0.f);
      gpos[s][2] -= 2.f * P.w_g * gv;
      c.h[s][2] += (pos[s][2] < P.z_min) ? 2.f * P.w_g : 0.f;
    }
    if (P.use_vel_hinge) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v = vel[s][a];
        const float vv = fmaxf(fabsf(v) - vmax, 0.f);
        const float sgn = (v > 0.f) ? 1.f : ((v < 0.f) ? -1.f : 0.f);
        gvel[s][a] += 2.f * P.w_vb * sgn * vv;
        c.hv[s][a] = (fabsf(v) > vmax) ? 2.f * P.w_vb : 0.f;
      }
    }
  }
  // pull back to thrust space
  zero<S>(g);
  stage<S>(sh.bufA, gpos, lane);
  stage<S>(sh.bufB, gvel, lane);
  apply_map<S>(sh.Spt, sh.bufA, N, lane, g);
  apply_map<S>(sh.Svt, sh.bufB, N, lane, g);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = lane + 32 * s;
#pragma unroll
    for (int a = 0; a < 4; ++a) c.tl[s][a] = 0.f;
#pragma unroll
    for (int a = 0; a < 5; ++a) c.tn[s][a] = 0.f;
    if (k >= N) {
      g[s][0] = g[s][1] = g[s][2] = 0.f;
      continue;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float acc = u[s][a] * P.inv_m + (a == 2 ? P.g_z : 0.f);
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
      const float at = (lat - P.tan_max * uz > 0.f) ? 2.f * P.w_tilt : 0.f;
      dg[s][0] += at * jx * jx;
      dg[s][1] += at * jy * jy;
      dg[s][2] += at * (P.tan_max * P.tan_max);
      float ct = 0.f;
      if (full) {
        ct = cc / lat;
        dg[s][0] += ct * (1.f - jx * jx);
        dg[s][1] += ct * (1.f - jy * jy);
      }
      c.tl[s][0] = at;
      c.tl[s][1] = jx;
      c.tl[s][2] = jy;
      c.tl[s][3] = ct;
    }
    if (P.use_tnorm) {
      const float un = sqrtf(ux * ux + uy * uy + uz * uz + 1e-9f);
      const float nvv = fmaxf(un - P.u_max, 0.f);
      const float nx = ux / un, ny = uy / un, nz = uz / un;
      const float cng = 2.f * P.w_tn * nvv;
      g[s][0] += cng * nx;
      g[s][1] += cng * ny;
      g[s][2] += cng * nz;
      const float an = (un > P.u_max) ? 2.f * P.w_tn : 0.f;
      dg[s][0] += an * nx * nx;
      dg[s][1] += an * ny * ny;
      dg[s][2] += an * nz * nz;
      float cn = 0.f;
      if (full) {
        cn = cng / un;
        dg[s][0] += cn * (1.f - nx * nx);
        dg[s][1] += cn * (1.f - ny * ny);
        dg[s][2] += cn * (1.f - nz * nz);
      }
      c.tn[s][0] = an;
      c.tn[s][1] = nx;
      c.tn[s][2] = ny;
      c.tn[s][3] = nz;
      c.tn[s][4] = cn;
    }
  }

  // active set: at a bound with the gradient pushing outward
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool valid = lane + 32 * s < N;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const bool at_lo = (u[s][a] <= P.lb[a] + 1e-6f) && (g[s][a] > 0.f);
      const bool at_hi = (u[s][a] >= P.ub[a] - 1e-6f) && (g[s][a] < 0.f);
      c.free[s][a] = (valid && !(at_lo || at_hi)) ? 1.f : 0.f;
    }
  }

  // Jacobi preconditioner
  float minv[S][3];
  {
    float diag[S][3];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float dq = sh.dq[lane + 32 * s];
#pragma unroll
      for (int a = 0; a < 3; ++a) diag[s][a] = dq + dg[s][a];
    }
    if (pen) {
      float hpd[S][3];
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int a = 0; a < 3; ++a) hpd[s][a] = c.h[s][a];
      stage<S>(sh.bufA, hpd, lane);
      stage<S>(sh.bufB, c.hv, lane);
      apply_map<S, true>(sh.Spt, sh.bufA, N, lane, diag);
      if (P.use_vel_hinge) apply_map<S, true>(sh.Svt, sh.bufB, N, lane, diag);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float dq = sh.dq[lane + 32 * s];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        // The absolute 1e-8 floor keeps idle lanes (dq == 0) at minv = 0
        // instead of 0 / 0 = NaN, which would poison every warp sum.
        const float den = full ? fmaxf(fmaxf(diag[s][a], 0.1f * dq), 1e-8f)
                               : fmaxf(diag[s][a], 1e-8f);
        minv[s][a] = c.free[s][a] / den;
      }
    }
  }

  // Steihaug-truncated preconditioned CG on the free subspace
  float d[S][3], r[S][3], z0[S][3], p[S][3];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      r[s][a] = -(g[s][a] * c.free[s][a]);
      z0[s][a] = minv[s][a] * r[s][a];
      p[s][a] = z0[s][a];
      d[s][a] = 0.f;
    }
  float rz = vdot<S>(r, z0);
  for (int it = 0; it < cg_iters; ++it) {
    float ap[S][3];
    matvec<S>(P, sh, lane, pen, c, p, ap);
    const float pap = vdot<S>(p, ap);
    const float pp = vdot<S>(p, p);
    // once a direction shows (near-)negative curvature the scenario's
    // step is frozen for the rest of the round: later iterations would
    // change nothing, so the warp leaves the loop
    if (!(pap > 1e-8f * pp)) break;
    const float alpha = rz / fmaxf(pap, 1e-12f);
    float z[S][3];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        d[s][a] += alpha * p[s][a];
        r[s][a] -= alpha * ap[s][a];
        z[s][a] = minv[s][a] * r[s][a];
      }
    const float rz_new = vdot<S>(r, z);
    const float beta = rz_new / fmaxf(rz, 1e-12f);
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int a = 0; a < 3; ++a) p[s][a] = z[s][a] + beta * p[s][a];
    rz = rz_new;
  }
  if (full) {
    // negative curvature on the first CG step leaves d = 0: fall back to
    // preconditioned steepest descent
    float dn[S][3];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int a = 0; a < 3; ++a) dn[s][a] = fabsf(d[s][a]);
    if (!(vsum<S>(dn) > 0.f)) {
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int a = 0; a < 3; ++a) d[s][a] = z0[s][a];
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) d[s][a] *= c.free[s][a];

  // projected line search: keep the current iterate unless a candidate is
  // strictly better (earliest alpha on ties)
  const float cur = cost<S>(P, sh, lane, vmax, u, pos, vel, goal);
  float best = cur;
  float bu[S][3];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) bu[s][a] = u[s][a];
  for (int ia = 0; ia < P.n_alpha; ++ia) {
    const float alpha = P.alphas[ia];
    float cand[S][3];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool valid = lane + 32 * s < N;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        cand[s][a] =
            valid ? fminf(fmaxf(u[s][a] + alpha * d[s][a], P.lb[a]), P.ub[a]) : 0.f;
    }
    float pc[S][3], vc[S][3];
    rollout<S>(sh, N, lane, cpos, cvel, cand, pc, vc);
    const float cj = cost<S>(P, sh, lane, vmax, cand, pc, vc, goal);
    if (cj < best) {
      best = cj;
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int a = 0; a < 3; ++a) bu[s][a] = cand[s][a];
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int a = 0; a < 3; ++a) u[s][a] = bu[s][a];
  const float imp = (cur - best) / (1.f + fabsf(best));
  min_imp = fminf(min_imp, imp);
}

template <int S>
__global__ void __launch_bounds__(kWarps * 32)
    mpc_solve_kernel(const MpcParams P, const float* __restrict__ consts,
                     const float* __restrict__ u0, const float* __restrict__ p0,
                     const float* __restrict__ v0, const float* __restrict__ goal_in,
                     const float* __restrict__ obs_in, const float* __restrict__ mask_in,
                     const float* __restrict__ vcap, float* __restrict__ u_out,
                     float* __restrict__ pos_out, float* __restrict__ vel_out,
                     float* __restrict__ imp_out, float* __restrict__ cost_out) {
  constexpr int LD = 32 * S;
  extern __shared__ float smem[];
  const int N = P.N, K = P.K;
  const int nconst = 5 * N * LD + 4 * LD;
  for (int i = threadIdx.x; i < nconst; i += blockDim.x) smem[i] = consts[i];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  float* wbuf = smem + nconst + warp * (6 * LD + 5 * K);
  Shared sh;
  sh.Hd = smem;
  sh.Spd = sh.Hd + N * LD;
  sh.Svd = sh.Spd + N * LD;
  sh.Spt = sh.Svd + N * LD;
  sh.Svt = sh.Spt + N * LD;
  sh.tv = sh.Svt + N * LD;
  sh.spg = sh.tv + LD;
  sh.svg = sh.spg + LD;
  sh.dq = sh.svg + LD;
  sh.bufA = wbuf;
  sh.bufB = wbuf + 3 * LD;
  float* obs_s = wbuf + 6 * LD;
  sh.obs = obs_s;
  if (b < P.B) {
    for (int i = lane; i < 5 * K; i += 32) {
      const int o = i / 5, f = i % 5;
      obs_s[i] = f < 4 ? obs_in[((size_t)b * K + o) * 4 + f] : mask_in[(size_t)b * K + o];
    }
  }
  __syncthreads();
  if (b >= P.B) return;  // no block-wide barrier follows

  const float vmax = vcap ? vcap[b] : P.v_max;
  float u[S][3], goal[S][3], cpos[S][3], cvel[S][3];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = lane + 32 * s;
    const bool valid = k < N;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const size_t at = ((size_t)b * N + k) * 3 + a;
      const float ga = a == 2 ? P.g_z : 0.f;
      u[s][a] = valid ? u0[at] : 0.f;
      goal[s][a] = valid ? goal_in[at] : 0.f;
      cpos[s][a] = valid ? p0[b * 3 + a] + sh.tv[k] * v0[b * 3 + a] + sh.spg[k] * ga : 0.f;
      cvel[s][a] = valid ? v0[b * 3 + a] + sh.svg[k] * ga : 0.f;
    }
  }

  float min_imp = INFINITY;
  for (int i = 0; i < P.n_gn; ++i)
    newton_round<S>(P, sh, lane, vmax, false, cpos, cvel, goal, u, min_imp, P.cg_iters);
  if (P.n_full > 0) {
    min_imp = INFINITY;  // the stall tracker restarts with stage 2
    for (int i = 0; i < P.n_full; ++i)
      newton_round<S>(P, sh, lane, vmax, true, cpos, cvel, goal, u, min_imp, P.cg_iters);
  }

  float pos[S][3], vel[S][3];
  rollout<S>(sh, N, lane, cpos, cvel, u, pos, vel);
  const float J = cost<S>(P, sh, lane, vmax, u, pos, vel, goal);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int k = lane + 32 * s;
    if (k >= N) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const size_t at = ((size_t)b * N + k) * 3 + a;
      u_out[at] = u[s][a];
      pos_out[at] = pos[s][a];
      vel_out[at] = vel[s][a];
    }
  }
  if (lane == 0) {
    imp_out[b] = min_imp;
    cost_out[b] = J;
  }
}

template <int S>
cudaError_t launch(const MpcParams& P, const float* consts, const float* u0, const float* p0,
                   const float* v0, const float* goal, const float* obs, const float* mask,
                   const float* vcap, float* u_out, float* pos_out, float* vel_out,
                   float* imp_out, float* cost_out, cudaStream_t stream) {
  constexpr int LD = 32 * S;
  const size_t smem =
      sizeof(float) * (size_t)(5 * P.N * LD + 4 * LD + kWarps * (6 * LD + 5 * P.K));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mpc_solve_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((P.B + kWarps - 1) / kWarps), block(kWarps * 32);
  mpc_solve_kernel<S><<<grid, block, smem, stream>>>(P, consts, u0, p0, v0, goal, obs, mask,
                                                     vcap, u_out, pos_out, vel_out, imp_out,
                                                     cost_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mpc_params_size() { return (int)sizeof(MpcParams); }

extern "C" const char* mpc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the solve on `stream` (does not synchronize). Returns the CUDA
// error code of the launch, 0 on success.
extern "C" int mpc_solve_launch(const MpcParams* params, const float* consts, const float* u0,
                                const float* p0, const float* v0, const float* goal,
                                const float* obs, const float* mask, const float* vcap,
                                float* u_out, float* pos_out, float* vel_out, float* imp_out,
                                float* cost_out, void* stream) {
  const MpcParams P = *params;
  if (P.B <= 0) return 0;
  if (P.N < 1 || P.N > 64 || P.K < 0 || P.n_alpha < 0 || P.n_alpha > kMaxAlphas)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (P.N <= 32)
    e = launch<1>(P, consts, u0, p0, v0, goal, obs, mask, vcap, u_out, pos_out, vel_out,
                  imp_out, cost_out, st);
  else
    e = launch<2>(P, consts, u0, p0, v0, goal, obs, mask, vcap, u_out, pos_out, vel_out,
                  imp_out, cost_out, st);
  return (int)e;
}
