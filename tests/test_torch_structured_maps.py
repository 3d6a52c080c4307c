"""The structured rollout maps on the CPU: ``ops/dynamics.py::apply_structured``
and the CG operator and Jacobi diagonal that the CUDA solver kernel
(``csrc/mpc_solve.cu``) builds from the same prefix and suffix sums.

- Each map (S_p, S_v and their transposes) by ``cumsum`` against the dense
  ``rollout_matrices`` product in float64. Tolerance: 1e-6 of the sum of
  |terms| per entry (the scale a float32 sum of up to 64 terms rounds at),
  in float64 and in float32.
- The fused CG operator the kernel applies,
  ``(S_p/m)^T[(2 wp I + h) (S_p/m) dv] + (S_v/m)^T[(2 w_v + hv) (S_v/m) dv]
  + 2 (w_a/m^2 + w_T) dv``, in float32, against the plain loop's dense
  matvec (``quadratic_hessian`` plus the penalty blocks) and against the JAX
  package's ``costs.quadratic_hessian``, on the same numpy inputs with
  random blocks of ``penalty_blocks``' shapes: 1e-5 of the operator's scale.
- The kernel's Jacobi diagonal ``sum_k (S_p/m)[k,j]^2 h_k`` by three suffix
  sums against the dense squares: 1e-5 of its scale.
"""

import numpy as np
import pytest
import torch

from dart_planner_tpu.ops import costs as jcosts
from dart_planner_tpu_torch.ops import costs, dynamics
from dart_planner_tpu_torch.planning import se3_mpc as T

HORIZONS = [1, 8, 20, 33, 64]
DENSE = {"S_p": lambda Sp, Sv: Sp, "S_v": lambda Sp, Sv: Sv,
         "S_p^T": lambda Sp, Sv: Sp.T, "S_v^T": lambda Sp, Sv: Sv.T}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", dynamics.STRUCTURED_MAPS)
@pytest.mark.parametrize("N", HORIZONS)
def test_structured_map_matches_dense(N, kind, dtype):
    dt = 0.1
    Sp, Sv, _ = dynamics.rollout_matrices(N, dt)
    M = DENSE[kind](Sp, Sv)
    x = np.random.default_rng(N).normal(size=(3, N, 3))
    y = dynamics.apply_structured(kind, torch.tensor(x, dtype=dtype), dt)
    assert y.dtype == dtype and y.shape == x.shape
    ref = M @ x
    scale = np.abs(M) @ np.abs(x)
    err = np.abs(y.double().numpy() - ref)
    assert np.all(err <= 1e-6 * scale + 1e-300), float((err / (scale + 1e-300)).max())


def _weights(config):
    w = config.weights
    N = config.prediction_horizon
    wp = np.full(N, w.position)
    wp[-1] = w.position * (1.0 + w.terminal)
    return w, wp


def _random_blocks(N, seed):
    """Penalty blocks of ``penalty_blocks``' shapes: symmetric Hp (N, 3, 3)
    with a few negative eigenvalues (full curvature), Hv (N, 3) >= 0."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 30.0, (N, 3, 3))
    Hp = 0.5 * (a + np.swapaxes(a, -1, -2))
    Hv = rng.uniform(0.0, 2000.0, (N, 3)) * (rng.uniform(size=(N, 3)) < 0.5)
    dv = rng.normal(0, 1.0, (N, 3))
    return Hp, Hv, dv


def _fused_operator(config, Hp, Hv, dv):
    """The kernel's CG matvec (without the thrust-space blocks, which it
    applies per step), in float32 through the structured maps."""
    w, wp = _weights(config)
    dt, m = config.dt, config.mass
    f32 = dict(dtype=torch.float32)
    dv, Hp, Hv = (torch.tensor(x, **f32) for x in (dv, Hp, Hv))
    yp = dynamics.apply_structured("S_p", dv, dt) / m
    yv = dynamics.apply_structured("S_v", dv, dt) / m
    zp = 2.0 * torch.tensor(wp, **f32)[:, None] * yp + (Hp @ yp[..., None])[..., 0]
    zv = (2.0 * w.velocity + Hv) * yv
    back = dynamics.apply_structured("S_p^T", zp, dt) + dynamics.apply_structured(
        "S_v^T", zv, dt
    )
    return (back / m + 2.0 * (w.acceleration / m**2 + w.thrust) * dv).double().numpy()


def _dense_operator(config, H, Hp, Hv, dv):
    """The plain loop's matvec (planning/se3_mpc.py::_newton_iterate), in
    float64: H dv + (S_p/m)^T Hp (S_p/m) dv + (S_v/m)^T Hv (S_v/m) dv."""
    N, m = config.prediction_horizon, config.mass
    Sp, Sv, _ = dynamics.rollout_matrices(N, config.dt)
    Sp, Sv = Sp / m, Sv / m
    y = Sp @ dv
    z = (Hp @ y[..., None])[..., 0]
    return H @ dv + Sp.T @ z + Sv.T @ (Hv * (Sv @ dv))


@pytest.mark.parametrize("N", HORIZONS)
def test_fused_cg_operator_matches_dense_hessian(N):
    config = T.SE3MPCConfig(prediction_horizon=N)
    Hp, Hv, dv = _random_blocks(N, N)
    got = _fused_operator(config, Hp, Hv, dv)
    H_port = costs.quadratic_hessian(N, config.dt, config.mass, config.gravity,
                                     config.weights)
    jw = jcosts.CostWeights(**config.weights._asdict())
    H_jax = np.asarray(
        jcosts.quadratic_hessian(N, config.dt, config.mass, config.gravity, jw),
        np.float64,
    )
    for H in (H_port, H_jax):
        ref = _dense_operator(config, H, Hp, Hv, dv)
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("N", HORIZONS)
def test_jacobi_diagonal_by_suffix_sums(N):
    """sum_{k>j} (k-j-1/2)^2 h_k = F(h/4 + 2 (R1 + F(R1)))_j with R1 = F(h),
    F the exclusive suffix sum: the kernel's diagonal of (S_p/m)^T h (S_p/m)
    (plus the S_v term), every weight positive."""
    config = T.SE3MPCConfig(prediction_horizon=N)
    Hp, Hv, _ = _random_blocks(N, 100 + N)
    hp = np.abs(np.diagonal(Hp, axis1=-2, axis2=-1))
    cv = config.dt / config.mass
    cp = config.dt * cv

    def F(x):  # exclusive suffix sum: S_v^T with dt = 1
        return dynamics.apply_structured("S_v^T", x, 1.0)

    h = torch.tensor(cp * cp * hp, dtype=torch.float32)
    r1 = F(h)
    got = F(0.25 * h + 2.0 * (r1 + F(r1)) + torch.tensor(cv * cv * Hv, dtype=torch.float32))
    Sp, Sv, _ = dynamics.rollout_matrices(N, config.dt)
    ref = ((Sp / config.mass) ** 2).T @ hp + ((Sv / config.mass) ** 2).T @ Hv
    np.testing.assert_allclose(got.double().numpy(), ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max() + 1e-30))
