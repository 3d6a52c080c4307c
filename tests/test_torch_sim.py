"""The port's physics, tick block and closed loop (dart_planner_tpu_torch/
sim/ and ops/cuda_rollout.py) against the JAX package on the same numpy
inputs, and against themselves across the two tick paths.

Tolerances: physics steps 1e-5; the packing helpers exact or 1e-6; the
plain tick block against the JAX kernel in interpret mode 1e-5. Episodes:
the port's packed ("fused") path against its per-tick ("torch") path at
1e-4, as the JAX package holds its two paths; the port against JAX's scan
path at 1e-3 on final position, minimum distance and tracking RMSE (the
solve's flat plateau lets float32 rounding move an iterate, ROADMAP C.9);
obstacle episodes at 5e-2, as tests/test_worlds.py holds its own paths.
JAX's wind and sensor-noise draws are passed through to the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_planner_tpu.common.types import ControlCommand as JCommand
from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.control import geometric as JG
from dart_planner_tpu.ops import pallas_rollout
from dart_planner_tpu.ops import so3 as jso3
from dart_planner_tpu.planning import se3_mpc as JM
from dart_planner_tpu.sim import closed_loop as JL
from dart_planner_tpu.sim import physics as JP
from dart_planner_tpu_torch import ControlCommand, DroneState, interop
from dart_planner_tpu_torch.control import geometric as TG
from dart_planner_tpu_torch.ops import cuda_rollout
from dart_planner_tpu_torch.planning import se3_mpc as TM
from dart_planner_tpu_torch.sim import closed_loop as TL
from dart_planner_tpu_torch.sim import physics as TP


def _np(x):
    return np.asarray(x, np.float32)


def _states(pos, vel=None):
    """The same batch of initial states in both packages."""
    pos = _np(pos)
    B = pos.shape[0]
    vel = np.zeros((B, 3), np.float32) if vel is None else _np(vel)
    z = jnp.zeros((B, 3), jnp.float32)
    js = JDroneState.create(timestamp=jnp.zeros(B, jnp.float32), position=jnp.asarray(pos),
                            velocity=jnp.asarray(vel), attitude=z, angular_velocity=z)
    ts = DroneState.zeros((B,)).replace(position=torch.tensor(pos),
                                        velocity=torch.tensor(vel))
    return js, ts


# ---- physics ---------------------------------------------------------------

@pytest.mark.parametrize("body_frame", [True, False])
def test_point_mass_step_matches_jax(body_frame):
    jcfg = JP.PhysicsConfig(body_frame_thrust=body_frame, drag_coefficient=0.1)
    tcfg = TP.PhysicsConfig(**jcfg._asdict())
    rng = np.random.default_rng(0)
    B = 4
    att = _np(rng.normal(0, 0.2, (B, 3)))
    js = JDroneState.create(timestamp=jnp.zeros(B, jnp.float32),
                            position=jnp.asarray(_np(rng.normal(0, 1, (B, 3)))),
                            velocity=jnp.zeros((B, 3), jnp.float32),
                            attitude=jnp.asarray(att), angular_velocity=jnp.zeros((B, 3), jnp.float32))
    ts = DroneState(timestamp=torch.zeros(B), position=torch.tensor(np.asarray(js.position)),
                    velocity=torch.zeros(B, 3), attitude=torch.tensor(att),
                    angular_velocity=torch.zeros(B, 3))
    wind = _np(rng.normal(0, 1, (B, 3)))
    for _ in range(50):
        thrust = _np(rng.uniform(10, 18, B))
        torque = _np(rng.normal(0, 0.05, (B, 3)))
        js = JP.point_mass_step(jcfg, js, JCommand(thrust=jnp.asarray(thrust),
                                                   torque=jnp.asarray(torque)),
                                0.01, jnp.asarray(wind))
        ts = TP.point_mass_step(tcfg, ts, ControlCommand(thrust=torch.tensor(thrust),
                                                         torque=torch.tensor(torque)),
                                0.01, torch.tensor(wind))
    for name in ("timestamp", "position", "velocity", "attitude", "angular_velocity"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), _np(getattr(js, name)),
                                   atol=1e-5, err_msg=name)


def test_rigid_body_step_matches_jax():
    jcfg = JP.PhysicsConfig(drag_coefficient=0.05)
    tcfg = TP.PhysicsConfig(**jcfg._asdict())
    rng = np.random.default_rng(1)
    B = 4
    att = _np(rng.normal(0, 0.3, (B, 3)))
    js0 = JDroneState.create(timestamp=jnp.zeros(B, jnp.float32),
                             position=jnp.zeros((B, 3), jnp.float32),
                             velocity=jnp.zeros((B, 3), jnp.float32), attitude=jnp.asarray(att),
                             angular_velocity=jnp.asarray(_np(rng.normal(0, 1, (B, 3)))))
    jb = JP.RigidBodyState.from_drone_state(js0)
    tb = TP.RigidBodyState.from_drone_state(DroneState(
        timestamp=torch.zeros(B), position=torch.zeros(B, 3), velocity=torch.zeros(B, 3),
        attitude=torch.tensor(att), angular_velocity=torch.tensor(_np(js0.angular_velocity))))
    np.testing.assert_allclose(tb.rotation.numpy(), _np(jb.rotation), atol=1e-6)
    wind = _np(rng.normal(0, 1, (B, 3)))
    for _ in range(50):
        thrust = _np(rng.uniform(10, 18, B))
        torque = _np(rng.normal(0, 0.1, (B, 3)))
        jb = JP.rigid_body_step(jcfg, jb, JCommand(thrust=jnp.asarray(thrust),
                                                   torque=jnp.asarray(torque)),
                                0.0025, jnp.asarray(wind))
        tb = TP.rigid_body_step(tcfg, tb, ControlCommand(thrust=torch.tensor(thrust),
                                                         torque=torch.tensor(torque)),
                                0.0025, torch.tensor(wind))
    for name in ("position", "velocity", "rotation", "angular_velocity"):
        np.testing.assert_allclose(getattr(tb, name).numpy(), _np(getattr(jb, name)),
                                   atol=1e-5, err_msg=name)
    R = tb.rotation.numpy()
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    np.testing.assert_allclose(tb.to_drone_state(0.5).attitude.numpy(),
                               _np(jb.to_drone_state(0.5).attitude), atol=1e-5)


def test_sample_wind_shape_and_stream():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    w1 = TP.sample_wind(g1, (5,), 1.0, 0.5)
    w2 = TP.sample_wind(g2, (5,), 1.0, 0.5)
    assert w1.shape == (5, 3) and w1.dtype == torch.float32
    assert torch.equal(w1, w2)
    assert torch.equal(TP.sample_wind(g1, (5,), 0.0, 0.0), torch.zeros(5, 3))


# ---- tick-block helpers ------------------------------------------------------

def _random_block(rng, B, T, K, trigger=100):
    """Random but physical tick-block rows: states, controller state,
    setpoints, goal/wind and spheres (one of them inactive)."""
    att = _np(rng.uniform(-0.5, 0.5, (B, 3)))
    R = _np(jso3.euler_to_rotmat(jnp.asarray(att)))
    S = np.zeros((32, B), np.float32)
    S[0:3] = rng.normal(0, 1, (3, B)) + np.float32([[0], [0], [4]])
    S[3:6] = rng.normal(0, 2, (3, B))
    S[6:9] = rng.normal(0, 2, (3, B))
    S[9:18] = R.reshape(B, 9).T
    S[18:21] = rng.uniform(-1.5, 1.5, (3, B))
    S[21:24] = rng.integers(0, 2, (3, B))
    S[24] = rng.integers(0, trigger + 20, B)
    S[25] = rng.uniform(10, 20, B)
    sp = [(S[0:3][None] + rng.normal(0, 1.0, (T, 3, B))).reshape(3 * T, B),
          rng.normal(0, 1.5, (3 * T, B)), rng.normal(0, 2.5, (3 * T, B))]
    gw = np.zeros((8, B), np.float32)
    gw[0:3] = rng.normal(0, 3, (3, B))
    gw[3:6] = rng.normal(0, 1, (3, B))
    obs = None
    if K:
        obs = np.zeros((4 * K, B), np.float32)
        for k in range(K):
            obs[4 * k:4 * k + 3] = S[0:3] + rng.normal(0, 1.5, (3, B))
            obs[4 * k + 3] = rng.uniform(0.3, 0.8, B)
        obs[3, 0] = -1e30
    return [S] + [_np(x) for x in sp] + [gw], obs


TICK_CASES = {
    "no_obstacles": dict(T=4, sub=1, K=0, trigger=100),
    "obstacles": dict(T=4, sub=1, K=3, trigger=100),
    "substeps2_T25": dict(T=25, sub=2, K=0, trigger=100),
    "failsafe_latch": dict(T=8, sub=1, K=2, trigger=3),
}


@pytest.mark.parametrize("case", list(TICK_CASES))
def test_tick_block_plain_matches_jax_kernel(case):
    c = TICK_CASES[case]
    jc = JG.GeometricConfig(mass=1.5, max_thrust=25.0, failsafe_trigger_count=c["trigger"])
    jp = JP.PhysicsConfig(max_thrust=25.0, drag_coefficient=0.05)
    tc, tp = TG.GeometricConfig(**jc._asdict()), TP.PhysicsConfig(**jp._asdict())
    rows, obs = _random_block(np.random.default_rng(len(case)), 6, c["T"], c["K"],
                              c["trigger"])
    js, ja = pallas_rollout.run_tick_block(
        jc, jp, 0.0025, c["T"], c["sub"], *map(jnp.asarray, rows),
        None if obs is None else jnp.asarray(obs), interpret=True,
    )
    before = cuda_rollout.LAUNCHES
    ts, ta = cuda_rollout.run_tick_block(
        tc, tp, 0.0025, c["T"], c["sub"], *map(torch.tensor, rows),
        None if obs is None else torch.tensor(obs),
    )
    assert cuda_rollout.LAUNCHES == before  # CPU tensors: the plain version
    assert ts.shape == (32, 6) and ta.shape == (8, 6)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(ta.numpy(), _np(ja), atol=1e-5, rtol=1e-6)
    if case == "failsafe_latch":
        assert (ts[24].numpy() > c["trigger"]).any()
    if c["K"]:
        assert (ta[3].numpy() < 1e29).all()


def test_packing_helpers_match_jax():
    rng = np.random.default_rng(5)
    B, N, T, K = 5, 8, 20, 3
    pos, vel, omega = (_np(rng.normal(0, 1, (B, 3))) for _ in range(3))
    R = _np(jso3.euler_to_rotmat(jnp.asarray(_np(rng.normal(0, 0.3, (B, 3))))))
    integral = _np(rng.normal(0, 1, (B, 3)))
    lt = rng.integers(0, 2, (B, 3)).astype(bool)
    count = rng.integers(0, 50, B).astype(np.int32)
    lv = _np(rng.uniform(10, 20, B))
    jrb = JP.RigidBodyState(position=jnp.asarray(pos), velocity=jnp.asarray(vel),
                            rotation=jnp.asarray(R), angular_velocity=jnp.asarray(omega))
    jct = JG.ControllerState.zeros(JG.GeometricConfig(), (B,)).replace(
        integral_vel_error=jnp.asarray(integral), last_torque_saturated=jnp.asarray(lt),
        failsafe_count=jnp.asarray(count), last_valid_thrust=jnp.asarray(lv))
    trb = TP.RigidBodyState(position=torch.tensor(pos), velocity=torch.tensor(vel),
                            rotation=torch.tensor(R), angular_velocity=torch.tensor(omega))
    tct = TG.ControllerState.zeros(TG.GeometricConfig(), (B,)).replace(
        integral_vel_error=torch.tensor(integral), last_torque_saturated=torch.tensor(lt),
        failsafe_count=torch.tensor(count), last_valid_thrust=torch.tensor(lv))
    S_j = _np(pallas_rollout.pack_state(jrb, jct))
    S_t = cuda_rollout.pack_state(trb, tct)
    np.testing.assert_array_equal(S_t.numpy(), S_j)
    rb2, ct2 = cuda_rollout.unpack_state(S_t, trb, tct)
    jrb2, jct2 = pallas_rollout.unpack_state(jnp.asarray(S_j), jrb, jct)
    for a, b in ((rb2.rotation, jrb2.rotation), (rb2.position, jrb2.position),
                 (ct2.failsafe_count, jct2.failsafe_count),
                 (ct2.last_torque_saturated, jct2.last_torque_saturated),
                 (ct2.failsafe_active, jct2.failsafe_active)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    obs = _np(rng.normal(0, 2, (B, K, 4)))
    mask = rng.integers(0, 2, (B, K)).astype(bool)
    np.testing.assert_array_equal(
        cuda_rollout.pack_obstacles(torch.tensor(obs), torch.tensor(mask)).numpy(),
        _np(pallas_rollout.pack_obstacles(jnp.asarray(obs), jnp.asarray(mask))),
    )

    np.testing.assert_array_equal(cuda_rollout._lerp_weights(T, 0.0025, 0.1, N),
                                  pallas_rollout._lerp_weights(T, 0.0025, 0.1, N))
    plan = [_np(rng.normal(0, 3, (B, N, 3))) for _ in range(3)]
    sp_t = cuda_rollout.setpoints_from_plan(*map(torch.tensor, plan), T, 0.0025, 0.1)
    sp_j = pallas_rollout.setpoints_from_plan(*map(jnp.asarray, plan), T, 0.0025, 0.1)
    for a, b in zip(sp_t, sp_j):
        assert a.shape == (3 * T, B)
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-6)


# ---- episodes ------------------------------------------------------------------

def _configs(**kw):
    jcfg = JL.ClosedLoopConfig(**kw)
    return jcfg, interop.closed_loop_config_from_jax_fields(jcfg)


def _close(a, b, atol, fields=("final_position", "min_distance", "tracking_rmse")):
    for f in fields:
        np.testing.assert_allclose(getattr(a, f).numpy(), _np(getattr(b, f)), atol=atol,
                                   err_msg=f)


def test_interop_configs_recurse():
    jcfg, tcfg = _configs(mpc=JM.SE3MPCConfig(prediction_horizon=9), physics_substeps=3)
    assert isinstance(tcfg.mpc, TM.SE3MPCConfig) and tcfg.mpc.prediction_horizon == 9
    assert isinstance(tcfg.control, TG.GeometricConfig)
    assert isinstance(tcfg.physics, TP.PhysicsConfig)
    assert tcfg.physics_substeps == 3
    assert tuple(TL.ClosedLoopConfig()._asdict()) == tuple(JL.ClosedLoopConfig()._asdict())
    assert TL.ClosedLoopConfig().mpc._asdict() == JL.ClosedLoopConfig().mpc._asdict()


def _fused_vs_torch(tcfg, ts, goals, atol, rtol=0.0):
    r_torch = TL.simulate_episode(tcfg, None, ts, goals, method="torch")
    r_fused = TL.simulate_episode(tcfg, None, ts, goals, method="fused")
    for f in ("final_position", "tracking_rmse", "min_distance"):
        np.testing.assert_allclose(getattr(r_fused, f).numpy(),
                                   getattr(r_torch, f).numpy(), atol=atol, rtol=rtol,
                                   err_msg=f)


def test_fused_tick_path_matches_torch_path():
    _, tcfg = _configs(mpc=JM.SE3MPCConfig(prediction_horizon=8, max_iterations=3),
                       num_replans=4)
    rng = np.random.default_rng(0)
    _, ts = _states(rng.normal(0, 1, (3, 3)) + [0, 0, 4])
    goals = torch.tensor(_np(rng.normal(0, 2, (3, 3)) + [0, 0, 4]))
    _fused_vs_torch(tcfg, ts, goals, atol=1e-4)


def test_fused_tick_path_failsafe_branch_matches_torch_path():
    _, tcfg = _configs(
        mpc=JM.SE3MPCConfig(prediction_horizon=8, max_iterations=2),
        control=JG.GeometricConfig(mass=1.5, max_thrust=25.0, failsafe_trigger_count=10),
        num_replans=3,
    )
    _, ts = _states([[60.0, 0, 30.0], [0, 60.0, 30.0]], [[-8.0, 0, 0], [0, -8.0, 0]])
    goals = torch.tensor([[0, 0, 3.0], [0, 0, 3.0]])
    r = TL.simulate_episode(tcfg, None, ts, goals, method="torch")
    f = TL.simulate_episode(tcfg, None, ts, goals, method="fused")
    np.testing.assert_allclose(f.final_position.numpy(), r.final_position.numpy(),
                               rtol=1e-4, atol=1e-3)


def test_fused_tick_path_substeps_and_horizon_match_torch_path():
    _, tcfg = _configs(
        mpc=JM.SE3MPCConfig(prediction_horizon=12, dt=0.08, max_iterations=3),
        physics_substeps=2, substeps_per_plan=25, num_replans=3,
    )
    _, ts = _states([[0, 0, 3.0], [1, -1, 4.0]], [[0.5, 0, 0], [0, 0.5, 0]])
    goals = torch.tensor([[3.0, 1.0, 3.5], [2.0, 2.0, 3.0]])
    _fused_vs_torch(tcfg, ts, goals, atol=1e-4)


SMALL = dict(mpc=JM.SE3MPCConfig(prediction_horizon=8, max_iterations=3,
                                 tail_iterations=0), num_replans=4)


@pytest.mark.parametrize("noisy", [False, True])
def test_torch_episode_matches_jax_scan(noisy):
    extra = dict(wind_mean=1.0, wind_std=0.5, sensor_noise_std=0.02) if noisy else {}
    jcfg, tcfg = _configs(**SMALL, **extra)
    rng = np.random.default_rng(4)
    B = 3
    js, ts = _states(rng.normal(0, 1, (B, 3)) + [0, 0, 4])
    goals = _np(rng.normal(0, 2, (B, 3)) + [0, 0, 4])
    key = jax.random.PRNGKey(7)
    rj = JL.simulate_episode(jcfg, key, js, jnp.asarray(goals), method="xla")
    kw = {}
    if noisy:  # JAX's own draws (closed_loop.py:240-262)
        k_wind, k_noise = jax.random.split(key)
        kw["wind"] = torch.tensor(_np(JP.sample_wind(k_wind, (B,), 1.0, 0.5, jnp.float32)))
        kw["noise"] = torch.tensor(np.stack([
            _np(0.02 * jax.random.normal(jax.random.fold_in(k_noise, i), (B, 6), jnp.float32))
            for i in range(jcfg.num_replans)
        ]))
    rt = TL.simulate_episode(tcfg, None, ts, torch.tensor(goals), method="torch", **kw)
    _close(rt, rj, atol=1e-3)
    np.testing.assert_array_equal(rt.success.numpy(), np.asarray(rj.success))
    assert (rt.min_obstacle_clearance.numpy() > 1e29).all()


def test_obstacle_episode_matches_jax():
    """Per-episode sphere worlds (planner and plant see the same set):
    clearance and final position at 5e-2, as tests/test_worlds.py:106."""
    from dart_planner_tpu.sim import worlds as JW

    jcfg, tcfg = _configs(
        mpc=JM.SE3MPCConfig(prediction_horizon=8, max_iterations=4, cg_iterations=8),
        substeps_per_plan=20, num_replans=12,
    )
    key = jax.random.PRNGKey(3)
    start, goal = jnp.asarray([0.0, 0.0, 3.0]), jnp.asarray([6.0, 3.0, 4.0])
    tobs, tmask = JW.sample_worlds(JW.WorldConfig(), key, 4, start, goal)
    ep_key, jst, jgoals = JL.sample_fleet(key, 4, start, goal)
    rj = JL.simulate_episode(jcfg, ep_key, jst, jgoals, tobs, tmask, method="xla")
    _, ts = _states(_np(jst.position))
    rt = TL.simulate_episode(tcfg, None, ts, torch.tensor(_np(jgoals)),
                             torch.tensor(_np(tobs)), torch.tensor(np.asarray(tmask)),
                             method="fused")
    np.testing.assert_allclose(rt.min_obstacle_clearance.numpy(),
                               _np(rj.min_obstacle_clearance), atol=5e-2)
    np.testing.assert_allclose(rt.final_position.numpy(), _np(rj.final_position), atol=5e-2)


def test_shared_obstacles_with_batched_goals_under_the_clamp():
    """Reference fault C.1: JAX raises for a shared (K, 4) set with batched
    goals when goal_margin_clamp > 0. The port broadcasts the set to the
    batch first: the shared run equals the per-episode run, and both match
    JAX given per-episode (B, K, 4) spheres."""
    mpc = JM.SE3MPCConfig(prediction_horizon=8, max_iterations=3, tail_iterations=0,
                          goal_margin_clamp=0.5)
    jcfg, tcfg = _configs(mpc=mpc, num_replans=6)
    B = 3
    js, ts = _states(np.tile([[0.0, 0.0, 3.0]], (B, 1)))
    goals = _np([[4.0, 0.0, 3.0], [4.0, 0.5, 3.0], [3.6, -0.3, 3.2]])
    sphere = _np([[4.0, 1.6, 3.0, 0.5]])  # its 1.5 m margin would swallow the goals
    shared = TL.simulate_episode(tcfg, None, ts, torch.tensor(goals),
                                 torch.tensor(sphere), method="torch")
    per_ep = np.broadcast_to(sphere, (B, 1, 4)).copy()
    batched = TL.simulate_episode(tcfg, None, ts, torch.tensor(goals),
                                  torch.tensor(per_ep), method="torch")
    for f in shared._fields:
        np.testing.assert_array_equal(getattr(shared, f).numpy(),
                                      getattr(batched, f).numpy(), err_msg=f)
    with pytest.raises(ValueError):
        JL.simulate_episode(jcfg, jax.random.PRNGKey(0), js, jnp.asarray(goals),
                            jnp.asarray(sphere), method="xla")
    rj = JL.simulate_episode(jcfg, jax.random.PRNGKey(0), js, jnp.asarray(goals),
                             jnp.asarray(per_ep), method="xla")
    np.testing.assert_allclose(shared.final_position.numpy(), _np(rj.final_position),
                               atol=5e-2)
    np.testing.assert_allclose(shared.min_obstacle_clearance.numpy(),
                               _np(rj.min_obstacle_clearance), atol=5e-2)


def test_proximity_sensing_reveals_blind_obstacle():
    """In-flight sensing: a TRUE sphere the perceived set misses joins the
    planner's set within sense_radius; the sensed flight keeps materially
    more clearance than the blind one (tests/test_sim.py:266)."""
    _, tcfg = _configs(mpc=JM.SE3MPCConfig(prediction_horizon=8, max_iterations=6),
                       substeps_per_plan=40, num_replans=30, sense_radius=3.0)
    B = 2
    _, ts = _states(np.tile([[0.0, 0.0, 3.0]], (B, 1)))
    goals = torch.tensor([[6.0, 0.0, 3.0]] * B)
    kw = dict(obstacles=torch.zeros(B, 2, 4), obstacle_mask=torch.zeros(B, 2, dtype=torch.bool),
              method="fused", true_obstacles=torch.tensor([[[3.0, 0.0, 3.0, 0.6]]] * B),
              true_obstacle_mask=torch.ones(B, 1, dtype=torch.bool))
    r_sense = TL.simulate_episode(tcfg, None, ts, goals, **kw)
    r_blind = TL.simulate_episode(tcfg._replace(sense_radius=0.0), None, ts, goals, **kw)
    clear_s = float(r_sense.min_obstacle_clearance[0])
    clear_b = float(r_blind.min_obstacle_clearance[0])
    assert not bool(r_sense.crashed[0])
    assert clear_s > 0.75
    assert clear_s > clear_b + 0.3


def test_unknown_speed_cap_slows_through_unknown_region():
    """The unknown-space cap binds on an unobserved corridor and is inert
    on a fully observed one (tests/test_sim.py:309)."""
    _, tcfg = _configs(mpc=JM.SE3MPCConfig(prediction_horizon=8, max_iterations=6,
                                           tail_iterations=0),
                       substeps_per_plan=40, num_replans=15)
    B = 2
    _, ts = _states(np.tile([[0.0, 0.0, 3.0]], (B, 1)))
    goals = torch.tensor([[20.0, 0.0, 3.0]] * B)
    r_fast = TL.simulate_episode(tcfg, None, ts, goals)
    capped = tcfg._replace(unknown_speed_cap=3.0)
    r_slow = TL.simulate_episode(capped, None, ts, goals, corridor_observed=torch.zeros(B, 12))
    r_same = TL.simulate_episode(capped, None, ts, goals, corridor_observed=torch.ones(B, 12))
    assert float(r_slow.final_distance[0]) > float(r_fast.final_distance[0]) + 1.0
    np.testing.assert_array_equal(r_same.final_position.numpy(), r_fast.final_position.numpy())


def test_randomness_comes_from_the_generator():
    _, tcfg = _configs(**SMALL, wind_mean=1.0, wind_std=0.5, sensor_noise_std=0.02)
    _, ts = _states([[0.0, 0.0, 3.0], [1.0, 0.0, 3.0]])
    goals = torch.tensor([[3.0, 1.0, 4.0], [4.0, 0.0, 3.0]])
    with pytest.raises(ValueError, match="random"):
        TL.simulate_episode(tcfg, None, ts, goals)
    a = TL.simulate_episode(tcfg, torch.Generator().manual_seed(5), ts, goals)
    b = TL.simulate_episode(tcfg, torch.Generator().manual_seed(5), ts, goals)
    c = TL.simulate_episode(tcfg, torch.Generator().manual_seed(6), ts, goals)
    assert torch.equal(a.final_position, b.final_position)
    assert not torch.equal(a.final_position, c.final_position)


def test_monte_carlo_runs_and_resolves_methods():
    _, tcfg = _configs(**SMALL, wind_mean=0.5, wind_std=0.3, sensor_noise_std=0.01)
    res = TL.monte_carlo(tcfg, torch.Generator().manual_seed(2), 4,
                         torch.tensor([0.0, 0.0, 3.0]), torch.tensor([4.0, 0.0, 5.0]),
                         start_spread=1.0, goal_spread=1.0)
    for f in res._fields:
        x = getattr(res, f)
        assert x.shape[0] == 4
        if x.dtype.is_floating_point:
            assert torch.isfinite(x).all(), f
    assert TL.resolve_method("auto", torch.device("cpu")) == "torch"
    assert TL.resolve_method("auto", torch.device("cuda", 0)) == "fused"
    with pytest.raises(ValueError):
        TL.resolve_method("xla", torch.device("cpu"))
    d = interop.episode_result_to_numpy(res)
    assert set(d) == set(res._fields) and isinstance(d["success"], np.ndarray)


@pytest.mark.parametrize("field, control, batch_shape", [
    (None, {}, (4,)),
    ("anti_windup_method", {"anti_windup_method": "back_calculation"}, (4,)),
    ("yaw_convention", {"yaw_convention": "reference"}, (4,)),
    ("batch_shape", {}, (2, 2)),
])
def test_tick_block_scope_runs_plain_on_cpu_and_raises_on_cuda(field, control, batch_shape):
    """Outside kernel B2's scope a "fused" episode runs the per-tick loop on
    CPU tensors (as the JAX package does) and refuses a CUDA device, where
    the kernel was asked for; "torch" never takes the tick block."""
    cfg = TL.ClosedLoopConfig()
    cfg = cfg._replace(control=cfg.control._replace(**control))
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert TL.uses_tick_block(cfg, "fused", batch_shape, cpu) is (field is None)
    assert not TL.uses_tick_block(cfg, "torch", batch_shape, cuda)
    if field is None:
        assert TL.uses_tick_block(cfg, "fused", batch_shape, cuda)
    else:
        with pytest.raises(ValueError, match=f"{field}.*method='torch'"):
            TL.uses_tick_block(cfg, "fused", batch_shape, cuda)
