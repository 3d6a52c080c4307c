"""Kernel B2's whole scope on the CPU: every closed-loop configuration the
JAX package flies (dart_planner_tpu_torch/ops/cuda_rollout.py,
sim/closed_loop.py).

- ``run_tick_block_plain`` under back-calculation anti-windup (with the
  failsafe latch driven, and with thrust and torque saturated), under the
  "reference" yaw convention, both together, at K = 0 and K = 3, against a
  reference built from the JAX package's own ``compute_control`` and
  ``rigid_body_step`` looped over the block's ticks (the JAX Pallas kernel
  asserts clamping, so it cannot be the reference for these arms), at the
  tolerance of ``test_torch_sim.py::test_tick_block_plain_matches_jax_kernel``
  (atol 1e-5, rtol 1e-6).
- Whole episodes: ``simulate_episode(method="fused")`` on the CPU (the
  packed tick block's plain version) against the JAX package's
  ``simulate_episode(method="xla")`` on the same inputs under
  back-calculation, the reference yaw, a (2, 3) batch and a replan of 30
  ticks split into launches of 8, at the tolerance of
  ``test_torch_sim.py::test_torch_episode_matches_jax_scan`` (atol 1e-3 on
  final position, minimum distance and tracking RMSE, ``success`` equal).
  A (2, 3) batch flies exactly as the same six episodes flown as (6,).
- The kernel's own source (``csrc/tick_block.cu``) compiled by g++ against
  ``csrc/emulation/cuda_runtime.h`` (a block's threads take turns on one CPU
  thread, meeting at each ``__syncthreads``)
  and driven through the wrapper's launch loop: each arm and the chunked
  launches against the plain version at atol 1e-4 + rtol 1e-4 (g++
  contracts into FMAs as nvcc does, the plain version does not), as the
  ``cuda`` tests hold the kernel on the card.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_one_thread import one_torch_thread  # noqa: F401
from dart_planner_tpu.common.types import DroneState as JDroneState
from dart_planner_tpu.control import geometric as JG
from dart_planner_tpu.planning import se3_mpc as JM
from dart_planner_tpu.sim import closed_loop as JL
from dart_planner_tpu.sim import physics as JP
from dart_planner_tpu_torch import DroneState, interop
from dart_planner_tpu_torch.control import geometric as TG
from dart_planner_tpu_torch.ops import _build, cuda_rollout
from dart_planner_tpu_torch.sim import closed_loop as TL
from dart_planner_tpu_torch.sim import physics as TP
from test_torch_sim import _random_block

BACK = "back_calculation"


def _np(x):
    return np.asarray(x, np.float32)


def _block(seed, B, T, K, trigger, back_calc):
    """``_random_block``'s rows; under back-calculation rows 26-29 carry a
    last raw thrust of 0-40 N (the cap is 25) and raw torques ~ N(0, 8)
    (the caps are 5.4, 5.4, 0.36), so the feedback of both is live."""
    rows, obs = _random_block(np.random.default_rng(seed), B, T, K, trigger)
    if back_calc:
        rng = np.random.default_rng(seed + 100)
        rows[0][26] = rng.uniform(0.0, 40.0, B)
        rows[0][27:30] = rng.normal(0.0, 8.0, (3, B))
    return rows, obs


def _jax_block(jc, jp, control_dt, T, substeps, rows, obs):
    """One block of the JAX package's own controller and plant: T ticks of
    ``compute_control`` (the drone state through ``to_drone_state``, as its
    scan path builds it) and ``substeps`` of ``rigid_body_step``, with the
    block's metrics; returned packed as the port's rows."""
    S, spp, spv, spa, gw = (jnp.asarray(x) for x in rows)
    B = S.shape[1]
    back_calc = jc.anti_windup_method != "clamping"
    rb = JP.RigidBodyState(position=S[0:3].T, velocity=S[3:6].T,
                           rotation=S[9:18].T.reshape(B, 3, 3), angular_velocity=S[6:9].T)
    cs = JG.ControllerState.zeros(jc, (B,)).replace(
        integral_vel_error=S[18:21].T, last_torque_saturated=S[21:24].T > 0.5,
        failsafe_count=S[24].astype(jnp.int32), last_valid_thrust=S[25])
    if back_calc:
        cs = cs.replace(unsaturated_thrust=S[26], unsaturated_torque=S[27:30].T)
    goal, wind = gw[0:3].T, gw[3:6].T
    big = jnp.full((B,), 1e30, jnp.float32)
    min_dist, min_alt, min_clear, track = big, big, big, jnp.zeros((B,), jnp.float32)
    spheres = None if obs is None else jnp.asarray(obs).reshape(-1, 4, B)
    zero = jnp.zeros((), jnp.float32)
    for j in range(T):
        sp = JG.ControlSetpoint(position=spp[3 * j:3 * j + 3].T,
                                velocity=spv[3 * j:3 * j + 3].T,
                                acceleration=spa[3 * j:3 * j + 3].T, yaw=zero, yaw_rate=zero)
        cmd, cs = JG.compute_control(jc, cs, rb.to_drone_state(0.0), sp, control_dt)
        for _ in range(substeps):
            rb = JP.rigid_body_step(jp, rb, cmd, control_dt / substeps, wind)
        p = rb.position
        min_dist = jnp.minimum(min_dist, jnp.linalg.norm(p - goal, axis=-1))
        min_alt = jnp.minimum(min_alt, p[:, 2])
        track = track + jnp.sum((p - sp.position) ** 2, axis=-1)
        if spheres is not None:
            gap = jnp.linalg.norm(p.T[None] - spheres[:, :3], axis=1) - spheres[:, 3]
            min_clear = jnp.minimum(min_clear, gap.min(0))
    out = np.zeros((32, B), np.float32)
    out[0:3], out[3:6], out[6:9] = rb.position.T, rb.velocity.T, rb.angular_velocity.T
    out[9:18] = _np(rb.rotation).reshape(B, 9).T
    out[18:21] = cs.integral_vel_error.T
    out[21:24] = cs.last_torque_saturated.T
    out[24], out[25] = cs.failsafe_count, cs.last_valid_thrust
    if back_calc:
        out[26], out[27:30] = cs.unsaturated_thrust, cs.unsaturated_torque.T
    acc = np.zeros((8, B), np.float32)
    acc[0], acc[1], acc[2], acc[3] = min_dist, track, min_alt, min_clear
    return out, acc


def _configs(anti_windup="clamping", yaw="lee", trigger=100):
    jc = JG.GeometricConfig(mass=1.5, max_thrust=25.0, failsafe_trigger_count=trigger,
                            anti_windup_method=anti_windup, yaw_convention=yaw)
    jp = JP.PhysicsConfig(max_thrust=25.0, drag_coefficient=0.05)
    return jc, jp, TG.GeometricConfig(**jc._asdict()), TP.PhysicsConfig(**jp._asdict())


def _tensors(rows, obs):
    return [torch.tensor(x) for x in rows], None if obs is None else torch.tensor(obs)


# ---- one block against the JAX controller and plant ----------------------------

SCOPE_CASES = {
    "back_calculation_failsafe_latch": dict(aw=BACK, yaw="lee", T=8, sub=1, K=2, trigger=3),
    "back_calculation_saturated": dict(aw=BACK, yaw="lee", T=6, sub=1, K=0, trigger=100),
    "reference_yaw": dict(aw="clamping", yaw="reference", T=6, sub=1, K=2, trigger=100),
    "both": dict(aw=BACK, yaw="reference", T=8, sub=2, K=2, trigger=100),
    "both_K0": dict(aw=BACK, yaw="reference", T=5, sub=1, K=0, trigger=100),
    "both_K3": dict(aw=BACK, yaw="reference", T=5, sub=1, K=3, trigger=10),
}


@pytest.mark.parametrize("case", list(SCOPE_CASES))
def test_tick_block_plain_matches_jax_controller_and_plant(case):
    c = SCOPE_CASES[case]
    jc, jp, tc, tp = _configs(c["aw"], c["yaw"], c["trigger"])
    back_calc = c["aw"] == BACK
    rows, obs = _block(len(case), 6, c["T"], c["K"], c["trigger"], back_calc)
    js, ja = _jax_block(jc, jp, 0.0025, c["T"], c["sub"], rows, obs)
    trows, tobs = _tensors(rows, obs)
    before = cuda_rollout.LAUNCHES
    ts, ta = cuda_rollout.run_tick_block(tc, tp, 0.0025, c["T"], c["sub"], *trows, tobs)
    assert cuda_rollout.LAUNCHES == before  # CPU tensors: the plain version
    np.testing.assert_allclose(ts.numpy(), js, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(ta.numpy(), ja, atol=1e-5, rtol=1e-6)
    assert (ts[30:] == 0).all() and (ta[4:] == 0).all()
    if not back_calc:
        assert (ts[26:] == 0).all()  # the JAX package's packing
    # the arms were live: latch, saturation, the yaw convention's own frame
    if c["trigger"] < 100:
        assert (ts[24].numpy() > c["trigger"]).any()
    if case == "back_calculation_saturated":
        raw = ts[26].numpy()
        assert (raw > 25.0).any() and (ts[21:24].numpy() > 0.5).any()
    if c["K"]:
        assert (ta[3].numpy() < 1e29).all()
    else:
        assert (ta[3].numpy() == 1e30).all()
    other = tc._replace(yaw_convention="lee" if c["yaw"] == "reference" else "reference")
    os_, _ = cuda_rollout.run_tick_block_plain(other, tp, 0.0025, c["T"], c["sub"], *trows,
                                               tobs)
    assert not torch.allclose(os_[9:18], ts[9:18], atol=1e-3)


def test_back_calculation_rows_pack_and_unpack():
    """Rows 26-29 carry the unsaturated thrust and torque only when the
    packer is told the configuration back-calculates; unpacking restores
    them into the controller state."""
    B = 4
    rng = np.random.default_rng(3)
    rb = TP.RigidBodyState.from_drone_state(DroneState.zeros((B,), device="cpu"))
    ctrl = TG.ControllerState.zeros(TG.GeometricConfig(), (B,), device="cpu").replace(
        unsaturated_thrust=torch.tensor(_np(rng.uniform(0, 40, B))),
        unsaturated_torque=torch.tensor(_np(rng.normal(0, 3, (B, 3)))))
    clamp = cuda_rollout.pack_state(rb, ctrl)
    back = cuda_rollout.pack_state(rb, ctrl, back_calc=True)
    assert (clamp[26:] == 0).all() and torch.equal(clamp[:26], back[:26])
    assert torch.equal(back[26], ctrl.unsaturated_thrust)
    assert torch.equal(back[27:30], ctrl.unsaturated_torque.T) and (back[30:] == 0).all()
    zeros = TG.ControllerState.zeros(TG.GeometricConfig(), (B,), device="cpu")
    _, c2 = cuda_rollout.unpack_state(back, rb, zeros, back_calc=True)
    assert torch.equal(c2.unsaturated_thrust, ctrl.unsaturated_thrust)
    assert torch.equal(c2.unsaturated_torque, ctrl.unsaturated_torque)
    _, c3 = cuda_rollout.unpack_state(back, rb, zeros)
    assert (c3.unsaturated_thrust == 0).all()
    assert cuda_rollout.back_calculation(TG.GeometricConfig(anti_windup_method=BACK))
    assert not cuda_rollout.back_calculation(TG.GeometricConfig())


def _small_limit(monkeypatch, ticks):
    """Shrink the shared memory a launch may take to ``ticks`` ticks, so
    that a block of more runs as several launches (on any device)."""
    limit = cuda_rollout.shared_bytes(ticks)
    monkeypatch.setattr(cuda_rollout, "DEFAULT_SHARED_BYTES", limit)
    monkeypatch.setattr(cuda_rollout, "shared_limit", lambda device: limit)


def test_chunked_plain_block_chains_the_state(monkeypatch):
    """A block of 30 ticks in launches of 8: the state rows equal one
    launch's bit for bit (each launch starts from the last one's rows), the
    minima too; the tracking sum is the sum of the launches' sums."""
    _, _, tc, tp = _configs(BACK, "reference")
    rows, obs = _block(4, 5, 30, 2, 100, True)
    args = (tc, tp, 0.0025, 30, 1, *_tensors(rows, obs)[0], _tensors(rows, obs)[1])
    one_s, one_a = cuda_rollout.run_tick_block_plain(*args)
    _small_limit(monkeypatch, 8)
    assert cuda_rollout.tick_chunks(30, torch.device("cpu")) == (8, 8, 8, 6)
    assert cuda_rollout.tick_chunks(24, torch.device("cpu")) == (8, 8, 8)
    ch_s, ch_a = cuda_rollout.run_tick_block(*args)
    assert torch.equal(ch_s, one_s)
    assert torch.equal(ch_a[[0, 2, 3]], one_a[[0, 2, 3]]) and (ch_a[4:] == 0).all()
    torch.testing.assert_close(ch_a[1], one_a[1], atol=0, rtol=1e-6)


# ---- whole episodes against the JAX package's scan ----------------------------

SMALL = dict(mpc=JM.SE3MPCConfig(prediction_horizon=8, max_iterations=3,
                                 tail_iterations=0), num_replans=4)


def _episode_pair(batch_shape, seed, control=None, **kw):
    """The JAX package's scan episode and the port's packed one on the same
    starts, goals, winds and noise (JAX's own draws, passed through)."""
    jcfg = JL.ClosedLoopConfig(**SMALL, wind_mean=1.0, wind_std=0.5, sensor_noise_std=0.02,
                               **({} if control is None else {"control": control}), **kw)
    tcfg = interop.closed_loop_config_from_jax_fields(jcfg)
    rng = np.random.default_rng(seed)
    pos = _np(rng.normal(0, 1, batch_shape + (3,)) + [0, 0, 4])
    goals = _np(rng.normal(0, 2, batch_shape + (3,)) + [0, 0, 4])
    z = jnp.zeros(batch_shape + (3,), jnp.float32)
    js = JDroneState.create(timestamp=jnp.zeros(batch_shape, jnp.float32),
                            position=jnp.asarray(pos), velocity=z, attitude=z,
                            angular_velocity=z)
    key = jax.random.PRNGKey(seed)
    rj = JL.simulate_episode(jcfg, key, js, jnp.asarray(goals), method="xla")
    k_wind, k_noise = jax.random.split(key)
    wind = _np(JP.sample_wind(k_wind, batch_shape, 1.0, 0.5, jnp.float32))
    noise = np.stack([
        _np(0.02 * jax.random.normal(jax.random.fold_in(k_noise, i), batch_shape + (6,),
                                     jnp.float32))
        for i in range(jcfg.num_replans)
    ])
    ts = DroneState.zeros(batch_shape, device="cpu").replace(position=torch.tensor(pos))
    before = cuda_rollout.LAUNCHES
    rt = TL.simulate_episode(tcfg, None, ts, torch.tensor(goals), method="fused",
                             wind=torch.tensor(wind), noise=torch.tensor(noise))
    assert cuda_rollout.LAUNCHES == before
    return rt, rj, (tcfg, ts, goals, wind, noise)


def _close(rt, rj):
    for f in ("final_position", "min_distance", "tracking_rmse"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), _np(getattr(rj, f)), atol=1e-3,
                                   err_msg=f)
    np.testing.assert_array_equal(rt.success.numpy(), np.asarray(rj.success))


def _no_tick_loop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the per-tick loop ran on a fused episode")

    monkeypatch.setattr(TL, "_tick_loop", refuse)


@pytest.mark.parametrize("control", [
    dict(anti_windup_method=BACK), dict(yaw_convention="reference"),
])
def test_fused_episode_matches_jax_scan_in_every_controller_arm(monkeypatch, control):
    _no_tick_loop(monkeypatch)
    ctl = JG.GeometricConfig(mass=1.5, max_thrust=25.0, **control)
    rt, rj, _ = _episode_pair((3,), 4, ctl)
    _close(rt, rj)


def test_fused_episode_of_a_two_axis_batch_matches_jax_scan_and_its_flat_flight(monkeypatch):
    _no_tick_loop(monkeypatch)
    rt, rj, (tcfg, ts, goals, wind, noise) = _episode_pair((2, 3), 5)
    assert rt.final_position.shape == (2, 3, 3) and rt.success.shape == (2, 3)
    _close(rt, rj)
    flat = TL.simulate_episode(
        tcfg, None, DroneState.zeros((6,), device="cpu").replace(
            position=ts.position.reshape(6, 3)),
        torch.tensor(goals).reshape(6, 3), method="fused",
        wind=torch.tensor(wind).reshape(6, 3),
        noise=torch.tensor(noise).reshape(tcfg.num_replans, 6, 6))
    for f in rt._fields:
        a, b = getattr(rt, f), getattr(flat, f)
        assert torch.equal(a, b.reshape(a.shape)), f


def test_two_axis_batch_draws_line_up_with_the_flat_order():
    """Wind and noise drawn by the episode from a generator: a (2, 3) batch
    flies exactly as the same six episodes flown as (6,), per-episode
    spheres and a shared goal included."""
    tcfg = interop.closed_loop_config_from_jax_fields(JL.ClosedLoopConfig(
        **SMALL, wind_mean=1.0, wind_std=0.5, sensor_noise_std=0.02, substeps_per_plan=10))
    rng = np.random.default_rng(8)
    pos = torch.tensor(_np(rng.normal(0, 1, (2, 3, 3)) + [0, 0, 3]))
    spheres = torch.tensor(_np(np.concatenate(
        [rng.normal(0, 2, (2, 3, 2, 3)) + [2, 0, 3], rng.uniform(0.3, 0.6, (2, 3, 2, 1))], -1)))
    goal = torch.tensor([3.0, 1.0, 3.5])

    def fly(shape):
        st = DroneState.zeros(shape, device="cpu").replace(position=pos.reshape(shape + (3,)))
        return TL.simulate_episode(tcfg, torch.Generator().manual_seed(2), st, goal,
                                   spheres.reshape(shape + (2, 4)), method="fused")

    two, six = fly((2, 3)), fly((6,))
    for f in two._fields:
        a, b = getattr(two, f), getattr(six, f)
        assert torch.equal(a, b.reshape(a.shape)), f
    assert (two.min_obstacle_clearance < 1e29).all()


def test_fused_episode_with_a_replan_past_one_launch_matches_jax_scan(monkeypatch):
    """30 ticks a replan in launches of 8 (8, 8, 8, 6)."""
    _no_tick_loop(monkeypatch)
    _small_limit(monkeypatch, 8)
    rt, rj, _ = _episode_pair((3,), 6, substeps_per_plan=30)
    _close(rt, rj)


# ---- the kernel's own source, emulated on the CPU -------------------------------

_EMULATION_SMEM = """
namespace { float smem[1 << 22]; }
"""
_LAUNCH = "kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>("


@pytest.fixture(scope="module")
def emulated_tick_library(tmp_path_factory):
    """``csrc/tick_block.cu`` compiled by g++ (C++20) for the CPU, its one
    launch a call of the emulation's block launcher, bound with the
    kernel's C interface. ``-mfma -ffp-contract=fast`` contracts into FMAs
    as nvcc does; square roots and divisions stay IEEE as nvcc's defaults."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's CPU emulation")
    text = (_build.SRC_DIR / "tick_block.cu").read_text()
    assert text.count(_LAUNCH) == 1, "expected one kernel launch"
    text = text.replace(_LAUNCH, "emu_launch_block(kernel, blocks, kThreads, smem, "
                                 "static_cast<cudaStream_t>(stream), ")
    out = tmp_path_factory.mktemp("tick_emulation")
    (out / "tick_block.cu").write_text(text + _EMULATION_SMEM)
    subprocess.run([gxx, "-std=c++20", "-O2", "-mfma", "-ffp-contract=fast", "-fPIC",
                    "-shared", f"-I{_build.SRC_DIR / 'emulation'}",
                    "-o", str(out / "libtick_block.so"), "-x", "c++",
                    str(out / "tick_block.cu")],
                   check=True, capture_output=True, text=True)
    return cuda_rollout.bind(ctypes.CDLL(str(out / "libtick_block.so")))


def _hold_emulated(lib, tc, tp, T, sub, rows, obs, B):
    trows, tobs = _tensors(rows, obs)
    args = (tc, tp, 0.0025, T, sub, *trows, tobs)
    before = cuda_rollout.LAUNCHES
    ks, ka = cuda_rollout.run_library(lib, *args, None)
    assert cuda_rollout.LAUNCHES == before  # no CUDA stream: not a launch
    ps, pa = cuda_rollout.run_tick_block_plain(*args)
    parted = (ks[21:25] != ps[21:25]).any(0)
    assert int(parted.sum()) <= 1
    for k, p in ((ks, ps), (ka, pa)):
        torch.testing.assert_close(k[:, ~parted], p[:, ~parted], atol=1e-4, rtol=1e-4)
    zero_from = 30 if cuda_rollout.back_calculation(tc) else 26
    assert (ks[zero_from:] == 0).all() and (ka[4:] == 0).all()
    return ks, ps


@pytest.mark.parametrize("aw, yaw, sub, trigger", [
    ("clamping", "lee", 1, 100), (BACK, "lee", 1, 3), ("clamping", "reference", 2, 100),
    (BACK, "reference", 1, 10), (BACK, "reference", 3, 100),
])
def test_emulated_kernel_matches_plain_in_every_arm(emulated_tick_library, aw, yaw, sub,
                                                    trigger):
    """40 episodes (a full block and a ragged one) of 9 ticks and 3 spheres
    in each instantiation the launcher picks."""
    _, _, tc, tp = _configs(aw, yaw, trigger)
    rows, obs = _block(sub + trigger, 40, 9, 3, trigger, aw == BACK)
    ks, ps = _hold_emulated(emulated_tick_library, tc, tp, 9, sub, rows, obs, 40)
    if trigger < 100:
        assert (ps[24] > trigger).any()


def test_emulated_kernel_chains_launches_past_its_shared_memory(emulated_tick_library,
                                                                monkeypatch):
    """A block of 30 ticks as launches of 8, each sized by its own T."""
    _small_limit(monkeypatch, 8)
    _, _, tc, tp = _configs(BACK, "reference", 100)
    rows, obs = _block(11, 33, 30, 2, 100, True)
    _hold_emulated(emulated_tick_library, tc, tp, 30, 1, rows, obs, 33)
