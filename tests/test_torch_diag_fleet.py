"""The port's Monte-Carlo diagnostics (scripts/diag_timeouts_torch.py,
diag_goalclamp_torch.py, diag_unknown_torch.py) on the CPU, against the JAX
scripts they mirror, on JAX's own fleet, worlds and draws at 8 episodes.

``jax.random``'s draws cannot be reproduced in torch (ROADMAP C, reference
fault 5), so the JAX timeouts script's ``main`` runs at ``--episodes 8``
with its ``simulate_episode`` recorded (the fleet, the perceived and true
worlds, the corridor's coverage and the episode key of every row), and the
wind and the sensor noise are drawn from that key as
``dart_planner_tpu/sim/closed_loop.py:240-262`` draws them, as
tests/test_torch_examples_fleet.py does. Then:

- the port's shipping row (``fly`` on those draws, the plain path) equals
  JAX's ``simulate_episode`` of that row episode for episode in success and
  crash (exact);
- ``census`` prints exactly what the JAX script's prints, on the same
  result arrays (JAX's episode result, and a seeded one with timeouts): it
  is numpy on the same inputs;
- every row's ``ClosedLoopConfig`` equals the JAX script's field for field
  through ``interop.closed_loop_config_from_jax_fields``, with the same
  corridor keying, in order: timeouts 60/80/100 replans and the cap off;
  goalclamp's six (clamp, floor) pairs; unknown's caps, margin, ramp and
  coverage, and its uncapped check (the JAX mains run with
  ``simulate_episode`` recorded and not run; goalclamp's, at its fixed
  2048 episodes, with its worlds stubbed);
- the port's rows share one wind draw, and each row's noise is the first
  ``num_replans`` blocks of one draw: the 80-replan row's first 60 blocks
  are the 60-replan row's;
- without a card and without ``--device cpu`` each script exits non-zero.
"""

import contextlib
import importlib.util
import io
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dart_planner_tpu.sim as jsim
from dart_planner_tpu.sim import closed_loop as JL
from dart_planner_tpu.sim import physics as JP
from dart_planner_tpu.sim import worlds as JW
from dart_planner_tpu_torch import DroneState, interop
from dart_planner_tpu_torch.sim import closed_loop as TL
from _torch_one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
EPISODES = 8
FLEET_SCRIPTS = ("diag_timeouts", "diag_goalclamp", "diag_unknown")


def _load(name):
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f"_script_{name}", SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _episode_result(module, n, like):
    z = like.zeros(n)
    return module.EpisodeResult(
        final_position=like.zeros((n, 3)), final_distance=z, min_distance=z,
        tracking_rmse=z, min_obstacle_clearance=z, crashed=like.zeros(n, like.bool),
        success=like.zeros(n, like.bool))


class _J:
    bool = jnp.bool_

    @staticmethod
    def zeros(shape, dtype=jnp.float32):
        return jnp.zeros(shape, dtype)


class _T:
    bool = torch.bool

    @staticmethod
    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)


def _jax_rows(mp, name: str, argv=(), stub_worlds: bool = False) -> list:
    """The JAX script's ``main`` with ``simulate_episode`` recorded and not
    run: each row's (config, key, states, goals, keyword arguments)."""
    calls = []

    def record(cfg, key, states, goals, **kw):
        calls.append((cfg, key, states, goals, kw))
        return _episode_result(JL, states.position.shape[0], _J)

    mp.setattr(JL, "simulate_episode", record)
    # the scripts point jax's compilation cache under the home directory
    mp.setattr(jax.config, "update", lambda *a, **k: None)
    if stub_worlds:
        K, M = JW.WorldConfig().num_obstacles, JW.WorldConfig().corridor_samples
        mp.setattr(jsim, "sample_worlds", lambda wc, k, n, s, g: (
            jnp.zeros((n, K, 4)), jnp.zeros((n, K), bool)))
        mp.setattr(JW, "perceive_worlds", lambda wc, to, tm, s, g, max_obstacles,
                   corridor_samples: (jnp.zeros((s.shape[0], max_obstacles, 4)),
                                      jnp.zeros((s.shape[0], max_obstacles), bool),
                                      jnp.ones((s.shape[0], M))))
    mp.setattr(sys, "argv", [name, *argv])
    _printed(_load(name).main)
    return calls


@pytest.fixture(scope="module")
def jax_draws():
    """JAX's 8-episode fleet and draws, and its rows, from the timeouts
    script."""
    with pytest.MonkeyPatch.context() as mp:
        calls = _jax_rows(mp, "diag_timeouts", ["--episodes", str(EPISODES)])
    cfg, key, states, goals, kw = calls[0]
    dtype = states.position.dtype
    k_wind, k_noise = jax.random.split(key)
    wind = JP.sample_wind(k_wind, (EPISODES,), cfg.wind_mean, cfg.wind_std, dtype)
    noise = np.stack([
        np.asarray(cfg.sensor_noise_std * jax.random.normal(
            jax.random.fold_in(k_noise, i), (EPISODES, 6), dtype), np.float32)
        for i in range(100)])
    real = JL.simulate_episode(cfg, key, states, goals, **kw)
    return {"calls": calls, "wind": np.asarray(wind, np.float32), "noise": noise, "real": real}


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _port_fleet(port, jax_draws):
    _, _, states, goals, kw = jax_draws["calls"][0]
    return port.Fleet(
        states=DroneState.zeros((EPISODES,), device="cpu").replace(position=_t(states.position)),
        goals=_t(goals), true_obstacles=_t(kw["true_obstacles"]),
        true_mask=_t(kw["true_obstacle_mask"], torch.bool), obstacles=_t(kw["obstacles"]),
        mask=_t(kw["obstacle_mask"], torch.bool), corridor=_t(kw["corridor_observed"]),
        wind=_t(jax_draws["wind"]), noise=_t(jax_draws["noise"]))


def test_shipping_row_matches_jax_episode_for_episode(jax_draws):
    port = _load("diag_timeouts_torch")
    cfg = jax_draws["calls"][0][0]
    assert cfg.num_replans == 60 and cfg.unknown_speed_cap == 2.0
    rj = jax_draws["real"]
    rt, _ = port.fly(port.base_config(), _port_fleet(port, jax_draws))
    np.testing.assert_array_equal(rt.success.numpy(), np.asarray(rj.success))
    np.testing.assert_array_equal(rt.crashed.numpy(), np.asarray(rj.crashed))


def test_census_prints_the_jax_scripts_numbers(jax_draws):
    port, jscript = _load("diag_timeouts_torch"), _load("diag_timeouts")
    _, _, states, goals, kw = jax_draws["calls"][0]
    d0 = np.linalg.norm(np.asarray(states.position) - np.asarray(goals), axis=-1)
    unk = (np.asarray(kw["corridor_observed"]) < 0.6).any(axis=1)
    rng = np.random.default_rng(0)
    n = 64
    seeded = JL.EpisodeResult(
        final_position=rng.normal(size=(n, 3)), final_distance=rng.uniform(0, 5, n),
        min_distance=rng.uniform(0, 4, n), tracking_rmse=rng.uniform(0, 0.1, n),
        min_obstacle_clearance=rng.uniform(-0.5, 2, n), crashed=rng.uniform(size=n) < 0.1,
        success=rng.uniform(size=n) < 0.6)
    d0_s, unk_s = rng.uniform(2, 12, n), rng.uniform(size=n) < 0.3
    for res, d, u in ((jax_draws["real"], d0, unk), (seeded, d0_s, unk_s)):
        tj, pj = _printed(jscript.census, "6s shipping (cap 2.0)", res, d, u)
        tt, pt = _printed(port.census, "6s shipping (cap 2.0)", res, d, u)
        assert pt == pj
        np.testing.assert_array_equal(tt, tj)
    assert "timeouts: n=" in pt


def _port_rows(monkeypatch, name: str, **kw) -> list:
    calls = []

    def record(cfg, generator, states, goals, **k):
        calls.append((cfg, k))
        return _episode_result(TL, states.position.shape[0], _T)

    monkeypatch.setattr(TL, "simulate_episode", record)
    port = _load(f"{name}_torch")
    fleet = _load("diag_timeouts_torch").build_fleet(EPISODES, 0, "cpu")
    _printed(port.rows, fleet, **kw)
    return calls, fleet


@pytest.mark.parametrize("name", FLEET_SCRIPTS)
def test_row_configs_match_the_jax_script(name, monkeypatch):
    argv = [] if name == "diag_goalclamp" else ["--episodes", str(EPISODES)]
    with pytest.MonkeyPatch.context() as mp:
        jax_calls = _jax_rows(mp, name, argv, stub_worlds=True)
    port_calls, _ = _port_rows(monkeypatch, name)
    assert len(port_calls) == len(jax_calls) == {"diag_timeouts": 4, "diag_goalclamp": 6,
                                                 "diag_unknown": 5}[name]
    for (ct, kt), (cj, _, _, _, kj) in zip(port_calls, jax_calls):
        assert ct == interop.closed_loop_config_from_jax_fields(cj)
        assert (kt["corridor_observed"] is None) == (kj.get("corridor_observed") is None)
        assert kt["method"] == "auto" == kj["method"]


def test_rows_share_one_draw(monkeypatch):
    calls, fleet = _port_rows(monkeypatch, "diag_timeouts")
    assert [c.num_replans for c, _ in calls] == [60, 80, 100, 60]
    for cfg, k in calls:
        assert k["wind"] is fleet.wind
        assert torch.equal(k["noise"], fleet.noise[:cfg.num_replans])
    assert torch.equal(calls[1][1]["noise"][:60], calls[0][1]["noise"])


@pytest.mark.parametrize("name", FLEET_SCRIPTS)
def test_without_a_card_it_exits_non_zero(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script runs there")
    r = subprocess.run([sys.executable, str(SCRIPTS / f"{name}_torch.py"), "--episodes", "4"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert "platform=" not in r.stdout
