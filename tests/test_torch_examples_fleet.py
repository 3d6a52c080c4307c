"""The port's Monte-Carlo example (examples_torch/advanced/
monte_carlo_fleet.py) on the CPU, held against the JAX example on JAX's own
draws.

``jax.random``'s draws cannot be reproduced in torch (ROADMAP C, reference
fault 5), so the JAX example's ``main(episodes=8)`` runs with its draws
recorded (starts, goals, true worlds; the episode key, from which the wind
and the sensor noise are drawn as ``closed_loop.py:240-262`` draws them),
and the port's ``fly`` takes those draws. Per episode, success and crash
equal; tracking RMSE and minimum true-sphere clearance at atol 5e-2, as
tests/test_torch_sim.py's ``test_obstacle_episode_matches_jax`` holds
obstacle episodes (the largest differences measured are 2.4e-5 m and
5.4e-3 m). The printed lines carry the JAX example's labels.
"""

import contextlib
import importlib.util
import io
import pathlib

import jax
import numpy as np
import torch

from dart_planner_tpu.sim import closed_loop as JL
from dart_planner_tpu.sim import physics as JP
from dart_planner_tpu_torch import DroneState

ROOT = pathlib.Path(__file__).resolve().parents[1]
EPISODES = 8


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def _jax_example_with_draws(monkeypatch, episodes: int):
    """The JAX example's main, its draws and its EpisodeResult recorded."""
    example = _load(ROOT / "examples" / "advanced" / "monte_carlo_fleet.py",
                    "jax_example_monte_carlo_fleet")
    rec = {}

    def recorded(name, fn):
        def call(*args, **kw):
            rec[name] = (args, fn(*args, **kw))
            return rec[name][1]
        return call

    monkeypatch.setattr(JL, "sample_fleet", recorded("fleet", JL.sample_fleet))
    monkeypatch.setattr(JL, "simulate_episode", recorded("episode", JL.simulate_episode))
    monkeypatch.setattr(example, "sample_worlds", recorded("worlds", example.sample_worlds))
    _, lines = _printed(example.main, episodes)
    return rec, lines


def test_monte_carlo_fleet_matches_jax_on_jax_draws(monkeypatch):
    port = _load(ROOT / "examples_torch" / "advanced" / "monte_carlo_fleet.py",
                 "examples_torch_monte_carlo_fleet")
    rec, jax_lines = _jax_example_with_draws(monkeypatch, EPISODES)
    ep_key, states, goals = rec["fleet"][1]
    tobs, tmask = rec["worlds"][1]
    rj = rec["episode"][1]
    config = port.loop_config()
    # the dtype the JAX example ran in (float64 under the tests' x64): the
    # draws are made in it, as the episode made them
    dtype = states.position.dtype
    k_wind, k_noise = jax.random.split(ep_key)
    wind = np.asarray(JP.sample_wind(k_wind, (EPISODES,), config.wind_mean, config.wind_std,
                                     dtype), np.float32)
    noise = np.stack([
        np.asarray(config.sensor_noise_std * jax.random.normal(
            jax.random.fold_in(k_noise, i), (EPISODES, 6), dtype), np.float32)
        for i in range(config.num_replans)
    ])

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype)

    ts = DroneState.zeros((EPISODES,), device="cpu").replace(position=t(states.position))
    rt = port.fly(config, ts, t(goals), t(tobs), t(tmask, torch.bool),
                  wind=t(wind), noise=t(noise))
    np.testing.assert_array_equal(rt.success.numpy(), np.asarray(rj.success))
    np.testing.assert_array_equal(rt.crashed.numpy(), np.asarray(rj.crashed))
    np.testing.assert_allclose(rt.tracking_rmse.numpy(), np.asarray(rj.tracking_rmse, np.float32),
                               atol=5e-2)
    np.testing.assert_allclose(rt.min_obstacle_clearance.numpy(),
                               np.asarray(rj.min_obstacle_clearance, np.float32), atol=5e-2)

    _, lines = _printed(port.report, port.summary(rt))
    assert [ln.split(":")[0] for ln in lines] == [ln.split(":")[0] for ln in jax_lines]
    assert lines[:3] == jax_lines[:3]  # episodes, success and crash rates


def test_monte_carlo_fleet_main_draws_then_flies():
    """``main`` draws the fleet, then the worlds, then flies on the rest of
    the same generator's stream: equal, bit for bit, to ``draw`` then
    ``fly`` on a generator with the same seed."""
    port = _load(ROOT / "examples_torch" / "advanced" / "monte_carlo_fleet.py",
                 "examples_torch_monte_carlo_fleet")
    out, lines = _printed(port.main, episodes=4, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    states, goals, tobs, tmask = port.draw(gen, 4, "cpu")
    res = port.fly(port.loop_config(), states, goals, tobs, tmask, gen)
    for name, a, b in zip(res._fields, out["result"], res):
        assert torch.equal(a, b), name
    assert out["episodes"] == 4 and lines[0] == "episodes:        4"
    assert out["result"].success.device.type == "cpu"
    assert np.isfinite([out[k] for k in ("tracking_rmse_m", "mean_min_clearance_m",
                                         "final_distance_p50_m")]).all()
