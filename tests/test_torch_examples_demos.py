"""The port's examples that show the runtime pieces
(examples_torch/intermediate/state_buffer_demo.py, scheduler_demo.py,
examples_torch/beginner/heartbeat_demo.py) on the CPU beside the JAX
examples, and two checks over all nine: every example that makes tensors
runs on the card by default and, without one, raises the error that names
``device="cpu"`` (no fallback to the CPU); every JAX example has its port.

Each demo prints the JAX example's lines, and behaves as it does: the state
buffer's versions rise with each update and ``get_state_at_time`` finds the
snapshot 50 ms back; the scheduler's run counts are within 20% of 2 s x
each task's rate; the heartbeat's emergency fires within 2 s of the last
heartbeat. The scheduler and the heartbeat run on the wall clock, so they
keep the JAX package's one retry.
"""

import ast
import asyncio
import contextlib
import importlib.util
import inspect
import io
import pathlib
import re

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TENSOR_EXAMPLES = (
    "intermediate/batched_solves", "intermediate/state_buffer_demo",
    "advanced/fleet_sharding", "advanced/monte_carlo_fleet",
    "advanced/three_layer_mission", "advanced/hardware_mission",
    "beginner/minimal_takeoff",
)
HOST_EXAMPLES = ("beginner/heartbeat_demo", "intermediate/scheduler_demo")


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _example(rel: str):
    return _load(ROOT / "examples_torch" / f"{rel}.py", "examples_torch_" + rel.replace("/", "_"))


def _jax_example(rel: str):
    return _load(ROOT / "examples" / f"{rel}.py", "jax_example_" + rel.replace("/", "_"))


def _printed(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def _retry_once(run):
    """Wall-clock coupled: retried once, as the JAX package's tests are."""
    last = None
    for _ in range(2):
        try:
            return run()
        except AssertionError as e:
            last = e
    raise last


def test_every_jax_example_has_its_port():
    jax_examples = {p.relative_to(ROOT / "examples")
                    for p in (ROOT / "examples").rglob("*.py")}
    ports = {p.relative_to(ROOT / "examples_torch")
             for p in (ROOT / "examples_torch").rglob("*.py")}
    assert len(jax_examples) == 9 and ports == jax_examples
    named = {f"{rel}.py" for rel in TENSOR_EXAMPLES + HOST_EXAMPLES}
    assert {str(p) for p in ports} == named


@pytest.mark.parametrize("rel", TENSOR_EXAMPLES)
def test_example_needs_a_card_unless_asked(rel, monkeypatch):
    main = _example(rel).main
    assert inspect.signature(main).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _printed(main)


@pytest.mark.parametrize("rel", HOST_EXAMPLES)
def test_host_example_takes_no_device(rel):
    assert "device" not in inspect.signature(_example(rel).main).parameters


def test_state_buffer_demo_matches_jax():
    out, lines = _printed(_example("intermediate/state_buffer_demo").main, device="cpu")
    _, jax_lines = _printed(_jax_example("intermediate/state_buffer_demo").main)
    stats = out["stats"]
    # versions rise by one with each update, and the buffer held the ones
    # 50 ms back
    assert out["version"] == stats["updates"] == stats["current_version"] > 10
    assert abs(out["timestamp"] - out["past_timestamp"] - 0.05) < 1e-6
    assert lines[0] == f"latest: version={out['version']} t={out['timestamp']:.3f}"
    assert lines[1] == f"50 ms ago: t={out['past_timestamp']:.3f}"
    assert [re.sub(r"=[^ ]*", "=", ln) for ln in lines[:2]] == \
        [re.sub(r"=[^ ]*", "=", ln) for ln in jax_lines[:2]]
    keys = re.compile(r"'(\w+)':")
    assert keys.findall(lines[2]) == keys.findall(jax_lines[2])
    assert lines[2].startswith("stats: ") and jax_lines[2].startswith("stats: ")


TASK_LINE = re.compile(r"^ +(\w+): (\d+) runs, (\d+) misses, jitter RMS [0-9.]+ ms$")
RATES = {"control": 200.0, "planning": 25.0, "safety": 50.0}


def _check_scheduler_lines(lines):
    counts = ast.literal_eval(lines[0].removeprefix("tick counts over 2 s: "))
    assert set(counts) == set(RATES)
    runs = {}
    for line in lines[1:]:
        name, n, _ = TASK_LINE.match(line).groups()
        runs[name] = int(n)
    assert runs == counts
    for name, rate in RATES.items():
        assert abs(counts[name] - 2.0 * rate) <= 0.2 * 2.0 * rate, (name, counts)
    return counts


def test_scheduler_demo_matches_jax():
    def run():
        out, lines = _printed(_example("intermediate/scheduler_demo").main)
        assert _check_scheduler_lines(lines) == out["counters"]
        for name, st in out["stats"].items():
            assert st["execution_count"] == out["counters"][name]
        jax_example = _jax_example("intermediate/scheduler_demo")
        _, jax_lines = _printed(asyncio.run, jax_example.demo())
        _check_scheduler_lines(jax_lines)

    _retry_once(run)


def test_heartbeat_demo_matches_jax():
    def run():
        out, lines = _printed(_example("beginner/heartbeat_demo").main)
        assert out["emergency_triggered"]
        assert 0.3 <= out["fired_after_s"] <= 2.0
        _, jax_lines = _printed(asyncio.run, _jax_example("beginner/heartbeat_demo").demo())
        assert lines == jax_lines

    _retry_once(run)
