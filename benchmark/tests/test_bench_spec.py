"""BENCHMARK.json against the benchmark's contract, and the harness finding
each configuration, traffic mix and per-layer metric by name, a new cell
made of new files included."""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
import types

import pytest

from benchmark.lib import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
        if (ROOT / word).is_file():
            assert any(word.startswith(p.rstrip("/") + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        content = json.loads((ROOT / c["file"]).read_text())
        assert content["name"] == c["name"] and content["reduced"] == c["reduced"]
        for key in c["reduced"]:  # no width is ever cut
            assert not key.endswith(("_dim", "_rank")) and key in content


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])


def test_metrics():
    e2e, layers = BENCH["end_to_end"], BENCH["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    by_name = {m["name"]: m for m in e2e}
    assert "setup_s" in by_name and by_name["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in by_name
        for cell in m.get("workloads", cells):
            moved = by_name[m["moves"]]
            assert cell in moved.get("workloads", cells)
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        reported = [m["name"] for m in e2e if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in layers)


def test_layers_of_one_name_are_spelled_alike():
    assert {m["layer"] for m in BENCH["per_layer"]} == {
        "planning.se3_mpc", "ops.cuda_mpc", "ops.cuda_rollout", "sim.closed_loop", "the device"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    spec = harness.cell_spec(cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["generator"]
    assert (harness.HERE / "drivers" / f"{spec['config']['driver']}.py").is_file()
    assert spec["config"]["limits"], "a cell compares at least one number"
    for m in spec["per_layer"]:
        reader = harness.load_metric(m["name"])
        assert reader.read({}) is None, "a reader that finds nothing returns nothing"


def test_a_new_cell_is_new_files_only(tmp_path):
    """A dummy cell (its configuration, traffic mix and per-layer metric as
    new files, and new entries) is listed by the harness of a copy in which
    no file that was there changed."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "benchmark/configs/fleet_shard.json").read_text())
    cfg.update(name="dummy_shard", scenarios=1024)
    (tmp_path / "benchmark/configs/dummy_shard.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "benchmark/traffic/spheres.json").read_text())
    traffic["live_spheres"] = 2
    (tmp_path / "benchmark/traffic/two_spheres.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/metrics/dummy_ms.small.py").write_text(
        "def read(ctx):\n    return ctx.get('replan_ms')\n")
    bench["configs"].append({"name": "dummy_shard", "source": "https://example.org/dummy",
                             "file": "benchmark/configs/dummy_shard.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy1k-two", "config": "dummy_shard",
                               "traffic": "two_spheres", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("solves_per_s", "replan_p95_ms"):
            m["workloads"].append("dummy1k-two")
    bench["per_layer"].append({"name": "dummy_ms.small", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "planning.se3_mpc",
                               "moves": "solves_per_s", "workloads": ["dummy1k-two"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import json, sys; sys.path.insert(0, sys.argv[1]);"
        "from benchmark.lib import harness;"
        "s = harness.cell_spec('dummy1k-two');"
        "print(json.dumps([str(harness.ROOT), s['config']['scenarios'],"
        " s['traffic']['live_spheres'], [m['name'] for m in s['per_layer']],"
        " [m['name'] for m in s['end_to_end']],"
        " harness.load_metric('dummy_ms.small').read({'replan_ms': 2.5})]))")
    out = subprocess.run([sys.executable, "-c", probe, str(tmp_path)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    root, scenarios, live, layers, e2e, read = json.loads(out.stdout.strip().splitlines()[-1])
    assert pathlib.Path(root) == tmp_path
    assert (scenarios, live, layers, read) == (1024, 2, ["dummy_ms.small"], 2.5)
    assert e2e == ["solves_per_s", "replan_p95_ms", "setup_s"]
    for rel, content in before.items():
        assert (tmp_path / rel).read_bytes() == content


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    base = set(harness.forbidden_modules())
    for name in ("jax._bench_probe", "dart_planner_tpu_torch._bench_probe",
                 "dart_planner_tpu_x", "dart_planner_tpu._bench_probe"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert set(harness.forbidden_modules()) - base == {"jax._bench_probe",
                                                       "dart_planner_tpu._bench_probe"}
