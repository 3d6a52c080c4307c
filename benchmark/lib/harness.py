"""One run of one cell of ``BENCHMARK.json``, driven by data.

A cell names a configuration and a traffic mix. The configuration's file
(``configs[].file``) names its ``driver``, a module of
``benchmark/drivers/``; the traffic mix is ``benchmark/traffic/<name>.json``, read by the one
generator of :mod:`benchmark.lib.traffic`;
each per-layer metric is ``benchmark/metrics/<name>.py``, whose ``read``
takes what the driver's traced window gathered and returns a number, or
None where it finds nothing to read. Adding a configuration, a traffic mix,
a metric or a cell adds files and entries and edits none.

A run: the inputs drawn from the seed and the program warmed on every
shape the cell uses (``setup_s``); the measured window; with ``--trace 1``
the per-layer metrics and one profiled stretch after the window; the
program's state freed; the comparison with the plain reference; the import
guard. The result is the last line of standard output; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
# module names that no run may load, compared whole with the part of each
# loaded module's name before the first dot
FORBIDDEN = ("jax", "jaxlib", "flax", "dart_planner_tpu")
# the kernels' names in a device trace, by the key of their launch counters
KERNELS = {"B1": "mpc_solve", "B2": "tick_block"}


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def load_metric(name: str):
    """The reader module ``benchmark/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_spec(workload: str, bench: dict | None = None) -> dict:
    """The cell's entry, its configuration (the file's content with the
    entry's name), its traffic, and the end-to-end and per-layer metric
    entries it reports."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; the cells are {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])

    def ours(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell, "config": config, "traffic": load_traffic(cell["traffic"]),
            "end_to_end": [m for m in bench["end_to_end"] if ours(m)],
            "per_layer": [m for m in bench["per_layer"] if ours(m)]}


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             overrides: dict | None = None, bench: dict | None = None) -> dict:
    """One run; returns the result's fields. ``overrides`` replaces keys
    of the configuration (the tests run a cell at a small size)."""
    import torch

    from benchmark.lib import trace as tr
    from benchmark.lib.traffic import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = cell_spec(workload, bench)
    config = {**spec["config"], **(overrides or {})}
    device = torch.device(device)
    driver = importlib.import_module(f"benchmark.drivers.{config['driver']}")
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    inputs = generate(spec["traffic"], config, seed, device)
    if on_card:
        torch.cuda.synchronize(device)
    t_inputs = time.perf_counter() - t0
    cell = driver.Cell(config, spec["traffic"], inputs, seed, device, trace)
    cell.setup()
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    tr.note(f"setup: {setup_s:.2f} s, of which the inputs {t_inputs:.2f} s")

    with tr.Conditions(device) as cond:
        e2e = cell.window(seconds)
    tr.note(cond.line())
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0

    metrics, breakdown, dev = {}, None, {}
    if trace:
        ctx = cell.layers()
        ctx["missing_hooks"] = (ctx.get("missing_hooks", [])
                                + (list(cell.events.missing) if cell.events else []))
        if on_card:
            before = _launch_counts()
            prof = tr.profile(cell.profiled, cell.spans, KERNELS)
            launched = {k: n - before[k] for k, n in _launch_counts().items()}
            ctx["profile"] = {**prof, "launches": launched}
            dev = {"busy_s": prof["busy_s"], "window_s": prof["window_s"]}
            breakdown = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
            for k, n in launched.items():
                if prof["records"].get(k, 0) != n:
                    tr.note(f"trace: {prof['records'].get(k, 0)} records of {k} against "
                            f"{n} launches: the idle shares are left out")
        for hook in ctx["missing_hooks"]:
            tr.note(f"trace: hook {hook} is gone: the metrics that read it are left out")
        for m in spec["per_layer"]:
            value = load_metric(m["name"]).read(ctx)
            if value is None or not math.isfinite(value):
                tr.note(f"trace: {m['name']} found nothing to read and is left out")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**e2e, "setup_s": setup_s}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    cell.release()
    t_check = time.perf_counter()
    numbers = cell.check()
    tr.note(f"check: the comparison with the reference took "
            f"{time.perf_counter() - t_check:.1f} s")
    limits = config["limits"]
    for name, value in sorted(numbers.items()):
        if name not in limits:
            tr.note(f"check (not compared): {name} = {value!r}")
    checks = {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": int(spec["cell"]["chips"]), "memory_peak_bytes": peak, **dev}
    out = {"correct": correct, "attempted": e2e["attempted"], "failed": e2e["failed"],
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    out["numbers"] = numbers  # every number the comparison worked out; not printed
    return out


def _launch_counts() -> dict:
    from dart_planner_tpu_torch.ops import cuda_mpc, cuda_rollout

    return {"B1": cuda_mpc.LAUNCHES, "B2": cuda_rollout.LAUNCHES}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths (the
    # port's own nvcc library goes under build/kernels already)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    import torch

    chips = int(cell_spec(args.workload)["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    stderr_tail, line = report(result)
    print(stderr_tail, file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


def report(result: dict) -> tuple[str, str]:
    """The run's last lines of standard error (each number compared beside
    its limit) and its result line, the checks its last key."""
    out = {k: v for k, v in result.items() if k not in ("numbers", "checks")}
    out["checks"] = result["checks"]
    tail = "\n".join(f"check {name} = {c['value']!r} (limit {c['limit']!r})"
                     for name, c in result["checks"].items())
    return tail, json.dumps(out)
