"""Where a benchmark cell's device idles, by the program's stage spans.

Builds one cell of ``BENCHMARK.json`` as the benchmark does (its inputs from
``--seed``, set-up, a window of ``--seconds`` to reach the steady state),
then runs the cell's profiled stretch (16 fleet replans, or one whole
Monte-Carlo run) ``--repeats`` times under ``common/metrics.device_trace``
and prints one JSON object: the card, and for each stretch its wall, the
device's busy share, its idle seconds by the innermost program span the
host was in, the host syncs by span, the calls by span and the syncs a
replan. The spans' tier 1 (profiler ranges and the sync count) is on under
the profiler, so the idle seconds carry its cost. The traces go to
``build/trace_stages/`` (not kept in git).

    python scripts/trace_stages_torch.py --workload mc16k-perceived --seed 7

Needs the card the cell runs on; imports the port and ``benchmark/``, never
JAX.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def stretches(workload: str, seed: int, seconds: float, repeats: int, device) -> list[dict]:
    """The cell's profiled stretch ``repeats`` times under ``device_trace``;
    returns each stretch's summary with ``syncs_per_replan``."""
    import torch

    from benchmark.lib.harness import cell_spec
    from benchmark.lib.traffic import generate
    from dart_planner_tpu_torch.common import metrics

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = cell_spec(workload)
    config = spec["config"]
    driver = importlib.import_module(f"benchmark.drivers.{config['driver']}")
    inputs = generate(spec["traffic"], config, seed, torch.device(device))
    cell = driver.Cell(config, spec["traffic"], inputs, seed, device, False)
    cell.setup()
    cell.window(seconds)
    per_replan = "loop.replan" if config["driver"] == "closed_loop" else "mpc.solve"
    log_dir = ROOT / "build" / "trace_stages"
    out = []
    for turn in range(repeats):
        with metrics.device_trace(str(log_dir / f"{workload}-{turn}")) as seen:
            cell.profiled()
        row = seen.as_dict()
        calls = seen.calls.get(per_replan, 0)
        row["syncs_per_replan"] = sum(seen.syncs.values()) / calls if calls else None
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card: the device's idle time is read from its trace",
              file=sys.stderr)
        return 2
    from dart_planner_tpu_torch.common.device import card_label

    device = torch.device("cuda", 0)
    rows = stretches(args.workload, args.seed, args.seconds, args.repeats, device)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "card": card_label(device),
                      "stretches": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
