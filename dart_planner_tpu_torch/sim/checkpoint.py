"""Fleet checkpoint / resume (PyTorch counterpart of
:mod:`dart_planner_tpu.sim.checkpoint`).

Snapshots the sweep's random stream, the scenario cursor and the accumulated
episode statistics to one ``.npz`` with the JAX package's field names, and
restores them, so a long Monte-Carlo sweep survives preemption. The random
stream is a CPU ``torch.Generator``: ``rng_key`` holds its state (JAX's
``jax.random`` stream cannot be reproduced in torch), and a resumed sweep
continues it where the last chunk left it, so it gives bit for bit the
totals of an uninterrupted one.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from dart_planner_tpu_torch.common.device import resolve_device


@dataclass
class FleetCheckpoint:
    """Resumable sweep state."""

    rng_key: np.ndarray  # (n,) uint8: the CPU torch.Generator's state
    scenario_cursor: int  # episodes completed so far
    total_scenarios: int
    successes: int = 0
    crashes: int = 0
    sum_final_distance: float = 0.0
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def success_rate(self) -> float:
        return self.successes / max(self.scenario_cursor, 1)


def save_checkpoint(path: str | pathlib.Path, ckpt: FleetCheckpoint) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        path,
        rng_key=np.asarray(ckpt.rng_key),
        scalars=np.asarray(
            [ckpt.scenario_cursor, ckpt.total_scenarios, ckpt.successes, ckpt.crashes],
            np.int64,
        ),
        sum_final_distance=np.asarray(ckpt.sum_final_distance),
        extras=np.frombuffer(json.dumps(ckpt.extras).encode(), np.uint8),
    )


def load_checkpoint(path: str | pathlib.Path) -> Optional[FleetCheckpoint]:
    path = pathlib.Path(path)
    if not path.exists():
        return None
    with np.load(path) as z:
        s = z["scalars"]
        return FleetCheckpoint(
            rng_key=z["rng_key"],
            scenario_cursor=int(s[0]),
            total_scenarios=int(s[1]),
            successes=int(s[2]),
            crashes=int(s[3]),
            sum_final_distance=float(z["sum_final_distance"]),
            extras=json.loads(z["extras"].tobytes().decode()),
        )


def run_sweep(
    config,
    total_scenarios: int,
    chunk: int,
    start_center,
    goal_center,
    checkpoint_path: str | pathlib.Path,
    seed: int = 0,
    max_chunks: Optional[int] = None,
    device=None,
    **mc_kwargs,
) -> FleetCheckpoint:
    """Resumable Monte-Carlo sweep on ``device`` (default: the card):
    ``chunk`` episodes of :func:`~.closed_loop.monte_carlo` per step, a
    checkpoint after each chunk. Re-invoking with the same path continues
    where the last run stopped."""
    from dart_planner_tpu_torch.sim.closed_loop import monte_carlo

    device = resolve_device(device)
    ckpt = load_checkpoint(checkpoint_path)
    if ckpt is None or ckpt.total_scenarios != total_scenarios:
        ckpt = FleetCheckpoint(
            rng_key=torch.Generator().manual_seed(seed).get_state().numpy(),
            scenario_cursor=0,
            total_scenarios=total_scenarios,
        )
    start = torch.as_tensor(start_center, dtype=torch.float32, device=device)
    goal = torch.as_tensor(goal_center, dtype=torch.float32, device=device)
    chunks_done = 0
    while ckpt.scenario_cursor < ckpt.total_scenarios:
        if max_chunks is not None and chunks_done >= max_chunks:
            break
        n = min(chunk, ckpt.total_scenarios - ckpt.scenario_cursor)
        gen = torch.Generator()
        gen.set_state(torch.as_tensor(np.array(ckpt.rng_key, np.uint8)))
        res = monte_carlo(config, gen, num_episodes=n, start_center=start,
                          goal_center=goal, **mc_kwargs)
        ckpt.rng_key = gen.get_state().numpy()
        ckpt.scenario_cursor += n
        ckpt.successes += int(res.success.sum())
        ckpt.crashes += int(res.crashed.sum())
        ckpt.sum_final_distance += float(res.final_distance.sum())
        save_checkpoint(checkpoint_path, ckpt)
        chunks_done += 1
    return ckpt
