"""Multi-process fleet execution over ``torch.distributed`` (PyTorch
counterpart of :mod:`dart_planner_tpu.parallel.distributed`).

Every process runs the same program. The process group stitches the
processes into one ("hosts", "devices") mesh whose rows are the processes;
each process solves only its own scenarios, and only the
:class:`~dart_planner_tpu_torch.parallel.scenario.FleetStats` cross
processes (``all_reduce``; NCCL between cards, gloo between CPU processes).

- :func:`initialize`: join the process group;
- :func:`global_fleet_mesh`: the mesh over every process's devices;
- :func:`host_local_problem`: this process's shards of the fleet, from its
  own scenarios only (no process materializes the fleet);
- :func:`measure_throughput`: chained fleet solves, timed after a
  synchronize of the local cards, for weak-scaling numbers.

:mod:`.worker` is the per-process entry; ``tests/test_torch_distributed.py``
launches it as real processes on gloo.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from dart_planner_tpu_torch.ops import costs
from dart_planner_tpu_torch.parallel import scenario
from dart_planner_tpu_torch.planning import se3_mpc

TIMEOUT = datetime.timedelta(seconds=120)  # a lost peer fails a collective, not hangs it


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Join the process group (idempotent).

    ``coordinator_address`` is ``host:port`` of process 0, reached over
    ``tcp://``; with no arguments the standard ``MASTER_ADDR``/``RANK``/
    ``WORLD_SIZE`` environment is read. ``backend`` defaults to NCCL, which
    needs a card: without one, a RuntimeError names ``backend="gloo"`` (the
    group is never carried to the CPU unasked, as
    :func:`~dart_planner_tpu_torch.common.device.default_device` never
    falls back). An NCCL process is pinned first to ``device``, by default
    the card of its local rank (:func:`local_rank`), so two processes on
    one host never share a card."""
    if dist.is_initialized():
        return
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the process group runs on NCCL "
                'by default; pass backend="gloo" for a group of CPU processes'
            )
        backend = "nccl"
    if backend == "nccl":
        if device is None:
            device = local_rank(process_id) % torch.cuda.device_count()
        torch.cuda.set_device(device)
    kw = dict(backend=backend, timeout=TIMEOUT)
    if coordinator_address is not None:
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
    dist.init_process_group(**kw)


def local_rank(process_id: Optional[int] = None) -> int:
    """This process's rank on its host: ``LOCAL_RANK`` where a launcher set
    it, else its global rank (``process_id``, else ``RANK``, else 0), which
    is the local rank when every process runs on one host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if process_id is not None:
        return process_id
    return int(os.environ.get("RANK", 0))


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_fleet_mesh(local_devices: Optional[Sequence] = None) -> scenario.FleetMesh:
    """("hosts", "devices") mesh over every process's devices: one row per
    process (rank order), one column per local device (default: every
    visible CUDA device; each process is taken to hold as many as this
    one). This process solves its own row. The same mesh as
    :func:`~.scenario.make_fleet_mesh` with no ``hosts`` given."""
    return scenario.make_fleet_mesh(local_devices)


def host_local_problem(prob_local: costs.Problem, mesh: scenario.FleetMesh) -> scenario.Sharded:
    """This process's shards of a fleet from its own scenarios:
    ``prob_local`` (leading axis = global batch / process count) is split
    contiguously over the local devices. The global batch is the local one
    times the mesh's rows over this process's rows."""
    b = scenario._batch(prob_local)
    local = mesh.local_devices
    if b % len(local) != 0:
        raise ValueError(f"local batch {b} not divisible by {len(local)} local devices")
    per = b // len(local)
    shards = tuple(scenario._take(prob_local, slice(i * per, (i + 1) * per), dev)
                   for i, dev in enumerate(local))
    return scenario.Sharded(shards, b * mesh.shape["hosts"] // len(mesh.local_rows))


def _synchronize(mesh: scenario.FleetMesh) -> None:
    for dev in set(mesh.local_devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _barrier() -> None:
    """A closing collective: every process has finished its chain."""
    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1, device=scenario.collective_device()))


def measure_throughput(
    config,
    mesh: scenario.FleetMesh,
    prob,
    reps: int = 5,
    passes: int = 3,
    method: str = "auto",
    per_call_stats: bool = False,
) -> dict:
    """Weak-scaling measurement: ``reps`` chained fleet solves (each warm
    started from the last, so they run one after another), the best of
    ``passes``, host clock after a synchronize of the local cards.

    ``per_call_stats=False`` (the production cadence) chains solves with no
    collective; one all-reduce after each pass is the global barrier, out
    of the timed window. ``per_call_stats=True`` pays the stats reduction
    in every call."""
    sp = prob if isinstance(prob, scenario.Sharded) else scenario.shard_scenarios(prob, mesh)
    u0 = sp.map(lambda p: se3_mpc.initialize_thrusts(config, p))
    _, stats = scenario.solve_fleet(config, mesh, sp, u0, method=method)
    batch = int(stats.total)
    best = float("inf")
    for _ in range(passes):
        u = u0
        _synchronize(mesh)
        t0 = time.perf_counter()
        for _ in range(reps):
            res, st = scenario.solve_fleet(config, mesh, sp, u, method=method,
                                           with_stats=per_call_stats)
            u = res.map(lambda r: r.thrusts)
        if per_call_stats:
            float(st.mean_cost)
        _synchronize(mesh)
        best = min(best, (time.perf_counter() - t0) / reps)
        _barrier()
    world, _ = scenario._process_grid()
    return {
        "global_batch": batch,
        "devices": mesh.size,
        "processes": world,
        "per_call_stats": per_call_stats,
        "seconds_per_solve_call": best,
        "solves_per_s": batch / best,
        "solves_per_s_per_device": batch / best / mesh.size,
    }
