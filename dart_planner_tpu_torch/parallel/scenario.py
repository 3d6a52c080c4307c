"""Sharded scenario-fleet solver (PyTorch counterpart of
:mod:`dart_planner_tpu.parallel.scenario`).

The scaling axis is the scenario batch: thousands of independent MPC solves
per card, split into contiguous shards over a ("hosts", "devices") grid of
torch devices (:class:`FleetMesh`, the counterpart of ``jax.sharding.Mesh``):

- one card: the whole batch is one shard, one launch of kernel B1 per phase;
- one process: one shard per local device, each solved on its device;
- many processes (:mod:`.distributed`): each process solves only its own
  rows of the mesh. Scenarios are independent, so nothing crosses devices
  during the solve; only :class:`FleetStats` are reduced, over the local
  shards and then across processes with ``torch.distributed.all_reduce``.

A batch split over a mesh is a :class:`Sharded` value: this process's
shards, one per local device, and the global batch size. No process holds
the whole fleet unless it was given it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from dart_planner_tpu_torch.common.device import default_device
from dart_planner_tpu_torch.ops import costs
from dart_planner_tpu_torch.planning import se3_mpc

Tensor = torch.Tensor

BATCH_AXES = ("hosts", "devices")


class FleetStats(NamedTuple):
    """Fleet-level reductions (scalar float32 tensors, the same on every
    process)."""

    total: Tensor  # fleet size
    converged: Tensor  # scenarios with converged solves
    mean_cost: Tensor
    max_grad_norm: Tensor


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """A ("hosts", "devices") grid of torch devices.

    ``devices[h][d]`` is device ``d`` of host row ``h``; ``local_rows`` are
    the rows this process solves (every row in one process; its own row
    under :mod:`.distributed`, where the other rows stand for the other
    processes' devices)."""

    devices: tuple
    local_rows: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(BATCH_AXES, (len(self.devices), len(self.devices[0]))))

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def local_devices(self) -> tuple:
        """This process's devices, in mesh order."""
        return tuple(d for h in self.local_rows for d in self.devices[h])


class Sharded(NamedTuple):
    """This process's contiguous shards of a scenario batch, one per local
    device of a mesh (each a Problem, a SolveResult or a tensor on its
    device), and the global batch size."""

    shards: tuple
    global_batch: int

    def map(self, fn: Callable) -> "Sharded":
        """``fn`` applied to each shard (on its device)."""
        return Sharded(tuple(fn(s) for s in self.shards), self.global_batch)

    def gather(self, device="cpu"):
        """The local shards concatenated on ``device`` (a copy: the fleet
        solve itself never gathers)."""
        return _concat(self.shards, torch.device(device))


def _visible_cuda_devices() -> list:
    default_device()  # raises, naming device="cpu", without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _process_grid() -> tuple[int, int]:
    """(world size, rank) of the initialized process group, else (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_fleet_mesh(
    devices: Optional[Sequence] = None,
    hosts: Optional[int] = None,
) -> FleetMesh:
    """The ("hosts", "devices") mesh over this process's ``devices``
    (default: every visible CUDA device; without a card it raises unless
    devices are passed, e.g. ``[torch.device("cpu")] * 4``).

    ``hosts`` splits the devices into that many virtual host rows, all
    solved here (e.g. 8 devices as 2 hosts x 4 for scaling tests). Left
    None under an initialized ``torch.distributed`` group, the rows are the
    processes (:func:`.distributed.global_fleet_mesh`), as the JAX mesh's
    host axis is under ``jax.distributed``."""
    devs = [torch.device(d) for d in devices] if devices is not None \
        else _visible_cuda_devices()
    if not devs:
        raise ValueError("a fleet mesh needs at least one device")
    world, rank = _process_grid()
    if hosts is None and world > 1:
        return FleetMesh(tuple(tuple(devs) for _ in range(world)), (rank,))
    h = 1 if hosts is None else hosts
    n = len(devs)
    if h < 1 or n % h != 0:
        raise ValueError(f"{n} devices not divisible by {h} hosts")
    per = n // h
    rows = tuple(tuple(devs[i * per:(i + 1) * per]) for i in range(h))
    return FleetMesh(rows, tuple(range(h)))


def batch_sharding(mesh: FleetMesh, batch: int) -> tuple:
    """This process's part of a ``batch`` split over the whole mesh:
    ``(device, slice of the scenario axis)`` per local device, contiguous
    in mesh order (row-major, the JAX sharding over both mesh axes)."""
    if batch % mesh.size != 0:
        raise ValueError(f"batch {batch} not divisible by the mesh size {mesh.size}")
    per = batch // mesh.size
    width = mesh.shape["devices"]
    return tuple(
        (mesh.devices[h][d], slice((h * width + d) * per, (h * width + d + 1) * per))
        for h in mesh.local_rows for d in range(width)
    )


def _take(tree, sl: slice, device: torch.device):
    if tree is None:
        return None
    if isinstance(tree, Tensor):
        return tree[sl].to(device)
    return type(tree)(*[_take(x, sl, device) for x in tree])


def _concat(parts: Sequence, device: torch.device):
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, Tensor):
        return torch.cat([p.to(device) for p in parts], dim=0)
    return type(first)(*[_concat(f, device) for f in zip(*parts)])


def _batch(prob: costs.Problem) -> int:
    if prob.p0.ndim != 2:
        raise ValueError(f"a fleet has one leading scenario axis: p0 is {tuple(prob.p0.shape)}")
    return prob.p0.shape[0]


def shard_scenarios(prob: costs.Problem, mesh: FleetMesh) -> Sharded:
    """Split a batched Problem (the whole fleet, one leading scenario axis,
    every field batched) over the mesh; this process keeps the shards of
    its rows, each moved to its device."""
    B = _batch(prob)
    return Sharded(tuple(_take(prob, sl, dev) for dev, sl in batch_sharding(mesh, B)), B)


def _shard_like(x, sp: Sharded, mesh: FleetMesh) -> Sharded:
    """``x`` (None, a Sharded value, or a tensor over the whole fleet) as
    shards matching ``sp``."""
    if x is None:
        return Sharded((None,) * len(sp.shards), sp.global_batch)
    if isinstance(x, Sharded):
        return x
    if x.shape[0] != sp.global_batch:
        raise ValueError(f"a warm start tensor covers the whole fleet ({sp.global_batch} "
                         f"scenarios), got {x.shape[0]}: pass a Sharded one")
    return Sharded(tuple(_take(x, sl, dev) for dev, sl in batch_sharding(mesh, x.shape[0])),
                   sp.global_batch)


def collective_device() -> torch.device:
    """Where the cross-process reductions run: the current CUDA device for
    NCCL, the CPU otherwise."""
    if dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _reduce_stats(results: Sequence[se3_mpc.SolveResult]) -> FleetStats:
    """FleetStats over the local shards, then across processes when a
    process group is initialized: SUM of (count, converged, summed cost),
    MAX of the gradient norm; the mean is taken last. The sums run in
    float64, so the fleet's mean cost does not depend on how it is split."""
    dev = collective_device()
    f64 = torch.float64
    sums = torch.stack([
        torch.stack([
            torch.tensor(float(r.cost.shape[0]), dtype=f64, device=r.cost.device),
            r.converged.to(f64).sum(),
            r.cost.to(f64).sum(),
        ]).to(dev)
        for r in results
    ]).sum(0)
    gmax = torch.stack([r.grad_norm.max().to(dev) for r in results]).max().reshape(1)
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX)
    f32 = torch.float32
    return FleetStats(total=sums[0].to(f32), converged=sums[1].to(f32),
                      mean_cost=(sums[2] / sums[0]).to(f32), max_grad_norm=gmax[0].to(f32))


def solve_fleet(
    config: se3_mpc.SE3MPCConfig,
    mesh: FleetMesh,
    prob,
    u_init=None,
    use_obstacles: bool = True,
    method: str = "auto",
    with_stats: bool = True,
) -> tuple[Sharded, Optional[FleetStats]]:
    """Solve a scenario fleet shard by shard and reduce fleet statistics.

    ``prob`` is the whole fleet (a Problem with one leading batch axis
    divisible by the mesh size, split by :func:`shard_scenarios`) or an
    already :class:`Sharded` one (:func:`.distributed.host_local_problem`);
    ``u_init`` likewise, or None for the cold start. Each shard goes
    through :func:`se3_mpc.solve` on its device (``method="auto"``: kernel
    B1 on a card, for phase 1 and for the shard's own tail; the plain loop
    on the CPU). The tail refine runs PER SHARD, with no cross-shard
    gather, so the two-phase result depends on the split; the single-phase
    core (``tail_iterations=0``) does not.

    Returns the result as :class:`Sharded` (one SolveResult per local
    shard, on its device) and :class:`FleetStats` reduced over the whole
    mesh. ``with_stats=False`` returns ``(result, None)`` and issues no
    collective: back-to-back fleet calls then run with no cross-process
    synchronization."""
    sp = prob if isinstance(prob, Sharded) else shard_scenarios(prob, mesh)
    u0 = _shard_like(u_init, sp, mesh)
    results = tuple(
        se3_mpc.solve(config, p, u, use_obstacles=use_obstacles, method=method)
        for p, u in zip(sp.shards, u0.shards)
    )
    res = Sharded(results, sp.global_batch)
    if not with_stats:
        return res, None
    return res, _reduce_stats(results)


def fleet_statistics(result) -> dict:
    """Host-side summary of a result (a SolveResult, or this process's
    Sharded result gathered to the host), in float64."""
    res = result.gather("cpu") if isinstance(result, Sharded) else result
    cost = res.cost.detach().cpu().double()
    return {
        "total": int(cost.shape[0]),
        "converged": int(res.converged.sum()),
        "mean_cost": float(cost.mean()),
        "max_grad_norm": float(res.grad_norm.detach().cpu().max()),
    }
