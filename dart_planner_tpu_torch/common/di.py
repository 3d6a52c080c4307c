"""Dependency-injection container (PyTorch counterpart of
:mod:`dart_planner_tpu.common.di`).

A framework-free copy of the reference ``common/di_container_v2.py``:
staged registration (bootstrap -> runtime, :24-29), singleton/factory/
instance providers (:75-117), cycle detection with topological ordering
(:130-196), and domain helpers (:492-575). The graph is explicit —
providers declare their dependencies by type — rather than
reflection-based, keeping resolution deterministic and debuggable.
:func:`create_default_container` wires the port's stack, each component on
one device (default: the card), its planner built from the port's frozen
configuration.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Type, TypeVar

from dart_planner_tpu_torch.common.errors import DependencyError

T = TypeVar("T")


class Stage(enum.Enum):
    """(reference di_container_v2.py:24-29)"""

    BOOTSTRAP = "bootstrap"
    RUNTIME = "runtime"


@dataclass
class _Registration:
    factory: Callable[["DIContainer"], Any]
    singleton: bool
    stage: Stage
    depends_on: tuple


class DIContainer:
    """(reference DIContainerV2, di_container_v2.py:198+)"""

    def __init__(self):
        self._registry: Dict[Type, _Registration] = {}
        self._instances: Dict[Type, Any] = {}
        self._lock = threading.RLock()
        self._finalized_bootstrap = False

    # -- registration (reference :75-117) --
    def register_singleton(
        self,
        interface: Type[T],
        factory: Callable[["DIContainer"], T],
        stage: Stage = Stage.RUNTIME,
        depends_on: tuple = (),
    ) -> None:
        self._register(interface, factory, True, stage, depends_on)

    def register_factory(
        self,
        interface: Type[T],
        factory: Callable[["DIContainer"], T],
        stage: Stage = Stage.RUNTIME,
        depends_on: tuple = (),
    ) -> None:
        self._register(interface, factory, False, stage, depends_on)

    def register_instance(self, interface: Type[T], instance: T) -> None:
        self._register(interface, lambda c: instance, True, Stage.BOOTSTRAP, ())
        self._instances[interface] = instance

    def _register(self, interface, factory, singleton, stage, depends_on):
        with self._lock:
            if stage is Stage.BOOTSTRAP and self._finalized_bootstrap:
                raise DependencyError(
                    f"bootstrap stage is finalized; cannot register {interface}"
                )
            self._registry[interface] = _Registration(
                factory, singleton, stage, tuple(depends_on)
            )

    def finalize_bootstrap(self) -> None:
        """Freeze the bootstrap stage (reference staged registration)."""
        self._finalized_bootstrap = True

    # -- graph checks (reference :130-196) --
    def detect_cycles(self) -> List[List[Type]]:
        cycles: List[List[Type]] = []
        visiting: set = set()
        done: set = set()

        def dfs(node: Type, path: List[Type]):
            if node in done or node not in self._registry:
                return
            if node in visiting:
                cycles.append(path[path.index(node):] + [node])
                return
            visiting.add(node)
            for dep in self._registry[node].depends_on:
                dfs(dep, path + [node])
            visiting.discard(node)
            done.add(node)

        for n in list(self._registry):
            dfs(n, [])
        return cycles

    def dependency_order(self) -> List[Type]:
        """Topological order (dependencies first)."""
        cycles = self.detect_cycles()
        if cycles:
            raise DependencyError(f"dependency cycles: {cycles}")
        order: List[Type] = []
        seen: set = set()

        def visit(node: Type):
            if node in seen or node not in self._registry:
                return
            seen.add(node)
            for dep in self._registry[node].depends_on:
                visit(dep)
            order.append(node)

        for n in list(self._registry):
            visit(n)
        return order

    # -- resolution --
    def resolve(self, interface: Type[T]) -> T:
        with self._lock:
            if interface in self._instances:
                return self._instances[interface]
            reg = self._registry.get(interface)
            if reg is None:
                raise DependencyError(f"no registration for {interface}")
            instance = reg.factory(self)
            if reg.singleton:
                self._instances[interface] = instance
            return instance

    def reset(self) -> None:
        with self._lock:
            self._instances = {
                k: v
                for k, v in self._instances.items()
                if k in self._registry and self._registry[k].stage is Stage.BOOTSTRAP
            }


_container: Optional[DIContainer] = None


def get_container() -> DIContainer:
    """Process-wide container wired with the standard stack
    (reference :492-575 domain sub-containers)."""
    global _container
    if _container is None:
        _container = create_default_container()
    return _container


def reset_container() -> None:
    global _container
    _container = None


def create_default_container(device=None) -> DIContainer:
    """Standard wiring: config -> planner/controller/mapper/smoother, each
    made on ``device`` when first resolved (default: the card, which raises
    without one; pass ``device="cpu"`` for the CPU)."""
    from dart_planner_tpu_torch.config import get_frozen_config
    from dart_planner_tpu_torch.config.frozen_config import DARTPlannerFrozenConfig
    from dart_planner_tpu_torch.control.geometric import GeometricController
    from dart_planner_tpu_torch.control.smoother import TrajectorySmoother
    from dart_planner_tpu_torch.perception.mapper import GeometricMapper
    from dart_planner_tpu_torch.planning.global_mission import GlobalMissionPlanner
    from dart_planner_tpu_torch.planning.se3_mpc import SE3MPCPlanner

    c = DIContainer()
    c.register_singleton(
        DARTPlannerFrozenConfig,
        lambda _: get_frozen_config(),
        stage=Stage.BOOTSTRAP,
    )
    c.register_singleton(
        SE3MPCPlanner,
        lambda cc: SE3MPCPlanner(
            cc.resolve(DARTPlannerFrozenConfig).planning.to_se3_config(),
            device=device,
        ),
        depends_on=(DARTPlannerFrozenConfig,),
    )
    c.register_singleton(
        GeometricController, lambda _: GeometricController(device=device))
    c.register_singleton(
        TrajectorySmoother, lambda _: TrajectorySmoother(device=device))
    c.register_singleton(GeometricMapper, lambda _: GeometricMapper(device=device))
    c.register_singleton(GlobalMissionPlanner, lambda _: GlobalMissionPlanner())
    c.finalize_bootstrap()
    return c
