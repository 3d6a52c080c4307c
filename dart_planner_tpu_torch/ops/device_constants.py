"""Host-built constants of the solve and the closed loop, made on their
device once and shared.

A constant built on the host and copied to the card at every call (a rollout
map, the gravity vector, the thrust box) is a copy from pageable memory:
the host waits at it for every launch queued before it. :func:`device_constant`
makes each such tensor once per key on its device and returns that same
tensor to every later call, so a solve or a replan uploads nothing and never
waits on the card. Each cache miss adds one to the global metrics counter
``device_constant_uploads``; in a steady loop the counter stays flat.

The returned tensors are shared by every caller in the process: read them,
take views of them, never write into them (nor into a view of them).
"""

from __future__ import annotations

import functools

import torch

_MAX_ENTRIES = 256  # keys held; the least recently used goes first


def normal_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index, so that ``"cuda"`` and
    ``"cuda:0"`` (when card 0 is current) name one device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def device_constant(build, *key, dtype: torch.dtype, device):
    """``build(*key, dtype=dtype, device=device)``, a tensor or a tuple of
    tensors, made on the first call for ``(build, key, dtype, device)`` and
    the same object returned on every later one. ``build`` is a module-level
    function (its identity is part of the key) that makes its tensors
    exactly as an uncached caller would; ``key`` holds the hashable values
    that define them (horizon, step, the configuration's floats). Read only:
    see the module's docstring."""
    return _cached(build, key, dtype, normal_device(device))


def _vector_on(values: tuple, *, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def vector(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values)`` (python floats: a gravity or hover vector, a
    thrust bound, the line search's alphas) on ``device``, made there once
    per values (read only)."""
    return device_constant(_vector_on, tuple(values), dtype=dtype, device=device)


@functools.lru_cache(maxsize=_MAX_ENTRIES)
def _cached(build, key, dtype, device):
    from dart_planner_tpu_torch.common.metrics import get_metrics  # common shares ops' layer

    get_metrics().increment("device_constant_uploads")
    return build(*key, dtype=dtype, device=device)
