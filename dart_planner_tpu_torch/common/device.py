"""The port's default device, the first CUDA card, and host copies of
tensors on any device.

Entry points that make tensors (the facades, ``make_problem`` on non-tensor
input, the fleet and world samplers, the type constructors) run on the card
unless the caller passes ``device="cpu"``. Without a card they raise; they
never fall back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def default_device() -> torch.device:
    """``cuda:0``; raises a RuntimeError that names ``device="cpu"`` when no
    CUDA device is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on the card by default; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or :func:`default_device` for None."""
    return default_device() if device is None else torch.device(device)


def to_host(x, dtype=np.float64) -> np.ndarray:
    """A numpy copy of ``x`` as ``dtype``: a tensor on any device is copied
    to the host (an explicit read, which waits for the card), anything
    else goes through ``np.array``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype)
