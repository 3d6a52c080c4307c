"""The port's default device: the first CUDA card.

Entry points that make tensors (the facades, ``make_problem`` on non-tensor
input, the fleet and world samplers, the type constructors) run on the card
unless the caller passes ``device="cpu"``. Without a card they raise; they
never fall back to the CPU.
"""

from __future__ import annotations

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
