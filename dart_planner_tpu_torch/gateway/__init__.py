"""API gateway layer (PyTorch counterpart of :mod:`dart_planner_tpu.gateway`;
the reference's ``src/dart_planner/gateway/``): pure ASGI middleware."""

from dart_planner_tpu_torch.gateway.middleware import (
    CSRFMiddleware,
    SecureMiddleware,
    SecurityHeadersMiddleware,
)

__all__ = ["CSRFMiddleware", "SecureMiddleware", "SecurityHeadersMiddleware"]
