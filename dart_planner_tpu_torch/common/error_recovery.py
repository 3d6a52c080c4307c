"""Retry, backoff, and circuit-breaker utilities (PyTorch counterpart of
:mod:`dart_planner_tpu.common.error_recovery`).

A framework-free copy of the reference ``common/error_recovery.py``: retry
with exponential backoff + jitter (:26-50), circuit breaker with
closed/open/half-open states, and a graceful-degradation registry.
"""

from __future__ import annotations

import asyncio
import functools
import random
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Optional, Type

from dart_planner_tpu_torch.common.errors import DARTPlannerError


@dataclass
class RetryConfig:
    """(reference error_recovery.py retry parameters)"""

    max_attempts: int = 3
    base_delay: float = 0.1
    max_delay: float = 5.0
    exponential_base: float = 2.0
    jitter: float = 0.1


def retry_with_backoff(
    config: Optional[RetryConfig] = None,
    exceptions: tuple[Type[Exception], ...] = (Exception,),
):
    """Decorator: retry sync or async callables with exponential backoff +
    jitter (reference :26-50)."""
    cfg = config or RetryConfig()

    def delay_for(attempt: int) -> float:
        d = min(cfg.base_delay * cfg.exponential_base**attempt, cfg.max_delay)
        return d + random.uniform(0, cfg.jitter * d)

    def decorator(fn: Callable):
        if asyncio.iscoroutinefunction(fn):

            @functools.wraps(fn)
            async def async_wrapper(*args, **kwargs):
                last: Optional[Exception] = None
                for attempt in range(cfg.max_attempts):
                    try:
                        return await fn(*args, **kwargs)
                    except exceptions as e:
                        last = e
                        if attempt < cfg.max_attempts - 1:
                            await asyncio.sleep(delay_for(attempt))
                raise last

            return async_wrapper

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            last: Optional[Exception] = None
            for attempt in range(cfg.max_attempts):
                try:
                    return fn(*args, **kwargs)
                except exceptions as e:
                    last = e
                    if attempt < cfg.max_attempts - 1:
                        time.sleep(delay_for(attempt))
            raise last

        return wrapper

    return decorator


class CircuitState(Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreakerOpenError(DARTPlannerError):
    """Raised when calling through an open circuit."""


class CircuitBreaker:
    """Classic 3-state circuit breaker (reference error_recovery.py)."""

    def __init__(
        self,
        failure_threshold: int = 5,
        recovery_timeout: float = 30.0,
        half_open_max_calls: int = 1,
    ):
        self.failure_threshold = failure_threshold
        self.recovery_timeout = recovery_timeout
        self.half_open_max_calls = half_open_max_calls
        self.state = CircuitState.CLOSED
        self.failure_count = 0
        self.last_failure_time = 0.0
        self._half_open_calls = 0

    def _check_transition(self) -> None:
        if (
            self.state is CircuitState.OPEN
            and time.time() - self.last_failure_time >= self.recovery_timeout
        ):
            self.state = CircuitState.HALF_OPEN
            self._half_open_calls = 0

    def call(self, fn: Callable, *args, **kwargs) -> Any:
        self._check_transition()
        if self.state is CircuitState.OPEN:
            raise CircuitBreakerOpenError("circuit is open")
        if (
            self.state is CircuitState.HALF_OPEN
            and self._half_open_calls >= self.half_open_max_calls
        ):
            raise CircuitBreakerOpenError("half-open probe limit reached")
        if self.state is CircuitState.HALF_OPEN:
            self._half_open_calls += 1
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result

    def record_success(self) -> None:
        self.failure_count = 0
        self.state = CircuitState.CLOSED

    def record_failure(self) -> None:
        self.failure_count += 1
        self.last_failure_time = time.time()
        if (
            self.state is CircuitState.HALF_OPEN
            or self.failure_count >= self.failure_threshold
        ):
            self.state = CircuitState.OPEN


class GracefulDegradation:
    """Fallback registry (reference graceful-degradation helper): register
    a fallback per operation; ``execute`` tries primary then fallback."""

    def __init__(self):
        self._fallbacks: Dict[str, Callable] = {}

    def register_fallback(self, name: str, fallback: Callable) -> None:
        self._fallbacks[name] = fallback

    def execute(self, name: str, primary: Callable, *args, **kwargs) -> Any:
        try:
            return primary(*args, **kwargs)
        except Exception:
            fb = self._fallbacks.get(name)
            if fb is None:
                raise
            return fb(*args, **kwargs)
