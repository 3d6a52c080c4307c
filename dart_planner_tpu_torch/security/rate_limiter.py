"""Login/command rate limiting (PyTorch counterpart
of :mod:`dart_planner_tpu.security.rate_limiter`).

Port of the reference ``security/rate_limiter.py``: per-identifier
attempt counting with sliding window and escalating lockouts
(:38-157), plus a module-level ``check_login_rate_limit`` helper (:199).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class RateLimitConfig:
    """(reference rate_limiter.py:20-28)"""

    max_attempts: int = 5
    window_s: float = 60.0
    base_lockout_s: float = 30.0
    max_lockout_s: float = 3600.0


@dataclass
class _Entry:
    attempts: list = field(default_factory=list)
    lockout_until: float = 0.0
    lockout_count: int = 0


class RateLimiter:
    """(reference rate_limiter.py:38-197)"""

    def __init__(self, config: Optional[RateLimitConfig] = None):
        self.config = config or RateLimitConfig()
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()

    def is_allowed(self, identifier: str) -> Tuple[bool, Optional[str]]:
        """Record one attempt; (allowed, reason-if-denied) (ref :63-106)."""
        now = time.time()
        with self._lock:
            e = self._entries.setdefault(identifier, _Entry())
            if now < e.lockout_until:
                return False, f"locked out for {e.lockout_until - now:.0f}s"
            e.attempts = [t for t in e.attempts if now - t < self.config.window_s]
            e.attempts.append(now)
            if len(e.attempts) > self.config.max_attempts:
                e.lockout_count += 1
                duration = min(
                    self.config.base_lockout_s * 2 ** (e.lockout_count - 1),
                    self.config.max_lockout_s,
                )
                e.lockout_until = now + duration
                e.attempts.clear()
                return False, f"too many attempts; locked for {duration:.0f}s"
            return True, None

    def record_success(self, identifier: str) -> None:
        """Reset on success (ref :108-119)."""
        with self._lock:
            self._entries.pop(identifier, None)

    def get_status(self, identifier: str) -> Optional[dict]:
        with self._lock:
            e = self._entries.get(identifier)
            if e is None:
                return None
            return {
                "recent_attempts": len(e.attempts),
                "lockout_until": e.lockout_until,
                "lockout_count": e.lockout_count,
            }


_default = RateLimiter()


def check_login_rate_limit(identifier: str) -> Tuple[bool, Optional[str]]:
    """(reference rate_limiter.py:199)"""
    return _default.is_allowed(identifier)
