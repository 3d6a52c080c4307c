"""Key lifecycle manager: JSON keystore, rotation, HMAC tokens, revocation
(PyTorch counterpart of :mod:`dart_planner_tpu.security.key_manager`).

Parity port of the reference ``SecureKeyManager``
(the reference's security/key_manager.py:80-456, "KM" —
plus key_config.py/key_core.py): a persisted keystore (reference default
``~/.dart_planner/keys.json``, README.md:90), active-key selection per
algorithm, timed rotation with a retired-key verification grace window,
HMAC-SHA256 tokens with TTL + JTI revocation (KM:239-397), expiry cleanup
(KM:399-411), and key statistics / security checks (KM:413-437). The
file-watcher hot-reload is replaced by an mtime check on load — no
watchdog dependency.
"""

from __future__ import annotations

import hashlib
import hmac
import json

from dart_planner_tpu_torch.security import secure_files
import os
import secrets
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

from dart_planner_tpu_torch.common.errors import SecurityError

DEFAULT_KEYSTORE = "~/.dart_planner_tpu/keys.json"
DEFAULT_ROTATION_S = 30 * 24 * 3600  # 30 days
DEFAULT_GRACE_S = 24 * 3600  # retired keys verify for 1 day
DEFAULT_TOKEN_TTL_S = 3600


@dataclass
class KeyConfig:
    """One managed key (reference key_config.py)."""

    key_id: str
    secret_hex: str
    algorithm: str = "HS256"
    created_at: float = field(default_factory=time.time)
    retired_at: Optional[float] = None

    @property
    def secret(self) -> bytes:
        return bytes.fromhex(self.secret_hex)


class SecureKeyManager:
    """Keystore + HMAC token service (KM:80-456)."""

    def __init__(
        self,
        keystore_path: str = DEFAULT_KEYSTORE,
        rotation_interval_s: float = DEFAULT_ROTATION_S,
        grace_period_s: float = DEFAULT_GRACE_S,
    ):
        self.path = Path(os.path.expanduser(keystore_path))
        self.rotation_interval_s = rotation_interval_s
        self.grace_period_s = grace_period_s
        self._keys: Dict[str, KeyConfig] = {}
        self._revoked: Dict[str, float] = {}  # jti -> revocation time
        self._loaded_mtime: float = -1.0
        self.load_or_initialize_keys()

    # -- persistence (KM:119-162) --------------------------------------
    def load_or_initialize_keys(self) -> None:
        if self.path.exists():
            self.load_keys()
        else:
            self.initialize_keys()

    def initialize_keys(self) -> None:
        self._keys = {}
        self._mint_key()
        self.save_keys()

    def load_keys(self) -> None:
        data = json.loads(self.path.read_text())
        self._keys = {
            kid: KeyConfig(**cfg) for kid, cfg in data.get("keys", {}).items()
        }
        self._revoked = dict(data.get("revoked", {}))
        self._loaded_mtime = self.path.stat().st_mtime

    def save_keys(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "keys": {kid: vars(k) for kid, k in self._keys.items()},
            "revoked": self._revoked,
        }
        secure_files.secure_write(self.path, json.dumps(payload, indent=1))
        self._loaded_mtime = self.path.stat().st_mtime

    def reload_keys(self) -> bool:
        """Hot-reload if the file changed on disk (replaces the reference's
        watchdog file watcher, KM:50-77,164-189)."""
        if self.path.exists() and self.path.stat().st_mtime != self._loaded_mtime:
            self.load_keys()
            return True
        return False

    # -- key lifecycle (KM:134,191-200,399-411) ------------------------
    def _mint_key(self, algorithm: str = "HS256") -> KeyConfig:
        key = KeyConfig(
            key_id=secrets.token_hex(8),
            secret_hex=secrets.token_hex(32),
            algorithm=algorithm,
        )
        self._keys[key.key_id] = key
        return key

    def get_active_key(self, algorithm: str = "HS256") -> KeyConfig:
        active = [
            k
            for k in self._keys.values()
            if k.retired_at is None and k.algorithm == algorithm
        ]
        if not active:
            k = self._mint_key(algorithm)
            self.save_keys()
            return k
        newest = max(active, key=lambda k: k.created_at)
        if time.time() - newest.created_at > self.rotation_interval_s:
            return self.rotate_keys(algorithm)
        return newest

    def rotate_keys(self, algorithm: str = "HS256") -> KeyConfig:
        """Retire current active keys, mint a fresh one (KM:195-200)."""
        now = time.time()
        for k in self._keys.values():
            if k.retired_at is None and k.algorithm == algorithm:
                k.retired_at = now
        k = self._mint_key(algorithm)
        self.save_keys()
        return k

    def cleanup_expired_keys(self) -> int:
        """Drop retired keys past the grace window (KM:399-411)."""
        now = time.time()
        dead = [
            kid
            for kid, k in self._keys.items()
            if k.retired_at is not None
            and now - k.retired_at > self.grace_period_s
        ]
        for kid in dead:
            del self._keys[kid]
        if dead:
            self.save_keys()
        return len(dead)

    # -- HMAC tokens (KM:239-362) --------------------------------------
    def create_hmac_token(
        self,
        claims: Dict[str, Any],
        ttl_s: float = DEFAULT_TOKEN_TTL_S,
    ) -> str:
        key = self.get_active_key()
        now = time.time()
        body = {
            **claims,
            "iat": now,
            "exp": now + ttl_s,
            "jti": secrets.token_hex(8),
            "kid": key.key_id,
        }
        payload = json.dumps(body, sort_keys=True).encode()
        sig = hmac.new(key.secret, payload, hashlib.sha256).hexdigest()
        return payload.hex() + "." + sig

    def verify_hmac_token(self, token: str) -> Dict[str, Any]:
        """Signature (active or in-grace retired key) + TTL + revocation
        (KM:306-362)."""
        try:
            payload_hex, sig = token.split(".")
            payload = bytes.fromhex(payload_hex)
            body = json.loads(payload)
        except (ValueError, json.JSONDecodeError) as exc:
            raise SecurityError("malformed token") from exc
        key = self._keys.get(body.get("kid", ""))
        if key is None:
            raise SecurityError("unknown key id")
        if key.retired_at is not None and (
            time.time() - key.retired_at > self.grace_period_s
        ):
            raise SecurityError("key retired beyond grace period")
        expect = hmac.new(key.secret, payload, hashlib.sha256).hexdigest()
        if not hmac.compare_digest(expect, sig):
            raise SecurityError("bad signature")
        if time.time() > body["exp"]:
            raise SecurityError("token expired")
        if self.is_token_revoked(body["jti"]):
            raise SecurityError("token revoked")
        return body

    # -- revocation (KM:363-397) ---------------------------------------
    def revoke_token(self, jti: str) -> bool:
        self._revoked[jti] = time.time()
        self.save_keys()
        return True

    def is_token_revoked(self, jti: str) -> bool:
        return jti in self._revoked

    # -- stats / checks (KM:413-437) -----------------------------------
    def get_key_stats(self) -> Dict[str, Any]:
        now = time.time()
        active = [k for k in self._keys.values() if k.retired_at is None]
        return {
            "total_keys": len(self._keys),
            "active_keys": len(active),
            "retired_keys": len(self._keys) - len(active),
            "revoked_tokens": len(self._revoked),
            "oldest_active_age_s": (
                max(now - k.created_at for k in active) if active else 0.0
            ),
        }

    def check_security(self) -> Dict[str, Any]:
        stats = self.get_key_stats()
        issues = []
        if stats["active_keys"] == 0:
            issues.append("no active key")
        if stats["oldest_active_age_s"] > self.rotation_interval_s:
            issues.append("active key overdue for rotation")
        mode = self.path.stat().st_mode & 0o777 if self.path.exists() else 0
        if mode & 0o077:
            issues.append(f"keystore permissions too open: {oct(mode)}")
        return {"ok": not issues, "issues": issues, **stats}


_global_manager: Optional[SecureKeyManager] = None


def get_key_manager() -> SecureKeyManager:
    """Process-wide singleton (KM:448-454)."""
    global _global_manager
    if _global_manager is None:
        _global_manager = SecureKeyManager()
    return _global_manager


def set_key_manager(manager: SecureKeyManager) -> None:
    """(KM:456)"""
    global _global_manager
    _global_manager = manager
