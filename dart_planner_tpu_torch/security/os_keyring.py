"""OS-keyring-backed key storage with a file-store fallback (PyTorch
counterpart of :mod:`dart_planner_tpu.security.os_keyring`).

Parity analog of the reference's keyring integration
(the reference's security/os_keyring.py:62-340, "OK"):
key material (KEK/DEK/JWT/HMAC/API keys) lives in the operating system's
credential service — Windows Credential Manager, macOS Keychain, or the
Linux Secret Service — instead of application-managed files, with
per-key metadata (type, creation/expiry, rotation policy, usage count)
kept alongside.

Differences from the reference, by design:

- the ``keyring`` package is an *optional* import; when absent the store
  degrades to an owner-only (0600) JSON secrets file compatible with the
  rest of this repo's key handling (``key_manager.SecureKeyManager``'s
  store discipline) rather than raising at construction (OK:74-76 raises
  ``ConfigurationError``). Real deployments get the OS service; CI and
  air-gapped images keep working. The downgrade is *loud*: a
  ``logging.warning`` fires whenever the OS backend was preferred but
  unavailable, and ``require_os_keyring=True`` restores the reference's
  fail-closed behavior (raises ``SecurityError`` at construction) for
  production deployments.
- the file backend serializes read-modify-write cycles with an
  inter-process ``flock`` on a sidecar ``.lock`` file, so concurrent
  processes sharing the store cannot lose writes.
- no win32crypt DPAPI re-implementation (OK:290-327) — that layer only
  exists because the reference duplicates what ``keyring`` already does
  on Windows.
"""

from __future__ import annotations

import base64
import contextlib
import json
import logging
import os
import secrets
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, Optional

from dart_planner_tpu_torch.common.errors import SecurityError

try:  # POSIX-only; Windows keyring deployments use the OS backend anyway
    import fcntl as _fcntl
except ImportError:  # pragma: no cover
    _fcntl = None

logger = logging.getLogger(__name__)

try:  # optional dependency; absent in minimal images
    import keyring as _keyring  # type: ignore

    KEYRING_AVAILABLE = True
except ImportError:  # pragma: no cover - exercised implicitly in CI
    _keyring = None
    KEYRING_AVAILABLE = False

SERVICE_NAME = "dart_planner_tpu"
DEFAULT_FALLBACK_PATH = "~/.dart_planner_tpu/keyring.json"


class KeyType:
    """Key classes stored in the keyring (OK:43-49)."""

    KEK = "kek"
    DEK = "dek"
    JWT = "jwt"
    HMAC = "hmac"
    API = "api"


@dataclass
class KeyMetadata:
    """Per-key bookkeeping (OK:52-59)."""

    key_id: str
    key_type: str
    created_at: float
    expires_at: Optional[float] = None
    rotation_policy: Optional[str] = None
    usage_count: int = 0


class _FileKeyring:
    """Owner-only JSON file implementing the keyring get/set/delete
    surface; used when the ``keyring`` package (or its OS backend) is
    unavailable. Same 0600-from-first-byte discipline as
    ``key_manager.SecureKeyManager.save_keys``."""

    def __init__(self, path: str = DEFAULT_FALLBACK_PATH):
        self.path = Path(os.path.expanduser(path))
        self._lock_depth = 0
        self._lock_fd: Optional[int] = None

    @contextlib.contextmanager
    def locked(self):
        """Exclusive inter-process lock (flock on a sidecar .lock file)
        held across load-modify-save cycles so two processes sharing the
        store cannot interleave and lose writes. Re-entrant within the
        instance; a no-op where fcntl is unavailable."""
        if _fcntl is None:
            yield
            return
        if self._lock_depth == 0:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._lock_fd = os.open(
                self.path.with_suffix(".lock"),
                os.O_WRONLY | os.O_CREAT,
                0o600,
            )
            _fcntl.flock(self._lock_fd, _fcntl.LOCK_EX)
        self._lock_depth += 1
        try:
            yield
        finally:
            self._lock_depth -= 1
            if self._lock_depth == 0 and self._lock_fd is not None:
                _fcntl.flock(self._lock_fd, _fcntl.LOCK_UN)
                os.close(self._lock_fd)
                self._lock_fd = None

    def _load(self) -> Dict[str, Dict[str, str]]:
        if not self.path.exists():
            return {}
        return json.loads(self.path.read_text())

    def _save(self, data: Dict[str, Dict[str, str]]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(data))
        os.replace(tmp, self.path)
        os.chmod(self.path, 0o600)

    def set_password(self, service: str, name: str, value: str) -> None:
        with self.locked():
            data = self._load()
            data.setdefault(service, {})[name] = value
            self._save(data)

    def get_password(self, service: str, name: str) -> Optional[str]:
        return self._load().get(service, {}).get(name)

    def delete_password(self, service: str, name: str) -> None:
        with self.locked():
            data = self._load()
            if name not in data.get(service, {}):
                raise KeyError(name)
            del data[service][name]
            self._save(data)

    def names(self, service: str) -> list:
        return list(self._load().get(service, {}))


class OSKeyringManager:
    """Key storage over the OS credential service (OK:62-287).

    Secrets are stored under ``service_name`` with entry names
    ``<type>:<key_id>``; metadata travels in the same entry (keyring
    backends store one string per entry, so the value is a JSON envelope
    of base64 key bytes + metadata — the reference stores two entries
    per key, OK:126-139, which can desynchronize; one envelope cannot).
    """

    def __init__(
        self,
        service_name: str = SERVICE_NAME,
        fallback_path: str = DEFAULT_FALLBACK_PATH,
        prefer_os_keyring: bool = True,
        require_os_keyring: bool = False,
    ):
        self.service_name = service_name
        self.backend_name = "file"
        self._ring = None
        probe_error: Optional[Exception] = None
        if prefer_os_keyring and KEYRING_AVAILABLE:
            try:
                _keyring.get_keyring()  # probe the backend (OK:88-92)
                self._ring = _keyring
                self.backend_name = type(_keyring.get_keyring()).__name__
            except Exception as exc:
                self._ring = None
                probe_error = exc
        if self._ring is None:
            if require_os_keyring:
                # fail-closed, matching the reference's ConfigurationError
                # at construction (OK:74-76)
                raise SecurityError(
                    "OS keyring required but unavailable: "
                    + (
                        f"backend probe failed ({probe_error})"
                        if probe_error is not None
                        else "keyring package not installed"
                    )
                )
            if prefer_os_keyring:
                # The downgrade must be loud: a deployment that believes
                # it is on the OS credential service should not silently
                # end up on a plaintext-equivalent file store.
                if probe_error is not None:
                    logger.warning(
                        "OS keyring backend probe failed (%s); falling "
                        "back to file store at %s — key material is only "
                        "filesystem-permission protected",
                        probe_error,
                        fallback_path,
                    )
                elif not KEYRING_AVAILABLE:
                    logger.warning(
                        "keyring package not installed; falling back to "
                        "file store at %s — key material is only "
                        "filesystem-permission protected",
                        fallback_path,
                    )
            self._file = _FileKeyring(fallback_path)
        else:
            self._file = None

    def _locked(self):
        """Store-wide lock for multi-step read-modify-write sequences on
        the file backend; no-op on OS keyring backends (which serialize
        per-entry internally)."""
        if self._file is not None:
            return self._file.locked()
        return contextlib.nullcontext()

    # -- entry plumbing -------------------------------------------------
    def _name(self, key_id: str, key_type: str) -> str:
        return f"{key_type}:{key_id}"

    def _set(self, name: str, value: str) -> None:
        if self._ring is not None:
            self._ring.set_password(self.service_name, name, value)
        else:
            self._file.set_password(self.service_name, name, value)

    def _get(self, name: str) -> Optional[str]:
        if self._ring is not None:
            return self._ring.get_password(self.service_name, name)
        return self._file.get_password(self.service_name, name)

    def _delete(self, name: str) -> None:
        if self._ring is not None:
            self._ring.delete_password(self.service_name, name)
        else:
            self._file.delete_password(self.service_name, name)

    def _index(self) -> list:
        """Entry-name index. OS keyrings cannot enumerate, so an index
        entry tracks names (the file backend enumerates natively)."""
        if self._ring is None:
            return [n for n in self._file.names(self.service_name)
                    if n != "__index__"]
        raw = self._get("__index__")
        return json.loads(raw) if raw else []

    def _save_index(self, names: list) -> None:
        if self._ring is not None:
            self._set("__index__", json.dumps(names))

    # -- public API (OK:104-287) ----------------------------------------
    def store_key(
        self,
        key_data: bytes,
        key_type: str,
        expires_at: Optional[float] = None,
        rotation_policy: Optional[str] = None,
        key_id: Optional[str] = None,
    ) -> str:
        """Store key bytes; returns the generated key id (OK:104-148)."""
        if not key_data:
            raise SecurityError("refusing to store empty key material")
        key_id = key_id or f"{key_type}_{secrets.token_hex(8)}"
        meta = KeyMetadata(
            key_id=key_id,
            key_type=key_type,
            created_at=time.time(),
            expires_at=expires_at,
            rotation_policy=rotation_policy,
        )
        envelope = json.dumps(
            {
                "key": base64.b64encode(key_data).decode(),
                "meta": asdict(meta),
            }
        )
        name = self._name(key_id, key_type)
        with self._locked():
            self._set(name, envelope)
            idx = self._index()
            if name not in idx:
                self._save_index(idx + [name])
        return key_id

    def retrieve_key(self, key_id: str, key_type: str) -> Optional[bytes]:
        """Fetch key bytes; bumps usage count; expired keys return None
        (OK:150-195)."""
        name = self._name(key_id, key_type)
        with self._locked():
            raw = self._get(name)
            if raw is None:
                return None
            env = json.loads(raw)
            meta = env["meta"]
            if meta.get("expires_at") and time.time() > meta["expires_at"]:
                return None
            meta["usage_count"] = int(meta.get("usage_count", 0)) + 1
            self._set(name, json.dumps(env))
        return base64.b64decode(env["key"])

    def delete_key(self, key_id: str, key_type: str) -> bool:
        """(OK:197-223)"""
        name = self._name(key_id, key_type)
        with self._locked():
            try:
                self._delete(name)
            except Exception:
                return False
            self._save_index([n for n in self._index() if n != name])
        return True

    def list_keys(
        self, key_type: Optional[str] = None
    ) -> Dict[str, KeyMetadata]:
        """key_id -> metadata for stored (non-dangling) keys (OK:225-243)."""
        out: Dict[str, KeyMetadata] = {}
        for name in self._index():
            ktype, _, kid = name.partition(":")
            if key_type is not None and ktype != key_type:
                continue
            raw = self._get(name)
            if raw is None:
                continue
            out[kid] = KeyMetadata(**json.loads(raw)["meta"])
        return out

    def rotate_key(
        self, key_id: str, key_type: str, new_key_data: bytes
    ) -> str:
        """Store the replacement, then delete the old entry (OK:245-267).
        Order matters: a crash between the two operations must leave a
        usable key, so the new one lands first."""
        with self._locked():
            old = self.retrieve_key(key_id, key_type)
            if old is None:
                raise SecurityError(f"cannot rotate unknown key {key_id!r}")
            new_id = self.store_key(new_key_data, key_type)
            self.delete_key(key_id, key_type)
        return new_id

    def validate_key_access(self) -> bool:
        """Round-trip a probe entry (OK:269-287)."""
        probe = secrets.token_bytes(16)
        try:
            kid = self.store_key(probe, "probe")
            ok = self.retrieve_key(kid, "probe") == probe
            self.delete_key(kid, "probe")
            return ok
        except Exception:
            return False


_global_keyring: Optional[OSKeyringManager] = None


def get_keyring_manager() -> OSKeyringManager:
    """Process-wide singleton (OK:329-334)."""
    global _global_keyring
    if _global_keyring is None:
        _global_keyring = OSKeyringManager()
    return _global_keyring


def set_keyring_manager(manager: Optional[OSKeyringManager]) -> None:
    """(OK:336-340)"""
    global _global_keyring
    _global_keyring = manager
