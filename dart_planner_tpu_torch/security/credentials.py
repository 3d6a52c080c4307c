"""Encrypted credential store (PyTorch counterpart
of :mod:`dart_planner_tpu.security.credentials`).

Parity port of the reference ``SecureCredentialManager``
(the reference's security/credential_manager.py:27-229,
"CM"): named credentials with type/expiry metadata, encrypted at rest
with Fernet (AES-128-CBC + HMAC) under a passphrase-derived key
(:func:`~dart_planner_tpu_torch.security.key_derivation.derive_key_from_passphrase`),
stored as a single encrypted file with owner-only permissions.
"""

from __future__ import annotations

import base64
import json

from dart_planner_tpu_torch.security import secure_files
import os
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from cryptography.fernet import Fernet, InvalidToken

from dart_planner_tpu_torch.common.errors import SecurityError
from dart_planner_tpu_torch.security.key_derivation import derive_key_from_passphrase


@dataclass
class Credential:
    """One stored credential (CM:27-78)."""

    name: str
    value: str
    credential_type: str = "generic"  # api_key | password | token | generic
    created_at: float = field(default_factory=time.time)
    expires_at: Optional[float] = None

    @property
    def is_expired(self) -> bool:
        return self.expires_at is not None and time.time() > self.expires_at

    @property
    def days_until_expiry(self) -> Optional[float]:
        if self.expires_at is None:
            return None
        return (self.expires_at - time.time()) / 86400.0


class SecureCredentialManager:
    """Passphrase-encrypted credential file (CM:80-229)."""

    def __init__(
        self,
        credentials_file: str = "~/.dart_planner_tpu/credentials.enc",
        passphrase: Optional[str] = None,
    ):
        self.path = Path(os.path.expanduser(credentials_file))
        passphrase = passphrase or os.environ.get("DART_CREDENTIALS_KEY")
        if not passphrase:
            raise SecurityError(
                "credential passphrase required (arg or DART_CREDENTIALS_KEY)"
            )
        self._salt_path = self.path.with_suffix(".salt")
        salt = (
            self._salt_path.read_bytes() if self._salt_path.exists() else None
        )
        key, salt = derive_key_from_passphrase(passphrase, salt)
        self._fernet = Fernet(base64.urlsafe_b64encode(key))
        self._salt = salt
        self._creds: Dict[str, Credential] = {}
        if self.path.exists():
            self._load()

    # -- persistence ---------------------------------------------------
    def _load(self) -> None:
        try:
            raw = self._fernet.decrypt(self.path.read_bytes())
        except InvalidToken as exc:
            raise SecurityError("wrong passphrase or corrupted store") from exc
        self._creds = {
            name: Credential(**d) for name, d in json.loads(raw).items()
        }

    def _save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if not self._salt_path.exists():
            secure_files.secure_write(self._salt_path, self._salt)
        blob = self._fernet.encrypt(
            json.dumps(
                {n: asdict(c) for n, c in self._creds.items()}
            ).encode()
        )
        secure_files.secure_write(self.path, blob)

    # -- API (CM:159-229) ---------------------------------------------
    def store_credential(
        self,
        name: str,
        value: str,
        credential_type: str = "generic",
        expires_in_days: Optional[float] = None,
    ) -> None:
        expires_at = (
            time.time() + expires_in_days * 86400.0
            if expires_in_days is not None
            else None
        )
        self._creds[name] = Credential(
            name=name,
            value=value,
            credential_type=credential_type,
            expires_at=expires_at,
        )
        self._save()

    def get_credential(self, name: str) -> Optional[str]:
        cred = self._creds.get(name)
        if cred is None or cred.is_expired:
            return None
        return cred.value

    def get_credential_info(self, name: str) -> Optional[Dict[str, Any]]:
        cred = self._creds.get(name)
        if cred is None:
            return None
        return {
            "name": cred.name,
            "credential_type": cred.credential_type,
            "created_at": cred.created_at,
            "expires_at": cred.expires_at,
            "is_expired": cred.is_expired,
            "days_until_expiry": cred.days_until_expiry,
        }

    def remove_credential(self, name: str) -> bool:
        if name in self._creds:
            del self._creds[name]
            self._save()
            return True
        return False

    def list_credentials(self) -> List[str]:
        return sorted(self._creds)

    def cleanup_expired(self) -> int:
        dead = [n for n, c in self._creds.items() if c.is_expired]
        for n in dead:
            del self._creds[n]
        if dead:
            self._save()
        return len(dead)
