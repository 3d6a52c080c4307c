"""Typed credential helpers over :class:`SecureCredentialManager` (PyTorch
counterpart of :mod:`dart_planner_tpu.security.credential_helpers`).

Parity rebuild of the reference helper layer
(the reference's security/credential_helpers.py:1-343):
well-known credential kinds (MAVLink link auth, external API keys,
database DSN parts, JWT signing secrets) stored under canonical names
with the right expiry policies, so call sites never invent ad-hoc
naming or forget rotation metadata. Values are packed as JSON into the
generic encrypted store — the helpers own the schema.
"""

from __future__ import annotations

import json
import secrets
from typing import Optional, Tuple

from dart_planner_tpu_torch.security.credentials import SecureCredentialManager

_API_EXPIRY_DAYS = 90.0  # rotate external API keys quarterly
_JWT_EXPIRY_DAYS = 30.0  # signing secrets rotate monthly


def _put(mgr: SecureCredentialManager, name: str, payload: dict,
         expires_in_days: Optional[float]) -> None:
    mgr.store_credential(
        name, json.dumps(payload), expires_in_days=expires_in_days
    )


def _get(mgr: SecureCredentialManager, name: str) -> Optional[dict]:
    raw = mgr.get_credential(name)
    return None if raw is None else json.loads(raw)


# -- MAVLink link authentication ------------------------------------------
def store_mavlink_credentials(mgr: SecureCredentialManager, username: str,
                              password: Optional[str] = None) -> None:
    _put(mgr, "mavlink", {"username": username, "password": password},
         expires_in_days=None)


def get_mavlink_credentials(
    mgr: SecureCredentialManager,
) -> Optional[Tuple[str, Optional[str]]]:
    d = _get(mgr, "mavlink")
    return None if d is None else (d["username"], d.get("password"))


# -- external API keys -----------------------------------------------------
def store_api_credentials(mgr: SecureCredentialManager, service: str,
                          api_key: str,
                          api_secret: Optional[str] = None) -> None:
    _put(mgr, f"api:{service}", {"key": api_key, "secret": api_secret},
         expires_in_days=_API_EXPIRY_DAYS)


def get_api_credentials(
    mgr: SecureCredentialManager, service: str
) -> Optional[Tuple[str, Optional[str]]]:
    d = _get(mgr, f"api:{service}")
    return None if d is None else (d["key"], d.get("secret"))


def rotate_api_credentials(mgr: SecureCredentialManager, service: str,
                           new_key: str,
                           new_secret: Optional[str] = None) -> bool:
    """Replace a service's API credential; False if none existed."""
    if _get(mgr, f"api:{service}") is None:
        return False
    store_api_credentials(mgr, service, new_key, new_secret)
    return True


# -- database DSN parts ----------------------------------------------------
def store_database_credentials(mgr: SecureCredentialManager, db: str,
                               username: str, password: str,
                               host: str = "localhost",
                               port: int = 5432) -> None:
    _put(mgr, f"db:{db}",
         {"username": username, "password": password,
          "host": host, "port": port},
         expires_in_days=None)


def get_database_credentials(
    mgr: SecureCredentialManager, db: str
) -> Optional[Tuple[str, str, str, int]]:
    d = _get(mgr, f"db:{db}")
    if d is None:
        return None
    return d["username"], d["password"], d["host"], d["port"]


# -- JWT signing secrets ---------------------------------------------------
def store_jwt_credentials(mgr: SecureCredentialManager,
                          secret: Optional[str] = None,
                          algorithm: str = "HS256") -> str:
    """Store (or generate) the JWT signing secret; returns it."""
    if secret is None:
        secret = secrets.token_urlsafe(48)
    _put(mgr, "jwt", {"secret": secret, "algorithm": algorithm},
         expires_in_days=_JWT_EXPIRY_DAYS)
    return secret


def get_jwt_credentials(
    mgr: SecureCredentialManager,
) -> Optional[Tuple[str, str]]:
    d = _get(mgr, "jwt")
    return None if d is None else (d["secret"], d["algorithm"])
