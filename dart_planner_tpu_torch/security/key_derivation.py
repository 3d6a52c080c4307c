"""Key derivation and key-strength utilities (PyTorch counterpart
of :mod:`dart_planner_tpu.security.key_derivation`).

Parity port of the reference key-derivation helpers
(the reference's security/key_derivation.py, "KD"):
passphrase → key via PBKDF2-HMAC-SHA256 (KD:42-72) and scrypt (KD:74-105),
OS keystore integration (gated — DPAPI/Keychain/TPM paths raise
:class:`OSKeyStoreError` here, KD:107-243), secure key
generation (KD:245-253), and key-strength validation (KD:274+). Stdlib
``hashlib``/``secrets`` only.
"""

from __future__ import annotations

import hashlib
import secrets
from typing import Optional, Tuple

from dart_planner_tpu_torch.common.errors import SecurityError

KEY_BYTES = 32
SALT_BYTES = 16
PBKDF2_ITERATIONS = 600_000  # OWASP-level work factor


class KeyDerivationError(SecurityError):
    """(KD:32-35)"""


class OSKeyStoreError(SecurityError):
    """(KD:37-40)"""


def derive_key_from_passphrase(
    passphrase: str, salt: Optional[bytes] = None
) -> Tuple[bytes, bytes]:
    """PBKDF2-HMAC-SHA256 (KD:42-72); returns (key, salt)."""
    if not passphrase:
        raise KeyDerivationError("empty passphrase")
    if salt is None:
        salt = secrets.token_bytes(SALT_BYTES)
    key = hashlib.pbkdf2_hmac(
        "sha256", passphrase.encode(), salt, PBKDF2_ITERATIONS, dklen=KEY_BYTES
    )
    return key, salt


def derive_key_from_scrypt(
    passphrase: str, salt: Optional[bytes] = None
) -> Tuple[bytes, bytes]:
    """scrypt N=2^14, r=8, p=1 (KD:74-105); returns (key, salt)."""
    if not passphrase:
        raise KeyDerivationError("empty passphrase")
    if salt is None:
        salt = secrets.token_bytes(SALT_BYTES)
    key = hashlib.scrypt(
        passphrase.encode(), salt=salt, n=2**14, r=8, p=1, dklen=KEY_BYTES
    )
    return key, salt


def derive_key_from_os_keystore(key_id: str) -> bytes:
    """OS-native key stores (KD:107-243). None is wired up
    here; raises :class:`OSKeyStoreError` so callers fall back to
    passphrase derivation."""
    raise OSKeyStoreError(
        f"no OS keystore backend available for key {key_id!r} "
        "(DPAPI/Keychain/TPM not present)"
    )


def generate_secure_key(n_bytes: int = KEY_BYTES) -> bytes:
    """CSPRNG key material (KD:245-253)."""
    return secrets.token_bytes(n_bytes)


def validate_key_strength(key: bytes) -> bool:
    """Length + crude entropy screen (KD:274+): ≥32 bytes, not constant,
    not trivially repetitive."""
    if len(key) < KEY_BYTES:
        return False
    if len(set(key)) < 8:  # near-constant material
        return False
    return key != len(key) // 4 * key[:4]
