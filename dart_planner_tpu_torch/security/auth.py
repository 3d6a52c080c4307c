"""RS256 token authentication with roles (PyTorch counterpart
of :mod:`dart_planner_tpu.security.auth`).

Functional port of the reference ``security/auth.py``: JWT RS256 tokens
(auth.py:31,109-131) with 15-minute access / 1-hour refresh lifetimes
(README.md:87-99), a role/permission model (auth.py:42-47,181-192), and
PBKDF2 password hashing. Tokens are standard JWS compact serialization
(header.payload.signature) built on ``cryptography`` directly, without
PyJWT — interoperable with any RS256 JWT verifier.
"""

from __future__ import annotations

import base64
import enum
import hashlib
import hmac as _hmac
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import padding, rsa

from dart_planner_tpu_torch.common.errors import SecurityError


class TokenError(SecurityError):
    """Invalid, expired, or forged token."""


class Role(str, enum.Enum):
    """(reference auth.py:42-47)"""

    ADMIN = "admin"
    OPERATOR = "operator"
    VIEWER = "viewer"
    PILOT = "pilot"  # flight-control operations (reference auth.py:47)


# Short command-string permissions (the secure hardware channel keys
# off these, hardware/secure_interface.py). The full typed RBAC matrix
# lives in security.permissions (reference permissions.py parity).
ROLE_PERMISSIONS: Dict[Role, List[str]] = {
    Role.ADMIN: ["*"],
    Role.PILOT: ["arm", "disarm", "takeoff", "land", "emergency_stop",
                 "set_mission", "view"],
    Role.OPERATOR: ["arm", "takeoff", "land", "set_mission", "view"],
    Role.VIEWER: ["view"],
}

ACCESS_TOKEN_LIFETIME_S = 15 * 60  # 15 min (README.md:97)
REFRESH_TOKEN_LIFETIME_S = 60 * 60  # 1 h


@dataclass
class User:
    """(reference auth.py:49-57)"""

    username: str
    role: Role = Role.VIEWER
    password_hash: str = ""
    active: bool = True


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def generate_rsa_keypair() -> Tuple[bytes, bytes]:
    """(private_pem, public_pem) — reference key_manager key generation."""
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    priv = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    pub = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo,
    )
    return priv, pub


class AuthManager:
    """(reference auth.py:95-192)"""

    def __init__(
        self,
        private_key_pem: Optional[bytes] = None,
        public_key_pem: Optional[bytes] = None,
    ):
        if private_key_pem is None:
            private_key_pem, public_key_pem = generate_rsa_keypair()
        self._private = serialization.load_pem_private_key(
            private_key_pem, password=None
        )
        self._public = (
            serialization.load_pem_public_key(public_key_pem)
            if public_key_pem is not None
            else self._private.public_key()
        )
        self._users: Dict[str, User] = {}

    # -- password handling (reference auth.py:101-107) --
    @staticmethod
    def get_password_hash(password: str) -> str:
        salt = os.urandom(16)
        dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, 200_000)
        return f"{salt.hex()}${dk.hex()}"

    @staticmethod
    def verify_password(password: str, password_hash: str) -> bool:
        try:
            salt_hex, dk_hex = password_hash.split("$")
        except ValueError:
            return False
        dk = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), bytes.fromhex(salt_hex), 200_000
        )
        return _hmac.compare_digest(dk.hex(), dk_hex)

    # -- user registry --
    def register_user(self, username: str, password: str, role: Role) -> User:
        user = User(
            username=username,
            role=role,
            password_hash=self.get_password_hash(password),
        )
        self._users[username] = user
        return user

    def authenticate(self, username: str, password: str) -> Optional[User]:
        user = self._users.get(username)
        if user and user.active and self.verify_password(password, user.password_hash):
            return user
        return None

    # -- tokens (reference auth.py:109-131) --
    def _create_token(self, claims: dict, lifetime_s: int) -> str:
        header = {"alg": "RS256", "typ": "JWT"}
        now = int(time.time())
        payload = {**claims, "iat": now, "exp": now + lifetime_s}
        signing_input = (
            f"{_b64(json.dumps(header).encode())}"
            f".{_b64(json.dumps(payload).encode())}"
        )
        sig = self._private.sign(
            signing_input.encode(), padding.PKCS1v15(), hashes.SHA256()
        )
        return f"{signing_input}.{_b64(sig)}"

    def create_access_token(self, user: User) -> str:
        return self._create_token(
            {"sub": user.username, "role": user.role.value, "type": "access"},
            ACCESS_TOKEN_LIFETIME_S,
        )

    def create_refresh_token(self, user: User) -> str:
        return self._create_token(
            {"sub": user.username, "role": user.role.value, "type": "refresh"},
            REFRESH_TOKEN_LIFETIME_S,
        )

    def verify_token(self, token: str, expected_type: str = "access") -> dict:
        """(reference auth.py:148-179)"""
        try:
            h_b64, p_b64, s_b64 = token.split(".")
        except (ValueError, AttributeError) as e:
            raise TokenError("malformed token") from e
        try:
            self._public.verify(
                _unb64(s_b64),
                f"{h_b64}.{p_b64}".encode(),
                padding.PKCS1v15(),
                hashes.SHA256(),
            )
        except (InvalidSignature, ValueError) as e:
            # binascii.Error (garbage base64) subclasses ValueError:
            # malformed input is treated like a forgery
            raise TokenError("bad signature") from e
        try:
            payload = json.loads(_unb64(p_b64))
        except (ValueError, UnicodeDecodeError) as e:
            raise TokenError("malformed payload") from e
        if payload.get("exp", 0) < time.time():
            raise TokenError("token expired")
        if payload.get("type") != expected_type:
            raise TokenError(f"wrong token type {payload.get('type')!r}")
        return payload

    def refresh_access_token(self, refresh_token: str) -> str:
        payload = self.verify_token(refresh_token, expected_type="refresh")
        user = self._users.get(payload["sub"])
        if user is None or not user.active:
            raise TokenError("unknown or inactive user")
        return self.create_access_token(user)

    # -- permissions (reference auth.py:181-192) --
    @staticmethod
    def get_role_permissions(role: Role) -> List[str]:
        return list(ROLE_PERMISSIONS.get(role, []))

    def has_permission(self, token: str, permission: str) -> bool:
        payload = self.verify_token(token)
        perms = ROLE_PERMISSIONS.get(Role(payload["role"]), [])
        return "*" in perms or permission in perms
