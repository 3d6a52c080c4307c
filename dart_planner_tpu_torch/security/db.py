"""Persistent user database + token-revocation store (PyTorch counterpart
of :mod:`dart_planner_tpu.security.db`).

Parity port of the reference user DB
(the reference's security/db/{models,service,database}.py):
a ``users`` table (username, salted password hash, role, active flag,
timestamps) and a ``revoked_tokens`` table keyed by JTI. The reference
uses SQLAlchemy + alembic migrations; this uses stdlib ``sqlite3`` with a
``schema_version`` table and in-code migration steps (same capability,
no ORM dependency). Password hashing matches
:meth:`~dart_planner_tpu_torch.security.auth.AuthManager.get_password_hash`.
"""

from __future__ import annotations

import sqlite3
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from dart_planner_tpu_torch.common.errors import SecurityError
from dart_planner_tpu_torch.security.auth import AuthManager, Role, User

# ordered migration steps (replaces alembic; reference migrations/)
_MIGRATIONS = [
    """
    CREATE TABLE users (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        username TEXT UNIQUE NOT NULL,
        hashed_password TEXT NOT NULL,
        role TEXT NOT NULL DEFAULT 'operator',
        is_active INTEGER NOT NULL DEFAULT 1,
        created_at REAL NOT NULL,
        updated_at REAL
    );
    """,
    """
    CREATE TABLE revoked_tokens (
        id INTEGER PRIMARY KEY AUTOINCREMENT,
        jti TEXT UNIQUE NOT NULL,
        user_id INTEGER NOT NULL REFERENCES users(id),
        revoked_at REAL NOT NULL
    );
    CREATE INDEX idx_revoked_jti ON revoked_tokens (jti);
    """,
]


class UserService:
    """User CRUD + revocation over sqlite (reference db/service.py:13-70)."""

    def __init__(self, db_path: str = "~/.dart_planner_tpu/users.db"):
        path = Path(db_path).expanduser()
        if str(db_path) != ":memory:":
            path.parent.mkdir(parents=True, exist_ok=True)
            self._conn = sqlite3.connect(str(path))
        else:
            self._conn = sqlite3.connect(":memory:")
        self._conn.row_factory = sqlite3.Row
        self._migrate()

    # -- schema migrations --------------------------------------------
    def _migrate(self) -> None:
        cur = self._conn.cursor()
        cur.execute(
            "CREATE TABLE IF NOT EXISTS schema_version (version INTEGER)"
        )
        row = cur.execute("SELECT version FROM schema_version").fetchone()
        version = row["version"] if row else 0
        if row is None:
            cur.execute("INSERT INTO schema_version VALUES (0)")
        for i, step in enumerate(_MIGRATIONS[version:], start=version + 1):
            cur.executescript(step)
            cur.execute("UPDATE schema_version SET version = ?", (i,))
        self._conn.commit()

    @property
    def schema_version(self) -> int:
        row = self._conn.execute("SELECT version FROM schema_version").fetchone()
        return int(row["version"])

    # -- users (service.py:20-57) -------------------------------------
    def create_user(self, username: str, password: str, role: Role) -> Dict[str, Any]:
        hashed = AuthManager.get_password_hash(password)
        try:
            cur = self._conn.execute(
                "INSERT INTO users (username, hashed_password, role, "
                "created_at) VALUES (?, ?, ?, ?)",
                (username, hashed, Role(role).value, time.time()),
            )
        except sqlite3.IntegrityError as exc:
            raise SecurityError(f"user {username!r} already exists") from exc
        self._conn.commit()
        return self.get_user(cur.lastrowid)

    def get_user(self, user_id: int) -> Optional[Dict[str, Any]]:
        row = self._conn.execute(
            "SELECT * FROM users WHERE id = ?", (user_id,)
        ).fetchone()
        return dict(row) if row else None

    def get_user_by_username(self, username: str) -> Optional[Dict[str, Any]]:
        row = self._conn.execute(
            "SELECT * FROM users WHERE username = ?", (username,)
        ).fetchone()
        return dict(row) if row else None

    def get_all_users(self, skip: int = 0, limit: int = 100) -> List[Dict[str, Any]]:
        rows = self._conn.execute(
            "SELECT * FROM users ORDER BY id LIMIT ? OFFSET ?", (limit, skip)
        ).fetchall()
        return [dict(r) for r in rows]

    def delete_user(self, user_id: int) -> bool:
        cur = self._conn.execute("DELETE FROM users WHERE id = ?", (user_id,))
        self._conn.commit()
        return cur.rowcount > 0

    def update_user_role(self, user_id: int, new_role: Role) -> Optional[Dict[str, Any]]:
        self._conn.execute(
            "UPDATE users SET role = ?, updated_at = ? WHERE id = ?",
            (Role(new_role).value, time.time(), user_id),
        )
        self._conn.commit()
        return self.get_user(user_id)

    def set_active(self, user_id: int, active: bool) -> None:
        self._conn.execute(
            "UPDATE users SET is_active = ?, updated_at = ? WHERE id = ?",
            (1 if active else 0, time.time(), user_id),
        )
        self._conn.commit()

    # -- auth integration ---------------------------------------------
    def authenticate(self, username: str, password: str) -> Optional[User]:
        """Verify credentials against the DB; returns an auth-layer User."""
        row = self.get_user_by_username(username)
        if row is None or not row["is_active"]:
            return None
        if not AuthManager.verify_password(password, row["hashed_password"]):
            return None
        return User(
            username=row["username"],
            password_hash=row["hashed_password"],
            role=Role(row["role"]),
        )

    # -- revocation (service.py:58-70) --------------------------------
    def revoke_token(self, jti: str, user_id: int) -> None:
        self._conn.execute(
            "INSERT OR IGNORE INTO revoked_tokens (jti, user_id, revoked_at) "
            "VALUES (?, ?, ?)",
            (jti, user_id, time.time()),
        )
        self._conn.commit()

    def is_token_revoked(self, jti: str) -> bool:
        row = self._conn.execute(
            "SELECT 1 FROM revoked_tokens WHERE jti = ?", (jti,)
        ).fetchone()
        return row is not None

    def close(self) -> None:
        self._conn.close()
