"""File integrity verification: checksum + HMAC records with TTL (PyTorch
counterpart of :mod:`dart_planner_tpu.security.file_verification`).

Parity analog of the reference's ``FileVerificationManager``
(the reference's security/file_verification.py:90-460,
"FV"): critical artifacts (configs, key stores, model files) get a
persisted SHA-256 checksum and an HMAC-SHA256 signature bound to a key
id, with optional expiry, bulk cleanup of expired records, and a status
summary. Verification re-hashes the file and compares in constant time;
metadata (size, mtime) is checked first as a cheap tamper tripwire
(FV:316-321).

Differences from the reference, by design:

- ONE record type (``FileRecord``) holds both the checksum and the HMAC
  instead of two parallel dicts keyed by path (FV:31-88) that can
  desynchronize. ``verify_file`` still reports the two results
  separately.
- no hardcoded fallback secret: the reference ships
  ``"default_file_verification_key_2025"`` when no key is configured
  (FV:118-120), making every default deployment's HMACs forgeable. Here
  the key comes from the ``DART_FILE_VERIFICATION_KEY`` env var, an
  explicit argument, or is *generated* (32 random bytes) and persisted
  owner-only next to the record store — never a published constant.
- record paths are stored resolved, so relative/absolute spellings of
  the same file share one record.

Standalone helpers ``compute_file_digest``/``verify_file_digest`` remain
for call sites that only need a one-shot digest check.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json

from dart_planner_tpu_torch.security import secure_files
import logging
import os
import secrets
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, Optional, Union

from dart_planner_tpu_torch.common.errors import SecurityError

logger = logging.getLogger(__name__)

# 100 MB cap, matching the reference (FV:28); hashing larger artifacts
# should be an explicit decision, not a DoS vector.
MAX_FILE_SIZE = 100 * 1024 * 1024
RECORDS_FILE = "file_verification.json"
KEY_FILE = "file_verification.key"


def compute_file_digest(path: Union[str, Path], chunk_size: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(chunk_size):
            h.update(chunk)
    return h.hexdigest()


def verify_file_digest(path: Union[str, Path], expected_hex: str) -> bool:
    """True iff the file hashes to ``expected_hex`` (constant-time)."""
    try:
        actual = compute_file_digest(path)
    except OSError as e:
        raise SecurityError(f"cannot read {path}: {e}") from e
    return hmac.compare_digest(actual, expected_hex.lower())


@dataclass
class FileRecord:
    """One file's verification record (FV:31-88, both halves merged)."""

    file_path: str
    checksum: str  # sha256 hex
    hmac_signature: str  # sha256 hex, keyed
    key_id: str
    file_size: int
    last_modified: float
    created_at: float
    expires_at: Optional[float] = None

    @property
    def expired(self) -> bool:
        return self.expires_at is not None and time.time() > self.expires_at


class FileVerificationManager:
    """Persisted checksum+HMAC records for critical files (FV:90-460).

    Records live in ``<verification_dir>/file_verification.json``
    (owner-only, atomic replace). The HMAC key is bound into every
    signature together with the record's ``key_id``
    (``HMAC(key, file_bytes || key_id)``, FV:183-199), so a signature
    cannot be replayed under a rotated key id.
    """

    def __init__(
        self,
        verification_dir: Union[str, Path, None] = None,
        secret_key: Union[str, bytes, None] = None,
        max_file_size: int = MAX_FILE_SIZE,
    ):
        self.verification_dir = Path(
            os.path.expanduser(
                str(verification_dir or "~/.dart_planner_tpu/verification")
            )
        )
        self.verification_dir.mkdir(parents=True, exist_ok=True)
        self.records_path = self.verification_dir / RECORDS_FILE
        self.max_file_size = max_file_size
        self._key = self._resolve_key(secret_key)
        self.records: Dict[str, FileRecord] = {}
        self._load()

    # -- key + store plumbing ------------------------------------------
    def _resolve_key(self, secret_key: Union[str, bytes, None]) -> bytes:
        if secret_key is not None:
            return (
                secret_key.encode()
                if isinstance(secret_key, str)
                else bytes(secret_key)
            )
        env = os.environ.get("DART_FILE_VERIFICATION_KEY")
        if env:
            return env.encode()
        # Generate-and-persist instead of the reference's hardcoded
        # default (FV:118-120): forgeable-by-construction defaults are
        # worse than no HMAC at all.
        key_path = self.verification_dir / KEY_FILE
        if key_path.exists():
            return base64.b64decode(key_path.read_text())
        key = secrets.token_bytes(32)
        secure_files.secure_write(key_path, base64.b64encode(key).decode())
        logger.warning(
            "no DART_FILE_VERIFICATION_KEY configured; generated a "
            "random HMAC key at %s",
            key_path,
        )
        return key

    def _load(self) -> None:
        if not self.records_path.exists():
            return
        try:
            raw = json.loads(self.records_path.read_text())
            self.records = {
                path: FileRecord(**rec)
                for path, rec in raw.get("records", {}).items()
            }
        except Exception as e:  # corrupt store: start empty, loudly
            logger.warning("failed to load verification data: %s", e)
            self.records = {}

    def _save(self) -> None:
        data = {
            "records": {p: asdict(r) for p, r in self.records.items()},
            "last_updated": time.time(),
        }
        secure_files.secure_json_write(self.records_path, data)

    def _canon(self, file_path: Union[str, Path]) -> Path:
        return Path(file_path).resolve()

    def _check_size(self, path: Path) -> None:
        if not path.exists():
            raise SecurityError(f"file does not exist: {path}")
        if path.stat().st_size > self.max_file_size:
            raise SecurityError(f"file too large for verification: {path}")

    def _compute_hmac(self, path: Path, key_id: str) -> str:
        """HMAC over file bytes with the key id mixed in (FV:183-199)."""
        self._check_size(path)
        mac = hmac.new(self._key, digestmod=hashlib.sha256)
        with open(path, "rb") as f:
            while chunk := f.read(1 << 20):
                mac.update(chunk)
        mac.update(key_id.encode())
        return mac.hexdigest()

    # -- public API (FV:206-460) ---------------------------------------
    def create_record(
        self,
        file_path: Union[str, Path],
        key_id: Optional[str] = None,
        expires_in: Optional[float] = None,
    ) -> FileRecord:
        """Checksum + HMAC the file and persist the record. ``expires_in``
        is seconds from now (the reference takes a timedelta, FV:207)."""
        path = self._canon(file_path)
        self._check_size(path)
        key_id = key_id or f"key_{secrets.token_hex(4)}"
        st = path.stat()
        now = time.time()
        rec = FileRecord(
            file_path=str(path),
            checksum=compute_file_digest(path),
            hmac_signature=self._compute_hmac(path, key_id),
            key_id=key_id,
            file_size=st.st_size,
            last_modified=st.st_mtime,
            created_at=now,
            expires_at=now + expires_in if expires_in else None,
        )
        self.records[str(path)] = rec
        self._save()
        logger.info("created verification record for %s", path)
        return rec

    def _verify(self, file_path: Union[str, Path], what: str) -> bool:
        path = self._canon(file_path)
        rec = self.records.get(str(path))
        if rec is None:
            logger.warning("no verification record for %s", path)
            return False
        if rec.expired:
            logger.warning("verification record expired for %s", path)
            return False
        if not path.exists():
            return False
        st = path.stat()
        if st.st_size != rec.file_size or st.st_mtime != rec.last_modified:
            # cheap tripwire before hashing (FV:316-321); a legitimate
            # rewrite needs a fresh create_record anyway
            logger.warning("file metadata changed for %s", path)
            return False
        if what == "checksum":
            return hmac.compare_digest(compute_file_digest(path), rec.checksum)
        return hmac.compare_digest(
            self._compute_hmac(path, rec.key_id), rec.hmac_signature
        )

    def verify_checksum(self, file_path: Union[str, Path]) -> bool:
        """(FV:287-327)"""
        return self._verify(file_path, "checksum")

    def verify_hmac(self, file_path: Union[str, Path]) -> bool:
        """(FV:329-369)"""
        return self._verify(file_path, "hmac")

    def verify_file(self, file_path: Union[str, Path]) -> Dict[str, bool]:
        """Both checks + existence (FV:371-387)."""
        path = self._canon(file_path)
        return {
            "checksum_valid": self.verify_checksum(path),
            "hmac_valid": self.verify_hmac(path),
            "file_exists": path.exists(),
        }

    def remove_record(self, file_path: Union[str, Path]) -> bool:
        path = str(self._canon(file_path))
        if path in self.records:
            del self.records[path]
            self._save()
            return True
        return False

    def cleanup_expired(self) -> int:
        """Drop expired records; returns how many (FV:389-421)."""
        expired = [p for p, r in self.records.items() if r.expired]
        for p in expired:
            del self.records[p]
        if expired:
            self._save()
            logger.info("cleaned up %d expired records", len(expired))
        return len(expired)

    def get_verification_status(self) -> Dict[str, object]:
        """Store-level summary (FV:423-460)."""
        active = sum(1 for r in self.records.values() if not r.expired)
        return {
            "total_records": len(self.records),
            "active_records": active,
            "expired_records": len(self.records) - active,
            "verification_file": str(self.records_path),
            "last_updated": time.time(),
        }


def create_file_verification(
    file_path: Union[str, Path],
    secret_key: Union[str, bytes, None] = None,
    expires_in: Optional[float] = None,
    verification_dir: Union[str, Path, None] = None,
) -> FileRecord:
    """One-shot record creation (FV:465-483)."""
    mgr = FileVerificationManager(
        verification_dir=verification_dir, secret_key=secret_key
    )
    return mgr.create_record(file_path, expires_in=expires_in)


def verify_file_integrity(
    file_path: Union[str, Path],
    secret_key: Union[str, bytes, None] = None,
    verification_dir: Union[str, Path, None] = None,
) -> Dict[str, bool]:
    """One-shot verification (FV:486-499)."""
    mgr = FileVerificationManager(
        verification_dir=verification_dir, secret_key=secret_key
    )
    return mgr.verify_file(file_path)
