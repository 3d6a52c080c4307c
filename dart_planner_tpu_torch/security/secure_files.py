"""Secure file operations for sensitive material (PyTorch counterpart
of :mod:`dart_planner_tpu.security.secure_files`).

Parity rebuild of the reference's secure-file toolkit
(the reference's security/secure_file_utils.py:1-383):
symlink/path validation, owner-only permissions enforced from the first
byte, atomic writes, JSON convenience wrappers, and a posture report —
centralized so the key store, credential store, and file-verification
store share ONE audited implementation instead of three hand-rolled
copies.

Threat model notes baked into the behavior:

- writes go through a same-directory temp file opened 0600 at creation
  (secrets must never transit a default-umask file, even briefly) and
  land with an atomic ``os.replace`` — a crash leaves either the old
  file or the new one, never a torn or world-readable intermediate;
- symlinks are refused at the DESTINATION path (a hostile link planted
  at the expected location must not redirect key material), matching
  the reference's validate_path_security.
"""

from __future__ import annotations

import json
import os
import stat
from pathlib import Path
from typing import Any, Union

from dart_planner_tpu_torch.common.errors import SecurityError

PathLike = Union[str, Path]

OWNER_RW = 0o600
OWNER_RWX = 0o700
_GROUP_OTHER = stat.S_IRWXG | stat.S_IRWXO


def validate_path_security(path: PathLike) -> Path:
    """Refuse symlinked destinations; returns the resolved Path.

    (reference secure_file_utils.py:23-55) Checks the final component
    AND every existing ancestor — a symlinked parent directory
    redirects writes just as effectively as a symlinked file."""
    p = Path(path)
    probe = p
    while True:
        if probe.is_symlink():
            raise SecurityError(f"refusing symlinked path: {probe}")
        if probe == probe.parent:
            break
        probe = probe.parent
    return p


def set_secure_permissions(path: PathLike, mode: int = OWNER_RW) -> None:
    """(reference secure_file_utils.py:58-86)"""
    os.chmod(path, mode)


def create_secure_directory(path: PathLike, mode: int = OWNER_RWX) -> Path:
    """mkdir -p with owner-only permissions on every newly-created level
    (reference secure_file_utils.py:89-115)."""
    p = validate_path_security(path)
    missing = []
    probe = p
    while not probe.exists() and probe != probe.parent:
        missing.append(probe)
        probe = probe.parent
    p.mkdir(parents=True, exist_ok=True)
    for d in missing:
        os.chmod(d, mode)
    return p


def secure_write(path: PathLike, data: Union[str, bytes],
                 mode: int = OWNER_RW) -> Path:
    """Atomic owner-only write (reference secure_file_utils.py:118-159
    + :228-262; one function serves text and binary)."""
    p = validate_path_security(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data.encode() if isinstance(data, str) else data)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, p)
    os.chmod(p, mode)
    return p


def secure_read(path: PathLike, *, binary: bool = False,
                require_owner_only: bool = True) -> Union[str, bytes]:
    """Read after validating the file is not a symlink and (by default)
    not group/other-accessible (reference secure_file_utils.py:161-187).
    """
    p = validate_path_security(path)
    st = p.stat()
    if require_owner_only and (st.st_mode & _GROUP_OTHER):
        raise SecurityError(
            f"{p} is group/other-accessible "
            f"(mode {stat.filemode(st.st_mode)})"
        )
    return p.read_bytes() if binary else p.read_text()


def secure_json_write(path: PathLike, obj: Any, **dump_kwargs) -> Path:
    """(reference secure_file_utils.py:189-207)"""
    return secure_write(path, json.dumps(obj, **dump_kwargs))


def secure_json_read(path: PathLike, **read_kwargs) -> Any:
    """(reference secure_file_utils.py:210-226)"""
    return json.loads(secure_read(path, **read_kwargs))


def check_file_security(path: PathLike) -> dict:
    """Posture report for audits (reference secure_file_utils.py:287-349).
    """
    p = Path(path)
    report = {
        "path": str(p),
        "exists": p.exists(),
        "is_symlink": p.is_symlink(),
        "owner_only": False,
        "mode": None,
        "issues": [],
    }
    if p.is_symlink():
        report["issues"].append("path is a symlink")
    if not p.exists():
        report["issues"].append("file does not exist")
        return report
    st = p.stat()
    report["mode"] = stat.filemode(st.st_mode)
    report["owner_only"] = not (st.st_mode & _GROUP_OTHER)
    if not report["owner_only"]:
        report["issues"].append("group/other access bits set")
    if st.st_uid != os.getuid():
        report["issues"].append("not owned by the current user")
    return report
