"""The port's keys, credentials and secure files on the CPU
(dart_planner_tpu_torch/security/: key_derivation, key_manager,
credentials, credential_helpers, os_keyring, secure_files,
file_verification).

The key and credential cases of tests/test_security_gateway_airframe.py,
tests/test_os_keyring.py, tests/test_secure_files.py, the credential-helper
cases of tests/test_credential_helpers_mixing.py and the file-verification
cases of tests/test_security_validation.py run against the port. Held
against the JAX package:

- key derivation: the same passphrase and salt give the same key
  (PBKDF2 and scrypt), exactly;
- ``key_manager``'s HMAC tokens: on one keystore, with the clock and the
  token id (``secrets.token_hex``) fixed, the two packages mint the same
  bytes, and each verifies and revokes the other's;
- a keystore, an encrypted credential file (with its helpers' records), a
  keyring file store and a file-verification record written by one
  package are read by the other, both ways.

``get_key_manager`` and ``get_keyring_manager`` keep a process-wide
singleton in each package: both packages' are reset around every test.
"""

import json
import os
import secrets
import stat
import time

import pytest

from dart_planner_tpu.common.errors import SecurityError as JSecurityError
from dart_planner_tpu.security import credential_helpers as J_ch
from dart_planner_tpu.security import credentials as J_cred
from dart_planner_tpu.security import file_verification as J_fv
from dart_planner_tpu.security import key_derivation as J_kd
from dart_planner_tpu.security import key_manager as J_km
from dart_planner_tpu.security import os_keyring as J_ok
from dart_planner_tpu_torch.common.errors import SecurityError
from dart_planner_tpu_torch.security import credential_helpers as ch
from dart_planner_tpu_torch.security import key_manager as T_km
from dart_planner_tpu_torch.security import os_keyring
from dart_planner_tpu_torch.security import secure_files as sf
from dart_planner_tpu_torch.security.credentials import SecureCredentialManager
from dart_planner_tpu_torch.security.file_verification import FileVerificationManager
from dart_planner_tpu_torch.security.key_derivation import (
    KeyDerivationError,
    OSKeyStoreError,
    derive_key_from_os_keystore,
    derive_key_from_passphrase,
    derive_key_from_scrypt,
    generate_secure_key,
    validate_key_strength,
)
from dart_planner_tpu_torch.security.key_manager import SecureKeyManager


@pytest.fixture(autouse=True)
def _fresh_singletons():
    """Both packages' key-manager and keyring singletons, unset around each
    test."""
    for mod in (J_km, T_km):
        mod.set_key_manager(None)
    for mod in (J_ok, os_keyring):
        mod.set_keyring_manager(None)
    yield
    for mod in (J_km, T_km):
        mod.set_key_manager(None)
    for mod in (J_ok, os_keyring):
        mod.set_keyring_manager(None)


# -- key derivation ---------------------------------------------------

def test_derivation_deterministic_per_salt():
    k1, salt = derive_key_from_passphrase("hunter2-but-long")
    k2, _ = derive_key_from_passphrase("hunter2-but-long", salt)
    k3, _ = derive_key_from_passphrase("different", salt)
    assert k1 == k2 and k1 != k3 and len(k1) == 32
    s1, salt_s = derive_key_from_scrypt("hunter2-but-long")
    s2, _ = derive_key_from_scrypt("hunter2-but-long", salt_s)
    assert s1 == s2 and s1 != k1
    with pytest.raises(KeyDerivationError):
        derive_key_from_passphrase("")
    with pytest.raises(OSKeyStoreError):
        derive_key_from_os_keystore("main")


def test_key_strength():
    assert validate_key_strength(generate_secure_key())
    assert not validate_key_strength(b"short")
    assert not validate_key_strength(b"\x00" * 32)
    assert not validate_key_strength(b"abcd" * 8)  # repetitive


def test_derivation_matches_jax():
    salt = bytes(range(16))
    for port_fn, jax_fn in ((derive_key_from_passphrase, J_kd.derive_key_from_passphrase),
                            (derive_key_from_scrypt, J_kd.derive_key_from_scrypt)):
        assert port_fn("correct horse", salt) == jax_fn("correct horse", salt)
    for key in (generate_secure_key(), b"short", b"\x00" * 32, b"abcd" * 8, bytes(range(40))):
        assert validate_key_strength(key) == J_kd.validate_key_strength(key)


# -- key manager ------------------------------------------------------

@pytest.fixture
def km(tmp_path):
    return SecureKeyManager(str(tmp_path / "keys.json"))


def test_key_manager_token_roundtrip(km):
    tok = km.create_hmac_token({"sub": "alice"}, ttl_s=60)
    body = km.verify_hmac_token(tok)
    assert body["sub"] == "alice"
    with pytest.raises(SecurityError):
        km.verify_hmac_token(tok[:-2] + "ff")  # tampered signature
    with pytest.raises(SecurityError):
        km.verify_hmac_token("garbage")


def test_key_manager_rotation_grace(km):
    tok = km.create_hmac_token({"sub": "a"}, ttl_s=60)
    old_kid = km.verify_hmac_token(tok)["kid"]
    km.rotate_keys()
    # old token still verifies inside the grace window
    assert km.verify_hmac_token(tok)["kid"] == old_kid
    new_tok = km.create_hmac_token({"sub": "b"}, ttl_s=60)
    assert km.verify_hmac_token(new_tok)["kid"] != old_kid
    stats = km.get_key_stats()
    assert stats["active_keys"] == 1 and stats["retired_keys"] == 1
    # expire the grace window -> old key cleaned up, token rejected
    km._keys[old_kid].retired_at = time.time() - km.grace_period_s - 1
    assert km.cleanup_expired_keys() == 1
    with pytest.raises(SecurityError):
        km.verify_hmac_token(tok)


def test_key_manager_revocation_and_persistence(km, tmp_path):
    tok = km.create_hmac_token({"sub": "a"}, ttl_s=60)
    jti = km.verify_hmac_token(tok)["jti"]
    km.revoke_token(jti)
    with pytest.raises(SecurityError):
        km.verify_hmac_token(tok)
    # a second manager over the same file sees keys + revocations
    km2 = SecureKeyManager(str(tmp_path / "keys.json"))
    with pytest.raises(SecurityError):
        km2.verify_hmac_token(tok)
    ok = km2.check_security()
    assert ok["ok"], ok["issues"]


def test_key_manager_expired_token(km):
    tok = km.create_hmac_token({"sub": "a"}, ttl_s=-1)
    with pytest.raises(SecurityError):
        km.verify_hmac_token(tok)


def test_keystore_tmp_never_world_readable(tmp_path, monkeypatch):
    """Secrets must be 0600 from the first byte, including the temp file."""
    seen_modes = []
    real_open = os.open

    def spy_open(path, flags, mode=0o777):
        if str(path).endswith(".tmp"):
            seen_modes.append(mode)
        return real_open(path, flags, mode)

    monkeypatch.setattr(os, "open", spy_open)
    km = SecureKeyManager(str(tmp_path / "keys.json"))
    km.rotate_keys()
    assert seen_modes and all(m == 0o600 for m in seen_modes)


def test_global_key_managers_are_separate_per_package(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    port = T_km.get_key_manager()
    assert port is T_km.get_key_manager()
    assert str(port.path).startswith(str(tmp_path))
    mine = SecureKeyManager(str(tmp_path / "mine.json"))
    T_km.set_key_manager(mine)
    assert T_km.get_key_manager() is mine
    assert J_km._global_manager is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hmac_tokens_same_bytes_and_cross_verify(tmp_path, monkeypatch, writer):
    """One keystore written by ``writer``; the clock and the token id
    fixed: both packages mint the same token, each verifies the other's,
    and a revocation by either reaches the other through the file."""
    path = str(tmp_path / "keys.json")
    make = {"port": SecureKeyManager, "jax": J_km.SecureKeyManager}
    reader = "jax" if writer == "port" else "port"
    w = make[writer](path)
    r = make[reader](path)
    assert {k: vars(v) for k, v in w._keys.items()} == {k: vars(v) for k, v in r._keys.items()}
    monkeypatch.setattr(time, "time", lambda: 1_760_000_123.5)
    monkeypatch.setattr(secrets, "token_hex", lambda n=32: "0f" * n)
    a = w.create_hmac_token({"sub": "alice", "role": "pilot"}, ttl_s=90)
    b = r.create_hmac_token({"sub": "alice", "role": "pilot"}, ttl_s=90)
    assert a == b
    assert w.verify_hmac_token(b) == r.verify_hmac_token(a)
    r.revoke_token(r.verify_hmac_token(a)["jti"])
    w.load_keys()
    with pytest.raises((SecurityError, JSecurityError), match="revoked"):
        w.verify_hmac_token(a)


# -- credential manager ----------------------------------------------

def test_credentials_roundtrip(tmp_path):
    path = str(tmp_path / "creds.enc")
    cm = SecureCredentialManager(path, passphrase="pass-phrase-1")
    cm.store_credential("api", "s3cr3t", "api_key")
    cm.store_credential("stale", "x", expires_in_days=-1.0)
    assert cm.get_credential("api") == "s3cr3t"
    assert cm.get_credential("stale") is None  # expired
    assert cm.get_credential_info("api")["credential_type"] == "api_key"
    # reload with the right passphrase
    cm2 = SecureCredentialManager(path, passphrase="pass-phrase-1")
    assert cm2.get_credential("api") == "s3cr3t"
    assert cm2.cleanup_expired() == 1
    # wrong passphrase fails closed
    with pytest.raises(SecurityError):
        SecureCredentialManager(path, passphrase="wrong")
    assert cm2.remove_credential("api")
    assert cm2.list_credentials() == []


def test_credentials_require_passphrase(tmp_path, monkeypatch):
    monkeypatch.delenv("DART_CREDENTIALS_KEY", raising=False)
    with pytest.raises(SecurityError):
        SecureCredentialManager(str(tmp_path / "c.enc"))


@pytest.fixture
def mgr(tmp_path):
    return SecureCredentialManager(
        credentials_file=str(tmp_path / "creds.enc"), passphrase="test-pass-12345"
    )


def test_mavlink_and_api_roundtrip(mgr):
    assert ch.get_mavlink_credentials(mgr) is None
    ch.store_mavlink_credentials(mgr, "gcs", "hunter2")
    assert ch.get_mavlink_credentials(mgr) == ("gcs", "hunter2")

    ch.store_api_credentials(mgr, "weather", "KEY", "SECRET")
    assert ch.get_api_credentials(mgr, "weather") == ("KEY", "SECRET")
    assert ch.get_api_credentials(mgr, "missing") is None
    assert ch.rotate_api_credentials(mgr, "weather", "KEY2")
    assert ch.get_api_credentials(mgr, "weather") == ("KEY2", None)
    assert not ch.rotate_api_credentials(mgr, "never-stored", "x")


def test_database_and_jwt_helpers(mgr):
    ch.store_database_credentials(mgr, "flightlog", "app", "pw", host="db.local", port=5433)
    assert ch.get_database_credentials(mgr, "flightlog") == ("app", "pw", "db.local", 5433)
    secret = ch.store_jwt_credentials(mgr)
    got = ch.get_jwt_credentials(mgr)
    assert got == (secret, "HS256") and len(secret) > 30


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_credential_file_crosses_between_packages(tmp_path, writer):
    """An encrypted store (and its salt) written by one package, with the
    helpers' records, is read and extended by the other."""
    path = str(tmp_path / "creds.enc")
    pkgs = {"port": (SecureCredentialManager, ch), "jax": (J_cred.SecureCredentialManager, J_ch)}
    reader = "jax" if writer == "port" else "port"
    W, wh = pkgs[writer]
    R, rh = pkgs[reader]
    w = W(path, passphrase="pass-phrase-1")
    w.store_credential("api", "s3cr3t", "api_key", expires_in_days=30.0)
    wh.store_mavlink_credentials(w, "gcs", "hunter2")
    wh.store_database_credentials(w, "flightlog", "app", "pw", host="db.local", port=5433)
    jwt = wh.store_jwt_credentials(w)
    r = R(path, passphrase="pass-phrase-1")
    assert r.list_credentials() == w.list_credentials()
    assert r.get_credential("api") == "s3cr3t"
    assert r.get_credential_info("api")["expires_at"] == w.get_credential_info("api")["expires_at"]
    assert rh.get_mavlink_credentials(r) == ("gcs", "hunter2")
    assert rh.get_database_credentials(r, "flightlog") == ("app", "pw", "db.local", 5433)
    assert rh.get_jwt_credentials(r) == (jwt, "HS256")
    rh.store_api_credentials(r, "weather", "KEY", "SECRET")
    assert wh.get_api_credentials(W(path, passphrase="pass-phrase-1"), "weather") == \
        ("KEY", "SECRET")
    with pytest.raises((SecurityError, JSecurityError), match="passphrase"):
        R(path, passphrase="wrong")


# -- OS keyring (the file fallback) ------------------------------------

@pytest.fixture
def ring(tmp_path):
    return os_keyring.OSKeyringManager(
        fallback_path=str(tmp_path / "ring.json"), prefer_os_keyring=False
    )


def test_store_retrieve_roundtrip(ring):
    kid = ring.store_key(b"\x00\x01secret", os_keyring.KeyType.HMAC)
    assert ring.retrieve_key(kid, os_keyring.KeyType.HMAC) == b"\x00\x01secret"
    # wrong type namespace -> miss
    assert ring.retrieve_key(kid, os_keyring.KeyType.JWT) is None


def test_empty_key_rejected(ring):
    with pytest.raises(SecurityError):
        ring.store_key(b"", os_keyring.KeyType.KEK)


def test_usage_count_and_metadata(ring):
    kid = ring.store_key(b"k", os_keyring.KeyType.API, rotation_policy="30d")
    ring.retrieve_key(kid, os_keyring.KeyType.API)
    ring.retrieve_key(kid, os_keyring.KeyType.API)
    meta = ring.list_keys(os_keyring.KeyType.API)[kid]
    assert meta.usage_count == 2
    assert meta.rotation_policy == "30d"
    assert meta.key_type == os_keyring.KeyType.API


def test_expiry(ring):
    kid = ring.store_key(b"short-lived", os_keyring.KeyType.DEK, expires_at=time.time() - 1)
    assert ring.retrieve_key(kid, os_keyring.KeyType.DEK) is None


def test_delete_and_list(ring):
    k1 = ring.store_key(b"a", os_keyring.KeyType.JWT)
    k2 = ring.store_key(b"b", os_keyring.KeyType.JWT)
    assert set(ring.list_keys(os_keyring.KeyType.JWT)) == {k1, k2}
    assert ring.delete_key(k1, os_keyring.KeyType.JWT)
    assert not ring.delete_key(k1, os_keyring.KeyType.JWT)  # already gone
    assert set(ring.list_keys(os_keyring.KeyType.JWT)) == {k2}


def test_rotate_key(ring):
    kid = ring.store_key(b"old", os_keyring.KeyType.KEK)
    new_id = ring.rotate_key(kid, os_keyring.KeyType.KEK, b"new")
    assert new_id != kid
    assert ring.retrieve_key(kid, os_keyring.KeyType.KEK) is None
    assert ring.retrieve_key(new_id, os_keyring.KeyType.KEK) == b"new"
    with pytest.raises(SecurityError):
        ring.rotate_key("nope", os_keyring.KeyType.KEK, b"x")


def test_validate_key_access(ring):
    assert ring.validate_key_access()
    assert ring.list_keys("probe") == {}  # probe cleaned up


def test_fallback_file_is_owner_only(ring, tmp_path):
    ring.store_key(b"k", os_keyring.KeyType.HMAC)
    mode = stat.S_IMODE(os.stat(tmp_path / "ring.json").st_mode)
    assert mode == 0o600


def test_backend_reports_file_when_keyring_absent(ring):
    assert ring.backend_name == "file"


def test_require_os_keyring_raises_when_unavailable(tmp_path):
    # keyring is not installed here: the strict mode must fail closed
    with pytest.raises(SecurityError):
        os_keyring.OSKeyringManager(
            fallback_path=str(tmp_path / "ring.json"), require_os_keyring=True
        )


@pytest.fixture
def keyring_caplog(caplog):
    """caplog wired directly to the module logger (the package's logging
    config may stop propagation to the root logger)."""
    import logging

    logger = logging.getLogger(os_keyring.__name__)
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger=os_keyring.__name__):
            yield caplog
    finally:
        logger.removeHandler(caplog.handler)


def test_fallback_emits_warning(tmp_path, keyring_caplog):
    os_keyring.OSKeyringManager(fallback_path=str(tmp_path / "ring.json"))
    assert any("falling back" in r.message for r in keyring_caplog.records)


def test_explicit_file_backend_is_silent(tmp_path, keyring_caplog):
    os_keyring.OSKeyringManager(fallback_path=str(tmp_path / "ring.json"),
                                prefer_os_keyring=False)
    assert not keyring_caplog.records


def _store_keys(path, tag, n):
    m = os_keyring.OSKeyringManager(fallback_path=path, prefer_os_keyring=False)
    for i in range(n):
        m.store_key(f"{tag}-{i}".encode(), os_keyring.KeyType.API, key_id=f"{tag}-{i}")


def test_file_store_concurrent_writers_lose_nothing(tmp_path):
    """Two processes hammering the same store: flock serializes the
    read-modify-write cycles, so every stored key must survive."""
    import multiprocessing as mp

    path = str(tmp_path / "ring.json")
    procs = [mp.Process(target=_store_keys, args=(path, t, 20)) for t in ("a", "b")]
    for p in procs:
        p.start()
    for p in procs:
        p.join(60)
        assert p.exitcode == 0
    m = os_keyring.OSKeyringManager(fallback_path=path, prefer_os_keyring=False)
    assert len(m.list_keys(os_keyring.KeyType.API)) == 40


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_keyring_file_store_crosses_between_packages(tmp_path, writer):
    path = str(tmp_path / "ring.json")
    make = {"port": lambda: os_keyring.OSKeyringManager(fallback_path=path,
                                                        prefer_os_keyring=False),
            "jax": lambda: J_ok.OSKeyringManager(fallback_path=path, prefer_os_keyring=False)}
    reader = "jax" if writer == "port" else "port"
    w, r = make[writer](), make[reader]()
    kid = w.store_key(b"\x00kek-bytes", "kek", rotation_policy="90d")
    assert r.retrieve_key(kid, "kek") == b"\x00kek-bytes"
    assert w.list_keys("kek")[kid].usage_count == 1
    new = r.rotate_key(kid, "kek", b"rotated")
    assert w.retrieve_key(new, "kek") == b"rotated" and w.retrieve_key(kid, "kek") is None
    assert os_keyring.SERVICE_NAME == J_ok.SERVICE_NAME


# -- secure files ----------------------------------------------------

def test_secure_write_is_owner_only_and_atomic(tmp_path):
    p = tmp_path / "keys" / "store.json"
    sf.secure_write(p, "secret")
    assert p.read_text() == "secret"
    assert stat.S_IMODE(p.stat().st_mode) == 0o600
    assert not (tmp_path / "keys" / "store.json.tmp").exists()
    # overwrite keeps permissions and replaces content atomically
    sf.secure_write(p, b"v2")
    assert p.read_bytes() == b"v2"
    assert stat.S_IMODE(p.stat().st_mode) == 0o600


def test_symlink_destinations_refused(tmp_path):
    target = tmp_path / "elsewhere.txt"
    target.write_text("x")
    link = tmp_path / "link.txt"
    link.symlink_to(target)
    with pytest.raises(SecurityError):
        sf.secure_write(link, "hijack")
    with pytest.raises(SecurityError):
        sf.secure_read(link)
    # symlinked PARENT directory is refused too
    realdir = tmp_path / "real"
    realdir.mkdir()
    dirlink = tmp_path / "dlink"
    dirlink.symlink_to(realdir)
    with pytest.raises(SecurityError):
        sf.secure_write(dirlink / "f.txt", "hijack")


def test_secure_read_rejects_loose_permissions(tmp_path):
    p = tmp_path / "loose.txt"
    p.write_text("data")
    os.chmod(p, 0o644)
    with pytest.raises(SecurityError):
        sf.secure_read(p)
    assert sf.secure_read(p, require_owner_only=False) == "data"
    os.chmod(p, 0o600)
    assert sf.secure_read(p) == "data"


def test_json_roundtrip_and_directory(tmp_path):
    d = sf.create_secure_directory(tmp_path / "a" / "b")
    assert stat.S_IMODE(d.stat().st_mode) == 0o700
    assert stat.S_IMODE((tmp_path / "a").stat().st_mode) == 0o700
    p = d / "data.json"
    sf.secure_json_write(p, {"k": [1, 2]})
    assert sf.secure_json_read(p) == {"k": [1, 2]}


def test_check_file_security_report(tmp_path):
    p = tmp_path / "f.bin"
    sf.secure_write(p, b"\x00")
    rep = sf.check_file_security(p)
    assert rep["owner_only"] and rep["issues"] == []
    os.chmod(p, 0o666)
    rep = sf.check_file_security(p)
    assert not rep["owner_only"]
    assert any("group/other" in i for i in rep["issues"])
    rep = sf.check_file_security(tmp_path / "missing")
    assert "file does not exist" in rep["issues"]


def test_failed_write_leaves_no_droppings(tmp_path):
    p = tmp_path / "f.txt"

    class Boom(str):
        def encode(self, *a, **k):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        sf.secure_write(p, Boom("x"))
    assert list(tmp_path.iterdir()) == []


# -- file verification -------------------------------------------------

@pytest.fixture
def fvm(tmp_path):
    return FileVerificationManager(verification_dir=tmp_path / "verif", secret_key=b"test-key")


def test_create_and_verify_roundtrip(fvm, tmp_path):
    f = tmp_path / "artifact.yaml"
    f.write_text("gains: [7, 7, 8.5]\n")
    rec = fvm.create_record(f, key_id="kid-1")
    assert rec.key_id == "kid-1"
    out = fvm.verify_file(f)
    assert out == {"checksum_valid": True, "hmac_valid": True, "file_exists": True}


def test_tamper_detected(fvm, tmp_path):
    f = tmp_path / "artifact.yaml"
    f.write_text("gains: [7, 7, 8.5]\n")
    fvm.create_record(f)
    time.sleep(0.01)
    f.write_text("gains: [700, 7, 8.5]\n")
    out = fvm.verify_file(f)
    assert not out["checksum_valid"] and not out["hmac_valid"]


def test_key_id_binding(fvm, tmp_path):
    """Same file, different key ids -> different HMAC signatures."""
    f = tmp_path / "a.bin"
    f.write_bytes(b"payload")
    sig1 = fvm.create_record(f, key_id="k1").hmac_signature
    sig2 = fvm.create_record(f, key_id="k2").hmac_signature
    assert sig1 != sig2


def test_wrong_key_fails(tmp_path):
    f = tmp_path / "a.bin"
    f.write_bytes(b"payload")
    m1 = FileVerificationManager(verification_dir=tmp_path / "v", secret_key=b"key-A")
    m1.create_record(f)
    m2 = FileVerificationManager(verification_dir=tmp_path / "v", secret_key=b"key-B")
    assert m2.verify_checksum(f)  # checksum is keyless
    assert not m2.verify_hmac(f)  # HMAC is not


def test_ttl_and_cleanup(fvm, tmp_path):
    f = tmp_path / "a.bin"
    f.write_bytes(b"payload")
    fvm.create_record(f, expires_in=-1.0)  # already expired
    assert not fvm.verify_checksum(f)
    status = fvm.get_verification_status()
    assert status["expired_records"] == 1
    assert fvm.cleanup_expired() == 1
    assert fvm.get_verification_status()["total_records"] == 0


def test_persistence_across_instances(tmp_path):
    f = tmp_path / "a.bin"
    f.write_bytes(b"payload")
    FileVerificationManager(verification_dir=tmp_path / "v", secret_key=b"k").create_record(f)
    m2 = FileVerificationManager(verification_dir=tmp_path / "v", secret_key=b"k")
    assert m2.verify_file(f)["hmac_valid"]


def test_store_is_owner_only(fvm, tmp_path):
    f = tmp_path / "a.bin"
    f.write_bytes(b"x")
    fvm.create_record(f)
    assert stat.S_IMODE(os.stat(fvm.records_path).st_mode) == 0o600


def test_generated_key_persisted_not_hardcoded(tmp_path, monkeypatch):
    monkeypatch.delenv("DART_FILE_VERIFICATION_KEY", raising=False)
    m1 = FileVerificationManager(verification_dir=tmp_path / "v")
    m2 = FileVerificationManager(verification_dir=tmp_path / "v")
    assert m1._key == m2._key
    assert len(m1._key) == 32
    m3 = FileVerificationManager(verification_dir=tmp_path / "other")
    assert m3._key != m1._key


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_verification_records_cross_between_packages(tmp_path, monkeypatch, writer):
    """A record store (and its generated key) written by one package is
    read by the other: the same record, both checks pass, a tamper fails
    both; the HMAC of the same file and key id is the same hex."""
    monkeypatch.delenv("DART_FILE_VERIFICATION_KEY", raising=False)
    make = {"port": FileVerificationManager, "jax": J_fv.FileVerificationManager}
    reader = "jax" if writer == "port" else "port"
    f = tmp_path / "artifact.yaml"
    f.write_text("gains: [7, 7, 8.5]\n")
    w = make[writer](verification_dir=tmp_path / "v")
    rec = w.create_record(f, key_id="kid-1", expires_in=3600.0)
    r = make[reader](verification_dir=tmp_path / "v")
    assert vars(r.records[str(f.resolve())]) == vars(rec)
    assert r.verify_file(f) == {"checksum_valid": True, "hmac_valid": True, "file_exists": True}
    assert r._compute_hmac(f.resolve(), "kid-1") == rec.hmac_signature
    time.sleep(0.01)
    f.write_text("gains: [700, 7, 8.5]\n")
    assert not any(r.verify_file(f)[k] for k in ("checksum_valid", "hmac_valid"))
    data = json.loads((tmp_path / "v" / "file_verification.json").read_text())
    assert set(data) == {"records", "last_updated"}
