"""The port's authentication, permissions, rate limiter, user database and
process loop on the CPU (dart_planner_tpu_torch/security/, runtime/).

The security and process-loop cases of tests/test_security_di.py, and
tests/test_permissions.py and tests/test_user_db.py, run against the port.
Held against the JAX package:

- tokens: one RSA key, a fixed clock; the two packages' access and
  refresh tokens are the same bytes, and each verifies the other's;
- password hashes made by either package verify in the other, and a
  wrong password fails in both;
- the permission matrices (typed and legacy) are equal, role by role;
- the rate limiters give the same decision sequence (allowed, reason and
  status) under the same patched clock;
- a sqlite user database written by either package is read, authenticated
  against and revoked into by the other; the schema versions agree.

The global rate limiter behind ``check_login_rate_limit`` is a singleton in
each package: both are reset around every test.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dart_planner_tpu.security import auth as J_auth
from dart_planner_tpu.security import db as J_db
from dart_planner_tpu.security import permissions as J_perms
from dart_planner_tpu.security import rate_limiter as J_rl
from dart_planner_tpu_torch.common.errors import SecurityError, ValidationError
from dart_planner_tpu_torch.runtime.multiprocess_loop import ProcessControlLoop
from dart_planner_tpu_torch.security import (
    AuthManager,
    RateLimitConfig,
    RateLimiter,
    Role,
    TokenError,
    compute_file_digest,
    generate_rsa_keypair,
    manage_users,
    validate_position,
    validate_waypoints,
    verify_file_digest,
)
from dart_planner_tpu_torch.security import permissions as perms
from dart_planner_tpu_torch.security import rate_limiter as T_rl
from dart_planner_tpu_torch.security.db import UserService

P = perms.Permission
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_global_limiters():
    """Each package's ``check_login_rate_limit`` limiter, new for each test."""
    J_rl._default, T_rl._default = J_rl.RateLimiter(), T_rl.RateLimiter()
    yield
    J_rl._default, T_rl._default = J_rl.RateLimiter(), T_rl.RateLimiter()


# ---- auth ----
@pytest.fixture(scope="module")
def keys():
    return generate_rsa_keypair()


@pytest.fixture(scope="module")
def auth(keys):
    a = AuthManager(*keys)
    a.register_user("op", "hunter2-secure", Role.OPERATOR)
    a.register_user("viewer", "look-only", Role.VIEWER)
    return a


def test_password_hash_roundtrip(auth):
    assert auth.authenticate("op", "hunter2-secure") is not None
    assert auth.authenticate("op", "wrong") is None
    assert auth.authenticate("ghost", "x") is None


def test_token_lifecycle(auth):
    user = auth.authenticate("op", "hunter2-secure")
    token = auth.create_access_token(user)
    payload = auth.verify_token(token)
    assert payload["sub"] == "op" and payload["role"] == "operator"
    # refresh flow
    refresh = auth.create_refresh_token(user)
    new_access = auth.refresh_access_token(refresh)
    assert auth.verify_token(new_access)["sub"] == "op"
    # wrong type rejected
    with pytest.raises(TokenError):
        auth.verify_token(refresh, expected_type="access")


def test_token_forgery_rejected(auth):
    import base64
    import json

    user = auth.authenticate("op", "hunter2-secure")
    token = auth.create_access_token(user)
    h, p, s = token.split(".")
    payload = json.loads(base64.urlsafe_b64decode(p + "==="))
    payload["role"] = "admin"
    forged_p = base64.urlsafe_b64encode(json.dumps(payload).encode()).rstrip(b"=").decode()
    with pytest.raises(TokenError):
        auth.verify_token(f"{h}.{forged_p}.{s}")
    # a different keypair's token is also rejected
    other = AuthManager()
    other.register_user("op", "hunter2-secure", Role.ADMIN)
    alien = other.create_access_token(other.authenticate("op", "hunter2-secure"))
    with pytest.raises(TokenError):
        auth.verify_token(alien)


def test_role_permissions(auth):
    op = auth.create_access_token(auth.authenticate("op", "hunter2-secure"))
    vw = auth.create_access_token(auth.authenticate("viewer", "look-only"))
    assert auth.has_permission(op, "takeoff")
    assert not auth.has_permission(vw, "takeoff")
    assert auth.has_permission(vw, "view")


def test_tokens_are_the_same_bytes_and_cross_verify(keys, monkeypatch):
    """One key and a fixed clock: both packages mint byte-equal RS256
    tokens (PKCS#1 v1.5 is deterministic), and each verifies the other's;
    an expired one fails in both."""
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.25)
    port = AuthManager(*keys)
    jax_auth = J_auth.AuthManager(*keys)
    for role, jrole in ((Role.PILOT, J_auth.Role.PILOT), (Role.VIEWER, J_auth.Role.VIEWER)):
        pu = port.register_user("amelia", "s3cret-pass-123", role)
        ju = jax_auth.register_user("amelia", "s3cret-pass-123", jrole)
        for make in ("create_access_token", "create_refresh_token"):
            a, b = getattr(port, make)(pu), getattr(jax_auth, make)(ju)
            assert a == b
            kind = "access" if "access" in make else "refresh"
            assert port.verify_token(b, kind) == jax_auth.verify_token(a, kind)
        assert port.refresh_access_token(jax_auth.create_refresh_token(ju)) == \
            jax_auth.refresh_access_token(port.create_refresh_token(pu))
    token = port.create_access_token(pu)
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.25 + 16 * 60)
    with pytest.raises(TokenError):
        port.verify_token(token)
    with pytest.raises(J_auth.TokenError):
        jax_auth.verify_token(token)


def test_password_hashes_cross_both_ways():
    for make, check in ((AuthManager.get_password_hash, J_auth.AuthManager.verify_password),
                        (J_auth.AuthManager.get_password_hash, AuthManager.verify_password)):
        h = make("correct horse battery")
        assert check("correct horse battery", h)
        assert not check("correct horse batterY", h)
    assert not AuthManager.verify_password("x", "no-dollar") and \
        not J_auth.AuthManager.verify_password("x", "no-dollar")


# ---- permissions ----
def test_matrix_shape_and_hierarchy():
    # admin holds every permission; viewers only observe
    assert perms.get_role_permissions(Role.ADMIN) == frozenset(P)
    viewer = perms.get_role_permissions(Role.VIEWER)
    assert viewer and all(p.value.startswith("monitor:") for p in viewer)
    # strictly increasing capability: viewer < operator < pilot+... < admin
    op = perms.get_role_permissions(Role.OPERATOR)
    pilot = perms.get_role_permissions(Role.PILOT)
    assert viewer < op
    assert len(pilot) > len(op)
    assert pilot < perms.get_role_permissions(Role.ADMIN)


def test_flight_authority_split():
    """Reference semantics: pilots fly, operators may only STOP."""
    assert perms.has_permission(Role.PILOT, P.FLIGHT_ARM)
    assert perms.has_permission(Role.PILOT, P.FLIGHT_ATTITUDE)
    assert not perms.has_permission(Role.OPERATOR, P.FLIGHT_ARM)
    assert perms.has_permission(Role.OPERATOR, P.FLIGHT_EMERGENCY_STOP)
    assert not perms.has_permission(Role.VIEWER, P.FLIGHT_EMERGENCY_STOP)
    # no administration for either
    for r in (Role.PILOT, Role.OPERATOR):
        assert not perms.has_any_permission(r, perms.get_permissions_by_group("user"))
        assert not perms.has_permission(r, P.SECURITY_KEYS_MANAGE)


def test_helper_functions():
    mission = perms.get_permissions_by_group("mission")
    assert perms.has_all_permissions(Role.OPERATOR, mission)
    assert not perms.has_all_permissions(Role.VIEWER, mission)
    roles = perms.get_roles_with_permission(P.MISSION_START)
    assert set(roles) == {Role.ADMIN, Role.PILOT, Role.OPERATOR}
    assert perms.get_permissions_by_group("nope") == frozenset()


def test_legacy_string_bridge():
    """The secure hardware channel keys off short command strings
    (hardware/secure_interface.py); the typed matrix must agree."""
    assert perms.has_legacy_permission(Role.PILOT, "emergency_stop")
    assert perms.has_legacy_permission(Role.OPERATOR, "set_mission")
    assert not perms.has_legacy_permission(Role.VIEWER, "arm")
    assert not perms.has_legacy_permission(Role.VIEWER, "unknown_cmd")


def test_pilot_role_through_auth_tokens():
    """End to end: a PILOT token passes the flight-command permission gate
    that a VIEWER token fails."""
    priv, pub = generate_rsa_keypair()
    mgr = AuthManager(private_key_pem=priv, public_key_pem=pub)
    pilot = mgr.register_user("amelia", "s3cret-pass-123", Role.PILOT)
    token = mgr.create_access_token(pilot)
    assert mgr.has_permission(token, "arm")
    assert mgr.has_permission(token, "emergency_stop")
    viewer = mgr.register_user("vee", "s3cret-pass-456", Role.VIEWER)
    vtoken = mgr.create_access_token(viewer)
    assert not mgr.has_permission(vtoken, "arm")
    assert mgr.has_permission(vtoken, "view")


def test_permission_matrices_match_jax():
    def table(mod, roles):
        return {r.value: sorted(p.value for p in mod.get_role_permissions(r)) for r in roles}

    assert table(perms, Role) == table(J_perms, J_auth.Role)
    assert [p.value for p in P] == [p.value for p in J_perms.Permission]
    assert {g: sorted(p.value for p in s) for g, s in perms.PERMISSION_GROUPS.items()} == \
        {g: sorted(p.value for p in s) for g, s in J_perms.PERMISSION_GROUPS.items()}
    from dart_planner_tpu_torch.security.auth import ROLE_PERMISSIONS

    assert {r.value: v for r, v in ROLE_PERMISSIONS.items()} == \
        {r.value: v for r, v in J_auth.ROLE_PERMISSIONS.items()}
    for r, jr in zip(Role, J_auth.Role):
        for cmd in (*perms.LEGACY_PERMISSION_MAP, "unknown_cmd"):
            assert perms.has_legacy_permission(r, cmd) == J_perms.has_legacy_permission(jr, cmd)


# ---- rate limiter ----
def test_rate_limiter_lockout_and_recovery():
    rl = RateLimiter(RateLimitConfig(max_attempts=3, window_s=10.0, base_lockout_s=0.1))
    for _ in range(3):
        ok, _ = rl.is_allowed("1.2.3.4")
        assert ok
    ok, reason = rl.is_allowed("1.2.3.4")
    assert not ok and "locked" in reason
    time.sleep(0.12)
    ok, _ = rl.is_allowed("1.2.3.4")
    assert ok
    rl.record_success("1.2.3.4")
    assert rl.get_status("1.2.3.4") is None


def test_rate_limiters_decide_alike_under_one_clock(monkeypatch):
    """The same attempts at the same patched times: the same decisions,
    reasons and statuses, through escalating lockouts and the window."""
    clock = {"t": 1000.0}
    monkeypatch.setattr(time, "time", lambda: clock["t"])
    cfg = dict(max_attempts=3, window_s=5.0, base_lockout_s=2.0, max_lockout_s=6.0)
    port, jax_rl = RateLimiter(RateLimitConfig(**cfg)), J_rl.RateLimiter(J_rl.RateLimitConfig(**cfg))
    rng = np.random.default_rng(3)
    seen = []
    for step in range(200):
        clock["t"] += float(rng.exponential(0.6))
        who = ("a", "b", "c")[int(rng.integers(3))]
        if rng.random() < 0.05:
            port.record_success(who)
            jax_rl.record_success(who)
        a, b = port.is_allowed(who), jax_rl.is_allowed(who)
        assert a == b, step
        assert port.get_status(who) == jax_rl.get_status(who), step
        seen.append(a[0])
    assert any(seen) and not all(seen)
    for who in "ab":
        assert T_rl.check_login_rate_limit(who) == J_rl.check_login_rate_limit(who)


def test_global_limiters_are_separate_per_package():
    for _ in range(6):
        T_rl.check_login_rate_limit("10.0.0.1")
    assert not T_rl.check_login_rate_limit("10.0.0.1")[0]
    assert J_rl.check_login_rate_limit("10.0.0.1") == (True, None)


# ---- validation / file integrity ----
def test_validators():
    validate_position([1.0, 2.0, 3.0])
    with pytest.raises(ValidationError):
        validate_position([np.inf, 0, 0])
    with pytest.raises(ValidationError):
        validate_position([1, 2])
    with pytest.raises(ValidationError):
        validate_waypoints([])
    out = validate_waypoints([{"position": [0, 0, 1]}, [1, 1, 1]])
    assert len(out) == 2


def test_file_digest(tmp_path):
    f = tmp_path / "cfg.yaml"
    f.write_text("a: 1\n")
    digest = compute_file_digest(f)
    assert verify_file_digest(f, digest)
    f.write_text("a: 2\n")
    assert not verify_file_digest(f, digest)


# ---- user database ----
@pytest.fixture
def svc():
    s = UserService(":memory:")
    yield s
    s.close()


def test_schema_migrated(svc):
    assert svc.schema_version == 2  # both migration steps applied


def test_user_crud_and_roles(svc):
    u = svc.create_user("alice", "pw-alice-1", Role.OPERATOR)
    assert u["username"] == "alice" and u["role"] == "operator"
    assert svc.get_user_by_username("alice")["id"] == u["id"]
    with pytest.raises(SecurityError):
        svc.create_user("alice", "x", Role.VIEWER)  # duplicate
    svc.create_user("bob", "pw-bob-123", Role.VIEWER)
    assert [x["username"] for x in svc.get_all_users()] == ["alice", "bob"]
    svc.update_user_role(u["id"], Role.ADMIN)
    assert svc.get_user(u["id"])["role"] == "admin"
    assert svc.delete_user(u["id"])
    assert svc.get_user(u["id"]) is None


def test_authentication_against_db(svc):
    svc.create_user("op", "correct-horse", Role.OPERATOR)
    user = svc.authenticate("op", "correct-horse")
    assert user is not None and user.role == Role.OPERATOR
    assert svc.authenticate("op", "wrong") is None
    assert svc.authenticate("ghost", "x") is None
    # deactivated users cannot authenticate
    uid = svc.get_user_by_username("op")["id"]
    svc.set_active(uid, False)
    assert svc.authenticate("op", "correct-horse") is None


def test_token_revocation(svc):
    u = svc.create_user("op", "pw", Role.OPERATOR)
    assert not svc.is_token_revoked("jti-1")
    svc.revoke_token("jti-1", u["id"])
    assert svc.is_token_revoked("jti-1")
    svc.revoke_token("jti-1", u["id"])  # idempotent


def test_manage_users_cli(svc, capsys):
    assert manage_users.main(["create-admin", "-u", "root", "-p", "pw-root-1"], service=svc) == 0
    assert manage_users.main(
        ["create-user", "-u", "op", "-p", "pw-op-1", "-r", "operator"], service=svc
    ) == 0
    assert manage_users.main(["list-users"], service=svc) == 0
    out = capsys.readouterr().out
    assert "root" in out and "admin" in out and "op" in out
    assert manage_users.main(["set-role", "-u", "op", "-r", "admin"], service=svc) == 0
    assert svc.get_user_by_username("op")["role"] == "admin"
    assert manage_users.main(["delete-user", "-u", "op"], service=svc) == 0
    assert svc.get_user_by_username("op") is None
    assert manage_users.main(["delete-user", "-u", "nope"], service=svc) == 1


def test_manage_users_runs_as_a_module(tmp_path):
    """``python -m dart_planner_tpu_torch.security.manage_users`` on a
    database file, which the JAX package's service then reads."""
    db = str(tmp_path / "users.db")
    base = [sys.executable, "-m", "dart_planner_tpu_torch.security.manage_users", "--db", db]
    for args in (["create-admin", "-u", "root", "-p", "pw-root-1"],
                 ["create-user", "-u", "op", "-p", "pw-op-1", "-r", "pilot"]):
        out = subprocess.run(base + args, capture_output=True, text=True, cwd=ROOT, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
    listing = subprocess.run(base + ["list-users"], capture_output=True, text=True, cwd=ROOT,
                             timeout=120).stdout
    assert "root" in listing and "pilot" in listing
    jax_svc = J_db.UserService(db)
    try:
        assert jax_svc.authenticate("op", "pw-op-1").role == J_auth.Role.PILOT
    finally:
        jax_svc.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_user_db_crosses_between_packages(tmp_path, writer):
    """A database file written by one package is read, authenticated
    against, updated and revoked into by the other; rows compare equal."""
    db = str(tmp_path / "users.db")
    make = {"port": lambda: UserService(db), "jax": lambda: J_db.UserService(db)}
    roles = {"port": Role, "jax": J_auth.Role}
    reader = "jax" if writer == "port" else "port"
    w = make[writer]()
    alice = w.create_user("alice", "pw-alice-1", roles[writer].OPERATOR)
    w.create_user("bob", "pw-bob-123", roles[writer].VIEWER)
    w.revoke_token("jti-w", alice["id"])
    rows = w.get_all_users()
    w.close()
    r = make[reader]()
    try:
        assert r.schema_version == 2
        assert r.get_all_users() == rows
        assert r.authenticate("alice", "pw-alice-1").role.value == "operator"
        assert r.authenticate("alice", "nope") is None
        assert r.is_token_revoked("jti-w")
        r.update_user_role(alice["id"], roles[reader].ADMIN)
        r.revoke_token("jti-r", alice["id"])
    finally:
        r.close()
    w = make[writer]()
    try:
        assert w.get_user(alice["id"])["role"] == "admin"
        assert w.is_token_revoked("jti-r")
    finally:
        w.close()


# ---- multiprocess loop ----
def _double(s):
    return {"double": s["x"] * 2}


def test_process_control_loop():
    loop = ProcessControlLoop(lambda s: {"double": s["x"] * 2}, frequency_hz=200.0)
    loop.start()
    try:
        loop.send_state({"x": 21})
        deadline = time.time() + 2.0
        out = None
        while time.time() < deadline:
            out = loop.get_output(timeout=0.1)
            if out:
                break
        assert out == {"double": 42}
        assert loop.running
    finally:
        loop.stop()
    assert not loop.running


def test_process_control_loop_reports_errors_and_takes_host_arrays():
    """A numpy state crosses the pipe; an exception in the child surfaces as
    ``error`` instead of a silent death."""
    loop = ProcessControlLoop(_double, frequency_hz=200.0)
    loop.start()
    try:
        loop.send_state({"x": np.arange(3.0)})
        deadline = time.time() + 2.0
        out = None
        while time.time() < deadline and out is None:
            out = loop.get_output(timeout=0.1)
        np.testing.assert_array_equal(out["double"], [0.0, 2.0, 4.0])
        loop.send_state({"y": 1})  # KeyError in the child
        while time.time() < deadline + 2.0 and loop.error is None:
            loop.get_output(timeout=0.1)
        assert loop.error is not None and "KeyError" in loop.error
    finally:
        loop.stop()
    assert not loop.running
