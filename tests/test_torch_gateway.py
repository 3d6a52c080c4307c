"""The port's gateway middleware on the CPU (dart_planner_tpu_torch/gateway/):
pure ASGI CSRF, JSON-body validation and security headers.

The gateway cases of tests/test_security_gateway_airframe.py run against
the port. Held against the JAX package: each middleware of each package
wraps the same echo app and takes the same table of ASGI requests (safe
and unsafe methods, cookies and CSRF headers that match or not, JSON that
is good, malformed, too deep, too long or holds control characters, chunked
bodies, exempt and near-exempt paths, a websocket scope); the responses
have the same status, headers and body, with the CSRF cookie's random
token fixed (``secrets.token_hex``) on both sides.
"""

import asyncio
import json
import secrets

import pytest

from dart_planner_tpu import gateway as J_gateway
from dart_planner_tpu_torch.gateway import (
    CSRFMiddleware,
    SecureMiddleware,
    SecurityHeadersMiddleware,
)


def run(coro):
    return asyncio.get_event_loop_policy().new_event_loop().run_until_complete(coro)


async def _echo_app(scope, receive, send):
    if scope["type"] != "http":
        await send({"type": "websocket.close", "code": 1000})
        return
    body = b""
    while True:
        msg = await receive()
        body += msg.get("body", b"")
        if not msg.get("more_body", False):
            break
    await send({"type": "http.response.start", "status": 200,
                "headers": [(b"x-echo", scope["path"].encode())]})
    await send({"type": "http.response.body", "body": body})


def _exchange(app, method="GET", path="/", headers=(), body=b"", chunks=None,
              scope_type="http"):
    """Every message ``app`` sends for one request."""
    scope = {
        "type": scope_type,
        "method": method,
        "path": path,
        "headers": [(k.lower().encode(), v.encode()) for k, v in headers],
    }
    parts = list(chunks) if chunks is not None else [body]
    sent = []

    async def receive():
        if not parts:
            return {"type": "http.disconnect"}
        chunk = parts.pop(0)
        return {"type": "http.request", "body": chunk, "more_body": bool(parts)}

    async def send(message):
        sent.append(message)

    run(app(scope, receive, send))
    return sent


def _call(app, method="GET", path="/", headers=(), body=b""):
    sent = _exchange(app, method, path, headers, body)
    start = next(m for m in sent if m["type"] == "http.response.start")
    payload = b"".join(m.get("body", b"") for m in sent if m["type"] == "http.response.body")
    return start["status"], dict(start["headers"]), payload


def test_csrf_sets_cookie_on_safe_and_blocks_unsafe():
    app = CSRFMiddleware(_echo_app)
    status, hdrs, _ = _call(app, "GET")
    assert status == 200 and b"csrftoken=" in hdrs.get(b"set-cookie", b"")
    # POST without token -> 403
    status, _, payload = _call(app, "POST", body=b"{}")
    assert status == 403 and b"CSRF" in payload
    # POST with matching cookie + header -> allowed
    status, _, _ = _call(app, "POST",
                         headers=[("cookie", "csrftoken=tok123"), ("x-csrf-token", "tok123")],
                         body=b"{}")
    assert status == 200
    # mismatched token -> 403
    status, _, _ = _call(app, "POST",
                         headers=[("cookie", "csrftoken=tok123"), ("x-csrf-token", "nope")])
    assert status == 403


def test_secure_middleware_validates_json():
    app = SecureMiddleware(_echo_app)
    status, _, payload = _call(app, "POST", body=json.dumps({"pos": [1, 2, 3]}).encode())
    assert status == 200 and b"pos" in payload  # body replayed downstream
    status, _, _ = _call(app, "POST", body=b"{not json")
    assert status == 400
    status, _, _ = _call(app, "POST", body=json.dumps({"s": "\x00"}).encode())
    assert status == 422
    # exempt path bypasses validation
    status, _, _ = _call(app, "POST", path="/docs", body=b"{not json")
    assert status == 200


def test_security_headers_attached():
    app = SecurityHeadersMiddleware(_echo_app)
    _, hdrs, _ = _call(app, "GET")
    assert hdrs[b"x-content-type-options"] == b"nosniff"
    assert hdrs[b"x-frame-options"] == b"DENY"


def test_csrf_cookie_is_not_httponly():
    """RFC 6265: the HttpOnly attribute's mere presence enables it; the
    double-submit cookie must be JS-readable."""
    app = CSRFMiddleware(_echo_app)
    _, hdrs, _ = _call(app, "GET")
    assert b"httponly" not in hdrs[b"set-cookie"].lower()


def test_secure_middleware_exemption_is_prefix_only():
    """Routes merely containing an exempt segment must still be validated."""
    app = SecureMiddleware(_echo_app)
    status, _, _ = _call(app, "POST", path="/api/static-waypoints", body=b"{not json")
    assert status == 400  # not exempted


REQUESTS = {
    "get": dict(method="GET"),
    "head-with-cookie": dict(method="HEAD", headers=[("cookie", "csrftoken=abc")]),
    "options-other-cookie": dict(method="OPTIONS", headers=[("cookie", "session=1")]),
    "post-no-token": dict(method="POST", body=b"{}"),
    "post-match": dict(method="POST", body=b'{"a": 1}',
                       headers=[("cookie", "csrftoken=tok123"), ("X-CSRF-Token", "tok123")]),
    "post-mismatch": dict(method="POST", body=b"{}",
                          headers=[("cookie", "csrftoken=tok123"), ("x-csrf-token", "nope")]),
    "put-header-only": dict(method="PUT", body=b"{}", headers=[("x-csrf-token", "tok123")]),
    "patch-good-json": dict(method="patch", body=json.dumps({"pos": [1, 2, 3]}).encode()),
    "post-bad-json": dict(method="POST", body=b"{not json"),
    "post-control-char": dict(method="POST", body=json.dumps({"s": "a\x01b"}).encode()),
    "post-tab-ok": dict(method="POST", body=json.dumps({"s": "a\tb\n"}).encode()),
    "post-too-deep": dict(method="POST", body=json.dumps(
        {"a": [[[[[[[[[[1]]]]]]]]]]}).encode()),
    "post-long-string": dict(method="POST", body=json.dumps({"s": "x" * 5000}).encode()),
    "post-many-items": dict(method="POST", body=json.dumps(list(range(1001))).encode()),
    "post-empty": dict(method="POST", body=b""),
    "post-chunked": dict(method="POST", chunks=[b'{"waypoints": [[0, 0, ', b"1]]}"]),
    "post-docs": dict(method="POST", path="/docs/x", body=b"{not json"),
    "post-static-near": dict(method="POST", path="/api/static-waypoints", body=b"{not json"),
    "delete": dict(method="DELETE"),
    "websocket": dict(method="GET", scope_type="websocket"),
}
MIDDLEWARES = ("CSRFMiddleware", "SecureMiddleware", "SecurityHeadersMiddleware")


@pytest.mark.parametrize("middleware", MIDDLEWARES)
@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_middleware_responses_match_jax(middleware, name, monkeypatch):
    monkeypatch.setattr(secrets, "token_hex", lambda n=32: "5a" * n)
    import dart_planner_tpu_torch.gateway as T_gateway

    port = _exchange(getattr(T_gateway, middleware)(_echo_app), **REQUESTS[name])
    jax_out = _exchange(getattr(J_gateway, middleware)(_echo_app), **REQUESTS[name])
    assert port == jax_out
    assert port  # every request got an answer
