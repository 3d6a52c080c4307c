"""Gateway middleware: CSRF, request validation, security headers (PyTorch
counterpart of :mod:`dart_planner_tpu.gateway.middleware`).

Re-design of the reference FastAPI/Starlette middleware
(the reference's gateway/middleware.py:34-109, "GW") as
**pure ASGI** callables — it needs no Starlette, and the spec is
small, so each middleware wraps any ASGI app directly and is unit-testable
by calling ``await mw(scope, receive, send)``:

- :class:`CSRFMiddleware`: double-submit-cookie pattern (GW:34-73) —
  safe methods get a ``csrftoken`` cookie; unsafe methods must echo it in
  ``X-CSRF-Token``, compared with ``secrets.compare_digest``.
- :class:`SecureMiddleware`: JSON-body validation for POST/PUT/PATCH
  (GW:75-109) through :mod:`dart_planner_tpu_torch.security.validation`.
- :class:`SecurityHeadersMiddleware`: standard hardening headers the
  reference sets in its gateway stack.
"""

from __future__ import annotations

import json
import secrets
from http import cookies as http_cookies
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

from dart_planner_tpu_torch.common.errors import ValidationError

SAFE_METHODS = {"GET", "HEAD", "OPTIONS"}


def _get_header(scope: dict, name: bytes) -> Optional[bytes]:
    for k, v in scope.get("headers", []):
        if k.lower() == name:
            return v
    return None


def _get_cookie(scope: dict, name: str) -> Optional[str]:
    raw = _get_header(scope, b"cookie")
    if raw is None:
        return None
    jar = http_cookies.SimpleCookie()
    jar.load(raw.decode())
    morsel = jar.get(name)
    return morsel.value if morsel else None


async def _send_json(send, status: int, payload: Dict[str, Any]) -> None:
    body = json.dumps(payload).encode()
    await send(
        {
            "type": "http.response.start",
            "status": status,
            "headers": [
                (b"content-type", b"application/json"),
                (b"content-length", str(len(body)).encode()),
            ],
        }
    )
    await send({"type": "http.response.body", "body": body})


class CSRFMiddleware:
    """Double-submit-cookie CSRF protection (GW:34-73)."""

    def __init__(
        self,
        app,
        cookie_name: str = "csrftoken",
        header_name: str = "x-csrf-token",
    ):
        self.app = app
        self.cookie_name = cookie_name
        self.header_name = header_name.lower().encode()

    async def __call__(self, scope, receive, send):
        if scope["type"] != "http":
            return await self.app(scope, receive, send)
        method = scope["method"].upper()

        if method in SAFE_METHODS:
            has_cookie = _get_cookie(scope, self.cookie_name) is not None

            async def send_with_cookie(message):
                if message["type"] == "http.response.start" and not has_cookie:
                    token = secrets.token_hex(16)
                    # NOTE: no HttpOnly attribute — per RFC 6265 its mere
                    # presence (any value) marks the cookie http-only, and
                    # the double-submit pattern requires JS to read it
                    cookie = (
                        f"{self.cookie_name}={token}; Path=/; SameSite=Strict"
                    )
                    message = dict(message)
                    message["headers"] = list(message.get("headers", [])) + [
                        (b"set-cookie", cookie.encode())
                    ]
                await send(message)

            return await self.app(scope, receive, send_with_cookie)

        cookie = _get_cookie(scope, self.cookie_name)
        header = _get_header(scope, self.header_name)
        if (
            not cookie
            or not header
            or not secrets.compare_digest(cookie, header.decode())
        ):
            return await _send_json(
                send, 403, {"detail": "CSRF token mismatch"}
            )
        return await self.app(scope, receive, send)


class SecureMiddleware:
    """Validate JSON bodies of mutating requests (GW:75-109)."""

    EXEMPT_PATHS = ("/docs", "/openapi.json", "/static", "/favicon.ico")

    def __init__(self, app, validator: Optional[Callable[[Any], Any]] = None):
        self.app = app
        self.validator = validator or _default_validator

    async def __call__(self, scope, receive, send):
        if scope["type"] != "http" or any(
            scope.get("path", "").startswith(p) for p in self.EXEMPT_PATHS
        ):
            return await self.app(scope, receive, send)
        if scope["method"].upper() not in {"POST", "PUT", "PATCH"}:
            return await self.app(scope, receive, send)

        # buffer the body so we can validate and then replay it downstream
        chunks = []
        while True:
            message = await receive()
            if message["type"] != "http.request":
                break
            chunks.append(message.get("body", b""))
            if not message.get("more_body", False):
                break
        body = b"".join(chunks)
        if body:
            try:
                payload = json.loads(body)
                self.validator(payload)
            except json.JSONDecodeError:
                return await _send_json(
                    send, 400, {"detail": "Invalid JSON format."}
                )
            except ValidationError as exc:
                return await _send_json(
                    send, 422, {"detail": f"Validation Error: {exc}"}
                )

        replayed = False

        async def replay():
            nonlocal replayed
            if replayed:
                return {"type": "http.request", "body": b"", "more_body": False}
            replayed = True
            return {"type": "http.request", "body": body, "more_body": False}

        return await self.app(scope, replay, send)


_MAX_DEPTH = 8
_MAX_STRING = 4096
_MAX_ITEMS = 1000


def _default_validator(payload: Any, depth: int = 0) -> Any:
    """Generic request-shape screen (reference InputValidator
    .validate_generic): bounded depth/size, no control characters."""
    if depth > _MAX_DEPTH:
        raise ValidationError("payload nesting too deep")
    if isinstance(payload, dict):
        if len(payload) > _MAX_ITEMS:
            raise ValidationError("too many keys")
        for k, v in payload.items():
            _default_validator(k, depth + 1)
            _default_validator(v, depth + 1)
    elif isinstance(payload, (list, tuple)):
        if len(payload) > _MAX_ITEMS:
            raise ValidationError("too many items")
        for v in payload:
            _default_validator(v, depth + 1)
    elif isinstance(payload, str):
        if len(payload) > _MAX_STRING:
            raise ValidationError("string too long")
        if any(ord(c) < 32 and c not in "\t\n\r" for c in payload):
            raise ValidationError("control characters not allowed")
    return payload


_SECURITY_HEADERS: Tuple[Tuple[bytes, bytes], ...] = (
    (b"x-content-type-options", b"nosniff"),
    (b"x-frame-options", b"DENY"),
    (b"referrer-policy", b"same-origin"),
    (b"content-security-policy", b"default-src 'self'"),
    (b"strict-transport-security", b"max-age=63072000; includeSubDomains"),
)


class SecurityHeadersMiddleware:
    """Attach standard hardening headers to every response."""

    def __init__(self, app, extra: Iterable[Tuple[bytes, bytes]] = ()):
        self.app = app
        self.headers = _SECURITY_HEADERS + tuple(extra)

    async def __call__(self, scope, receive, send):
        if scope["type"] != "http":
            return await self.app(scope, receive, send)

        async def send_with_headers(message):
            if message["type"] == "http.response.start":
                message = dict(message)
                message["headers"] = (
                    list(message.get("headers", [])) + list(self.headers)
                )
            await send(message)

        return await self.app(scope, receive, send_with_headers)
