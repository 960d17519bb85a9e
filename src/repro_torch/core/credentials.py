"""Least-privilege credential management (paper §4.3.3).

The cluster orchestrator mints short-lived, function-scoped IAM tokens
and supplies them *only* to the trusted host backend. Guests hold an
opaque invocation handle; the raw signing key never crosses the
virtualization boundary. `TokenManager.assert_guest_clean` is used by
tests to prove no secret material ever landed in frontend state.
"""
from __future__ import annotations

import hashlib
import hmac
import secrets
import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class ScopedToken:
    function: str
    buckets: frozenset[str]        # allowed bucket prefixes
    actions: frozenset[str]        # {'get', 'put'}
    expires_at: float
    mac: str                       # HMAC over the scope (provider-signed)

    def allows(self, bucket: str, action: str, now: float) -> bool:
        return (now < self.expires_at
                and action in self.actions
                and any(bucket.startswith(b) for b in self.buckets))


class CredentialError(PermissionError):
    pass


class TokenManager:
    """Backend-side token vault; the orchestrator's signing key stays here."""

    def __init__(self, ttl_s: float = 900.0):
        self._root_key = secrets.token_bytes(32)     # NEVER leaves this object
        self._ttl = ttl_s
        self._tokens: dict[str, ScopedToken] = {}
        self._lock = threading.Lock()

    def _sign(self, function: str, buckets: frozenset, actions: frozenset,
              expires_at: float) -> str:
        msg = f"{function}|{sorted(buckets)}|{sorted(actions)}|{expires_at:.3f}"
        return hmac.new(self._root_key, msg.encode(), hashlib.sha256).hexdigest()

    def provision(self, function: str, buckets: set[str],
                  actions: set[str] = frozenset({"get", "put"})) -> str:
        """Mint a token for `function`; returns the *handle* (not the token)."""
        exp = time.time() + self._ttl
        b, a = frozenset(buckets), frozenset(actions)
        tok = ScopedToken(function, b, a, exp, self._sign(function, b, a, exp))
        handle = secrets.token_hex(8)
        with self._lock:
            self._tokens[handle] = tok
        return handle

    def authorize(self, handle: str, bucket: str, action: str) -> ScopedToken:
        with self._lock:
            tok = self._tokens.get(handle)
        if tok is None:
            raise CredentialError(f"unknown credential handle {handle!r}")
        if tok.mac != self._sign(tok.function, tok.buckets, tok.actions,
                                 tok.expires_at):
            raise CredentialError("token MAC invalid (forged scope?)")
        if not tok.allows(bucket, action, time.time()):
            raise CredentialError(
                f"{tok.function}: {action} on {bucket!r} denied by scope")
        return tok

    def revoke(self, handle: str) -> None:
        with self._lock:
            self._tokens.pop(handle, None)

    @staticmethod
    def assert_guest_clean(guest_state: dict) -> None:
        """Test hook: no secret-shaped values in frontend-visible state."""
        for k, v in guest_state.items():
            if isinstance(v, (bytes, bytearray)):
                raise AssertionError(f"raw key material in guest state: {k}")
            if isinstance(v, str) and len(v) >= 40 and k.lower() not in (
                    "invocation_id",):
                raise AssertionError(f"suspicious long secret in guest: {k}")
