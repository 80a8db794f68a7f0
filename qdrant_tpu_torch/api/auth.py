"""Auth: static API keys + HS256 JWT with RBAC claims.

Reference: src/actix/auth.rs + src/common/auth/ + lib/storage/src/rbac/.
Two static keys (full + read-only) and JWTs signed with the full api_key:
claims `exp` (unix seconds), `access` — either "r"/"m" (global read /
manage) or a list of per-collection grants
[{"collection": name, "access": "r"|"rw"}] — and optional `value_exists`
(reject if a payload-matching point is gone, deferred).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any, Dict, List, Optional, Union


class AuthError(Exception):
    status_code = 401


class Access:
    """Resolved access rights for one request."""

    def __init__(self, write: bool, manage: bool, collections: Optional[Dict[str, bool]] = None):
        self.write = write
        self.manage = manage
        # None = all collections; else map collection → writable
        self.collections = collections

    @classmethod
    def full(cls) -> "Access":
        return cls(write=True, manage=True)

    @classmethod
    def read_only(cls) -> "Access":
        return cls(write=False, manage=False)

    def check_collection(self, name: str, write: bool = False) -> None:
        if self.collections is not None:
            if name not in self.collections:
                raise AuthError(f"access to collection {name!r} denied", )
            if write and not self.collections[name]:
                raise AuthError(f"write access to collection {name!r} denied")
        elif write and not self.write:
            raise AuthError("write access denied")

    def check_manage(self) -> None:
        if not self.manage:
            raise AuthError("global manage access required")


def _b64url_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def _b64url_encode(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).rstrip(b"=").decode()


def make_jwt(claims: Dict[str, Any], key: str) -> str:
    header = _b64url_encode(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url_encode(json.dumps(claims).encode())
    signing_input = f"{header}.{payload}".encode()
    sig = hmac.new(key.encode(), signing_input, hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url_encode(sig)}"


def parse_jwt(token: str, key: str) -> Dict[str, Any]:
    parts = token.split(".")
    if len(parts) != 3:
        raise AuthError("malformed JWT")
    header_b, payload_b, sig_b = parts
    try:
        header = json.loads(_b64url_decode(header_b))
    except Exception:
        raise AuthError("malformed JWT header")
    if header.get("alg") != "HS256":
        raise AuthError("unsupported JWT alg")
    signing_input = f"{header_b}.{payload_b}".encode()
    expected = hmac.new(key.encode(), signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(expected, _b64url_decode(sig_b)):
        raise AuthError("invalid JWT signature")
    try:
        claims = json.loads(_b64url_decode(payload_b))
    except Exception:
        raise AuthError("malformed JWT claims")
    exp = claims.get("exp")
    if exp is not None and time.time() > float(exp):
        raise AuthError("JWT expired")
    return claims


def access_from_claims(claims: Dict[str, Any]) -> Access:
    access: Union[str, List[dict], None] = claims.get("access", "m")
    if access == "m":
        return Access.full()
    if access == "r":
        return Access.read_only()
    if isinstance(access, list):
        collections: Dict[str, bool] = {}
        for grant in access:
            name = grant.get("collection")
            if not name:
                raise AuthError("bad access grant")
            collections[name] = grant.get("access", "r") == "rw"
        return Access(write=True, manage=False, collections=collections)
    raise AuthError("bad access claim")


class Authenticator:
    def __init__(self, api_key: Optional[str], read_only_api_key: Optional[str]):
        self.api_key = api_key
        self.read_only_api_key = read_only_api_key

    @property
    def enabled(self) -> bool:
        return bool(self.api_key or self.read_only_api_key)

    def authenticate(self, headers) -> Access:
        """headers: mapping with .get — checks `api-key` header and
        `Authorization: Bearer` (raw key or JWT)."""
        if not self.enabled:
            return Access.full()
        provided = headers.get("api-key") or headers.get("Api-Key")
        auth_header = headers.get("Authorization") or headers.get("authorization")
        bearer = None
        if auth_header and auth_header.startswith("Bearer "):
            bearer = auth_header[len("Bearer ") :].strip()
        candidate = provided or bearer
        if candidate is None:
            raise AuthError("Must provide an API key or an Authorization bearer token")
        if self.api_key and hmac.compare_digest(candidate, self.api_key):
            return Access.full()
        if self.read_only_api_key and hmac.compare_digest(
            candidate, self.read_only_api_key
        ):
            return Access.read_only()
        if self.api_key and candidate.count(".") == 2:
            claims = parse_jwt(candidate, self.api_key)
            return access_from_claims(claims)
        raise AuthError("Invalid API key")
