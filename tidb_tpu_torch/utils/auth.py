# ported from tidb_tpu/utils/auth.py @ 6233200
"""mysql_native_password auth primitives (shared by the wire protocol
layer and the privilege manager; reference: pkg/util/hack + auth pkg)."""

from __future__ import annotations

import hashlib


def native_password_hash(password: str) -> bytes:
    """SHA1(SHA1(password)) — what mysql.user stores."""
    return hashlib.sha1(hashlib.sha1(password.encode()).digest()).digest()


def scramble_password(password: str, salt: bytes) -> bytes:
    """Client-side: SHA1(pwd) XOR SHA1(salt + SHA1(SHA1(pwd)))."""
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    mix = hashlib.sha1(salt + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, mix))


def check_scramble(scrambled: bytes, salt: bytes, stored_hash: bytes) -> bool:
    """Server-side verify: recover SHA1(pwd-hash) and compare."""
    if not scrambled:
        return stored_hash == native_password_hash("")
    mix = hashlib.sha1(salt + stored_hash).digest()
    h1 = bytes(a ^ b for a, b in zip(scrambled, mix))
    return hashlib.sha1(h1).digest() == stored_hash


def sha2_cache_digest(password: str) -> bytes:
    """SHA256(SHA256(password)) — the fast-auth cache entry the server
    keeps after one full authentication (reference: privilege/privileges
    globalPrivCache sha2 cache; MySQL's caching_sha2_password design)."""
    return hashlib.sha256(hashlib.sha256(password.encode()).digest()).digest()


def sha2_scramble(password: str, nonce: bytes) -> bytes:
    """Client-side caching_sha2_password fast-auth token:
    SHA256(pwd) XOR SHA256(SHA256(SHA256(pwd)) || nonce)."""
    if not password:
        return b""
    h1 = hashlib.sha256(password.encode()).digest()
    h2 = hashlib.sha256(h1).digest()
    mix = hashlib.sha256(h2 + nonce).digest()
    return bytes(a ^ b for a, b in zip(h1, mix))


def check_sha2_scramble(token: bytes, nonce: bytes,
                        cache_digest: bytes) -> bool:
    """Server-side fast-auth verify against the cached
    SHA256(SHA256(password)): recover SHA256(pwd) from the token and
    re-hash."""
    if not token:
        return cache_digest == sha2_cache_digest("")
    mix = hashlib.sha256(cache_digest + nonce).digest()
    h1 = bytes(a ^ b for a, b in zip(token, mix))
    return hashlib.sha256(h1).digest() == cache_digest


__all__ = ["native_password_hash", "scramble_password", "check_scramble",
           "sha2_cache_digest", "sha2_scramble", "check_sha2_scramble"]
