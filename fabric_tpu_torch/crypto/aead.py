"""AEAD + HKDF for the secure channel, mode-aware.

`hkdf_sha256` is RFC 5869 over stdlib hmac/hashlib in BOTH modes —
it's deterministic and byte-identical to cryptography's HKDF, so key
schedules never depend on which mode a process runs in.

`Aead` wraps ChaCha20-Poly1305 when the real library is present.  The
fallback is encrypt-then-MAC over a SHA-256 counter keystream with an
HMAC-SHA256 tag (truncated to 16 bytes, like Poly1305's).  That keeps
hot bytes on C-speed hashlib instead of a pure-Python ChaCha core; it
is integrity+confidentiality sound for the dev topologies the fallback
serves, but it is NOT wire-compatible with the real mode — which is
fine, because every process in a topology shares one environment.

Counterpart of `fabric_tpu/crypto/aead.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import hashlib
import hmac
import struct

try:  # pragma: no cover - environment probe
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    _HAVE_CHACHA = True
except ImportError:
    ChaCha20Poly1305 = None
    _HAVE_CHACHA = False

_TAG_LEN = 16
_U64 = struct.Struct("<Q")


def hkdf_sha256(secret: bytes, salt: bytes, info: bytes,
                length: int = 32) -> bytes:
    """RFC 5869 HKDF-Extract + Expand with SHA-256."""
    if length > 255 * 32:
        raise ValueError("hkdf output too long")
    prk = hmac.new(salt or b"\x00" * 32, secret, hashlib.sha256).digest()
    okm = b""
    block = b""
    counter = 1
    while len(okm) < length:
        block = hmac.new(prk, block + info + bytes([counter]),
                         hashlib.sha256).digest()
        okm += block
        counter += 1
    return okm[:length]


class Aead:
    """ChaCha20-Poly1305 when available; hashlib-based AEAD otherwise.
    API: encrypt(nonce12, plaintext, aad) / decrypt(nonce12, ct, aad),
    decrypt raises ValueError on authentication failure."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("Aead keys are 32 bytes")
        if _HAVE_CHACHA:
            self._impl = ChaCha20Poly1305(key)
            self._enc_key = self._mac_key = None
        else:
            self._impl = None
            self._enc_key = hashlib.sha256(b"ftpu-aead-enc" + key).digest()
            self._mac_key = hashlib.sha256(b"ftpu-aead-mac" + key).digest()

    def _keystream_xor(self, nonce: bytes, data: bytes) -> bytes:
        out = bytearray(len(data))
        view = memoryview(data)
        for i in range(0, len(data), 32):
            block = hashlib.sha256(
                self._enc_key + nonce + _U64.pack(i // 32)).digest()
            chunk = view[i:i + 32]
            out[i:i + len(chunk)] = bytes(
                a ^ b for a, b in zip(chunk, block))
        return bytes(out)

    def _tag(self, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
        mac = hmac.new(self._mac_key, digestmod=hashlib.sha256)
        mac.update(_U64.pack(len(aad)))
        mac.update(aad)
        mac.update(nonce)
        mac.update(ct)
        return mac.digest()[:_TAG_LEN]

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes = b"") -> bytes:
        if self._impl is not None:
            return self._impl.encrypt(nonce, data, aad or None)
        ct = self._keystream_xor(nonce, data)
        return ct + self._tag(nonce, aad or b"", ct)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes = b"") -> bytes:
        if self._impl is not None:
            try:
                return self._impl.decrypt(nonce, data, aad or None)
            except Exception as exc:
                raise ValueError("AEAD authentication failed") from exc
        if len(data) < _TAG_LEN:
            raise ValueError("AEAD ciphertext too short")
        ct, tag = data[:-_TAG_LEN], data[-_TAG_LEN:]
        if not hmac.compare_digest(tag, self._tag(nonce, aad or b"", ct)):
            raise ValueError("AEAD authentication failed")
        return self._keystream_xor(nonce, ct)
