"""Crypto shim: the host-side signature operations the port's BCCSP needs.

Counterpart of `fabric_tpu/crypto/__init__.py`, cut down to what the
software provider (`bccsp/sw.py`) and the MSP (`msp/`) reach.  Two
surfaces:

- functions for the provider: P-256 ECDSA and Ed25519 key generation,
  signing and verification, and the DER codec for ECDSA signatures.
  When the `cryptography` package is installed it does the work; when
  it is missing (as on the GPU hosts this port targets) the pure-Python
  engines `_p256`, `_ed25519` and `_der` take over with the same
  results.  These functions read `HAVE_CRYPTOGRAPHY` at call time, so a
  test can force the pure-Python path.  Keys are opaque objects to
  callers: pass what `*_generate` / `p256_key_from_scalar` return (or
  a key the MSP's CA minted) back into the other functions.
- the reference shim's `x509`, `serialization`, `hashes`, `ec`,
  `ed25519` and `NameOID`, which the MSP uses to mint and read identity
  certs: `cryptography`'s own modules when it is installed, else the
  lite modules (`lite_x509` and friends: serde-encoded "certs" in a PEM
  armour, not ASN.1).  This choice is made once, at import; the two
  modes are not wire-compatible, and a deployment runs one of them.
- the secure channel's primitives (`comm/secure.py`), chosen as the
  reference chooses them: `X25519PrivateKey` and `X25519PublicKey` from
  `cryptography` when it is installed, else the pure-Python
  `lite_x25519` (RFC 7748); `Aead` and `hkdf_sha256` from `aead`, whose
  HKDF is the same in both modes and whose AEAD is ChaCha20-Poly1305
  with `cryptography` and a hashlib construction without it (the two
  AEAD modes are not wire-compatible either).
"""

from __future__ import annotations

from typing import Tuple

from . import _der, _ed25519, _p256
from ._errors import InvalidSignature

try:  # pragma: no cover - environment probe
    import cryptography  # noqa: F401
    HAVE_CRYPTOGRAPHY = True
except ImportError:
    HAVE_CRYPTOGRAPHY = False


def decode_dss_signature(sig: bytes) -> Tuple[int, int]:
    """DER (r, s) -> ints; raises ValueError on anything but strict DER."""
    if HAVE_CRYPTOGRAPHY:
        from cryptography.hazmat.primitives.asymmetric.utils import (
            decode_dss_signature as dec)
        return dec(sig)
    return _der.decode_dss_signature(sig)


def encode_dss_signature(r: int, s: int) -> bytes:
    return _der.encode_dss_signature(r, s)


# -- P-256 -------------------------------------------------------------------

class _P256Key:
    """Pure-Python private key: the scalar and its affine public point."""

    def __init__(self, d: int):
        if not 1 <= d < _p256.N:
            raise ValueError("private scalar out of range")
        self.d = d
        self.q = _p256.public_from_scalar(d)


def p256_key_from_scalar(d: int):
    """Private key for scalar d in [1, n)."""
    if HAVE_CRYPTOGRAPHY:
        from cryptography.hazmat.primitives.asymmetric import ec
        return ec.derive_private_key(d, ec.SECP256R1())
    return _P256Key(d)


def p256_generate():
    return p256_key_from_scalar(_p256.generate_private_scalar())


def _is_lite(key) -> bool:
    """A key object of the lite modules (minted by the MSP's CA when
    `cryptography` is missing)."""
    return type(key).__module__.startswith(__name__ + ".lite_")


def p256_public_bytes(key) -> bytes:
    """SEC1 uncompressed point (65 bytes, 0x04 || X || Y)."""
    if isinstance(key, _P256Key):
        return _p256.encode_point(key.q)
    if _is_lite(key):
        return _p256.encode_point(key.public_key()._q)
    from cryptography.hazmat.primitives import serialization
    return key.public_key().public_bytes(
        serialization.Encoding.X962,
        serialization.PublicFormat.UncompressedPoint)


def p256_sign_digest(key, digest: bytes) -> Tuple[int, int]:
    """ECDSA over a 32-byte digest -> (r, s), s not low-S normalized."""
    if len(digest) != 32:
        raise ValueError("p256 signs a 32-byte digest")
    if isinstance(key, _P256Key):
        return _p256.sign_digest(key.d, digest)
    if _is_lite(key):
        return _p256.sign_digest(key._d, digest)
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import Prehashed
    der = key.sign(digest, ec.ECDSA(Prehashed(hashes.SHA256())))
    return decode_dss_signature(der)


def p256_verify_digest(pubkey: bytes, signature: bytes,
                       digest: bytes) -> bool:
    """Verify a DER signature over a 32-byte digest.  Raises ValueError
    for a public key that is not an on-curve SEC1 uncompressed point;
    returns False for a signature that does not verify."""
    if HAVE_CRYPTOGRAPHY:
        from cryptography.exceptions import InvalidSignature as _Bad
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import ec
        from cryptography.hazmat.primitives.asymmetric.utils import (
            Prehashed)
        pub = ec.EllipticCurvePublicKey.from_encoded_point(
            ec.SECP256R1(), pubkey)
        try:
            pub.verify(signature, digest,
                       ec.ECDSA(Prehashed(hashes.SHA256())))
        except _Bad:
            return False
        return True
    q = _p256.decode_point(bytes(pubkey))
    if len(digest) != 32:
        raise ValueError("prehashed data has wrong length")
    r, s = _der.decode_dss_signature(signature)
    return _p256.verify_digest(q, digest, r, s)


# -- Ed25519 -------------------------------------------------------------------

class _Ed25519Key:
    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("Ed25519 seeds are 32 bytes")
        self.seed = bytes(seed)
        self.pub = _ed25519.public_from_seed(self.seed)


def ed25519_key_from_seed(seed: bytes):
    if HAVE_CRYPTOGRAPHY:
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PrivateKey)
        return Ed25519PrivateKey.from_private_bytes(seed)
    return _Ed25519Key(seed)


def ed25519_generate():
    import secrets
    return ed25519_key_from_seed(secrets.token_bytes(32))


def ed25519_public_bytes(key) -> bytes:
    if isinstance(key, _Ed25519Key):
        return key.pub
    if _is_lite(key):
        return key.public_key().public_bytes_raw()
    from cryptography.hazmat.primitives import serialization
    return key.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)


def ed25519_sign(key, msg: bytes) -> bytes:
    if isinstance(key, _Ed25519Key):
        return _ed25519.sign(key.seed, bytes(msg))
    return key.sign(msg)


def ed25519_verify(pubkey: bytes, signature: bytes, msg: bytes) -> bool:
    """RFC 8032 verify; raises ValueError for a key that is not 32 bytes."""
    if HAVE_CRYPTOGRAPHY:
        from cryptography.exceptions import InvalidSignature as _Bad
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PublicKey)
        try:
            Ed25519PublicKey.from_public_bytes(pubkey).verify(
                signature, msg)
        except _Bad:
            return False
        return True
    if len(pubkey) != 32:
        raise ValueError("Ed25519 public keys are 32 bytes")
    return _ed25519.verify(bytes(pubkey), bytes(signature), bytes(msg))


# -- the certificate shim (msp/) ---------------------------------------------

if HAVE_CRYPTOGRAPHY:  # pragma: no cover - exercised only with the real lib
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec, ed25519
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey, X25519PublicKey)
    from cryptography.x509.oid import NameOID
else:
    from . import lite_ec as ec
    from . import lite_ed25519 as ed25519
    from . import lite_hashes as hashes
    from . import lite_serialization as serialization
    from . import lite_x509 as x509
    from .lite_x25519 import X25519PrivateKey, X25519PublicKey
    from .lite_x509 import NameOID

from .aead import Aead, hkdf_sha256


__all__ = [
    "HAVE_CRYPTOGRAPHY", "InvalidSignature",
    "x509", "ec", "ed25519", "hashes", "serialization", "NameOID",
    "decode_dss_signature", "encode_dss_signature",
    "p256_key_from_scalar", "p256_generate", "p256_public_bytes",
    "p256_sign_digest", "p256_verify_digest",
    "ed25519_key_from_seed", "ed25519_generate", "ed25519_public_bytes",
    "ed25519_sign", "ed25519_verify",
    "X25519PrivateKey", "X25519PublicKey", "Aead", "hkdf_sha256",
]
