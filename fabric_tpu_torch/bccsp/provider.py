"""Provider interface and item types for the batch-first BCCSP plane.

Counterpart of `fabric_tpu/bccsp/provider.py`, with the same item type,
scheme and hash constants, and verbs.  Signing always stays on the host
CPU — private keys never reach the device.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Sequence

import numpy as np

SCHEME_P256 = "ecdsa-p256"
SCHEME_ED25519 = "ed25519"
SCHEME_IDEMIX = "idemix-bbs"

HASH_SHA256 = "sha256"
HASH_SHA384 = "sha384"
HASH_SHA3_256 = "sha3_256"
HASH_SHA3_384 = "sha3_384"


class VerifyItem(NamedTuple):
    """One signature-verification work item.

    scheme   : SCHEME_P256 | SCHEME_ED25519
    pubkey   : SEC1 uncompressed point (65B, 0x04||X||Y) for p256;
               raw 32B for ed25519
    signature: ASN.1/DER (r,s) for p256; raw 64B (R||S) for ed25519
    payload  : the 32-byte *digest* for p256 (hashing happened upstream);
               the full *message* for ed25519 (RFC 8032 signs the
               message itself)
    """
    scheme: str
    pubkey: bytes
    signature: bytes
    payload: bytes


def hash_payload(data: bytes, algo: str = HASH_SHA256) -> bytes:
    """The provider Hash verb."""
    try:
        return hashlib.new(algo, data).digest()
    except ValueError as e:
        raise ValueError(f"unsupported hash {algo!r}") from e


class Provider:
    """Abstract BCCSP provider.  Concrete: sw.SoftwareProvider,
    cuda.CudaProvider."""

    name = "abstract"

    # -- keys / signing (host-side in every provider) -----------------------

    def key_gen(self, scheme: str):
        raise NotImplementedError

    def sign(self, private_key, payload: bytes) -> bytes:
        raise NotImplementedError

    # -- verification -------------------------------------------------------

    def verify(self, item: VerifyItem) -> bool:
        return bool(self.batch_verify([item])[0])

    def batch_verify(self, items: Sequence[VerifyItem]) -> np.ndarray:
        """Verify a batch; returns bool[N] aligned to `items`.

        Malformed items (bad lengths, undecodable DER/points) yield False —
        they never raise, so one bad signature cannot fail a whole block."""
        raise NotImplementedError

    def batch_verify_async(self, items: Sequence[VerifyItem]):
        """Start verifying a batch; returns resolve() -> bool[N].

        Device providers override this to enqueue the work and return
        at once, so the caller can overlap host work with the device.
        The default is lazy-but-correct: the work happens at resolve()."""
        from fabric_tpu_torch.ops_plane import tracing
        items = list(items)
        span = tracing.tracer.start_span(
            "bccsp.batch_verify", require_parent=True,
            attributes={"provider": self.name, "batch_size": len(items)})

        def resolve():
            import time as _t
            t0 = _t.perf_counter()
            try:
                out = self.batch_verify(items)
            except BaseException as exc:
                span.set_attribute("error", repr(exc))
                span.end(status="ERROR")
                raise
            span.set_attribute("block_until_ready_s",
                               round(_t.perf_counter() - t0, 6))
            span.end()
            return out

        return resolve

    def hash(self, data: bytes, algo: str = HASH_SHA256) -> bytes:
        return hash_payload(data, algo)
