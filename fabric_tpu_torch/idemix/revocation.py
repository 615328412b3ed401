"""Credential revocation: epoch CRIs + weak-BB non-revocation proofs.

The port's own copy of `fabric_tpu/idemix/revocation.py`, on the port's
crypto shim (`cryptography`, or the pure-Python engines where it is not
installed).  Fabric's idemix revocation_authority.go (the RA
signs per-epoch credential revocation information with a long-term ECDSA
key) and nonrevocation-prover.go / nonrevocation-verifier.go (per
algorithm: ALG_NO_REVOCATION — the epoch attests an empty revocation
set — and a signature-based scheme where the holder proves, in zero
knowledge, possession of the RA's weak Boneh-Boyen signature on its
hidden revocation-handle attribute).

The weak-BB construction here:
  per epoch e the RA samples x_e, publishes W_e = g2^x_e inside an
  ECDSA-signed epoch record, and signs each UNREVOKED handle rh as
    A_rh = g1^(1/(x_e + rh)).
  The holder randomizes A' = A_rh^t and proves knowledge of (rh, t) with
    e(A', W_e) * e(A', g2)^rh = e(g1, g2)^t
  via a Schnorr proof over GT whose response for rh is THE SAME response
  the BBS+ presentation uses for the hidden rh attribute (joint
  Fiat-Shamir challenge) — so the proven-unrevoked handle is exactly the
  credential's handle, not some other value the prover knows a
  signature for.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

from fabric_tpu_torch.utils import serde

from . import bn254 as bn

ALG_NO_REVOCATION = 0
ALG_PLAIN_SIGNATURE = 1

# GT bases reused by every proof
_GT_G = None


def _gt_gen():
    global _GT_G
    if _GT_G is None:
        _GT_G = bn.pairing(bn.G1_GEN, bn.G2_GEN)
    return _GT_G


def _g2_ser(pt) -> bytes:
    (xa, xb), (ya, yb) = pt
    return b"".join(v.to_bytes(32, "big") for v in (xa, xb, ya, yb))


def _g2_deser(raw: bytes):
    if len(raw) != 128:
        raise ValueError("bad G2 encoding")
    vs = [int.from_bytes(raw[i * 32:(i + 1) * 32], "big") for i in range(4)]
    return ((vs[0], vs[1]), (vs[2], vs[3]))


@dataclass(frozen=True)
class EpochPK:
    """The verifier-side CRI: per-epoch revocation public data, bound to
    the RA's long-term key (revocation_authority.go CRI)."""
    epoch: int
    alg: int
    w_e: bytes              # serialized G2 (empty for ALG_NO_REVOCATION)
    signature: bytes        # RA long-term ECDSA over the canonical body

    def body(self) -> bytes:
        return serde.encode({"epoch": self.epoch, "alg": self.alg,
                             "w": self.w_e})


class RevocationAuthority:
    """Issues epoch records and per-handle weak-BB signatures."""

    def __init__(self):
        from fabric_tpu_torch.crypto import ec
        self._lt_key = ec.generate_private_key(ec.SECP256R1())
        self._epochs: Dict[int, int] = {}       # epoch -> x_e
        self.revoked: Set[int] = set()

    # -- long-term key -------------------------------------------------------

    def public_key_pem(self) -> bytes:
        from fabric_tpu_torch.crypto import serialization
        return self._lt_key.public_key().public_bytes(
            serialization.Encoding.PEM,
            serialization.PublicFormat.SubjectPublicKeyInfo)

    def _sign(self, body: bytes) -> bytes:
        from fabric_tpu_torch.crypto import hashes
        from fabric_tpu_torch.crypto import ec
        return self._lt_key.sign(body, ec.ECDSA(hashes.SHA256()))

    # -- epochs --------------------------------------------------------------

    def revoke(self, rh: int) -> None:
        self.revoked.add(rh % bn.R)

    def epoch_pk(self, epoch: int,
                 alg: int = ALG_PLAIN_SIGNATURE) -> EpochPK:
        if alg == ALG_NO_REVOCATION:
            rec = EpochPK(epoch, alg, b"", b"")
            return EpochPK(epoch, alg, b"", self._sign(rec.body()))
        x_e = self._epochs.get(epoch)
        if x_e is None:
            x_e = secrets.randbelow(bn.R - 2) + 1
            self._epochs[epoch] = x_e
        w = _g2_ser(bn.g2_mul(x_e, bn.G2_GEN))
        rec = EpochPK(epoch, alg, w, b"")
        return EpochPK(epoch, alg, w, self._sign(rec.body()))

    def sign_handle(self, epoch: int, rh: int):
        """Weak-BB signature on an unrevoked handle for this epoch (the
        holder's per-epoch non-revocation credential)."""
        rh %= bn.R
        if rh in self.revoked:
            raise PermissionError(f"handle revoked")
        if epoch not in self._epochs:
            self.epoch_pk(epoch)
        x_e = self._epochs[epoch]
        inv = pow((x_e + rh) % bn.R, -1, bn.R)
        return bn.g1_mul(inv, bn.G1_GEN)


def verify_epoch_pk(epk: EpochPK, ra_public_key_pem: bytes) -> bool:
    from fabric_tpu_torch.crypto import InvalidSignature
    from fabric_tpu_torch.crypto import hashes, serialization
    from fabric_tpu_torch.crypto import ec
    try:
        pub = serialization.load_pem_public_key(ra_public_key_pem)
        pub.verify(epk.signature, epk.body(), ec.ECDSA(hashes.SHA256()))
        return True
    except (InvalidSignature, ValueError, TypeError):
        return False


# ---------------------------------------------------------------------------
# prover / verifier halves (joined into the BBS+ presentation by
# credential.present / credential.verify_presentation)
# ---------------------------------------------------------------------------

class NonRevProver:
    """Holder-side context: commits before the joint challenge, responds
    after."""

    def __init__(self, epk: EpochPK, handle_sig, rh: int):
        if epk.alg != ALG_PLAIN_SIGNATURE:
            raise ValueError("prover only needed for ALG_PLAIN_SIGNATURE")
        self.epk = epk
        self.rh = rh % bn.R
        self.t = secrets.randbelow(bn.R - 2) + 1
        self.a_prime = bn.g1_mul(self.t, handle_sig)
        self._r_t = secrets.randbelow(bn.R - 2) + 1
        self._r_rh: Optional[int] = None

    def commit(self, r_rh: int) -> Tuple:
        """r_rh: the BBS+ proof's randomizer for the hidden rh attribute
        (shared — this is the binding).  Returns hashable commitment
        parts for the joint Fiat-Shamir challenge."""
        self._r_rh = r_rh
        b1 = bn.pairing(self.a_prime, bn.G2_GEN)
        t3 = bn.f12_mul(bn.f12_pow_raw(_gt_gen(), self._r_t),
                        bn.f12_pow_raw(bn.f12_inv(b1), r_rh))
        return (self.epk.epoch, self.epk.w_e, self.a_prime,
                repr(t3).encode())

    def respond(self, c: int) -> dict:
        return {"epoch": self.epk.epoch, "a_prime": list(self.a_prime),
                "z_t": (self._r_t + c * self.t) % bn.R}


def nonrev_commitment_parts(epk: EpochPK, proof: dict, c: int,
                            z_rh: int) -> Optional[Tuple]:
    """Verifier half: recompute the commitment parts from the responses
    (T3' = B2^z_t * B1^(-z_rh) * P1^(-c)) for the joint-challenge
    re-derivation.  Returns None when the proof is structurally invalid."""
    try:
        a_prime = (int(proof["a_prime"][0]), int(proof["a_prime"][1]))
        z_t = int(proof["z_t"]) % bn.R
    except (KeyError, TypeError, ValueError, IndexError):
        return None
    if not bn.g1_on_curve(a_prime) or a_prime is None:
        return None
    w_e = _g2_deser(epk.w_e)
    p1 = bn.pairing(a_prime, w_e)
    b1 = bn.pairing(a_prime, bn.G2_GEN)
    t3 = bn.f12_mul(
        bn.f12_mul(bn.f12_pow_raw(_gt_gen(), z_t),
                   bn.f12_pow_raw(bn.f12_inv(b1), z_rh % bn.R)),
        bn.f12_pow_raw(bn.f12_inv(p1), c % bn.R))
    return (epk.epoch, epk.w_e, a_prime, repr(t3).encode())
