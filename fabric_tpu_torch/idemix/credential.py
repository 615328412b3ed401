"""Anonymous credentials over BN254 — the Idemix capability pillar.

The port's own copy of `fabric_tpu/idemix/credential.py`.  Fabric's
idemix (issuerkey.go, credential.go, signature.go) implements a
CL/BBS+-family anonymous credential scheme over BN254 (via fabric-amcl):
an issuer signs an attribute vector; the holder later proves possession
in zero knowledge, selectively disclosing attributes, unlinkably across
presentations.  This module implements the same BBS+ structure
(A = (g1 h0^s prod hi^mi)^(1/(e+x))) with the standard presentation
protocol (randomized signature + two Fiat-Shamir Schnorr proofs), on the
from-scratch pairing of fabric_tpu_torch/idemix/bn254.py.

Wire/test-vector compatibility with fabric-amcl is NOT claimed (different
generator derivation and hash-to-group); the scheme, proof obligations,
and verification equations are Fabric's.  The presentation's pairing
equation is what the CUDA provider batches on the card
(fabric_tpu_torch/ops/bn254.py, kernel KB8); the host check here is its
oracle.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from . import bn254 as bn


def _rand_zr() -> int:
    return secrets.randbelow(bn.R - 1) + 1


def _hash_zr(*parts) -> int:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, int):
            p = p.to_bytes(32, "big")
        elif isinstance(p, tuple):
            p = repr(p).encode()
        h.update(p)
        h.update(b"|")
    return int.from_bytes(h.digest(), "big") % bn.R


def attr_to_zr(value: bytes) -> int:
    return int.from_bytes(hashlib.sha256(value).digest(), "big") % bn.R


@dataclass
class IssuerKey:
    """isk = x; ipk = (w = g2^x, bases h0..hL) (issuerkey.go)."""
    x: int
    w: bn.G2Point
    h: List[Tuple[int, int]]     # h[0] = HRand; h[1..L] = attribute bases
    n_attrs: int

    @staticmethod
    def generate(n_attrs: int) -> "IssuerKey":
        x = _rand_zr()
        w = bn.g2_mul(x, bn.G2_GEN)
        h = [bn.hash_to_g1(b"fabric-tpu-idemix-h%d" % i)
             for i in range(n_attrs + 1)]
        return IssuerKey(x, w, h, n_attrs)

    def public(self) -> "IssuerPublicKey":
        return IssuerPublicKey(self.w, self.h, self.n_attrs)


@dataclass
class IssuerPublicKey:
    w: bn.G2Point
    h: List[Tuple[int, int]]
    n_attrs: int


@dataclass
class Credential:
    """(A, e, s) on attributes m1..mL (credential.go)."""
    A: Tuple[int, int]
    e: int
    s: int
    attrs: List[int]

    def B(self, ipk: IssuerPublicKey):
        b = bn.g1_add(bn.G1_GEN, bn.g1_mul(self.s, ipk.h[0]))
        for i, m in enumerate(self.attrs):
            b = bn.g1_add(b, bn.g1_mul(m, ipk.h[i + 1]))
        return b


def issue(isk: IssuerKey, attrs: Sequence[int]) -> Credential:
    if len(attrs) != isk.n_attrs:
        raise ValueError("attribute count mismatch")
    e = _rand_zr()
    s = _rand_zr()
    cred = Credential(None, e, s, list(attrs))
    b = cred.B(isk.public())
    inv = pow((e + isk.x) % bn.R, -1, bn.R)
    cred.A = bn.g1_mul(inv, b)
    return cred


def verify_credential(ipk: IssuerPublicKey, cred: Credential) -> bool:
    """e(A, w * g2^e) == e(B, g2) (signature.go credential check)."""
    if cred.A is None or not bn.g1_on_curve(cred.A):
        return False
    lhs = bn.pairing(cred.A, bn.g2_add(ipk.w, bn.g2_mul(cred.e, bn.G2_GEN)))
    rhs = bn.pairing(cred.B(ipk), bn.G2_GEN)
    return lhs == rhs


# ---------------------------------------------------------------------------
# Presentation: selective disclosure, unlinkable (signature.go NewSignature /
# Ver — the BBS+ SPK with Fiat-Shamir)
# ---------------------------------------------------------------------------

@dataclass
class Presentation:
    A_prime: Tuple[int, int]
    A_bar: Tuple[int, int]
    d: Tuple[int, int]
    c: int
    z_e: int
    z_r2: int
    z_r3: int
    z_sprime: int
    z_hidden: Dict[int, int]          # attr index -> response
    disclosed: Dict[int, int]         # attr index -> attribute value
    nonrev: Optional[dict] = None     # joint non-revocation proof fields


def present(ipk: IssuerPublicKey, cred: Credential,
            disclose: Sequence[int], nonce: bytes,
            nonrev=None, rh_index: Optional[int] = None) -> Presentation:
    """Randomize (A, e, s) and prove possession, disclosing attrs in
    `disclose` (indices).

    nonrev: optional revocation.NonRevProver — its weak-BB proof shares
    the hidden rh attribute's Schnorr response through the JOINT
    Fiat-Shamir challenge, binding "some unrevoked handle" to "THIS
    credential's handle" (nonrevocation-prover.go).  rh_index selects
    the handle attribute (must be hidden).
    """
    D = set(disclose)
    if nonrev is not None and (rh_index is None or rh_index in D):
        raise ValueError("non-revocation needs a HIDDEN rh attribute")
    r1 = _rand_zr()
    r2 = _rand_zr()
    r3 = pow(r1, -1, bn.R)
    B = cred.B(ipk)
    A_prime = bn.g1_mul(r1, cred.A)
    A_bar = bn.g1_add(bn.g1_mul((-cred.e) % bn.R, A_prime), bn.g1_mul(r1, B))
    d = bn.g1_add(bn.g1_mul(r1, B), bn.g1_mul((-r2) % bn.R, ipk.h[0]))
    s_prime = (cred.s - r2 * r3) % bn.R

    # pi1: A_bar - d = -e * A' + r2 * h0      (knowledge of e, r2)
    re_, rr2 = _rand_zr(), _rand_zr()
    t1 = bn.g1_add(bn.g1_mul((-re_) % bn.R, A_prime), bn.g1_mul(rr2, ipk.h[0]))
    # pi2: g1 + sum_D mi*hi = r3*d - s'*h0 - sum_{!D} mi*hi
    rr3, rs = _rand_zr(), _rand_zr()
    rm = {i: _rand_zr() for i in range(len(cred.attrs)) if i not in D}
    t2 = bn.g1_add(bn.g1_mul(rr3, d), bn.g1_mul((-rs) % bn.R, ipk.h[0]))
    for i, r in rm.items():
        t2 = bn.g1_add(t2, bn.g1_mul((-r) % bn.R, ipk.h[i + 1]))

    disclosed = {i: cred.attrs[i] for i in D}
    extra = ()
    if nonrev is not None:
        extra = nonrev.commit(rm[rh_index])
    c = _hash_zr(A_prime, A_bar, d, t1, t2, *extra, nonce,
                 repr(sorted(disclosed.items())).encode())

    return Presentation(
        A_prime=A_prime, A_bar=A_bar, d=d, c=c,
        z_e=(re_ + c * cred.e) % bn.R,
        z_r2=(rr2 + c * r2) % bn.R,
        z_r3=(rr3 + c * r3) % bn.R,
        z_sprime=(rs + c * s_prime) % bn.R,
        z_hidden={i: (rm[i] + c * cred.attrs[i]) % bn.R for i in rm},
        disclosed=disclosed,
        nonrev=nonrev.respond(c) if nonrev is not None else None,
    )


def verify_presentation(ipk: IssuerPublicKey, pres: Presentation,
                        nonce: bytes, epoch_pk=None,
                        rh_index: Optional[int] = None) -> bool:
    ok, pair = verify_presentation_parts(ipk, pres, nonce,
                                         epoch_pk=epoch_pk,
                                         rh_index=rh_index)
    if not ok:
        return False
    a_prime, a_bar = pair
    # (1) pairing check: e(A', w) == e(A_bar, g2) — host path; the CUDA
    # provider batches this equation instead (ops/bn254.py
    # pairing_check_batch)
    return bn.pairing(a_prime, ipk.w) == bn.pairing(a_bar, bn.G2_GEN)


def verify_presentation_parts(ipk: IssuerPublicKey, pres: Presentation,
                              nonce: bytes, epoch_pk=None,
                              rh_index: Optional[int] = None):
    """Everything in verify_presentation EXCEPT the pairing equation.

    Returns (ok, (A_prime, A_bar)): when ok, the presentation is valid
    iff e(A_prime, w) == e(A_bar, g2) — the caller either checks it on
    host or collects it into the device pairing batch (BASELINE config 4).
    """
    # reject (never crash on) degenerate attacker-supplied points
    if any(p is None for p in (pres.A_prime, pres.A_bar, pres.d)):
        return False, None
    # invalid-curve gate: the group ops and the pairing operate blindly
    # on off-curve coordinates; soundness requires membership
    if not all(bn.g1_on_curve(p)
               for p in (pres.A_prime, pres.A_bar, pres.d)):
        return False, None
    # (2) recompute t1: t1 = -z_e*A' + z_r2*h0 - c*(A_bar - d)
    abar_minus_d = bn.g1_add(pres.A_bar, bn.g1_neg(pres.d))
    t1 = bn.g1_add(
        bn.g1_add(bn.g1_mul((-pres.z_e) % bn.R, pres.A_prime),
                  bn.g1_mul(pres.z_r2, ipk.h[0])),
        bn.g1_mul((-pres.c) % bn.R, abar_minus_d))
    # (3) recompute t2: t2 = z_r3*d - z_s'*h0 - sum z_mi*hi
    #                        - c*(g1 + sum_D mi*hi)
    t2 = bn.g1_add(bn.g1_mul(pres.z_r3, pres.d),
                   bn.g1_mul((-pres.z_sprime) % bn.R, ipk.h[0]))
    for i, z in pres.z_hidden.items():
        if i in pres.disclosed or not 0 <= i < ipk.n_attrs:
            return False, None
        t2 = bn.g1_add(t2, bn.g1_mul((-z) % bn.R, ipk.h[i + 1]))
    if set(pres.z_hidden) | set(pres.disclosed) != set(range(ipk.n_attrs)):
        return False, None
    pub = bn.G1_GEN
    for i, m in pres.disclosed.items():
        pub = bn.g1_add(pub, bn.g1_mul(m, ipk.h[i + 1]))
    t2 = bn.g1_add(t2, bn.g1_mul((-pres.c) % bn.R, pub))

    if t1 is None or t2 is None:
        return False, None
    # (4) non-revocation (when the channel requires an epoch_pk):
    # recompute the weak-BB commitment from the shared rh response —
    # the joint challenge below then binds it to THIS credential
    extra = ()
    if epoch_pk is not None:
        from . import revocation as rev
        if epoch_pk.alg == rev.ALG_NO_REVOCATION:
            pass                         # empty revocation set attested
        else:
            if (not isinstance(pres.nonrev, dict) or rh_index is None
                    or rh_index not in pres.z_hidden
                    or pres.nonrev.get("epoch") != epoch_pk.epoch):
                return False, None
            extra = rev.nonrev_commitment_parts(
                epoch_pk, pres.nonrev, pres.c, pres.z_hidden[rh_index])
            if extra is None:
                return False, None
    c = _hash_zr(pres.A_prime, pres.A_bar, pres.d, t1, t2, *extra, nonce,
                 repr(sorted(pres.disclosed.items())).encode())
    if c != pres.c:
        return False, None
    return True, (pres.A_prime, pres.A_bar)
