"""Idemix MSP: anonymous identities as a first-class membership provider.

The port's own copy of `fabric_tpu/idemix/msp.py` (Fabric's
msp/idemixmsp.go + bccsp/idemix): an MSP whose identities are fresh unlinkable BBS+ presentations instead of
X.509 certificates.  The identity BYTES disclose only (mspid, OU, role);
the SIGNATURE over a payload is a presentation whose Fiat-Shamir nonce
is the payload digest, proving possession of an issuer credential whose
hidden attributes include the enrollment id and the revocation handle
(checked against the channel's revocation epoch when configured).

Attribute convention (idemixmsp.go's four attributes):
    [0] OU, [1] role (1 = member, 2 = admin), [2] enrollment id, [3] rh
OU/role are DISCLOSED in every presentation; EID and RH never are.

This MSP plugs into the same surfaces as the X.509 MSP: the validator's
deserialize_from_msps, policy principals, and the provider batch-verify
plane (scheme "idemix-bbs": the software provider verifies an item on
the host, the CUDA provider runs the host checks here and batches the
pairing equation on the card, kernel KB8, BASELINE config 4).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.bccsp.provider import SCHEME_IDEMIX, VerifyItem
from fabric_tpu_torch.utils import serde

from . import bn254 as bn
from . import credential as cred
from . import revocation as rev

ATTR_OU, ATTR_ROLE, ATTR_EID, ATTR_RH = 0, 1, 2, 3
N_ATTRS = 4
ROLE_MEMBER, ROLE_ADMIN = 1, 2


# -- serialization -----------------------------------------------------------

def _g1_l(pt) -> list:
    return [int(pt[0]), int(pt[1])]


def _g1_t(v) -> Tuple[int, int]:
    return (int(v[0]), int(v[1]))


def serialize_ipk(ipk: cred.IssuerPublicKey) -> bytes:
    (xa, xb), (ya, yb) = ipk.w
    return serde.encode({
        "w": [xa, xb, ya, yb],
        "h": [_g1_l(p) for p in ipk.h],
        "n_attrs": ipk.n_attrs,
    })


def deserialize_ipk(raw: bytes) -> cred.IssuerPublicKey:
    d = serde.decode(raw)
    w = ((d["w"][0], d["w"][1]), (d["w"][2], d["w"][3]))
    h = [_g1_t(p) for p in d["h"]]
    for p in h:
        if not bn.g1_on_curve(p):
            raise ValueError("ipk base off-curve")
    return cred.IssuerPublicKey(w, h, int(d["n_attrs"]))


def serialize_presentation(p: cred.Presentation) -> bytes:
    return serde.encode({
        "ap": _g1_l(p.A_prime), "ab": _g1_l(p.A_bar), "d": _g1_l(p.d),
        "c": p.c, "ze": p.z_e, "zr2": p.z_r2, "zr3": p.z_r3,
        "zs": p.z_sprime,
        "zh": {str(k): v for k, v in p.z_hidden.items()},
        "disc": {str(k): v for k, v in p.disclosed.items()},
        "nonrev": p.nonrev if p.nonrev is not None else {},
    })


def deserialize_presentation(raw: bytes) -> cred.Presentation:
    d = serde.decode(raw)
    return cred.Presentation(
        A_prime=_g1_t(d["ap"]), A_bar=_g1_t(d["ab"]), d=_g1_t(d["d"]),
        c=int(d["c"]), z_e=int(d["ze"]), z_r2=int(d["zr2"]),
        z_r3=int(d["zr3"]), z_sprime=int(d["zs"]),
        z_hidden={int(k): int(v) for k, v in d["zh"].items()},
        disclosed={int(k): int(v) for k, v in d["disc"].items()},
        # attacker-typed: only a non-empty dict is a proof
        nonrev=(d["nonrev"] if isinstance(d.get("nonrev"), dict)
                and d["nonrev"] else None),
    )


def attr_int(value: bytes) -> int:
    return cred.attr_to_zr(value)


def serialize_credential(c: cred.Credential) -> bytes:
    return serde.encode({"a": _g1_l(c.A), "e": c.e, "s": c.s,
                         "attrs": list(c.attrs)})


def deserialize_credential(raw: bytes) -> cred.Credential:
    d = serde.decode(raw)
    return cred.Credential(_g1_t(d["a"]), int(d["e"]), int(d["s"]),
                           [int(a) for a in d["attrs"]])


# -- config ------------------------------------------------------------------

@dataclass
class IdemixMSPConfig:
    """idemixmsp config: issuer public key + optional revocation data."""
    mspid: str
    ipk_bytes: bytes
    ra_public_key_pem: bytes = b""
    epoch_pk: Optional[rev.EpochPK] = None      # current revocation epoch


# -- identities --------------------------------------------------------------

class IdemixIdentity:
    """A deserialized idemix identity: only (mspid, ou, role) are known;
    signature verification carries the cryptographic weight."""

    def __init__(self, mspid: str, ou: str, role: int, config_key: bytes):
        self.mspid = mspid
        self.ou = ou
        self.role = role
        self._config_key = config_key      # pubkey field of VerifyItems

    def serialize(self) -> bytes:
        return serde.encode({"mspid": self.mspid, "fmt": "idemix",
                             "ou": self.ou, "role": self.role})

    def verify_item(self, payload: bytes, signature: bytes) -> VerifyItem:
        """The batchable verification unit: payload digest is the
        presentation nonce (identities.go:178 digest-only parity).

        The identity's CLAIMED (ou, role) ride in the item so the
        verifier checks them against the presentation's disclosed
        attributes — otherwise a member credential could claim admin in
        its identity bytes and policy evaluation would believe it."""
        digest = hashlib.sha256(payload).digest()
        pk = serde.encode({"cfg": self._config_key, "ou": self.ou,
                           "role": self.role})
        return VerifyItem(SCHEME_IDEMIX, pk, signature, digest)

    def verify(self, payload: bytes, signature: bytes) -> bool:
        return verify_item_host(self.verify_item(payload, signature))


class IdemixSigningIdentity(IdemixIdentity):
    """Holder side: a credential + the per-epoch non-revocation data."""

    def __init__(self, mspid: str, config: IdemixMSPConfig,
                 credential: cred.Credential, ou: str, role: int,
                 handle_sig=None):
        super().__init__(mspid, ou, role, _config_key(config))
        self._config = config
        self._cred = credential
        self._handle_sig = handle_sig      # weak-BB sig for this epoch

    def sign(self, payload: bytes) -> bytes:
        ipk = deserialize_ipk(self._config.ipk_bytes)
        nonce = hashlib.sha256(payload).digest()
        nonrev = None
        epk = self._config.epoch_pk
        if epk is not None and epk.alg == rev.ALG_PLAIN_SIGNATURE:
            if self._handle_sig is None:
                raise PermissionError("no non-revocation credential for "
                                      "the current epoch")
            nonrev = rev.NonRevProver(epk, self._handle_sig,
                                      self._cred.attrs[ATTR_RH])
        pres = cred.present(ipk, self._cred,
                            disclose=[ATTR_OU, ATTR_ROLE], nonce=nonce,
                            nonrev=nonrev, rh_index=ATTR_RH)
        return serialize_presentation(pres)


# -- the verification core (shared by providers and the MSP) -----------------

_CONFIGS: Dict[bytes, IdemixMSPConfig] = {}


def _config_key(config: IdemixMSPConfig) -> bytes:
    """VerifyItem.pubkey for this MSP's items: a self-contained serde of
    the verification material (registered for host lookup)."""
    key = serde.encode({
        "ipk": config.ipk_bytes,
        "ra": config.ra_public_key_pem,
        "epoch": (serde.encode({
            "epoch": config.epoch_pk.epoch, "alg": config.epoch_pk.alg,
            "w": config.epoch_pk.w_e, "sig": config.epoch_pk.signature})
            if config.epoch_pk is not None else b""),
    })
    _CONFIGS.setdefault(key, config)
    return key


def verify_item_host(item: VerifyItem) -> bool:
    """Host-side verification of one idemix VerifyItem (the provider
    plane's scheme handler)."""
    ok, ipk_bytes, pair = collect_item_parts(item)
    if not ok:
        return False
    from . import bn254 as bn
    ipk = deserialize_ipk(ipk_bytes)
    a_prime, a_bar = pair
    return bn.pairing(a_prime, ipk.w) == bn.pairing(a_bar, bn.G2_GEN)


def collect_item_parts(item: VerifyItem):
    """Everything host-side EXCEPT the pairing equation.

    -> (ok, ipk_bytes, (A_prime, A_bar)).  When ok, the item is valid
    iff e(A_prime, w_ipk) == e(A_bar, g2) — the CUDA provider batches
    that check over every issuer of a batch (ops/bn254.py
    pairing_check_batch, BASELINE config 4); verify_item_host checks it
    with host ints.
    """
    try:
        outer = serde.decode(item.pubkey)
        kd = serde.decode(outer["cfg"])
        claimed_ou = str(outer["ou"])
        claimed_role = int(outer["role"])
        ipk = deserialize_ipk(kd["ipk"])
        pres = deserialize_presentation(item.signature)
    except Exception:
        return False, None, None
    epoch_pk = None
    if kd.get("epoch"):
        try:
            ed = serde.decode(kd["epoch"])
            epoch_pk = rev.EpochPK(int(ed["epoch"]), int(ed["alg"]),
                                   ed["w"], ed["sig"])
        except Exception:
            return False, None, None
        if not rev.verify_epoch_pk(epoch_pk, kd["ra"]):
            return False, None, None
    # the presentation must disclose exactly OU+role, and they must
    # MATCH the identity's claims — the binding between the anonymous
    # credential and what policy evaluation believes about it
    if pres.disclosed != {ATTR_OU: attr_int(claimed_ou.encode()),
                          ATTR_ROLE: claimed_role}:
        return False, None, None
    try:
        ok, pair = cred.verify_presentation_parts(
            ipk, pres, item.payload, epoch_pk=epoch_pk, rh_index=ATTR_RH)
    except Exception:
        # attacker-shaped structures must yield False, never crash the
        # batch path (policy.go:390-393 per-signature failure semantics)
        return False, None, None
    if not ok:
        return False, None, None
    return True, kd["ipk"], pair


# -- the MSP -----------------------------------------------------------------

class IdemixMSP:
    """msp.MSP surface for idemix identities (idemixmsp.go)."""

    def __init__(self, config: IdemixMSPConfig):
        self.mspid = config.mspid
        self.config = config
        self._key = _config_key(config)

    def deserialize_identity(self, data: bytes) -> IdemixIdentity:
        d = serde.decode(data)
        if d.get("fmt") != "idemix" or d.get("mspid") != self.mspid:
            raise ValueError("not an idemix identity of this MSP")
        role = int(d.get("role", 0))
        if role not in (ROLE_MEMBER, ROLE_ADMIN):
            raise ValueError("bad idemix role")
        return IdemixIdentity(self.mspid, str(d.get("ou", "")), role,
                              self._key)

    def is_valid(self, ident) -> bool:
        # structural only: an idemix identity has no certificate chain;
        # the presentation carried as its signature proves membership,
        # and verify_item_host re-checks the disclosed (ou, role)
        return isinstance(ident, IdemixIdentity) and ident.mspid == self.mspid

    def validate(self, ident) -> None:
        if not self.is_valid(ident):
            raise ValueError("invalid idemix identity")

    def satisfies_principal(self, ident, principal) -> bool:
        if getattr(principal, "mspid", None) != self.mspid:
            return False
        role = getattr(principal, "role", "member")
        if role == "member":
            return True
        if role == "admin":
            return ident.role == ROLE_ADMIN
        if role == "ou":
            return ident.ou == getattr(principal, "ou", None)
        return False


# -- issuance helper (idemixgen's core) --------------------------------------

def enroll(isk: cred.IssuerKey, config: IdemixMSPConfig, ou: str,
           role: int, enrollment_id: str,
           ra: Optional[rev.RevocationAuthority] = None,
           rh: Optional[int] = None) -> IdemixSigningIdentity:
    """Issue a credential over the 4-attribute convention and wrap it as
    a signing identity (idemixgen signerconfig)."""
    import secrets
    rh = rh if rh is not None else secrets.randbelow(bn.R - 1) + 1
    attrs = [attr_int(ou.encode()), role,
             attr_int(enrollment_id.encode()), rh % bn.R]
    credential = cred.issue(isk, attrs)
    handle_sig = None
    epk = config.epoch_pk
    if (ra is not None and epk is not None
            and epk.alg == rev.ALG_PLAIN_SIGNATURE):
        handle_sig = ra.sign_handle(epk.epoch, rh)
    return IdemixSigningIdentity(config.mspid, config, credential, ou,
                                 role, handle_sig=handle_sig)
