"""The orderer node's identity loaders.

Counterpart of `fabric_tpu/node/orderer.py`, so far only its
`load_signing_identity` (an MSP signing identity from a PEM certificate
and key) and `attestation_trust` (the `verify_once` config's attestor
switch and allowlist), which the peer's intake and its tests need.  The
runnable orderer (Broadcast/Deliver + Raft over the RPC plane) comes
with the port's orderer.
"""

from __future__ import annotations

from fabric_tpu_torch.msp.identity import SigningIdentity


def load_signing_identity(mspid: str, cert_pem: bytes, key_pem: bytes,
                          scheme: str = None) -> SigningIdentity:
    from fabric_tpu_torch.crypto import x509
    from fabric_tpu_torch.crypto import serialization
    from fabric_tpu_torch.bccsp.sw import SigningKey

    from fabric_tpu_torch.crypto import ec as _ec
    from fabric_tpu_torch.bccsp import SCHEME_ED25519, SCHEME_P256

    cert = x509.load_pem_x509_certificate(cert_pem)
    key = serialization.load_pem_private_key(key_pem, password=None)
    if scheme is None:
        scheme = (SCHEME_P256 if isinstance(key, _ec.EllipticCurvePrivateKey)
                  else SCHEME_ED25519)
    return SigningIdentity(mspid, cert, SigningKey(scheme, key))


def attestation_trust(vcfg: dict):
    """(trust_attestations, attestors) from a `verify_once` config
    sub-dict.  Trusting gateway verdict attestations is a security
    decision, so it is OFF unless explicitly enabled — and useless
    without an attestor allowlist naming who may vouch."""
    return (bool(vcfg.get("trust_attestations", False)),
            list(vcfg.get("attestors", [])))
