"""Socket transport for the Raft orderer cluster: the consenter binding.

Counterpart of `fabric_tpu/orderer/cluster.py`, so far only its
`cert_fingerprint`, the token that binds an identity to its certificate
("mspid|cert-sha256"), by which the byzantine plane names whom it
convicts.  The cluster's transport (`raft.step` over the RPC plane, its
sender queues and its clock thread) comes with the port's orderer.
"""

from __future__ import annotations


def cert_fingerprint(cert) -> str:
    """sha256 hex of the DER certificate — the consenter binding token.

    CN strings are forgeable by any org's CA; the full certificate hash
    is not (the reference authenticates the sender's actual TLS cert
    against the consenter set, cluster/comm.go).
    """
    import hashlib
    from fabric_tpu_torch.crypto import serialization
    der = cert.public_bytes(serialization.Encoding.DER)
    return hashlib.sha256(der).hexdigest()
