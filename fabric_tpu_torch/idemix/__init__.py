"""Idemix anonymous-credential plane of the port (host side).

The port's own copy of `fabric_tpu/idemix/`: BN254 host arithmetic
(bn254.py), the BBS+ credential scheme with zero-knowledge
selective-disclosure presentations (credential.py), revocation
(revocation.py), the idemix MSP (msp.py) and idemixgen (gen.py).  The
presentation's pairing equation runs batched on the card through
`fabric_tpu_torch.bccsp.cuda.CudaProvider` (kernel KB8).
"""

from .credential import (
    Credential,
    IssuerKey,
    IssuerPublicKey,
    Presentation,
    attr_to_zr,
    issue,
    present,
    verify_credential,
    verify_presentation,
)

__all__ = ["IssuerKey", "IssuerPublicKey", "Credential", "Presentation",
           "issue", "present", "verify_credential", "verify_presentation",
           "attr_to_zr"]
