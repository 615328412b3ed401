"""BCCSP: the pluggable, batch-first crypto provider plane of the port.

Counterpart of `fabric_tpu/bccsp`.  Providers:
- sw   : host provider (cryptography, or the pure-Python fallback) —
         signing and the correctness oracle
- cuda : batched provider whose P-256 and Ed25519 lanes run
         hand-written CUDA kernels on the GPU
"""

from .provider import (VerifyItem, SCHEME_P256, SCHEME_ED25519,
                       SCHEME_IDEMIX)
from .factory import get_default, init_factories, FactoryOpts

__all__ = [
    "VerifyItem", "SCHEME_P256", "SCHEME_ED25519", "SCHEME_IDEMIX",
    "get_default", "init_factories", "FactoryOpts",
]
