"""Verify-once plane: signed verdict cache + speculative verification.

Converts the pipeline's 3x signature work (gateway ingress, orderer
SigFilter, commit-time validator) into at most ONE device verification
per unique (identity, signature) pair per node.  See cache.py for the
safety model and speculative.py for the ordering-overlap half.

Counterpart of `fabric_tpu/verify_plane`.  Not ported yet:
`register_ops`, the GET /verify_plane route, which waits for the port's
ops server; `VerdictCache.snapshot()` is what it would serve.
"""

from .attest import accept_block_attestations, attest_block
from .cache import CachingProvider, CoverageWindow, VerdictCache, item_digest
from .speculative import SpeculativeVerifier, derive_items
from .trust import AttestorTrust

__all__ = ["CachingProvider", "CoverageWindow", "VerdictCache",
           "item_digest", "SpeculativeVerifier", "derive_items",
           "attest_block", "accept_block_attestations", "AttestorTrust"]
