"""Verify-once plane: signed verdict cache + speculative verification.

Converts the pipeline's 3x signature work (gateway ingress, orderer
SigFilter, commit-time validator) into at most ONE device verification
per unique (identity, signature) pair per node.  See cache.py for the
safety model and speculative.py for the ordering-overlap half.

Counterpart of `fabric_tpu/verify_plane`, whole: `register_ops` mounts
GET /verify_plane on a node's `ops_plane.OperationsServer`.
"""

from .attest import accept_block_attestations, attest_block
from .cache import (CachingProvider, CoverageWindow, VerdictCache,
                    item_digest, note_device_verifications)
from .speculative import SpeculativeVerifier, derive_items
from .trust import AttestorTrust

__all__ = ["CachingProvider", "CoverageWindow", "VerdictCache",
           "item_digest", "note_device_verifications",
           "SpeculativeVerifier", "derive_items", "register_ops",
           "attest_block", "accept_block_attestations", "AttestorTrust"]


def register_ops(ops, cache: VerdictCache, spec=None, extra=None) -> None:
    """Mount GET /verify_plane on a node's ops server: the cache's live
    economics plus the speculative worker's state.  `extra()` lets the
    node add role-specific fields (e.g. the orderer's attestation-trust
    setting)."""

    def _route(path, body):
        out = cache.snapshot()
        if spec is not None:
            out["speculative_dispatched"] = spec.dispatched
        if extra is not None:
            try:
                out.update(extra())
            except Exception:
                pass
        return 200, out

    ops.register_route("GET", "/verify_plane", _route)
