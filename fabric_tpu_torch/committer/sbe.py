"""State-based (key-level) endorsement — SBE.

Reference parity: core/common/validation/statebased/
validator_keylevel.go:244 and the shim's SetStateValidationParameter.  A key's validation parameter
(a signature policy) OVERRIDES the chaincode endorsement policy for
transactions that write that key; keys without one fall back to the
chaincode policy.  Policy transitions take effect at the point the
metadata-updating transaction commits: later transactions in the SAME
block that touch the key are judged under the new policy when the updater
was valid (the reference's intra-block dependency tracking), and
transactions in later blocks read the committed metadata.

Storage model: validation parameters live in the companion namespace
`<ns>#meta` as ordinary versioned writes — MVCC orders concurrent policy
updates exactly like state writes, and the statedb is the committed
lookup source.

Counterpart of `fabric_tpu/committer/sbe.py`, whole.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from fabric_tpu_torch.policy import SignaturePolicy
from fabric_tpu_torch.utils import serde

META_SUFFIX = "#meta"


def meta_namespace(namespace: str) -> str:
    return namespace + META_SUFFIX


def is_meta_namespace(namespace: str) -> bool:
    return namespace.endswith(META_SUFFIX)


def base_namespace(meta_ns: str) -> str:
    return meta_ns[:-len(META_SUFFIX)]


def encode_policy(policy: SignaturePolicy) -> bytes:
    return serde.encode(policy.to_dict())


def decode_policy(data: bytes) -> SignaturePolicy:
    return SignaturePolicy.from_dict(serde.decode(data))


class SbeOverlay:
    """Intra-block view of key-level policies: committed statedb metadata
    plus updates from already-validated transactions of this block."""

    def __init__(self, lookup=None):
        # lookup: (base_ns, key) -> policy bytes | None (committed state)
        self._lookup = lookup or (lambda ns, key: None)
        self._updates: Dict[Tuple[str, str], Optional[bytes]] = {}
        # decoded-policy intern table, keyed by the policy BYTES: repeat
        # lookups return the SAME object, so consumers may key caches on
        # object identity for the overlay's lifetime (one block).  A
        # fresh decode per call would free+reuse ids and let one
        # policy's cached verdict answer for another's.
        self._decoded: Dict[bytes, Optional[SignaturePolicy]] = {}

    def policy_for(self, namespace: str, key: str) -> Optional[SignaturePolicy]:
        k = (namespace, key)
        if k in self._updates:
            raw = self._updates[k]
        else:
            raw = self._lookup(namespace, key)
        if not raw:
            return None
        raw = bytes(raw)
        if raw in self._decoded:
            return self._decoded[raw]
        try:
            pol = decode_policy(raw)
        except Exception:
            pol = None
        self._decoded[raw] = pol
        return pol

    def apply_valid_tx(self, meta_writes) -> None:
        """Record a VALID transaction's metadata writes:
        meta_writes: iterable of (base_ns, key, policy_bytes|None)."""
        for ns, key, raw in meta_writes:
            self._updates[(ns, key)] = raw


def statedb_lookup(statedb):
    """Adapter: committed key-level policies from the state DB."""
    def lookup(namespace: str, key: str):
        vv = statedb.get(meta_namespace(namespace), key)
        return None if vv is None else vv.value
    return lookup
