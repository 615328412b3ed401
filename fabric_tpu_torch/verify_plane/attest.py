"""Verdict attestations riding the deliver stream (orderer -> peer).

The orderer already verified every admitted envelope's creator
signature at its SigFilter (and cached the verdict).  When
`verify_once.attest_deliver` is on, each delivered block carries a
per-envelope list of cache-key digests for the creator items whose
verdicts this orderer holds as True — the committing peer can then seed
its own verdict cache and skip re-dispatching those signatures at the
commit gate.

Trust model (same as the gateway->orderer direction, msgprocessor.py):
the digest itself is a public hash anyone can compute, so an
attestation carries NO authority of its own.  The peer only honours the
list when

  - `verify_once.trust_attestations` is on AND the transport-
    authenticated sender of the deliver stream — the orderer's
    handshake-verified identity — is pinned in the peer's configured
    `attestors` allowlist by (mspid, cert sha256); and
  - the digest re-derived from the peer's OWN envelope bytes and OWN
    MSP set is bit-identical to the attested one, so a forged or stale
    digest can never vouch for different bytes than the ones being
    committed.

Items are derived with the same `derive_items` the speculative plane
and the committer use, so an accepted attestation lands under exactly
the cache key the commit-time validator will probe.
"""

from __future__ import annotations

from typing import List, Optional

from .cache import VerdictCache, item_digest
from .speculative import derive_items


def attest_block(cache: VerdictCache, block, channel_id: str,
                 msps) -> Optional[List[Optional[str]]]:
    """Per-envelope attestation list for one block: the creator item's
    digest hex where this node's cache holds verdict True, else None.
    Returns None (send nothing) when no envelope is attestable."""
    out: List[Optional[str]] = []
    any_hit = False
    memo: dict = {}
    for raw in block.data:
        att = None
        try:
            creators, _ = derive_items(raw, channel_id, msps, memo=memo)
            if creators and cache.peek(creators[0]) is True:
                att = item_digest(creators[0]).hex()
                any_hit = True
        except Exception:
            att = None
        out.append(att)
    return out if any_hit else None


def accept_block_attestations(cache: VerdictCache, block, attests,
                              channel_id: str, msps, trust=None,
                              attestor_binding=None) -> int:
    """Seed `cache` from an AUTHORIZED sender's attestation list (the
    caller already checked the allowlist).  Every digest is re-derived
    from our own envelope bytes before acceptance.  Returns how many
    verdicts were seeded.

    `trust`/`attestor_binding` (optional) feed the sender's per-identity
    standing (trust.py): a digest that fails re-derivation is a vouch
    for bytes the sender did not deliver and revokes it; envelopes whose
    creator cannot even be derived are skipped without blame (that is a
    local MSP question, not the attestor's)."""
    if not attests:
        return 0
    n = 0
    memo: dict = {}
    for raw, att in zip(block.data, attests):
        if not att:
            continue
        try:
            creators, _ = derive_items(raw, channel_id, msps, memo=memo)
            if not creators:
                continue
            item = creators[0]
            if item_digest(item).hex() != att:
                if trust is not None and attestor_binding is not None:
                    trust.note_mismatch(attestor_binding)
                continue
            cache.put(item, True, scope=channel_id)
            n += 1
        except Exception:
            continue
    if n and trust is not None and attestor_binding is not None:
        trust.note_accepted(attestor_binding, n)
    if n:
        try:
            from .cache import _m
            _m()["attested"].add(n)
        except Exception:
            pass
    return n
