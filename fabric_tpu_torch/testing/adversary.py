"""Adversarial actors: in-process nodes that commit Byzantine crimes
deterministically.

Crash-stop chaos (chaos.py + comm/faults.py) models components that
die; this module models components that LIE, so the byzantine plane's
detection/containment paths can be exercised as ordinary seeded tests:

  EquivocatingOrderer   a real OrdererNode (it orders, raft-replicates,
                        and serves honestly) whose deliver stream also
                        commits crimes on configured heights: it serves
                        the honest block AND a forged, validly-SIGNED
                        sibling at the same height (equivocation /
                        double-serve), or tampers the attestation
                        digests riding its deliver frames.
  forge_fork_block      build the history-rewrite weapon: a forged
                        sibling of an already-committed block, signed
                        with a consenter key — inject it via gossip and
                        every honest peer convicts the signer from its
                        blockstore witness ("fork"), with zero effect
                        on the committed chain.
  GossipPoisoner        injects garbage / badly-signed / stale payloads
                        (and forged blocks) straight into a victim
                        channel's gossip intake — the same entrypoint
                        transport casts land on, minus the transport,
                        so every injection is deterministic.

All forgeries are signed with REAL consenter keys (the adversary owns
an orderer identity), so they pass signature verification and reach the
witness/judgment layer — exactly the threat the byzantine plane exists
for.  Nothing here weakens honest nodes: adversaries are built only by
tests and scenarios, via ChaosNet's `node_factory` hook.

Counterpart of `fabric_tpu/testing/adversary.py`, whole, on the port's
imports: the forgeries are made of the port's types, and
`EquivocatingOrderer` is the port's `OrdererNode`.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from fabric_tpu_torch.node.orderer import OrdererNode

logger = logging.getLogger("fabric_tpu_torch.testing.adversary")


def forge_sibling(block, signer) -> "Block":
    """A forged sibling of `block`: same height, same previous_hash,
    different data (one duplicated envelope) — so a DIFFERENT header
    hash — carrying a fully VALID orderer signature by `signer`.  This
    is the provable-misbehavior artifact: two validly-signed headers at
    one height."""
    from fabric_tpu_torch.orderer.blockwriter import block_signed_bytes
    from fabric_tpu_torch.protocol.build import new_nonce
    from fabric_tpu_torch.protocol.types import (
        META_LAST_CONFIG,
        META_SIGNATURES,
        Block,
        BlockHeader,
        BlockMetadata,
        block_data_hash,
    )
    data = [bytes(d) for d in block.data]
    data.append(data[-1] if data else b"\x00")
    header = BlockHeader(block.header.number, block.header.previous_hash,
                         block_data_hash(data))
    last_config = int(block.metadata.items.get(META_LAST_CONFIG, 0))
    forged = Block(header, data, BlockMetadata({
        META_LAST_CONFIG: last_config}))
    sig_header = {"creator": signer.serialize(), "nonce": new_nonce()}
    forged.metadata.items[META_SIGNATURES] = [{
        "sig_header": sig_header,
        "signature": signer.sign(
            block_signed_bytes(forged, sig_header, last_config)),
    }]
    return forged


def forge_fork_block(blockstore, height: int, signer):
    """History rewrite: a validly-signed forged sibling of the COMMITTED
    block at `height` (the fork-at-height crime)."""
    return forge_sibling(blockstore.get_by_number(int(height)), signer)


def break_signature(block):
    """A copy of `block` whose header no longer matches its orderer
    signature (data_hash flipped, signature kept): parses fine, fails
    MCS verification — the `bad_sig` gossip offense."""
    from fabric_tpu_torch.protocol.types import Block, BlockHeader
    bad_hash = bytes(b ^ 0xFF for b in block.header.data_hash)
    return Block(
        BlockHeader(block.header.number, block.header.previous_hash,
                    bad_hash),
        [bytes(d) for d in block.data], block.metadata)


class EquivocatingOrderer(OrdererNode):
    """An OrdererNode that commits deliver-plane crimes on demand.

    `crimes` keys:
      mode         "equivocate" (default): serve honest block then a
                   forged sibling at each crime height.
                   "two_faced": equivocate ONLY toward the peers named
                   in `victims` — every other caller gets a spotless
                   honest stream.  Without fraud-proof gossip, only the
                   victims ever hold conviction evidence; with it, one
                   victim's conviction must spread network-wide.
                   "tamper_attests": flip the attestation digests on
                   every deliver frame from `fork_height` on (requires
                   attest_deliver on this orderer + trust_attestations
                   on the peer).
      victims      ("two_faced" only) list of peer mspids and/or full
                   "mspid|cert-sha256" bindings the crimes target
      fork_height  first height the crime fires at (default 2 — past
                   genesis/config so the honest chain has traction)
      count        how many consecutive heights to hit (default 1)
      channel      restrict crimes to one channel (default: all)

    Honest-THEN-forged order is deliberate: the honest header reaches
    the victim first, so detection happens against a committed (or
    witnessed) honest hash and the drill's convergence assertions stay
    deterministic.  The forged sibling is still a complete, validly
    signed equivocation — exactly what a real double-serving orderer
    would emit."""

    def __init__(self, cfg: dict, data_dir: str,
                 crimes: Optional[dict] = None):
        super().__init__(cfg, data_dir)
        self.crimes = dict(crimes or {})
        self.crimes_committed: List[dict] = []

    def _crime_heights(self) -> range:
        start = int(self.crimes.get("fork_height", 2))
        return range(start, start + int(self.crimes.get("count", 1)))

    def _is_victim(self, peer_identity) -> bool:
        """two_faced target check: match the caller's mspid or its full
        mspid|cert-sha256 binding against crimes["victims"]."""
        victims = set(self.crimes.get("victims") or [])
        if peer_identity is None or not victims:
            return False
        labels = {getattr(peer_identity, "mspid", None)}
        try:
            from fabric_tpu_torch.orderer.cluster import cert_fingerprint
            labels.add(f"{peer_identity.mspid}|"
                       f"{cert_fingerprint(peer_identity.cert)}")
        except Exception:
            pass
        return bool(victims & labels)

    def _rpc_deliver(self, body: dict, peer_identity):
        from fabric_tpu_torch.protocol.types import Block
        mode = self.crimes.get("mode", "equivocate")
        only = self.crimes.get("channel")
        cid = body.get("channel")
        armed = only is None or cid == only
        if mode == "two_faced":
            # honest face for everyone but the configured victims; the
            # crime itself is the plain double-serve below
            armed = armed and self._is_victim(peer_identity)
            mode = "equivocate"
        heights = self._crime_heights()
        for out in super()._rpc_deliver(body, peer_identity):
            if not armed:
                yield out
                continue
            block = Block.deserialize(bytes(out["block"]))
            num = int(block.header.number)
            if mode == "tamper_attests" and num >= heights.start \
                    and block.data:
                out = dict(out)
                if out.get("attests"):
                    # flip real attestation digests riding the frame
                    out["attests"] = [
                        None if a is None else
                        "".join("%02x" % (int(c, 16) ^ 0xF) for c in a)
                        for a in out["attests"]]
                else:
                    # no cached verdicts to vouch for: fabricate a
                    # digest per envelope — re-derivation on the peer
                    # mismatches and revokes this attestor just the same
                    out["attests"] = ["5a" * 32] * len(block.data)
                self.crimes_committed.append(
                    {"kind": "tamper_attests", "height": num})
                yield out
                continue
            yield out
            if mode == "equivocate" and num in heights:
                forged = forge_sibling(block, self.signer)
                self.crimes_committed.append(
                    {"kind": "equivocate", "height": num,
                     "forged_hash": forged.hash().hex()})
                logger.warning("adversary: equivocating at height %d "
                               "on %r", num, cid)
                yield {"block": forged.serialize()}


class GossipPoisoner:
    """Deterministic gossip-intake attacker for one victim channel.

    Injections land on `GossipState.handle` — the exact entrypoint the
    gossip transport dispatches casts to — under a fixed fake transport
    endpoint, so offense scoring and quarantine hit a stable identity
    (`gossip|<endpoint>`)."""

    def __init__(self, victim_channel, endpoint: str = "evil:0"):
        self.state = victim_channel.gossip.state
        self.endpoint = endpoint
        self.sent: Dict[str, int] = {}

    def _note(self, kind: str, n: int = 1) -> None:
        self.sent[kind] = self.sent.get(kind, 0) + n

    def garbage(self, n: int = 1) -> None:
        """Unparseable payloads: each scores a `garbage` offense."""
        from fabric_tpu_torch.gossip.state import MSG_BLOCK
        for i in range(int(n)):
            self.state.handle(MSG_BLOCK, self.endpoint,
                              {"block": b"\xde\xad\xbe\xef" + bytes([i])})
        self._note("garbage", n)

    def bad_sig(self, n: int = 1) -> None:
        """Blocks whose header was tampered after signing: parse fine,
        fail MCS verification, score `bad_sig` offenses."""
        from fabric_tpu_torch.gossip.state import MSG_BLOCK
        store = self.state.committer.ledger.blockstore
        if store.height == 0:
            raise RuntimeError("victim has no committed block to tamper")
        raw = break_signature(
            store.get_by_number(store.height - 1)).serialize()
        for _ in range(int(n)):
            self.state.handle(MSG_BLOCK, self.endpoint, {"block": raw})
        self._note("bad_sig", n)

    def stale(self, n: int = 1) -> None:
        """Replay the victim's own genesis block: tolerated (dropped as
        an idempotent dup), never an offense — anti-entropy replays
        stale blocks all the time."""
        from fabric_tpu_torch.gossip.state import MSG_BLOCK
        store = self.state.committer.ledger.blockstore
        raw = store.get_by_number(0).serialize()
        for _ in range(int(n)):
            self.state.handle(MSG_BLOCK, self.endpoint, {"block": raw})
        self._note("stale", n)

    def inject(self, block) -> None:
        """Deliver an arbitrary (e.g. forged) block as a gossip frame."""
        from fabric_tpu_torch.gossip.state import MSG_BLOCK
        self.state.handle(MSG_BLOCK, self.endpoint,
                          {"block": block.serialize()})
        self._note("inject")


def adversary_factory(crimes_by_name: Dict[str, dict]):
    """A ChaosNet `node_factory` that builds EquivocatingOrderer for the
    named orderers (e.g. {"orderer1": {"fork_height": 4}})."""

    def _factory(name: str, kind: str, cfg: dict):
        crimes = crimes_by_name.get(name)
        if crimes is None or kind != "orderer":
            return None
        return EquivocatingOrderer(cfg, data_dir=cfg["data_dir"],
                                   crimes=crimes)

    return _factory
