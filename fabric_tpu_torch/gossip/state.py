"""Gossip state transfer: ordered block delivery + anti-entropy.

Reference parity: gossip/state/state.go — deliverPayloads (:547) drains
an out-of-order payload buffer strictly in block order into the
committer (commitBlock :781 -> coordinator.StoreBlock), and antiEntropy
(:591) asks peers for the [our_height, their_height) range when gaps
persist.  Block payloads arriving via gossip are MCS-verified before
buffering.

Counterpart of `fabric_tpu/gossip/state.py`, the same code on the port's
imports.  The byzantine branches run once a peer wires the port's
`byzantine.ByzantineMonitor` as `monitor` and a `ProofGossip` as
`proofs`, as the reference's peer channel does.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from fabric_tpu_torch.protocol import Block
from fabric_tpu_torch.protocol import wire

logger = logging.getLogger("fabric_tpu_torch.gossip.state")

MSG_BLOCK = "gossip.block"
MSG_STATE_REQ = "gossip.state_req"
MSG_STATE_RESP = "gossip.state_resp"

MAX_BUFFER = 256          # payload buffer cap (state.go buffer size role)
MAX_RANGE_PER_REQ = 32    # anti-entropy batch (state.go defAntiEntropyBatchSize)


class GossipState:
    """One channel's block intake: buffer -> verify -> commit in order."""

    def __init__(self, endpoint, discovery, committer, mcs=None,
                 fanout: int = 3):
        self.endpoint = endpoint
        self.discovery = discovery
        self.committer = committer  # needs .height and .store_block(block)
        self.mcs = mcs
        self.fanout = fanout
        # byzantine.ByzantineMonitor, wired post-construction by the
        # peer channel; None = classic blind intake
        self.monitor = None
        # byzantine.ProofGossip, wired post-construction alongside the
        # monitor; None = fraud proofs stay node-local (pre-r14 behavior)
        self.proofs = None
        self._buffer: Dict[int, Block] = {}
        # deliver loop + gossip dispatch threads both drain; the lock
        # closes the pop->store window (two threads pop adjacent heights
        # and the later store races a concurrent re-buffer of the same
        # height into an out-of-order commit)
        self._drain_lock = threading.Lock()

    # -- intake -------------------------------------------------------------

    def add_block(self, block: Block, gossip: bool = True) -> None:
        """Local intake from the deliver client (leader peer); optionally
        fan out to other peers."""
        self._buffer_block(block)
        if gossip:
            self._gossip_block(block)
        self._drain()

    def handle(self, msg_type: str, frm: str, body: dict) -> None:
        if (self.monitor is not None
                and self.monitor.blocked_source(self._byz_key(frm))):
            return                      # quarantined gossip source
        if msg_type == MSG_BLOCK:
            self._on_block_msg(frm, body)
        elif msg_type == MSG_STATE_REQ:
            self._on_state_req(frm, body)
        elif msg_type == MSG_STATE_RESP:
            for raw in body.get("blocks", []):
                self._on_block_msg(frm, {"block": raw})
        self._drain()

    @staticmethod
    def _byz_key(frm: str) -> str:
        """Quarantine key for a gossip transport source.  Distinct from
        signer bindings on purpose: gossip offenses score the RELAY
        (who injected garbage), crimes convict the SIGNER."""
        return f"gossip|{frm}"

    def _on_block_msg(self, frm: str, body: dict) -> None:
        try:
            # native span parse (BlockView) with Block.deserialize
            # fallback — reject behavior identical, per-tx decode gone
            block = wire.parse_block(body["block"])
        except (KeyError, ValueError, TypeError):
            # unparseable payload: honest peers (and the crash-stop
            # fault plane, which only drops/dups/reorders whole frames)
            # never produce one — score the source
            if self.monitor is not None and frm:
                self.monitor.offense(self._byz_key(frm), "garbage")
            return
        if self.mcs is not None and not self.mcs.verify_block(block):
            logger.warning("rejected gossiped block %s: bad orderer sig",
                           getattr(block.header, "number", "?"))
            if self.monitor is not None and frm:
                self.monitor.offense(self._byz_key(frm), "bad_sig")
            return
        if self.monitor is not None:
            from fabric_tpu_torch.byzantine.monitor import (
                VERDICT_ADMIT, VERDICT_STALE)
            verdict = self.monitor.check_block(block, self._byz_key(frm))
            if verdict == VERDICT_STALE:
                return                  # idempotent dup, not an offense
            if verdict != VERDICT_ADMIT:
                return                  # disputed/convicted: never buffer
        self._buffer_block(block)

    def _buffer_block(self, block: Block) -> None:
        num = block.header.number
        if num < self.committer.height or num in self._buffer:
            return
        if len(self._buffer) >= MAX_BUFFER:
            # full: never drop the immediately-drainable block — evict the
            # highest buffered number instead (anti-entropy re-fetches it),
            # so far-future blocks cannot wedge the buffer.
            evict = max(self._buffer)
            if num >= evict:
                return
            del self._buffer[evict]
        self._buffer[num] = block

    def _gossip_block(self, block: Block) -> None:
        raw = block.serialize()
        for to in self.discovery.alive_ids()[:self.fanout]:
            self.endpoint.send(to, MSG_BLOCK, {"block": raw})

    # -- ordered drain into the committer (deliverPayloads) ------------------

    def _drain(self) -> None:
        with self._drain_lock:
            while True:
                height = self.committer.height
                # a block popped by one drain can be re-buffered by a
                # concurrent intake before its store lands; with stores
                # serialized under the lock those copies surface here as
                # already-committed entries — purge instead of re-storing
                for num in [n for n in self._buffer if n < height]:
                    del self._buffer[num]
                if height not in self._buffer:
                    break
                if (self.monitor is not None
                        and not self.monitor.check_commit(
                            self._buffer[height])):
                    # the height became disputed AFTER this block was
                    # buffered (or this hash lost the dispute): evict it
                    # so the confirmed winner can take the slot — intake
                    # holds contested copies until resolution, and
                    # anti-entropy / deliver re-seek re-supply the winner
                    del self._buffer[height]
                    break
                self.committer.store_block(self._buffer.pop(height))

    # -- anti-entropy (state.go:591) -----------------------------------------

    def anti_entropy_tick(self) -> None:
        """If we have buffered blocks ahead of a gap (or just suspect
        lag), ask a random-ish alive peer for the missing range."""
        height = self.committer.height
        want_upto = max(self._buffer) + 1 if self._buffer else height
        peers = self.discovery.alive_ids()
        if not peers:
            return
        # ask even when no gap is visible — peers answer with their tip
        to = peers[height % len(peers)]
        self.endpoint.send(to, MSG_STATE_REQ,
                           {"from": height,
                            "to": max(want_upto, height + MAX_RANGE_PER_REQ)})

    def _on_state_req(self, frm: str, body: dict) -> None:
        try:
            start = int(body["from"])
            stop = min(int(body["to"]), start + MAX_RANGE_PER_REQ)
        except (KeyError, TypeError, ValueError):
            return
        blocks = []
        store = self.committer.ledger.blockstore
        for num in range(start, min(stop, store.height)):
            blocks.append(store.get_by_number(num).serialize())
        if blocks:
            self.endpoint.send(frm, MSG_STATE_RESP, {"blocks": blocks})

    @property
    def buffered(self) -> List[int]:
        return sorted(self._buffer)
