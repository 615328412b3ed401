"""Pull-digest anti-entropy: the gossip pull algorithm.

Reference parity: gossip/gossip/algo/pull.go — the four-phase exchange
(Hello -> Digest -> Request -> Response) by which a peer learns items it
is missing from a randomly chosen neighbor.  The reference runs this for
identity certificates (certstore.go) and channel messages; here it backs
the certstore (blocks use range-based anti-entropy instead — blocks are
totally ordered, so [height, peer_height) range requests strictly beat
digest diffs for them, gossip/state.py).

Items are opaque (item_id -> payload bytes) behind the PullStore
interface; stores validate payloads in `add` (e.g. the certstore rejects
identities no channel MSP vouches for), so a malicious responder cannot
poison the store.

Counterpart of `fabric_tpu/gossip/pull.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import logging
import random
from typing import Dict, List, Optional

logger = logging.getLogger("fabric_tpu_torch.gossip.pull")

MSG_PULL_HELLO = "gossip.pull_hello"
MSG_PULL_DIGEST = "gossip.pull_digest"
MSG_PULL_REQ = "gossip.pull_req"
MSG_PULL_RESP = "gossip.pull_resp"

PULL_MSGS = {MSG_PULL_HELLO, MSG_PULL_DIGEST, MSG_PULL_REQ, MSG_PULL_RESP}


class PullStore:
    """Interface pulled items live behind."""

    def digests(self) -> List[str]:
        raise NotImplementedError

    def get(self, item_id: str) -> Optional[bytes]:
        raise NotImplementedError

    def add(self, item_id: str, payload: bytes) -> bool:
        """Validate + store; returns False (and stores nothing) for
        payloads that fail validation or mismatch their id."""
        raise NotImplementedError


class PullMediator:
    """One pull kind's engine (algo/pull.go PullEngine).

    tick() initiates a round with `fanout` random alive peers; handle()
    serves both sides of the exchange.  Nonces bind responses to the
    initiating round so unsolicited digests/responses are ignored.
    """

    def __init__(self, endpoint, discovery, kind: str, store: PullStore,
                 fanout: int = 2, rng: Optional[random.Random] = None):
        self.endpoint = endpoint
        self.discovery = discovery
        self.kind = kind
        self.store = store
        self.fanout = fanout
        self.rng = rng or random.Random()
        self._pending: Dict[int, str] = {}      # nonce -> peer id
        self.stats = {"rounds": 0, "items_pulled": 0}

    # -- initiator side ------------------------------------------------------

    def tick(self) -> None:
        peers = [p for p in self.discovery.alive_ids()
                 if p != self.endpoint.id]
        self.rng.shuffle(peers)
        for to in peers[:self.fanout]:
            nonce = self.rng.getrandbits(63)
            self._pending[nonce] = to
            self.stats["rounds"] += 1
            self.endpoint.send(to, MSG_PULL_HELLO,
                               {"kind": self.kind, "nonce": nonce})
        # drop stale rounds (bounded memory under unresponsive peers)
        if len(self._pending) > 64:
            for nonce in list(self._pending)[:-64]:
                del self._pending[nonce]

    # -- both sides ----------------------------------------------------------

    def handle(self, msg_type: str, frm: str, body: dict) -> None:
        if body.get("kind") != self.kind:
            return
        if msg_type == MSG_PULL_HELLO:
            self.endpoint.send(frm, MSG_PULL_DIGEST, {
                "kind": self.kind, "nonce": body.get("nonce", 0),
                "digests": self.store.digests()})
        elif msg_type == MSG_PULL_DIGEST:
            nonce = body.get("nonce", 0)
            if self._pending.pop(nonce, None) != frm:
                return                      # unsolicited digest: ignore
            have = set(self.store.digests())
            want = [d for d in body.get("digests", []) if d not in have]
            if want:
                self.endpoint.send(frm, MSG_PULL_REQ, {
                    "kind": self.kind, "nonce": nonce, "items": want})
        elif msg_type == MSG_PULL_REQ:
            items = []
            for item_id in body.get("items", [])[:256]:
                payload = self.store.get(item_id)
                if payload is not None:
                    items.append([item_id, payload])
            if items:
                self.endpoint.send(frm, MSG_PULL_RESP, {
                    "kind": self.kind, "nonce": body.get("nonce", 0),
                    "items": items})
        elif msg_type == MSG_PULL_RESP:
            for entry in body.get("items", []):
                try:
                    item_id, payload = entry[0], entry[1]
                except (TypeError, IndexError):
                    continue
                if self.store.add(item_id, payload):
                    self.stats["items_pulled"] += 1
