"""Membership discovery: alive messages + expiry.

Reference parity: gossip/discovery/discovery_impl.go — each peer
periodically gossips a signed alive message carrying a monotonically
increasing sequence number; peers expire members whose last alive is
older than aliveExpirationTimeout.  Failure detection for the whole
framework hangs off this.

Deterministic: time advances via tick(); one tick = one heartbeat
period.  Signatures: alive messages are signed by the member and
verified through the MCS before acceptance (mcs.verify_peer_msg).

Counterpart of `fabric_tpu/gossip/discovery.py`, the same code on the port's
imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from fabric_tpu_torch.utils import serde

MSG_ALIVE = "gossip.alive"
MSG_MEMBERSHIP_REQ = "gossip.mem_req"
MSG_MEMBERSHIP_RESP = "gossip.mem_resp"


@dataclass
class Peer:
    """discovery.NetworkMember equivalent."""
    id: str
    endpoint: tuple = ()          # transport address, opaque
    identity: bytes = b""         # serialized msp identity
    seq: int = 0                  # alive sequence number
    last_seen_tick: int = 0


class Discovery:
    """One node's membership view."""

    def __init__(self, endpoint, self_identity: bytes = b"",
                 mcs=None, signer=None,
                 alive_expiration_ticks: int = 5,
                 bootstrap: Optional[List[str]] = None):
        self.endpoint = endpoint
        self.id = endpoint.id
        self.identity = self_identity
        self.mcs = mcs
        self.signer = signer
        self.expiration = alive_expiration_ticks
        self._members: Dict[str, Peer] = {}
        self._seq = 0
        self._tick = 0
        self._bootstrap = list(bootstrap or [])
        self.on_expire: Callable[[str], None] = lambda peer_id: None

    # -- outbound -----------------------------------------------------------

    def tick(self) -> None:
        """One heartbeat period: send alive to known members (and
        bootstrap anchors), probe one peer for ITS membership view
        (transitive learning — the reference's MembershipRequest
        exchange, gossip/discovery/discovery_impl.go), then expire the
        silent."""
        self._tick += 1
        self._seq += 1
        body = self._alive_body()
        targets = sorted(set(self.alive_ids()) | set(self._bootstrap))
        for to in targets:
            if to != self.id:
                self.endpoint.send(to, MSG_ALIVE, body)
        peers = [t for t in targets if t != self.id]
        if peers:
            self.endpoint.send(peers[self._tick % len(peers)],
                               MSG_MEMBERSHIP_REQ, {})
        self._expire()

    def _alive_body(self) -> dict:
        payload = {"id": self.id, "seq": self._seq,
                   "endpoint": list(self.endpoint.address)
                   if hasattr(self.endpoint, "address") else [],
                   "identity": self.identity}
        signature = b""
        if self.signer is not None:
            signature = self.signer.sign(serde.encode(payload))
        return {"payload": payload, "signature": signature}

    def _expire(self) -> None:
        for peer_id in list(self._members):
            if self._tick - self._members[peer_id].last_seen_tick \
                    > self.expiration:
                del self._members[peer_id]
                self.on_expire(peer_id)

    # -- inbound ------------------------------------------------------------

    def handle(self, msg_type: str, frm: str, body: dict) -> None:
        if msg_type == MSG_ALIVE:
            self._on_alive(body)
        elif msg_type == MSG_MEMBERSHIP_REQ:
            self.endpoint.send(frm, MSG_MEMBERSHIP_RESP,
                               {"alive": [self._peer_dict(p)
                                          for p in self._members.values()]})
        elif msg_type == MSG_MEMBERSHIP_RESP:
            for entry in body.get("alive", []):
                self._learn(entry)

    def _on_alive(self, body: dict) -> None:
        try:
            payload = body["payload"]
            peer_id = payload["id"]
            seq = int(payload["seq"])
        except (KeyError, TypeError, ValueError):
            return
        if peer_id == self.id:
            return
        if self.mcs is not None and not self.mcs.verify_peer_msg(
                payload.get("identity", b""),
                serde.encode(payload), body.get("signature", b"")):
            return  # unauthenticated alive: ignored
        member = self._members.get(peer_id)
        if member is not None and seq <= member.seq:
            return  # stale or replayed
        self._members[peer_id] = Peer(
            peer_id, tuple(payload.get("endpoint", ())),
            payload.get("identity", b""), seq, self._tick)
        # learn transport address for real-socket transports
        if hasattr(self.endpoint, "net"):
            pass
        elif hasattr(self.endpoint, "add_peer") and payload.get("endpoint"):
            self.endpoint.add_peer(peer_id, tuple(payload["endpoint"]))

    def _learn(self, entry: dict) -> None:
        """Indirect membership via exchange — unauthenticated hint; the
        peer only becomes a member once its own signed alive arrives."""
        peer_id = entry.get("id")
        if peer_id and peer_id != self.id and peer_id not in self._bootstrap \
                and peer_id not in self._members:
            self._bootstrap.append(peer_id)
            if hasattr(self.endpoint, "add_peer") and entry.get("endpoint"):
                self.endpoint.add_peer(peer_id, tuple(entry["endpoint"]))

    def _peer_dict(self, p: Peer) -> dict:
        return {"id": p.id, "endpoint": list(p.endpoint),
                "identity": p.identity}

    # -- queries ------------------------------------------------------------

    def alive_ids(self) -> List[str]:
        return sorted(self._members)

    def known_ids(self) -> List[str]:
        """Alive members PLUS configured-but-not-yet-heard bootstrap
        peers — the widest reachable-target set.  Planes that must reach
        peers before membership converges (fraud-proof gossip: a
        conviction can land within the first few ticks) send here;
        unreachable entries just drop (gossip tolerates loss)."""
        return sorted((set(self._members) | set(self._bootstrap))
                      - {self.id})

    def members(self) -> List[Peer]:
        return [self._members[k] for k in sorted(self._members)]

    def is_alive(self, peer_id: str) -> bool:
        return peer_id in self._members
