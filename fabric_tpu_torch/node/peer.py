"""The peer's deliver client.

Counterpart of `fabric_tpu/node/peer.py`, so far only `RemoteDeliver`
(the deliver-handler facade over the orderers' RPC `deliver` stream,
with per-call failover across endpoints; block bytes arrive as
memoryviews, `stream_views=True`, and go straight to the native span
parser) and `_app_org_ids` (a channel config's application orgs).
`PeerNode` and `PeerChannel`, which wire it to gossip, the private-data
coordinator and the committer, come with a later slice; until then a
caller wires the intake as `PeerChannel._deliver_loop` does:
`RemoteDeliver` -> `orderer.block_signature_items` -> the provider ->
`gossip.GossipState.add_block` -> `privdata.Coordinator.store_block`.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

from fabric_tpu_torch.comm.rpc import connect
from fabric_tpu_torch.protocol import wire

logger = logging.getLogger("fabric_tpu_torch.node.peer")


class RemoteDeliver:
    """Deliver-handler facade over the orderer cluster's RPC deliver
    stream, with per-call failover across orderer endpoints."""

    def __init__(self, orderers: List[Tuple[str, int]], signer, msps):
        self.orderers = list(orderers)
        self.signer = signer
        self.msps = msps
        self._rr = 0
        # optional containment hook: callable(sender_identity) -> bool;
        # a True verdict skips the endpoint (quarantined orderer)
        self.blocked = None

    def advance(self) -> None:
        """Rotate away from the current endpoint — called when the
        byzantine monitor convicts the stream's orderer so the next
        pull re-sources from a different consenter."""
        if self.orderers:
            self._rr = (self._rr + 1) % len(self.orderers)

    def deliver(self, channel_id, seek, signed=None, timeout_s: int = 10):
        """Yields (block, attests, sender) — `attests` is the orderer's
        optional per-envelope verdict-attestation list (verify_plane/
        attest.py) and `sender` the handshake-verified identity of the
        orderer connection it rode in on; both None when the orderer
        sends plain blocks.

        Standing-aware source selection is two-pass: quarantined
        endpoints are SKIPPED while any healthy endpoint remains
        (deferred, not refused), and retried as a last resort only once
        every healthy endpoint has failed — a convicted orderer degrades
        availability before it partitions the peer, and every block it
        serves is still re-judged by the byzantine monitor."""
        last = None
        payload = b"seek:%s" % channel_id.encode()
        sd = {"data": payload, "identity": self.signer.serialize(),
              "signature": self.signer.sign(payload)}
        deferred: List[int] = []
        for k in range(len(self.orderers)):
            idx = (self._rr + k) % len(self.orderers)
            addr = self.orderers[idx]
            try:
                # stream_views: block bytes arrive as memoryviews into
                # the received frame and go straight to the native span
                # parser — no frame->block copy, no per-tx objects
                conn = connect(tuple(addr), self.signer, self.msps,
                               timeout=3.0, stream_views=True)
                try:
                    sender = getattr(conn.channel, "peer_identity", None)
                    if self.blocked is not None and self.blocked(sender):
                        deferred.append(idx)
                        last = RuntimeError(
                            "orderer endpoint %s:%s is quarantined"
                            % tuple(addr[:2]))
                        continue
                    for item in conn.call_stream("deliver", {
                            "channel": channel_id, "start": seek.start,
                            "stop": seek.stop, "behavior": seek.behavior,
                            "timeout_s": int(timeout_s),
                            "signed_data": sd}):
                        yield (wire.parse_block(item["block"]),
                               item.get("attests"), sender)
                    self._rr = idx
                    return
                finally:
                    conn.close()
            except Exception as exc:
                last = exc
        for idx in deferred:
            addr = self.orderers[idx]
            try:
                conn = connect(tuple(addr), self.signer, self.msps,
                               timeout=3.0, stream_views=True)
                try:
                    sender = getattr(conn.channel, "peer_identity", None)
                    logger.warning(
                        "deliver: every healthy orderer failed; last-"
                        "resort pull from quarantined %s:%s",
                        *tuple(addr[:2]))
                    for item in conn.call_stream("deliver", {
                            "channel": channel_id, "start": seek.start,
                            "stop": seek.stop, "behavior": seek.behavior,
                            "timeout_s": int(timeout_s),
                            "signed_data": sd}):
                        yield (wire.parse_block(item["block"]),
                               item.get("attests"), sender)
                    # _rr stays put: the next pull tries healthy
                    # endpoints first again
                    return
                finally:
                    conn.close()
            except Exception as exc:
                last = exc
        if last is not None:
            raise last


def _app_org_ids(channel_cfg) -> List[str]:
    """The channel's APPLICATION org mspids: every config org that is
    not a consenter org (the reference scopes lifecycle endorsement /
    approvals to Application orgs, channelconfig/application.go)."""
    cons = {c.get("mspid")
            for c in (getattr(channel_cfg, "consenters", ()) or ())
            if isinstance(c, dict)}     # bare raft-id consenters: no org
    orgs = sorted(o.mspid for o in channel_cfg.orgs)
    app = [o for o in orgs if o not in cons]
    return app or orgs
