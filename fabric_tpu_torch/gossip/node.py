"""GossipNode: one peer's full gossip stack wired together.

Reference parity: gossip/service/gossip_service.go InitializeChannel —
discovery + election + state transfer + (leader-only) deliver client,
one instance per peer, shared across channels in the reference; one
node per (peer, channel) here for clarity.

Counterpart of `fabric_tpu/gossip/node.py`, the same code on the port's
imports.
"""

from __future__ import annotations

from typing import Optional

from fabric_tpu_torch.gossip.blocksprovider import BlocksProvider
from fabric_tpu_torch.gossip.certstore import CertStore
from fabric_tpu_torch.gossip.discovery import (
    Discovery,
    MSG_ALIVE,
    MSG_MEMBERSHIP_REQ,
    MSG_MEMBERSHIP_RESP,
)
from fabric_tpu_torch.gossip.election import MSG_LEADERSHIP, LeaderElection
from fabric_tpu_torch.gossip.pull import PULL_MSGS, PullMediator
from fabric_tpu_torch.gossip.state import (
    GossipState,
    MSG_BLOCK,
    MSG_STATE_REQ,
    MSG_STATE_RESP,
)
from fabric_tpu_torch.byzantine.proofgossip import MSG_FRAUD_PROOF, MSG_PARDON

_DISCOVERY_MSGS = {MSG_ALIVE, MSG_MEMBERSHIP_REQ, MSG_MEMBERSHIP_RESP}
_STATE_MSGS = {MSG_BLOCK, MSG_STATE_REQ, MSG_STATE_RESP}


class GossipNode:
    def __init__(self, register, peer_id: str, committer, mcs=None,
                 signer=None, deliver_handler=None, bootstrap=None,
                 window: int = 32, msps=None):
        """`register` is a callable(peer_id, handler) -> endpoint
        (InProcNetwork.register, a TcpTransport starter, or a
        SecureGossipTransport starter)."""
        self.id = peer_id
        self.endpoint = register(peer_id, self.handle)
        identity = signer.serialize() if signer is not None else b""
        self.discovery = Discovery(self.endpoint, identity, mcs=mcs,
                                   signer=signer, bootstrap=bootstrap)
        self.state = GossipState(self.endpoint, self.discovery, committer,
                                 mcs=mcs)
        self.election = LeaderElection(self.discovery)
        # certstore: identities replicate via pull-digest anti-entropy
        # (gossip/gossip/certstore.go + algo/pull.go)
        self.certstore = (CertStore(msps, identity)
                          if msps is not None else None)
        self.cert_pull: Optional[PullMediator] = None
        if self.certstore is not None:
            self.cert_pull = PullMediator(self.endpoint, self.discovery,
                                          "certs", self.certstore)
        self.provider: Optional[BlocksProvider] = None
        if deliver_handler is not None:
            self.provider = BlocksProvider(
                committer.validator.channel_id
                if hasattr(committer, "validator") else "ch",
                deliver_handler, self.state, mcs=mcs, window=window)

    def handle(self, msg_type: str, frm: str, body: dict) -> None:
        if msg_type in _DISCOVERY_MSGS:
            self.discovery.handle(msg_type, frm, body)
        elif msg_type in _STATE_MSGS:
            self.state.handle(msg_type, frm, body)
        elif msg_type == MSG_LEADERSHIP:
            self.election.handle(msg_type, frm, body)
        elif msg_type in PULL_MSGS and self.cert_pull is not None:
            self.cert_pull.handle(msg_type, frm, body)
        elif msg_type == MSG_FRAUD_PROOF and self.state.proofs is not None:
            self.state.proofs.handle(frm, body)
        elif msg_type == MSG_PARDON and self.state.proofs is not None:
            self.state.proofs.handle_pardon(frm, body)

    def tick(self) -> None:
        """One gossip period: heartbeat, elect, (leader) pull, anti-entropy."""
        self.discovery.tick()
        self.election.tick()
        if self.election.is_leader and self.provider is not None:
            self.provider.pull_window()
        self.state.anti_entropy_tick()
        if self.cert_pull is not None:
            self.cert_pull.tick()
        if self.state.proofs is not None:
            self.state.proofs.tick()

    @property
    def height(self) -> int:
        return self.state.committer.height
