"""Gossip plane: membership, election, state transfer, delivery.

Reference parity (Fabric's gossip):
  gossip/comm        -> comm.InProcNetwork / SecureGossipTransport /
                        TcpTransport (+ ChannelMux)
  gossip/discovery   -> discovery.Discovery (alive msgs, expiry)
  gossip/election    -> election.LeaderElection
  gossip/state       -> state.GossipState (payload buffer + anti-entropy)
  gossip/gossip/certstore + algo/pull -> certstore.CertStore, pull
  internal/peer/gossip/mcs.go -> mcs.MessageCryptoService
  blocksprovider/deliveryclient -> blocksprovider.BlocksProvider

Block dissemination fan-out stays host-side (network I/O), but every
signature the plane checks against the orderer (block signatures) is
emitted as batchable VerifyItems, so a node verifies a whole catch-up
window in one provider dispatch (`mcs.verify_window`): on the card, one
launch of the P-256 lanes.

Counterpart of `fabric_tpu/gossip`, the same code on the port's imports.
"""

from .comm import InProcNetwork, TcpTransport
from .discovery import Discovery, Peer
from .election import LeaderElection
from .mcs import MessageCryptoService
from .state import GossipState
from .blocksprovider import BlocksProvider

__all__ = ["InProcNetwork", "TcpTransport", "Discovery", "Peer",
           "LeaderElection", "MessageCryptoService", "GossipState",
           "BlocksProvider"]
