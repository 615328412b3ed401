"""Byzantine detection-and-containment plane.

The rest of the stack is hardened against honest-but-dead components:
crash-stop kills, torn WALs, dropped/duplicated/reordered frames.  This
package is the step past crash-stop — components that LIE:

  equivocation   an orderer (or any block source) emits two different,
                 validly-signed headers at the same height.  Peers keep
                 a compact per-channel witness log (block_num ->
                 header-hash + who vouched) and treat a conflicting
                 second header as provable misbehavior: a signed fraud
                 proof is persisted, the signing identity is permanently
                 quarantined (the verify_plane/trust.py
                 persistent-revocation pattern), and the deliver stream
                 re-sources from a healthy endpoint without giving up
                 exactly-once (re-seek from height + committer replay
                 guard).
  gossip poison  a gossip peer injects garbage, stale, or badly-signed
                 payloads into state transfer.  Intake verifies payload
                 hash chains before admission, scores offenders, and
                 quarantines repeat offenders.

Attribution is by SIGNER, not by relay: an honest peer may forward both
sides of a fork before anyone knows it is a fork, so only the identity
whose signature covers a losing header is convicted.  Crash-stop faults
(drop/delay/dup/reorder, kill/restart) can never produce two different
validly-signed headers at one height, so a crash-stop-only chaos run
yields ZERO quarantines — the no-false-positive gate tests pin this.

Observability: `byzantine_quarantines_total{reason}` and
`byzantine_offenses_total{reason}` counters and `GET /byzantine` on the
peer ops server (`ops.register_ops`).

Counterpart of `fabric_tpu/byzantine`, the whole package on the port's
imports.  The signature checks of fraud proofs and pardons (the
accuser's, the issuer's and each attested block or Raft-entry
signature) go one item a call through the identity's `verify`, on the
factory's default provider: KP2 on the CUDA provider.  The monitor
reads `orderer.raft.entry_signed_bytes` and
`orderer.cluster.cert_fingerprint` from the port's partial copies of
those modules.  A peer wires it as the reference's peer channel does:
`GossipState.monitor`, `GossipState.proofs` (a `ProofGossip` over the
gossip node's endpoint and discovery), `monitor.on_proof =
proofs.broadcast`, `monitor.on_pardon = proofs.broadcast_pardon`.
"""

from fabric_tpu_torch.byzantine.quarantine import QuarantineRegistry
from fabric_tpu_torch.byzantine.witness import WitnessLog
from fabric_tpu_torch.byzantine.monitor import (
    ByzantineMonitor,
    build_fraud_proof,
    build_pardon,
    verify_fraud_proof,
    verify_fraud_proof_strict,
    verify_pardon,
    verify_pardon_strict,
)
from fabric_tpu_torch.byzantine.proofgossip import (MSG_FRAUD_PROOF, MSG_PARDON,
                                              ProofGossip)
from fabric_tpu_torch.byzantine.ops import register_ops

__all__ = [
    "QuarantineRegistry",
    "WitnessLog",
    "ByzantineMonitor",
    "build_fraud_proof",
    "build_pardon",
    "verify_fraud_proof",
    "verify_fraud_proof_strict",
    "verify_pardon",
    "verify_pardon_strict",
    "MSG_FRAUD_PROOF",
    "MSG_PARDON",
    "ProofGossip",
    "register_ops",
]
