"""First-class fraud-proof gossip: convictions become a NETWORK-WIDE
property, not a per-peer one.

Without it, a two-faced adversary has a gap: each peer convicts
only from its own witness log, so an orderer that equivocates per-peer
on deliver is quarantined by the one peer that saw both headers and
keeps serving everyone else.  This plane closes it:

  * every NEW local conviction broadcasts its signed portable fraud
    proof over the channel's gossip endpoint (`gossip.fraud_proof`);
  * a RECEIVED proof is judged by `ByzantineMonitor.accept_remote_proof`
    — the accuser signature AND the self-incriminating payload are
    independently re-verified, the relay is never trusted and never
    blamed — and convicts without any local witness evidence;
  * a freshly-convicting receiver re-broadcasts the proof (epidemic
    propagation past the sender's fanout); a duplicate or rejected proof
    is NOT re-broadcast, so the flood terminates at the quarantine
    registry's first-conviction gate.

Proofs travel as JSON bytes inside the gossip frame: the proof body is
a JSON document (it carries floats and is signed over its
`json.dumps(sort_keys=True)` canonical form), so re-encoding it through
the wire serde would break the accuser's signature.

The broadcast counter doubles as the crash-stop gate: a chaos run with
no Byzantine adversary must end with `broadcasts == 0` (no conviction,
no proof, no gossip) — asserted by the scenario catalog's control runs.

Counterpart of `fabric_tpu/byzantine/proofgossip.py`, the same code on
the port's imports; `gossip/node.py` routes `MSG_FRAUD_PROOF` and
`MSG_PARDON` to the `ProofGossip` wired as `GossipState.proofs`.
"""

from __future__ import annotations

import json
import logging
from typing import Optional

logger = logging.getLogger("fabric_tpu_torch.byzantine")

MSG_FRAUD_PROOF = "gossip.fraud_proof"
MSG_PARDON = "gossip.pardon"


class ProofGossip:
    """One channel's fraud-proof dissemination plane."""

    OUTBOX_MAX = 16

    def __init__(self, endpoint, discovery, monitor, fanout: int = 3):
        self.endpoint = endpoint
        self.discovery = discovery
        self.monitor = monitor
        self.fanout = fanout
        self.broadcasts = 0           # local-conviction broadcasts only
        self.relayed = 0              # epidemic re-broadcasts
        self.received = {"convicted": 0, "duplicate": 0, "rejected": 0}
        # anti-entropy: every proof this node ever served (bounded) is
        # periodically re-offered to one known peer, so peers that were
        # down, partitioned, or not yet discovered at broadcast time
        # still converge; duplicates die at the receiver's quarantine
        # first-conviction gate
        self._outbox = []
        self._rr = 0
        # pardon lane: standing restorations ride the same plane,
        # symmetric counters + their own outbox so anti-entropy keeps
        # offering BOTH record kinds
        self.pardon_broadcasts = 0
        self.pardon_relayed = 0
        self.pardon_received = {"pardoned": 0, "duplicate": 0,
                                "rejected": 0}
        self._pardon_outbox = []

    # -- outbound ------------------------------------------------------------

    def broadcast(self, proof: dict) -> None:
        """ByzantineMonitor.on_proof hook: fan a NEW local conviction's
        proof out to alive peers."""
        self.broadcasts += 1
        self._count("byzantine_proofs_broadcast_total",
                    "fraud proofs broadcast for local convictions")
        self._fan_out(proof)

    def _targets(self) -> list:
        # known_ids reaches configured peers even before membership
        # converges — a conviction can happen within the first ticks
        if hasattr(self.discovery, "known_ids"):
            return self.discovery.known_ids()
        return self.discovery.alive_ids()

    def _fan_out(self, proof: dict) -> None:
        self._fan_out_record(proof, MSG_FRAUD_PROOF, "proof",
                             self._outbox)

    def _fan_out_record(self, record: dict, verb: str, field: str,
                        outbox: list) -> None:
        """Shared dissemination path for both record kinds: canonical
        JSON bytes (re-encoding through the wire serde would break the
        issuer's signature), bounded outbox, fanout to known peers."""
        try:
            raw = json.dumps(record, sort_keys=True).encode()
        except Exception:
            logger.exception("%s record not JSON-serializable", field)
            return
        if raw not in outbox:
            outbox.append(raw)
            del outbox[:-self.OUTBOX_MAX]
        for to in self._targets()[:self.fanout]:
            try:
                self.endpoint.send(to, verb, {field: raw})
            except Exception:
                logger.exception("%s send to %s failed", field, to)

    def broadcast_pardon(self, record: dict) -> None:
        """ByzantineMonitor.on_pardon hook: fan a NEW locally-issued
        pardon out to alive peers."""
        self.pardon_broadcasts += 1
        self._count("byzantine_pardons_broadcast_total",
                    "pardon records broadcast for local restorations")
        self._fan_out_record(record, MSG_PARDON, "pardon",
                             self._pardon_outbox)

    def tick(self) -> None:
        """Anti-entropy: re-offer every served record to ONE known peer,
        rotating through the membership — called from the gossip tick
        cadence.  No records, no traffic (the crash-stop silence gate
        stays meaningful)."""
        if not self._outbox and not self._pardon_outbox:
            return
        targets = self._targets()
        if not targets:
            return
        to = targets[self._rr % len(targets)]
        self._rr += 1
        for verb, field, outbox in (
                (MSG_FRAUD_PROOF, "proof", self._outbox),
                (MSG_PARDON, "pardon", self._pardon_outbox)):
            for raw in list(outbox):
                try:
                    self.endpoint.send(to, verb, {field: raw})
                except Exception:
                    logger.exception("%s re-offer to %s failed", field, to)

    # -- inbound -------------------------------------------------------------

    def handle(self, frm: str, body: dict) -> None:
        """Judge one received proof frame; re-broadcast only on a fresh
        conviction (the termination rule)."""
        try:
            proof = json.loads(bytes(body["proof"]).decode())
            if not isinstance(proof, dict):
                raise ValueError("proof frame is not an object")
        except Exception:
            logger.warning("unparseable fraud proof frame from %s", frm)
            self.received["rejected"] += 1
            self._count("byzantine_proofs_received_total",
                        "fraud proofs received via gossip",
                        verdict="rejected")
            return
        verdict = self.monitor.accept_remote_proof(proof, relay=frm)
        self.received[verdict] = self.received.get(verdict, 0) + 1
        self._count("byzantine_proofs_received_total",
                    "fraud proofs received via gossip", verdict=verdict)
        if verdict == "convicted":
            self.relayed += 1
            self._fan_out(proof)

    def handle_pardon(self, frm: str, body: dict) -> None:
        """Judge one received pardon frame; re-broadcast only on a
        fresh restoration (the same termination rule as proofs: a
        duplicate or rejected pardon dies here)."""
        try:
            record = json.loads(bytes(body["pardon"]).decode())
            if not isinstance(record, dict):
                raise ValueError("pardon frame is not an object")
        except Exception:
            logger.warning("unparseable pardon frame from %s", frm)
            self.pardon_received["rejected"] += 1
            self._count("byzantine_pardons_received_total",
                        "pardon records received via gossip",
                        verdict="rejected")
            return
        verdict = self.monitor.accept_remote_pardon(record, relay=frm)
        self.pardon_received[verdict] = \
            self.pardon_received.get(verdict, 0) + 1
        self._count("byzantine_pardons_received_total",
                    "pardon records received via gossip", verdict=verdict)
        if verdict == "pardoned":
            self.pardon_relayed += 1
            self._fan_out_record(record, MSG_PARDON, "pardon",
                                 self._pardon_outbox)

    # -- plumbing ------------------------------------------------------------

    @staticmethod
    def _count(name: str, help_text: str, **labels) -> None:
        try:
            from fabric_tpu_torch.ops_plane import registry
            registry.counter(name, help_text).add(1, **labels)
        except Exception:
            pass

    def snapshot(self) -> dict:
        return {"broadcasts": self.broadcasts, "relayed": self.relayed,
                "received": dict(self.received),
                "pardon_broadcasts": self.pardon_broadcasts,
                "pardon_relayed": self.pardon_relayed,
                "pardon_received": dict(self.pardon_received)}
