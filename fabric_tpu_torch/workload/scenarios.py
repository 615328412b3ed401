"""Declarative adversarial scenario catalog: WAN shapes x Byzantine
actors x open-loop load, as plain dict specs.

Each scenario is ONE dict (no YAML, no DSL) composing the fault planes
this framework already owns:

  topology        ChaosNet shape: orderer count, peer orgs, peers/org
  links           per-link latency/loss matrix keyed "src->dst" (src =
                  dialing identity's mspid pattern, dst = "host:port"
                  pattern), compiled via FaultPlan.links — direction
                  matters, asymmetric WAN paths are two entries
  link_schedule   FaultSchedule kwargs enveloping every link rule
                  (windowed partitions, bursts riding the load burst)
  partition       {"org": ..., "window": [start_s, end_s]} — drop ALL
                  frames dialed by that org's identities inside the
                  window (a crash-stop org-level netsplit; heals and
                  must catch up via anti-entropy)
  adversaries     {"orderer1": crimes} -> testing.adversary actors that
                  LIE (equivocating deliver streams, tampered
                  attestation digests) behind real consenter keys
  poison          gossip-intake injection counts for a victim peer
                  (garbage / bad_sig / stale / one forged fork block)
  identity_blend  client creator mix over the signature schemes the MSP
                  accepts ({"p256": w, "ed25519": w}); idemix creators
                  are validated end-to-end by the idemix test lane —
                  channel-config idemix enrollment is a roadmap item
  fan_out         shard the ONE seeded arrival process across every
                  gateway peer (socket slot i -> peer i mod n) instead
                  of pinning the whole population to peer 0 — the load
                  shape fleet-lifecycle drills need, since a drill that
                  drains peers must see traffic ON the drained peer
  rolling_upgrade background drill: drain -> kill -> restart every node
                  one at a time under load (ChaosNet.rolling_restart),
                  recording pre/post heights for the no-regression gate
  membership_churn background drill: add a provisioned spare orderer
                  through an add-consenter config entry, start it,
                  transfer leadership onto it, then remove an original
                  consenter — all mid-traffic
  scale_out       background drill: N peers wiped + snapshot-bootstrapped
                  simultaneously from ONE source peer under load (the
                  elastic-join path; exercises concurrent chunk serving)
  gateway         gateway config override passed to every ChaosNet
                  peer (linger/max_batch/max_queue/admission) — how a
                  scenario throttles the drain rate STRUCTURALLY so
                  "overload" is a topology property, not a host-speed
                  measurement
  slo             scenario-owned SloEvaluator config (windows +
                  objective overrides; DEFAULT_OBJECTIVES merge in
                  unless disabled per-objective with enabled: False)
  incidents       IncidentRecorder config for `incidents` expect kinds
                  (cooldown_s, keep, profile_window_s, ...); bundles
                  land under <base_dir>/incidents and the report
                  carries their ids + MANIFEST verification verdicts
  profiler        SamplingProfiler config feeding incident bundles'
                  profile.json / profile_folded.txt
  phases          open-loop arrival phases (workload.runner format);
                  a phase's `think` key is a per-client think-time
                  spec ({"kind": "exponential", "mean_s": ...} or
                  {"kind": "lognormal", "median_s": ..., "sigma": ...},
                  workload.clients.ThinkTimeModel) delaying that
                  client's next arrival — seeded per client, so burst
                  clustering replays exactly
  expect          in-run SLO assertions, evaluated before the report is
                  written: convergence, quarantine counts BY REASON,
                  zero-quarantine guarantees for crash-stop-only runs,
                  shed/commit bounds, exactly-once (no duplicate txid
                  ever committed), incident-bundle presence/absence
                  (`incidents`: min/max count for an objective prefix +
                  MANIFEST verification)

Every run is seeded end to end (arrival schedules, fault draws, zipf
keys) and writes a JSON report artifact next to its data dir (or at
`report_path`), so a scenario is a reproducible experiment:

    python -m fabric_tpu_torch.workload --scenario equivocation --seed 7

Counterpart of `fabric_tpu/workload/scenarios.py`, whole, on the port's
imports.  One deliberate difference: the reference runs every scenario
on the host's SW provider (`init_factories(FactoryOpts(default="SW"))`);
`run_scenario` here takes `bccsp` ("CUDA" by default, or "SW"), makes it
the factory's default and writes it into every node's config through
`ChaosNet`'s peer and orderer overrides.  The CUDA provider is
fail-stop: without a card the factory raises before any node starts,
and a kernel that fails to build or launch fails the run.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger("fabric_tpu_torch.workload.scenarios")

__all__ = ["SCENARIOS", "list_scenarios", "run_scenario",
           "ScenarioFailure"]


class ScenarioFailure(AssertionError):
    """Raised in strict mode when a scenario's `expect` block fails."""


# ---------------------------------------------------------------------------
# the catalog

SCENARIOS: Dict[str, dict] = {
    "geo-wan": {
        "description": "three regions on asymmetric WAN links (slow "
                       "trans-oceanic return paths, light loss); "
                       "diurnal load; everything honest — latency "
                       "reshapes tails, never safety",
        "topology": {"n_orderers": 3, "peer_orgs": ["Org1", "Org2"],
                     "peers_per_org": 1},
        "links": {
            "Org1->*": {"latency_s": 0.010, "loss": 0.005},
            "Org2->*": {"latency_s": 0.030, "loss": 0.01},
            "OrdererMSP->*": {"latency_s": 0.005, "loss": 0.0},
        },
        "phases": [
            # per-client lognormal think time rides the diurnal wave:
            # WAN users pause between submissions, so per-client
            # arrivals cluster instead of landing memorylessly
            {"name": "diurnal", "duration_s": 8.0,
             "arrivals": {"kind": "diurnal", "base_rate": 12.0,
                          "amplitude": 0.7, "period_s": 4.0},
             "think": {"kind": "lognormal", "median_s": 0.15,
                       "sigma": 0.8}},
        ],
        "expect": [
            {"kind": "converged", "min_height": 2},
            {"kind": "zero_quarantines"},
            {"kind": "min_committed", "value": 1},
            {"kind": "p99_ms", "objective": "commit_p99_s",
             "max_ms": 30000},
        ],
    },
    "equivocation": {
        "description": "orderer1 double-serves a forged, validly-signed "
                       "sibling at height 3 mid-ramp; every honest peer "
                       "must convict the signer from its witness, "
                       "persist a fraud proof, and converge exactly-once "
                       "on the honest chain",
        "topology": {"n_orderers": 3, "peer_orgs": ["Org1", "Org2"],
                     "peers_per_org": 1},
        "adversaries": {"orderer1": {"mode": "equivocate",
                                     "fork_height": 3, "count": 2}},
        "phases": [
            {"name": "ramp", "duration_s": 8.0,
             "arrivals": {"kind": "ramp", "start_rate": 4.0,
                          "end_rate": 20.0, "ramp_s": 6.0}},
        ],
        "expect": [
            {"kind": "converged", "min_height": 4},
            {"kind": "quarantine", "reasons": ["fork", "equivocation"],
             "min": 1, "on": "all_peers"},
            {"kind": "fraud_proofs", "min": 1, "on": "all_peers"},
            {"kind": "exactly_once"},
            {"kind": "min_committed", "value": 1},
        ],
    },
    "two-faced": {
        "description": "orderer1 keeps an honest raft face but "
                       "equivocates on deliver ONLY toward Org1's peer; "
                       "Org2's peer sees a spotless stream and must "
                       "still convict — via the victim's gossiped fraud "
                       "proof, independently re-verified — and every "
                       "peer demotes the convicted endpoints to last "
                       "resort while committing exactly-once",
        "topology": {"n_orderers": 3, "peer_orgs": ["Org1", "Org2"],
                     "peers_per_org": 1},
        "adversaries": {"orderer1": {"mode": "two_faced",
                                     "victims": ["Org1"],
                                     "fork_height": 3, "count": 2}},
        "phases": [
            {"name": "steady", "duration_s": 8.0,
             "arrivals": {"kind": "constant", "rate": 10.0}},
        ],
        "expect": [
            {"kind": "converged", "min_height": 4},
            {"kind": "quarantine", "reasons": ["fork", "equivocation"],
             "min": 1, "on": "all_peers"},
            {"kind": "fraud_proofs", "min": 1, "on": "all_peers"},
            {"kind": "exactly_once"},
            {"kind": "min_committed", "value": 1},
        ],
    },
    "gossip-poison": {
        "description": "a fake gossip endpoint floods one peer's intake "
                       "with garbage and tampered-signature payloads, "
                       "then injects a forged fork of a committed block; "
                       "the relay is score-quarantined, the forger "
                       "convicted, the ledger untouched",
        "topology": {"n_orderers": 3, "peer_orgs": ["Org1", "Org2"],
                     "peers_per_org": 1},
        "poison": {"victim": ["Org1", 0], "at_height": 2,
                   "garbage": 2, "bad_sig": 2, "stale": 3, "fork": True},
        "phases": [
            {"name": "steady", "duration_s": 8.0,
             "arrivals": {"kind": "constant", "rate": 10.0}},
        ],
        "expect": [
            {"kind": "converged", "min_height": 3},
            {"kind": "quarantine", "reasons": ["poison"], "min": 1,
             "on": "any_peer"},
            {"kind": "quarantine", "reasons": ["fork"], "min": 1,
             "on": "any_peer"},
            {"kind": "exactly_once"},
            {"kind": "min_committed", "value": 1},
        ],
    },
    "tampered-attestation": {
        "description": "orderer1 serves honest blocks but flips the "
                       "verdict-attestation digests riding its deliver "
                       "frames; the round-9 trust registry catches the "
                       "mismatch, the byzantine plane records the "
                       "conviction, peers re-verify and converge",
        "topology": {"n_orderers": 3, "peer_orgs": ["Org1", "Org2"],
                     "peers_per_org": 1},
        "adversaries": {"orderer1": {"mode": "tamper_attests",
                                     "fork_height": 2}},
        "phases": [
            {"name": "steady", "duration_s": 8.0,
             "arrivals": {"kind": "constant", "rate": 10.0}},
        ],
        "expect": [
            {"kind": "converged", "min_height": 3},
            {"kind": "quarantine", "reasons": ["tampered_attestation"],
             "min": 1, "on": "any_peer"},
            {"kind": "min_committed", "value": 1},
        ],
    },
    "snapshot-under-adversary": {
        "description": "the r12 wiped-peer snapshot rejoin with an "
                       "ACTIVE adversary: orderer1 equivocates mid-run, "
                       "then peerOrg2_0 is killed, its ledger wiped, and "
                       "it rejoins by snapshot with a quarantined source "
                       "listed first — the wipe-surviving registry must "
                       "steer the bootstrap to the honest source",
        "topology": {"n_orderers": 3, "peer_orgs": ["Org1", "Org2"],
                     "peers_per_org": 2},
        "adversaries": {"orderer1": {"mode": "equivocate",
                                     "fork_height": 3, "count": 2}},
        "snapshot_rejoin": {"victim": "peerOrg2_0",
                            "quarantined_source": "peerOrg1_0",
                            "honest_source": "peerOrg1_1"},
        "phases": [
            {"name": "steady", "duration_s": 8.0,
             "arrivals": {"kind": "constant", "rate": 10.0}},
        ],
        "expect": [
            {"kind": "snapshot_rejoin"},
            {"kind": "converged", "min_height": 4, "timeout_s": 45.0},
            {"kind": "quarantine", "reasons": ["fork", "equivocation"],
             "min": 1, "on": "any_peer"},
            {"kind": "exactly_once"},
            {"kind": "min_committed", "value": 1},
            {"kind": "p99_ms", "objective": "commit_p99_s",
             "max_ms": 30000},
        ],
    },
    "mixed-identity": {
        "description": "P-256 and ed25519 creators blended through one "
                       "gateway under bursty load — the MSP's multi-"
                       "scheme acceptance exercised at traffic level, "
                       "zero quarantines expected",
        "topology": {"n_orderers": 1, "peer_orgs": ["Org1"],
                     "peers_per_org": 1},
        "identity_blend": {"p256": 0.5, "ed25519": 0.5},
        "mode": "inline",
        "phases": [
            {"name": "bursts", "duration_s": 8.0,
             "arrivals": {"kind": "burst", "low_rate": 3.0,
                          "high_rate": 12.0, "period_s": 3.0,
                          "duty": 0.4},
             "think": {"kind": "exponential", "mean_s": 0.1}},
        ],
        "expect": [
            {"kind": "converged", "min_height": 2},
            {"kind": "zero_quarantines"},
            {"kind": "exactly_once"},
            {"kind": "min_committed", "value": 1},
        ],
    },
    "soak-compressed": {
        "description": "2-org compressed soak under steady open-loop "
                       "load with the resource collector sampling "
                       "RSS/fd/thread/GC into the timeseries ring; the "
                       "leak gate runs Theil-Sen over the soak window "
                       "and must find every gated series FLAT (slope "
                       "CI spanning zero or immaterial growth) — the "
                       "ROADMAP #4 leak/regression gate at smoke "
                       "length",
        "topology": {"n_orderers": 1, "peer_orgs": ["Org1", "Org2"],
                     "peers_per_org": 1},
        # observe: scenario-owned TimeSeriesStore + ResourceCollector
        # over the process-global registry (ChaosNet nodes share the
        # process, so one collector sees the whole cluster's resources).
        # warmup_s must outlast link establishment: the client pool is
        # warm-dialed up front, but gossip/state-transfer links dial
        # lazily on their first round ~3-6 s into the load — a one-time
        # step the gate should never even see
        "observe": {"interval_s": 0.25, "warmup_s": 6.0},
        # a clean soak must also capture ZERO incident bundles: the
        # recorder arms on the shed-rate objective only (the default
        # objectives are host-timing-sensitive and would make "zero
        # bundles" a flaky claim), and an unshedding soak never burns it
        "slo": {
            "sample_interval_s": 0.5, "short_window_s": 5.0,
            "long_window_s": 15.0,
            "objectives": {
                "shed_rate": {"kind": "max", "source": "counter_rate",
                              "metric": "gateway_shed_total",
                              "threshold": 1.0,
                              "help": "gateway sheds per second"},
                "commit_p99_s": {"enabled": False},
                "verify_throughput_floor": {"enabled": False},
                "breaker_open_frac": {"enabled": False},
                "overlap_floor": {"enabled": False},
            }},
        "phases": [
            {"name": "soak", "duration_s": 15.0,
             "arrivals": {"kind": "constant", "rate": 10.0},
             "think": {"kind": "exponential", "mean_s": 0.2}},
        ],
        "expect": [
            {"kind": "converged", "min_height": 2},
            {"kind": "min_committed", "value": 1},
            {"kind": "zero_quarantines"},
            {"kind": "incidents", "max": 0},
            # fd/thread counts must be dead flat at steady state; RSS
            # and allocator blocks grow legitimately with committed
            # ledger state under a 90%-write mix, so their thresholds
            # gate the RATE of growth, not its existence — an injected
            # leak (a steady retain of fds/objects) still blows
            # through, a one-time step never fires (slope CI hits 0)
            {"kind": "leak_free", "series": {
                "process_open_fds": {"max_growth_frac": 0.10},
                "process_threads": {"max_growth_frac": 0.10},
                "process_resident_memory_bytes":
                    {"max_growth_frac": 0.30},
                "process_allocated_blocks": {"max_growth_frac": 0.40},
            }},
        ],
    },
    "overload-incident": {
        "description": "structurally throttled gateway flooded at ~5x "
                       "its drain ceiling: the admission plane sheds, "
                       "the shed-rate SLO burns, and the flight data "
                       "recorder must capture EXACTLY ONE verifiable "
                       "incident bundle naming that objective — the "
                       "self-diagnosing-overload drill",
        "topology": {"n_orderers": 1, "peer_orgs": ["Org1"],
                     "peers_per_org": 1},
        # max_batch 2 + 250ms linger caps the drain rate structurally
        # (~8 tx/s), so "overload" is a topology property, not a host-
        # speed measurement; the short queue forces shedding within the
        # first burn window
        "gateway": {"linger_s": 0.25, "max_batch": 2, "max_queue": 16,
                    "broadcast_deadline_s": 20.0,
                    "admission": {"enabled": True,
                                  "queue_high_frac": 0.25,
                                  "latency_slo_s": 0.4, "dwell_s": 0.5,
                                  "recover_ratio": 0.6,
                                  "eval_interval_s": 0.05,
                                  "retry_after_base_ms": 50}},
        # only the shed-rate objective is armed (defaults disabled):
        # the drill must prove the bundle names the RIGHT objective,
        # so no other objective may fire first.  cooldown outlasts the
        # run -> "exactly one" is deterministic, not a race
        "slo": {
            "sample_interval_s": 0.25, "short_window_s": 2.0,
            "long_window_s": 6.0,
            "objectives": {
                "shed_rate": {"kind": "max", "source": "counter_rate",
                              "metric": "gateway_shed_total",
                              "threshold": 1.0,
                              "help": "gateway sheds per second"},
                "commit_p99_s": {"enabled": False},
                "verify_throughput_floor": {"enabled": False},
                "breaker_open_frac": {"enabled": False},
                "overlap_floor": {"enabled": False},
            }},
        "incidents": {"cooldown_s": 600.0, "keep": 4,
                      "profile_window_s": 30.0},
        "profiler": {"hz": 19.0, "window_s": 2.0},
        "mode": "pool",
        "phases": [
            {"name": "flood", "duration_s": 8.0,
             "arrivals": {"kind": "constant", "rate": 40.0}},
            # the cool-down lets in-flight batches drain so the
            # converged gate sees a quiesced ledger
            {"name": "cool", "duration_s": 4.0,
             "arrivals": {"kind": "constant", "rate": 1.0}},
        ],
        "expect": [
            {"kind": "incidents", "min": 1, "max": 1,
             "objective": "shed_rate"},
            {"kind": "min_committed", "value": 1},
            {"kind": "converged", "min_height": 1},
        ],
    },
    "rolling-upgrade": {
        "description": "drain -> restart every node one at a time while "
                       "the open loop keeps firing across all gateway "
                       "peers: each node must hand off cleanly (orderers "
                       "transfer leadership, peers checkpoint), come "
                       "back from disk without losing committed height, "
                       "and the fleet must end converged with every "
                       "txid committed exactly once and ZERO "
                       "quarantines — an upgrade is not a crime",
        "topology": {"n_orderers": 3, "peer_orgs": ["Org1", "Org2"],
                     "peers_per_org": 1},
        "fan_out": True,
        # inline mode: endorsement happens at fire time, so the drill
        # overlaps real traffic (pool mode would pre-endorse everything
        # against a peer the drill is about to drain)
        "mode": "inline",
        "rolling_upgrade": {"after_s": 2.0, "drain_timeout_s": 6.0,
                            "settle_s": 60.0},
        "phases": [
            {"name": "steady", "duration_s": 14.0,
             "arrivals": {"kind": "constant", "rate": 12.0}},
        ],
        "expect": [
            {"kind": "rolling_upgrade"},
            {"kind": "no_height_regression"},
            {"kind": "converged", "min_height": 2, "timeout_s": 90.0},
            {"kind": "exactly_once"},
            {"kind": "zero_quarantines"},
            {"kind": "min_committed", "value": 1},
            {"kind": "sojourn_p99_ms", "max_ms": 30000},
        ],
    },
    "membership-churn": {
        "description": "dynamic consenter set under load: a provisioned "
                       "spare orderer is added through an add-consenter "
                       "config entry riding the raft log itself, "
                       "started, handed leadership, then an original "
                       "consenter is removed by a second config entry — "
                       "the removed node self-evicts, every remaining "
                       "node drops it from the signed-entry verifier, "
                       "and throughput/exactly-once hold throughout "
                       "with zero false-positive quarantines",
        "topology": {"n_orderers": 3, "peer_orgs": ["Org1", "Org2"],
                     "peers_per_org": 1, "spare_orderers": 1},
        "membership_churn": {"after_s": 2.0, "remove": "orderer1"},
        "phases": [
            {"name": "steady", "duration_s": 14.0,
             "arrivals": {"kind": "constant", "rate": 10.0}},
        ],
        "expect": [
            {"kind": "membership_churn"},
            {"kind": "converged", "min_height": 2, "timeout_s": 90.0},
            {"kind": "exactly_once"},
            {"kind": "zero_quarantines"},
            {"kind": "min_committed", "value": 1},
        ],
    },
    "elastic-scale-out": {
        "description": "elastic join: two peers are wiped and snapshot-"
                       "bootstrap SIMULTANEOUSLY from one serving peer "
                       "while that peer is also carrying the client "
                       "load — both must install the same checkpoint "
                       "generation (the chunk server lease-pins it "
                       "against concurrent checkpoint GC), join deliver "
                       "at snapshot height, and converge with the fleet",
        "topology": {"n_orderers": 3, "peer_orgs": ["Org1", "Org2"],
                     "peers_per_org": 2},
        "scale_out": {"source": "peerOrg1_0",
                      "joiners": ["peerOrg2_0", "peerOrg2_1"],
                      "after_s": 3.0},
        "phases": [
            {"name": "steady", "duration_s": 12.0,
             "arrivals": {"kind": "constant", "rate": 10.0}},
        ],
        "expect": [
            {"kind": "scale_out"},
            {"kind": "converged", "min_height": 3, "timeout_s": 90.0},
            {"kind": "exactly_once"},
            {"kind": "zero_quarantines"},
            {"kind": "min_committed", "value": 1},
        ],
    },
    "burst-partition": {
        "description": "square-wave bursts while Org2's outbound links "
                       "black-hole for a mid-run window (crash-stop "
                       "netsplit, nobody lies): the partitioned peer "
                       "falls behind, heals, anti-entropy catches it up "
                       "— and the byzantine plane must stay SILENT",
        "topology": {"n_orderers": 3, "peer_orgs": ["Org1", "Org2"],
                     "peers_per_org": 1},
        "partition": {"org": "Org2", "window": [2.0, 5.0]},
        "phases": [
            {"name": "bursts", "duration_s": 8.0,
             "arrivals": {"kind": "burst", "low_rate": 4.0,
                          "high_rate": 16.0, "period_s": 4.0,
                          "duty": 0.35}},
        ],
        "expect": [
            {"kind": "converged", "min_height": 2,
             "timeout_s": 45.0},
            {"kind": "zero_quarantines"},
            {"kind": "min_committed", "value": 1},
        ],
    },
}


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


# ---------------------------------------------------------------------------
# spec -> fault plan

def build_plan(spec: dict, seed: int):
    """Compile a scenario's links/partition into one installed-ready
    FaultPlan (or None when the spec declares neither)."""
    from fabric_tpu_torch.comm.faults import FaultPlan, FaultSchedule
    links = spec.get("links")
    part = spec.get("partition")
    if not links and not part:
        return None
    plan = FaultPlan(seed=seed * 977 + 5)
    if links:
        matrix = {}
        for key, props in links.items():
            src, _, dst = key.partition("->")
            matrix[(src, dst or "*")] = props
        plan.links(matrix, schedule=spec.get("link_schedule"))
    if part:
        lo, hi = part.get("window", [0.0, 3.0])
        plan.rule(src=str(part.get("org", "*")), drop=1.0,
                  schedule=FaultSchedule(kind="window", start_s=float(lo),
                                         end_s=float(hi)))
    return plan


# ---------------------------------------------------------------------------
# gossip poisoning injection

def _poison_thread(net, spec: dict, sent: dict) -> threading.Thread:
    """Background injector: waits for the victim to commit past
    `at_height`, then lands the configured offenses + one forged fork
    block (signed with a real consenter key pulled from an orderer)."""
    pcfg = dict(spec.get("poison") or {})
    org, idx = pcfg.get("victim", ["Org1", 0])

    def _run() -> None:
        from fabric_tpu_torch.testing.adversary import (
            GossipPoisoner, forge_fork_block)
        deadline = time.time() + 30.0
        victim = None
        at = int(pcfg.get("at_height", 2))
        while time.time() < deadline:
            peers = [p for n, p in net.nodes.items()
                     if net._specs[n][0] == "peer"
                     and n.startswith(f"peer{org}")]
            if peers and idx < len(peers):
                ch = peers[idx].channels[net.channel_id]
                if ch.ledger.height > at:
                    victim = ch
                    break
            time.sleep(0.1)
        if victim is None:
            logger.warning("poison: victim never reached height %d", at)
            return
        poisoner = GossipPoisoner(victim)
        # fork first: once the offense flood quarantines the relay,
        # its frames are pre-dropped at intake and never reach the
        # witness — the forger must be convicted while the relay is
        # still being heard
        if pcfg.get("fork"):
            orderer = net.orderers()[0]
            forged = forge_fork_block(
                victim.ledger.blockstore, at, orderer.signer)
            poisoner.inject(forged)
        poisoner.garbage(int(pcfg.get("garbage", 0)))
        poisoner.bad_sig(int(pcfg.get("bad_sig", 0)))
        poisoner.stale(int(pcfg.get("stale", 0)))
        sent.update(poisoner.sent)

    t = threading.Thread(target=_run, name="scenario-poison", daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# wiped-peer snapshot rejoin under an active adversary

def _snapshot_rejoin(net, spec: dict) -> dict:
    """The r12 wiped-peer rejoin drill with standing: kill + wipe the
    victim peer's ledger, seed its quarantine registry (which SURVIVES
    the wipe — it is node-scoped, not ledger-scoped) with the first
    snapshot source's identity — the conviction a gossiped fraud proof
    left in the victim's previous life — then restart it with the
    convicted source listed FIRST.  The rejoining peer must refuse that
    source and bootstrap from the honest one behind it."""
    import shutil
    from fabric_tpu_torch.byzantine import QuarantineRegistry
    from fabric_tpu_torch.orderer.cluster import cert_fingerprint

    cfg = dict(spec["snapshot_rejoin"])
    victim = str(cfg.get("victim", "peerOrg2_0"))
    evil = str(cfg.get("quarantined_source", "peerOrg1_0"))
    honest = str(cfg.get("honest_source", "peerOrg1_1"))
    out: dict = {"victim": victim, "quarantined_source": evil,
                 "honest_source": honest}

    def _load_cfg(name):
        with open(net._specs[name][1]) as f:
            c = json.load(f)
        return c

    evil_cfg, honest_cfg, vcfg = (_load_cfg(evil), _load_cfg(honest),
                                  _load_cfg(victim))
    evil_addr = [evil_cfg.get("host", "127.0.0.1"), int(evil_cfg["port"])]
    honest_addr = [honest_cfg.get("host", "127.0.0.1"),
                   int(honest_cfg["port"])]
    evil_node = net.nodes[evil]
    evil_key = (f"{evil_node.signer.mspid}|"
                f"{cert_fingerprint(evil_node.signer.cert)}")

    net.kill(victim)
    ledger_root = os.path.join(vcfg["data_dir"], "channels",
                               net.channel_id, "ledger")
    if not os.path.isdir(ledger_root):
        ledger_root = os.path.join(vcfg["data_dir"], "ledger")
    shutil.rmtree(ledger_root, ignore_errors=True)
    QuarantineRegistry(
        os.path.join(vcfg["data_dir"], "byzantine_quarantine.json")
    ).quarantine(evil_key, "equivocation")
    vcfg["bootstrap_snapshot"] = {
        "enabled": True, "from": [evil_addr, honest_addr],
        "chunk_timeout_s": 2.0, "attempts": 4}
    with open(net._specs[victim][1], "w") as f:
        json.dump(vcfg, f)
    node = net.restart(victim)
    ch = node.channels[net.channel_id]
    info = getattr(ch, "snapshot_bootstrap", None)
    out["bootstrap"] = info
    out["base"] = int(ch.ledger.blockstore.base)
    src = list(info.get("from", [])) if info else None
    out["from_honest"] = src == list(honest_addr)
    out["refused_quarantined"] = src != list(evil_addr)
    return out


# ---------------------------------------------------------------------------
# fleet lifecycle drills (background threads riding the load phases)

def _admin_call(net, admin, msps, method: str, body: dict,
                timeout_s: float = 30.0,
                retry_on=("not_leader",)):
    """Issue one admin RPC against whichever running orderer currently
    leads: walk the consenters, follow not_leader verdicts (and any
    other status named in `retry_on`), retry until something terminal
    comes back.  Returns (orderer-name, response) — (None, last-error)
    when the deadline lapses."""
    from fabric_tpu_torch.comm.rpc import connect
    deadline = time.time() + timeout_s
    last = None
    while time.time() < deadline:
        for oname, (kind, _) in list(net._specs.items()):
            if kind != "orderer" or oname not in net.nodes:
                continue
            try:
                conn = connect(net.orderer_addr(oname), admin, msps,
                               timeout=5.0)
                try:
                    out = conn.call(method, body, timeout=10.0)
                finally:
                    conn.close()
                if out.get("status") not in retry_on:
                    return oname, out
                last = out
            except Exception as exc:       # dial/refusal: try the next
                last = {"error": str(exc)}
        time.sleep(0.2)
    return None, last


def _load_admin(net):
    """(admin-signer, msps) for the first peer org — membership RPCs
    are Admins-gated, and a peer-org admin of the bootstrap channel
    satisfies the orderer's participation gate."""
    from fabric_tpu_torch.node.orderer import load_signing_identity
    org = sorted(net.paths["admins"])[0]
    with open(net.paths["admins"][org]) as f:
        ac = json.load(f)
    admin = load_signing_identity(
        ac["mspid"], ac["cert_pem"].encode(), ac["key_pem"].encode())
    return admin, net.peers()[0].msps


def _rolling_upgrade_thread(net, spec: dict, out: dict) -> threading.Thread:
    """Background rolling restart: after `after_s`, drain -> kill ->
    restart every running node one at a time while the open loop keeps
    firing.  Pre/post heights land in `out` for the no-regression gate."""
    rcfg = dict(spec.get("rolling_upgrade") or {})

    def _run() -> None:
        time.sleep(float(rcfg.get("after_s", 2.0)))
        out["pre_heights"] = net.heights()
        try:
            out["drains"] = net.rolling_restart(
                drain_timeout_s=float(rcfg.get("drain_timeout_s", 6.0)),
                settle_s=float(rcfg.get("settle_s", 60.0)))
        except Exception as exc:
            logger.exception("rolling upgrade drill failed")
            out["error"] = str(exc)
        out["post_heights"] = net.heights()
        out["regressed"] = sorted(
            n for n, h in out["pre_heights"].items()
            if out["post_heights"].get(n, 0) < h)
        out["done"] = True

    t = threading.Thread(target=_run, name="scenario-roll", daemon=True)
    t.start()
    return t


def _membership_churn_thread(net, spec: dict, out: dict) -> threading.Thread:
    """Background membership churn: add the provisioned spare consenter
    through the log, start it, transfer leadership onto it, remove an
    original consenter, then prove the removed node is out — every
    remaining consenter's raft node set excludes it, the removed node
    self-evicted, and (once killed) the fleet keeps committing without
    it."""
    mcfg = dict(spec.get("membership_churn") or {})

    def _wait(pred, timeout_s: float) -> bool:
        deadline = time.time() + float(timeout_s)
        while time.time() < deadline:
            try:
                if pred():
                    return True
            except Exception:
                pass
            time.sleep(0.1)
        return False

    def _run() -> None:
        time.sleep(float(mcfg.get("after_s", 2.0)))
        try:
            admin, msps = _load_admin(net)
            spare = net.spare_names()[0]
            scfg = net.spare_cfg(spare)
            spare_rid = int(scfg["raft_id"])
            out["spare"] = spare

            # 1. add-consenter config entry THROUGH the raft log
            who, resp = _admin_call(net, admin, msps, "admin.add_consenter",
                                    {"raft_id": spare_rid,
                                     "host": scfg.get("host", "127.0.0.1"),
                                     "port": int(scfg["port"]),
                                     "mspid": scfg["mspid"],
                                     "cert_fp": scfg["cert_fp"]})
            out["add"] = {"via": who, "resp": resp}
            if who is None or resp.get("status") != "proposed":
                out["error"] = f"add_consenter failed: {resp}"
                return

            # 2. start the spare; it replicates the log (including its
            # own add entry) from the leader and becomes a voter
            spare_node = net.restart(spare)
            out["added_joined"] = _wait(
                lambda: spare_rid in spare_node.support.chain.node.nodes
                and spare_node.support.chain.node.applied_index
                >= int(resp.get("index", 1)), 30.0)

            # 3. leadership onto the NEW consenter (the gap-free
            # handover the drain path uses; retried — a transfer is a
            # request, the target still has to win its election)
            def _spare_leads():
                return spare_node.support.chain.node.role == "leader"
            deadline = time.time() + 30.0
            while not _spare_leads() and time.time() < deadline:
                _admin_call(net, admin, msps, "admin.transfer_leadership",
                            {"to": spare_rid}, timeout_s=5.0,
                            retry_on=("not_leader", "refused"))
                _wait(_spare_leads, 2.0)
            out["leader_transferred"] = _spare_leads()

            # 4. remove an ORIGINAL consenter by a second config entry
            victim = str(mcfg.get("remove", "orderer1"))
            with open(net._specs[victim][1]) as f:
                victim_rid = int(json.load(f)["raft_id"])
            victim_node = net.nodes[victim]
            who, resp = _admin_call(net, admin, msps,
                                    "admin.remove_consenter",
                                    {"raft_id": victim_rid})
            out["remove"] = {"via": who, "resp": resp, "node": victim}
            if who is None or resp.get("status") != "proposed":
                out["error"] = f"remove_consenter failed: {resp}"
                return

            # 5. the removal must take everywhere: remaining consenters
            # drop the victim from their raft node sets (its entries are
            # rejected at the consenter-authorization gate from the
            # commit point forward) and the victim self-evicts
            remaining = [net.nodes[n] for n, (k, _) in net._specs.items()
                         if k == "orderer" and n in net.nodes
                         and n != victim]
            out["removed_isolated"] = _wait(
                lambda: all(victim_rid not in o.support.chain.node.nodes
                            for o in remaining), 30.0)
            out["removed_self_evicted"] = _wait(
                lambda: victim_rid
                not in victim_node.support.chain.node.nodes, 30.0)
            # decommission the now-external process; deliver clients
            # fail over and the fleet must keep committing without it
            net.kill(victim)
        except Exception as exc:
            logger.exception("membership churn drill failed")
            out["error"] = str(exc)
        finally:
            out["done"] = True

    t = threading.Thread(target=_run, name="scenario-churn", daemon=True)
    t.start()
    return t


def _scale_out_thread(net, spec: dict, out: dict) -> threading.Thread:
    """Background elastic scale-out: wipe N peers and snapshot-bootstrap
    them SIMULTANEOUSLY from one source peer that is still serving the
    client load — the concurrent-fetch path the chunk server's
    generation leases exist for."""
    scfg = dict(spec.get("scale_out") or {})

    def _run() -> None:
        import shutil
        time.sleep(float(scfg.get("after_s", 3.0)))
        try:
            source = str(scfg.get("source", "peerOrg1_0"))
            joiners = [str(j) for j in (scfg.get("joiners") or [])]
            with open(net._specs[source][1]) as f:
                src_cfg = json.load(f)
            src_addr = [src_cfg.get("host", "127.0.0.1"),
                        int(src_cfg["port"])]
            # the source needs a snapshotable history first (pool-mode
            # pre-endorsement can hold the load back for a while, so
            # this wait is generous)
            deadline = time.time() + 120.0
            while time.time() < deadline:
                src = net.nodes.get(source)
                if src is not None and \
                        src.channels[net.channel_id].ledger.height >= 2:
                    break
                time.sleep(0.1)
            out["source"] = source
            results: Dict[str, dict] = {}

            def _join(name: str) -> None:
                try:
                    with open(net._specs[name][1]) as f:
                        vcfg = json.load(f)
                    net.kill(name)
                    root = os.path.join(vcfg["data_dir"], "channels",
                                        net.channel_id, "ledger")
                    if not os.path.isdir(root):
                        root = os.path.join(vcfg["data_dir"], "ledger")
                    shutil.rmtree(root, ignore_errors=True)
                    vcfg["bootstrap_snapshot"] = {
                        "enabled": True, "from": [src_addr],
                        "chunk_timeout_s": 5.0, "attempts": 6}
                    with open(net._specs[name][1], "w") as f:
                        json.dump(vcfg, f)
                    node = net.restart(name)
                    ch = node.channels[net.channel_id]
                    results[name] = {
                        "bootstrap": getattr(ch, "snapshot_bootstrap",
                                             None),
                        "base": int(ch.ledger.blockstore.base),
                        "height": int(ch.ledger.height)}
                except Exception as exc:
                    logger.exception("scale-out join of %s failed", name)
                    results[name] = {"error": str(exc)}

            threads = [threading.Thread(target=_join, args=(n,),
                                        name=f"scale-out-{n}",
                                        daemon=True) for n in joiners]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120.0)
            out["joiners"] = results
        except Exception as exc:
            logger.exception("scale-out drill failed")
            out["error"] = str(exc)
        finally:
            out["done"] = True

    t = threading.Thread(target=_run, name="scenario-scale", daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# byzantine state collection + SLO evaluation

def _byz_state(net) -> dict:
    out = {}
    for name, node in net.nodes.items():
        byz = getattr(node, "byzantine", None)
        if byz is None:
            continue
        kind = net._specs[name][0]
        chans = {}
        if kind == "peer":
            for cid, ch in getattr(node, "channels", {}).items():
                mon = getattr(ch, "byz_monitor", None)
                if mon is not None:
                    chans[cid] = mon.snapshot()
                pg = getattr(ch, "proof_gossip", None)
                if pg is not None:
                    chans.setdefault(cid, {})["proof_gossip"] = \
                        pg.snapshot()
        else:
            # orderers carry per-channel monitors too (r14); their
            # registry reads identically but quarantine expectations
            # are judged against PEERS, so kind rides along
            for cid, mon in getattr(node, "byz_monitors", {}).items():
                chans[cid] = mon.snapshot()
        out[name] = {"kind": kind,
                     "quarantined": byz.count(),
                     "reasons": byz.reasons(),
                     "identities": sorted(byz.snapshot()),
                     "channels": chans}
    return out


def _committed_txids(peer, channel_id: str) -> List[str]:
    """Every txid committed on one peer, in block order — the raw
    material of the exactly-once assertion."""
    from fabric_tpu_torch.protocol.types import Envelope
    store = peer.channels[channel_id].ledger.blockstore
    txids: List[str] = []
    # a snapshot-rejoined peer has no blocks below its snapshot base;
    # exactly-once is judged over what the store actually holds
    base = int(getattr(store, "base", 0) or 0)
    for num in range(base, store.height):
        for raw in store.get_by_number(num).data:
            try:
                hdr = Envelope.deserialize(bytes(raw)).header()
                txid = hdr.channel_header.txid
            except Exception:
                continue
            if txid:
                txids.append(txid)
    return txids


def _check_expectations(spec: dict, net, report: dict,
                        slo_eval=None, ts_store=None) -> List[str]:
    """Evaluate the `expect` block; returns human-readable violations
    (empty = all SLOs held)."""
    violations: List[str] = []
    byz = report["byzantine"]
    # quarantine/fraud-proof expectations are judged against PEERS:
    # orderer nodes carry registries of their own (r14) and "all_peers"
    # must not demand a conviction from the adversary's own process
    peers = {n: s for n, s in byz.items()
             if s.get("kind", "peer") == "peer"}
    tot = report.get("totals", {})
    for check in spec.get("expect", []):
        kind = check["kind"]
        if kind == "converged":
            ok = net.wait_converged(
                timeout_s=float(check.get("timeout_s", 30.0)),
                min_height=check.get("min_height"))
            report["converged"] = ok
            report["heights"] = net.heights()
            if not ok:
                violations.append(
                    f"converged: peers diverged or stalled "
                    f"(heights={net.heights()})")
        elif kind == "zero_quarantines":
            # every node kind: crash-stop faults must be silent on
            # orderer registries too
            noisy = {n: s["reasons"] for n, s in byz.items()
                     if s["quarantined"]}
            if noisy:
                violations.append(
                    f"zero_quarantines: false positives {noisy}")
            loud = {n: ch["proof_gossip"]["broadcasts"]
                    for n, s in byz.items()
                    for ch in s["channels"].values()
                    if ch.get("proof_gossip", {}).get("broadcasts")}
            if loud:
                violations.append(
                    f"zero_quarantines: fraud proofs broadcast with "
                    f"nothing to prove {loud}")
        elif kind == "quarantine":
            reasons = check.get("reasons", [])
            need = int(check.get("min", 1))
            hits = {n: sum(s["reasons"].get(r, 0) for r in reasons)
                    for n, s in peers.items()}
            quorum = (all if check.get("on", "any_peer") == "all_peers"
                      else any)
            if not peers or not quorum(v >= need for v in hits.values()):
                violations.append(
                    f"quarantine[{','.join(reasons)}]: wanted >={need} "
                    f"on {check.get('on', 'any_peer')}, got {hits}")
        elif kind == "fraud_proofs":
            need = int(check.get("min", 1))
            hits = {n: sum(c.get("fraud_proofs", 0)
                           for c in s["channels"].values())
                    for n, s in peers.items()}
            quorum = (all if check.get("on", "any_peer") == "all_peers"
                      else any)
            if not peers or not quorum(v >= need for v in hits.values()):
                violations.append(
                    f"fraud_proofs: wanted >={need}, got {hits}")
        elif kind == "min_committed":
            if tot.get("committed", 0) < int(check["value"]):
                violations.append(
                    f"min_committed: {tot.get('committed', 0)} < "
                    f"{check['value']}")
        elif kind == "max_shed_frac":
            if tot.get("shed_frac", 0.0) > float(check["value"]):
                violations.append(
                    f"max_shed_frac: {tot.get('shed_frac')} > "
                    f"{check['value']}")
        elif kind == "p99_ms":
            # latency-percentile assertion fed from the SLO evaluator's
            # WINDOWED quantiles (ops_plane/slo.py) — the same numbers
            # /slo serves in production, not a whole-run average
            obj_name = check.get("objective", "commit_p99_s")
            limit = float(check["max_ms"])
            value_ms = None
            if slo_eval is not None:
                try:
                    slo_eval.step()      # force one final sample+eval
                except Exception:
                    logger.exception("slo evaluator step failed")
                for obj in slo_eval.status().get("objectives", []):
                    if obj.get("name") != obj_name:
                        continue
                    v = obj.get("value_short")
                    if v is None:
                        v = obj.get("value_long")
                    if v is not None:
                        value_ms = round(float(v) * 1000.0, 3)
            report.setdefault("latency_p99_ms", {})[obj_name] = value_ms
            if value_ms is None:
                violations.append(
                    f"p99_ms[{obj_name}]: no windowed quantile observed")
            elif value_ms > limit:
                violations.append(
                    f"p99_ms[{obj_name}]: {value_ms}ms > {limit}ms")
        elif kind == "incidents":
            # the flight-data-recorder assertion: overload-shaped runs
            # must capture a bundle NAMING the burning objective
            # (min>=1); clean runs must capture none (max=0) — a bundle
            # on a healthy run is itself a regression
            inc = report.get("incidents") or {}
            bundles = inc.get("bundles") or []
            obj = check.get("objective")
            if obj is not None:
                bundles = [b for b in bundles
                           if str(b.get("objective", "")).startswith(obj)]
            need = int(check.get("min", 0))
            cap = check.get("max")
            tag = f"incidents[{obj or '*'}]"
            got = [(b["id"], b.get("objective")) for b in bundles]
            if len(bundles) < need:
                violations.append(
                    f"{tag}: wanted >={need} bundle(s), got {got}")
            if cap is not None and len(bundles) > int(cap):
                violations.append(
                    f"{tag}: wanted <={cap} bundle(s), got {got}")
            bad = [b["id"] for b in bundles if not b.get("verified")]
            if bad:
                violations.append(
                    f"{tag}: MANIFEST verification failed for {bad}")
        elif kind == "snapshot_rejoin":
            sr = report.get("snapshot_rejoin") or {}
            if sr.get("base", 0) <= 0:
                violations.append(
                    f"snapshot_rejoin: no snapshot installed ({sr})")
            elif not sr.get("refused_quarantined"):
                violations.append(
                    f"snapshot_rejoin: bootstrapped from the "
                    f"quarantined source ({sr})")
            elif not sr.get("from_honest"):
                violations.append(
                    f"snapshot_rejoin: honest source not used ({sr})")
        elif kind == "leak_free":
            # Theil-Sen slope gate over the scenario's timeseries ring
            # (ops_plane/timeseries.py): each gated series must stay
            # flat over the soak — slope CI spanning zero, or growth an
            # immaterial fraction of the level.  The verdicts (slope +
            # CI per series) land in the report either way, so an
            # honest run documents its flatness evidence.
            if ts_store is None:
                violations.append(
                    "leak_free: no timeseries store (spec needs an "
                    "`observe` block)")
                continue
            from fabric_tpu_torch.ops_plane import timeseries as _ts
            obs = dict(spec.get("observe", {}))
            gate = _ts.evaluate_leak_gate(
                ts_store, dict(check.get("series", {})),
                window_s=float(check.get("window_s", 1e9)),
                warmup_s=float(obs.get("warmup_s", 0.0)))
            report["leak_gate"] = gate
            for name in gate["leaking"]:
                v = gate["series"][name]
                violations.append(
                    f"leak_free[{name}]: slope "
                    f"{v['slope_per_s']:.4g}/s (95% CI "
                    f"[{v['ci_lo']:.4g}, {v['ci_hi']:.4g}]), "
                    f"+{v['growth_frac']:.1%} over {v['span_s']:.1f}s "
                    f"soak (limit {v['max_growth_frac']:.0%})")
            missing = [n for n, v in gate["series"].items()
                       if v.get("verdict") == "insufficient_data"]
            if missing:
                violations.append(
                    f"leak_free: insufficient samples for {missing}")
        elif kind == "rolling_upgrade":
            ru = report.get("rolling_upgrade") or {}
            if not ru.get("done"):
                violations.append("rolling_upgrade: drill never finished")
            elif ru.get("error"):
                violations.append(f"rolling_upgrade: {ru['error']}")
            else:
                stuck = {n: r for n, r in (ru.get("drains") or {}).items()
                         if r.get("lifecycle") != "drained"}
                if stuck:
                    violations.append(
                        f"rolling_upgrade: nodes never drained {stuck}")
        elif kind == "no_height_regression":
            ru = report.get("rolling_upgrade") or {}
            if ru.get("regressed"):
                violations.append(
                    f"no_height_regression: committed height lost on "
                    f"{ru['regressed']} (pre={ru.get('pre_heights')}, "
                    f"post={ru.get('post_heights')})")
        elif kind == "membership_churn":
            mc = report.get("membership_churn") or {}
            if not mc.get("done"):
                violations.append("membership_churn: drill never finished")
            elif mc.get("error"):
                violations.append(f"membership_churn: {mc['error']}")
            else:
                for flag in ("added_joined", "leader_transferred",
                             "removed_isolated", "removed_self_evicted"):
                    if not mc.get(flag):
                        violations.append(
                            f"membership_churn: {flag} is false ({mc})")
        elif kind == "scale_out":
            so = report.get("scale_out") or {}
            joiners = so.get("joiners") or {}
            if not so.get("done") or not joiners:
                violations.append(
                    f"scale_out: drill incomplete ({so})")
            elif so.get("error"):
                violations.append(f"scale_out: {so['error']}")
            else:
                for name, r in joiners.items():
                    if r.get("error"):
                        violations.append(
                            f"scale_out[{name}]: {r['error']}")
                    elif int(r.get("base", 0) or 0) <= 0:
                        violations.append(
                            f"scale_out[{name}]: no snapshot installed "
                            f"(joined from genesis, base="
                            f"{r.get('base')})")
        elif kind == "sojourn_p99_ms":
            # accepted-path tail straight off the runner's totals:
            # arrival -> orderer ack for every ADMITTED submission
            v = (tot.get("sojourn_ms") or {}).get("p99")
            limit = float(check["max_ms"])
            if v is None:
                violations.append("sojourn_p99_ms: nothing accepted")
            elif float(v) > limit:
                violations.append(
                    f"sojourn_p99_ms: {v}ms > {limit}ms")
        elif kind == "exactly_once":
            dup_peers = {}
            for name, node in net.nodes.items():
                if net._specs[name][0] != "peer":
                    continue
                txids = _committed_txids(node, net.channel_id)
                if len(txids) != len(set(txids)):
                    dup_peers[name] = len(txids) - len(set(txids))
            report["exactly_once"] = not dup_peers
            if dup_peers:
                violations.append(
                    f"exactly_once: duplicate commits {dup_peers}")
        else:
            violations.append(f"unknown expect kind {kind!r}")
    return violations


# ---------------------------------------------------------------------------
# the runner

def run_scenario(name: str, seed: int = 7,
                 base_dir: Optional[str] = None,
                 report_path: Optional[str] = None,
                 strict: bool = False, bccsp: str = "CUDA") -> dict:
    """Provision, attack, load, assert, report.

    Returns the report dict (also written as a JSON artifact).  With
    `strict=True` a failed `expect` block raises ScenarioFailure AFTER
    the artifact is written — the evidence survives the assertion.
    `bccsp` ("CUDA" or "SW") is the provider of the process's factory
    default and of every node.
    """
    spec = SCENARIOS.get(name)
    if spec is None:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(one of {list_scenarios()})")
    from fabric_tpu_torch.bccsp.factory import FactoryOpts, init_factories
    from fabric_tpu_torch.comm import faults
    from fabric_tpu_torch.gateway import GatewayClient
    from fabric_tpu_torch.node.orderer import load_signing_identity
    from fabric_tpu_torch.testing.chaos import ChaosNet
    from fabric_tpu_torch.workload.clients import ClientPopulation
    from fabric_tpu_torch.workload.keyspace import TrafficMix
    from fabric_tpu_torch.workload.runner import WorkloadRunner

    init_factories(FactoryOpts(default=bccsp))
    own_tmp = None
    if base_dir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix=f"scenario_{name}_")
        base_dir = own_tmp.name
        if report_path is None:
            # the artifact must outlive the scratch network dir
            report_path = os.path.join(
                tempfile.gettempdir(), f"scenario_{name}_report.json")
    report: dict = {"scenario": name, "seed": seed,
                    "description": spec.get("description", ""),
                    "spec": {k: v for k, v in spec.items()
                             if k != "description"}}

    factory = None
    adversaries = spec.get("adversaries")
    if adversaries:
        from fabric_tpu_torch.testing.adversary import adversary_factory
        factory = adversary_factory(adversaries)
    topo = dict(spec.get("topology", {}))
    net = ChaosNet(base_dir,
                   n_orderers=int(topo.get("n_orderers", 3)),
                   peer_orgs=tuple(topo.get("peer_orgs", ["Org1"])),
                   peers_per_org=int(topo.get("peers_per_org", 1)),
                   node_factory=factory,
                   spare_orderers=int(topo.get("spare_orderers", 0)),
                   peer_overrides={"bccsp": bccsp},
                   orderer_overrides={"bccsp": bccsp},
                   gateway_cfg=(dict(spec["gateway"])
                                if spec.get("gateway") else None))
    plan = build_plan(spec, seed)
    poison_sent: dict = {}
    clients = None
    # scenario-owned SLO evaluator over the process-global metrics
    # registry: ChaosNet nodes run without ops servers, so p99_ms
    # expectations sample here — tight windows sized to drill length
    slo_eval = None
    if any(c.get("kind") in ("p99_ms", "incidents")
           for c in spec.get("expect", [])):
        from fabric_tpu_torch.ops_plane import slo as _slo
        slo_cfg = {"sample_interval_s": 0.5,
                   "short_window_s": 10.0,
                   "long_window_s": 60.0}
        slo_cfg.update(spec.get("slo", {}))
        slo_eval = _slo.SloEvaluator(slo_cfg)
        slo_eval.start()
    # scenario-owned incident recorder (+ sampling profiler feeding its
    # bundles): `incidents` expect kinds assert that overload-shaped
    # runs capture a bundle naming the burning objective — and that
    # clean runs capture none
    incident_rec = None
    profiler = None
    if any(c.get("kind") == "incidents" for c in spec.get("expect", [])):
        from fabric_tpu_torch.ops_plane import incidents as _inc
        from fabric_tpu_torch.ops_plane import sampler as _sampler
        profiler = _sampler.SamplingProfiler(
            dict(spec.get("profiler", {})))
        profiler.start()
        inc_cfg = dict(spec.get("incidents", {}))
        inc_cfg.setdefault("dir", os.path.join(base_dir, "incidents"))
        incident_rec = _inc.IncidentRecorder(
            inc_cfg, node_name=f"scenario:{name}", profiler=profiler)
        incident_rec.attach_slo(slo_eval)
    # scenario-owned timeseries ring + resource collector (the leak
    # gate's evidence): ChaosNet nodes share this process, so one
    # collector watching the process-global registry sees the whole
    # cluster's RSS/fd/thread/GC/cache series
    ts_store = None
    ts_collector = None
    drills: List[threading.Thread] = []
    drill_out: Dict[str, dict] = {}
    if spec.get("observe") or any(c.get("kind") == "leak_free"
                                  for c in spec.get("expect", [])):
        from fabric_tpu_torch.ops_plane import resources as _res
        from fabric_tpu_torch.ops_plane import timeseries as _tsm
        obs = dict(spec.get("observe", {}))
        interval = float(obs.get("interval_s", 0.25))
        ts_store = _tsm.TimeSeriesStore({"interval_s": interval})
        ts_collector = _res.ResourceCollector({"interval_s": interval})
    if incident_rec is not None and ts_store is not None:
        incident_rec.timeseries = ts_store
    try:
        net.start()
        if plan is not None:
            faults.install(plan)
        poison = (None if not spec.get("poison")
                  else _poison_thread(net, spec, poison_sent))

        # -- fleet lifecycle drills (ride the load in the background) --
        for key, launch in (("rolling_upgrade", _rolling_upgrade_thread),
                            ("membership_churn", _membership_churn_thread),
                            ("scale_out", _scale_out_thread)):
            if spec.get(key):
                drill_out[key] = {}
                drills.append(launch(net, spec, drill_out[key]))

        # -- client population (identity blend over schemes) ----------
        org = list(topo.get("peer_orgs", ["Org1"]))[0]
        blend = dict(spec.get("identity_blend") or {"p256": 1.0})
        signers = {}
        with open(net.paths["clients"][org]) as f:
            cc = json.load(f)
        signers["p256"] = load_signing_identity(
            cc["mspid"], cc["cert_pem"].encode(), cc["key_pem"].encode())
        if blend.get("ed25519"):
            with open(net.paths["clients_ed25519"][org]) as f:
                ce = json.load(f)
            signers["ed25519"] = load_signing_identity(
                ce["mspid"], ce["cert_pem"].encode(),
                ce["key_pem"].encode())
        sockets = 6
        total_w = sum(blend.values()) or 1.0
        ed_slots = int(round(sockets * blend.get("ed25519", 0.0)
                             / total_w))
        peer = net.peers()[0]
        # fan-out: ONE seeded arrival process sharded across every
        # gateway peer (slot i -> peer i mod n) — lifecycle drills need
        # traffic ON the node being drained, not a spectator fleet
        gw_peers = (list(net.peers()) if spec.get("fan_out")
                    else [peer])
        gw_addrs = [p.rpc.addr for p in gw_peers]

        def _factory(slot: int):
            scheme = "ed25519" if slot < ed_slots else "p256"
            return GatewayClient(gw_addrs[slot % len(gw_addrs)],
                                 signers[scheme],
                                 peer.msps, channel_id=net.channel_id,
                                 seed=seed * 1000 + slot,
                                 call_timeout=30.0)

        clients = ClientPopulation(512, sockets, factory=_factory,
                                   seed=seed)
        clients.warm()

        traffic = dict(spec.get("traffic", {}))
        mix = TrafficMix([{
            "channel": net.channel_id, "chaincode": "assets",
            "weight": 1.0, "keys": int(traffic.get("keys", 64)),
            "zipf_s": float(traffic.get("zipf_s", 1.0)),
            "blend": traffic.get("blend", {"read": 0.1, "write": 0.9}),
        }], seed=seed)

        prepare = None
        prep_gw = None
        if spec.get("mode", "pool") == "pool":
            from fabric_tpu_torch.endorser.proposal import assemble_transaction
            prep_gw = GatewayClient(peer.rpc.addr, signers["p256"],
                                    peer.msps, channel_id=net.channel_id,
                                    shed_retry_max=0)

            def prepare(op):
                fn, args = WorkloadRunner._call_shape(op)
                sp, responses = prep_gw.endorse(op.chaincode, fn, args,
                                                channel=op.channel)
                return assemble_transaction(sp, responses,
                                            signers["p256"])

        runner = WorkloadRunner(clients, mix, list(spec["phases"]),
                                signer=signers["p256"], prepare=prepare,
                                workers=8, seed=seed)
        if ts_store is not None:
            # sampling starts at load start, not at provisioning: the
            # startup ramp (node boot, client warm) is not soak
            # evidence; the observe block's warmup_s still trims the
            # worker spin-up at the window head
            ts_collector.start()
            ts_store.start()
        report.update(runner.run())
        if prep_gw is not None:
            prep_gw.close()
        if poison is not None:
            poison.join(timeout=30.0)
            report["poison_sent"] = dict(poison_sent)
        if plan is not None:
            faults.uninstall()
            plan = None

        # -- post-run drills ------------------------------------------
        if spec.get("snapshot_rejoin"):
            report["snapshot_rejoin"] = _snapshot_rejoin(net, spec)
        for d in drills:
            d.join(timeout=300.0)
        for key, out_d in drill_out.items():
            report[key] = dict(out_d)

        # -- post-run evidence + SLO evaluation ------------------------
        report["byzantine"] = _byz_state(net)
        crimes = {}
        for n, node in net.nodes.items():
            cc_list = getattr(node, "crimes_committed", None)
            if cc_list:
                crimes[n] = list(cc_list)
        if crimes:
            report["crimes"] = crimes
        for p in net.peers():
            if getattr(p, "slo", None) is not None:
                report.setdefault("slo_alerts", {})[
                    p.name if hasattr(p, "name") else "peer"] = \
                    p.slo.alerts_snapshot()
                break
        if ts_store is not None:
            # one final sweep so the gate's window reaches run end
            if ts_collector is not None:
                ts_collector.collect()
            ts_store.step()
            ts_store.stop()
            ts_collector.stop()
        if incident_rec is not None:
            # the alert's capture thread may still be writing; the
            # expectation must see the landed bundle, not the race
            if slo_eval is not None:
                slo_eval.step()
            incident_rec.drain(30.0)
            from fabric_tpu_torch.ops_plane.incidents import verify_bundle
            bundles = []
            for meta in incident_rec.list():
                bpath = os.path.join(incident_rec.dir, meta["id"])
                bundles.append(dict(
                    meta, path=bpath,
                    verified=verify_bundle(bpath)["ok"]))
            report["incidents"] = {"dir": incident_rec.dir,
                                   "bundles": bundles}
        violations = _check_expectations(spec, net, report,
                                         slo_eval=slo_eval,
                                         ts_store=ts_store)
        report["slo"] = {"pass": not violations,
                         "checks": len(spec.get("expect", [])),
                         "violations": violations}
    finally:
        # lifecycle drills drive kill/restart on their own threads: let
        # them finish before the net (and its tmpdir) is torn down, or
        # teardown races a mid-restart node
        for d in drills:
            d.join(timeout=300.0)
        if slo_eval is not None:
            slo_eval.stop()
        if incident_rec is not None:
            incident_rec.stop()
        if profiler is not None:
            profiler.stop()
        if ts_collector is not None:
            ts_collector.stop()
        if ts_store is not None:
            ts_store.stop()
        if plan is not None:
            faults.uninstall()
        if clients is not None:
            clients.close()
        net.stop_all()
        out = report_path or os.path.join(
            base_dir, f"scenario_{name}_report.json")
        try:
            with open(out, "w") as f:
                json.dump(report, f, indent=2, default=str, sort_keys=True)
            report["report_path"] = out
        except OSError:
            logger.exception("scenario report not written: %s", out)
        if own_tmp is not None:
            own_tmp.cleanup()
    violations = report.get("slo", {}).get("violations")
    if strict and violations:
        raise ScenarioFailure(f"{name}: " + "; ".join(violations))
    return report
