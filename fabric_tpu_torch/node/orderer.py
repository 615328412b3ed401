"""Runnable orderer node: Broadcast/Deliver + Raft cluster over sockets.

The reference's orderer server binary (VERDICT.md missing #9 / #3):
orderer/common/server/main.go wires localconfig, the
multichannel registrar, the cluster transport, and the AtomicBroadcast
gRPC service into one process.  This module is the same composition for
this framework: a JSON node config + MSP material on disk produce a
process serving `broadcast` (unary), `deliver` (stream), and `raft.step`
(cast) over the authenticated RPC plane.

Run:  python -m fabric_tpu_torch.node.orderer <node.json>
Provision a dev network:  fabric_tpu_torch.node.provision.provision_orderers().

Counterpart of `fabric_tpu/node/orderer.py`, whole, on the port's
imports; it reads the reference's config keys, serves its RPC verbs and
REST routes and writes its WAL, snapshot and `membership.json` files.
One default differs on purpose: the node's provider is the factory's
CUDA kind unless the config names one (`"bccsp": "SW"`, or
`FABRIC_TPU_ORDERER_BCCSP=SW` through `load_node_config`'s env tier,
asks for the host), fail-stop.  On the card `start()` builds and loads
every kernel library and runs each signature lane once before the
cluster's clock starts, so no first-use build lands inside a Raft step.
`/healthz` carries the provider's `name`, `backend` and `degraded`
beside the reference's fields, as the peer's does.  `stop()` releases
the deliver streams waiting at each channel's tip and joins the
onboarding loop (ROADMAP C25).
"""

from __future__ import annotations

import json
import logging
import sys
import threading
from typing import Dict, Optional

from fabric_tpu_torch.bccsp.factory import FactoryOpts, init_factories
from fabric_tpu_torch.comm.rpc import RpcServer
from fabric_tpu_torch.config import Bundle, BundleSource, ChannelConfig
from fabric_tpu_torch.ledger.blkstorage import BlockStore
from fabric_tpu_torch.msp.identity import SigningIdentity
from fabric_tpu_torch.orderer import BroadcastHandler, DeliverHandler, Registrar
from fabric_tpu_torch.orderer.blockcutter import BatchConfig
from fabric_tpu_torch.orderer.cluster import ClusterService
from fabric_tpu_torch.orderer.consensus import RaftChain
from fabric_tpu_torch.orderer.deliver import SeekInfo
from fabric_tpu_torch.orderer.raft import RaftNode
from fabric_tpu_torch.policy import SignedData
from fabric_tpu_torch.protocol import Envelope

logger = logging.getLogger("fabric_tpu_torch.node.orderer")


def load_signing_identity(mspid: str, cert_pem: bytes, key_pem: bytes,
                          scheme: str = None) -> SigningIdentity:
    from fabric_tpu_torch.crypto import x509
    from fabric_tpu_torch.crypto import serialization
    from fabric_tpu_torch.bccsp.sw import SigningKey

    from fabric_tpu_torch.crypto import ec as _ec
    from fabric_tpu_torch.bccsp import SCHEME_ED25519, SCHEME_P256

    cert = x509.load_pem_x509_certificate(cert_pem)
    key = serialization.load_pem_private_key(key_pem, password=None)
    if scheme is None:
        scheme = (SCHEME_P256 if isinstance(key, _ec.EllipticCurvePrivateKey)
                  else SCHEME_ED25519)
    return SigningIdentity(mspid, cert, SigningKey(scheme, key))


def attestation_trust(vcfg: dict):
    """(trust_attestations, attestors) from a `verify_once` config
    sub-dict.  Trusting gateway verdict attestations is a security
    decision, so it is OFF unless explicitly enabled — and useless
    without an attestor allowlist naming who may vouch."""
    return (bool(vcfg.get("trust_attestations", False)),
            list(vcfg.get("attestors", [])))


class _BlockStoreLedger:
    """Adapter giving an orderer-side BlockStore the `.height` +
    `.blockstore` shape the ByzantineMonitor judges against."""

    def __init__(self, store: BlockStore):
        self.blockstore = store

    @property
    def height(self) -> int:
        return self.blockstore.height


class OrdererNode:
    """One orderer process (library form; `main` wraps it)."""

    def __init__(self, cfg: dict, data_dir: str):
        self.cfg = cfg
        # the card unless the config asks for the host ("bccsp": "SW");
        # fail-stop: a failed launch raises (the factory's degrade is off)
        self.provider = init_factories(
            FactoryOpts(default=cfg.get("bccsp", "CUDA")))
        self.signer = load_signing_identity(
            cfg["mspid"], cfg["cert_pem"].encode(), cfg["key_pem"].encode())

        # verify-once plane (on by default; `verify_once: {"enabled":
        # false}` opts out): duplicate/retried submissions stop
        # re-verifying.  Attestation trust is a SECURITY decision and
        # is OFF by default: enabling it requires BOTH
        # `trust_attestations: true` AND an explicit `attestors` list
        # of {"mspid", "cert_fp"} bindings naming the gateway
        # identities allowed to vouch — only attestations arriving on
        # a transport handshake-authenticated as one of those
        # identities skip the SigFilter's device verify.
        vcfg = dict(cfg.get("verify_once", {}))
        self.verify_cache = None
        self._trust_attestations, self._attestors = attestation_trust(vcfg)
        # attest_deliver (opt-in): ride this orderer's own admission
        # verdicts back to committing peers on the deliver stream, so a
        # creator signature verified once at SigFilter need not be
        # re-dispatched at any peer's commit gate.  Emitting digests is
        # harmless by itself — whether a peer HONOURS them is the
        # peer's own trust_attestations + attestor-allowlist decision.
        self._attest_deliver = bool(vcfg.get("attest_deliver", False))
        if vcfg.get("enabled", True):
            from fabric_tpu_torch.verify_plane import VerdictCache
            self.verify_cache = VerdictCache(
                capacity=int(vcfg.get("capacity", 65536)),
                owner="orderer%s" % cfg.get("raft_id", ""))

        channel_cfg = ChannelConfig.deserialize(
            bytes.fromhex(cfg["channel_config_hex"]))
        self.bundle_source = BundleSource(Bundle(channel_cfg))
        msps = self.bundle_source.current().msps
        self.data_dir = data_dir
        # per-gateway standing registry (verify_plane/trust.py): which
        # allowlisted attestors are still honoured.  Persisted under the
        # data dir so a digest-mismatch revocation survives restarts.
        self.attestor_trust = None
        if self._trust_attestations and self._attestors:
            import os
            from fabric_tpu_torch.verify_plane import AttestorTrust
            self.attestor_trust = AttestorTrust(
                os.path.join(data_dir, "attestor_trust.json"))

        self.registrar = Registrar()
        self.raft_id = int(cfg["raft_id"])
        self.peer_ids = [int(p["raft_id"]) for p in cfg["cluster"]]
        self.channel_id = channel_cfg.channel_id
        # fleet lifecycle: serving -> draining -> drained.  A draining
        # orderer refuses new broadcasts (clients fail over), hands off
        # raft leadership, and fsyncs its WALs so the following stop()
        # is a clean point-in-time exit rather than a crash.
        self.lifecycle = "serving"
        # per-channel raft membership: raft_id -> rich consenter entry
        # ({raft_id, host, port, mspid, cert_fp}).  Seeded from the
        # channel config (or the bootstrap cluster list) and THEREAFTER
        # owned by committed membership config entries — persisted to
        # <channel>/membership.json so a restart mid-churn reloads the
        # post-reconfig set, not the genesis one.
        self._membership: Dict[str, Dict[int, dict]] = {}

        self.rpc = RpcServer(cfg.get("host", "127.0.0.1"), int(cfg["port"]),
                             self.signer, msps)
        peers = {int(p["raft_id"]): (p.get("host", "127.0.0.1"), int(p["port"]))
                 for p in cfg["cluster"] if int(p["raft_id"]) != self.raft_id}
        # consenter auth is mandatory: every cluster entry must carry its
        # identity binding (mspid + cert sha256) or the node refuses to run
        consenters = {}
        for p in cfg["cluster"]:
            if not p.get("mspid") or not p.get("cert_fp"):
                raise ValueError(
                    f"cluster entry for raft_id {p.get('raft_id')} is "
                    "missing mspid/cert_fp — consenter identities must be "
                    "bound to certificate fingerprints (re-provision the "
                    "network; CN-based configs are no longer accepted)")
            consenters[int(p["raft_id"])] = (p["mspid"], p["cert_fp"])
        self.cluster = ClusterService(self.rpc, self.signer, msps, peers,
                                      consenters=consenters)

        # byzantine containment plane, orderer side: ONE persistent
        # quarantine registry per process (same file layout as the peer,
        # so standings read identically across node kinds), per-channel
        # witness monitors built in _create_channel.  The cluster
        # transport's entry verifier reports into it: a mis-signed or
        # unsigned append scores the sending node, a raft-entry
        # equivocation convicts the proposing consenter and mints a
        # portable fraud proof AT THE ORDERER.
        import os as _byz_os
        byz_cfg = dict(cfg.get("byzantine", {}))
        self.byzantine = None
        self.byz_monitors: Dict[str, object] = {}
        # clean-observation window before offense-based quarantines are
        # pardoned; None = permanent (the r13 behaviour)
        self.byz_pardon_window = (
            float(byz_cfg["pardon_window_s"])
            if byz_cfg.get("pardon_window_s") is not None else None)
        if byz_cfg.get("enabled", True):
            from fabric_tpu_torch.byzantine import QuarantineRegistry
            self.byzantine = QuarantineRegistry(
                _byz_os.path.join(data_dir, "byzantine_quarantine.json"),
                score_threshold=int(byz_cfg.get("score_threshold", 3)))
            self.cluster.on_entry_offense = self._on_entry_offense
            self.cluster.on_entry_crime = self._on_entry_crime

        # refuse to silently strand pre-multichannel node state (storage
        # moved from data_dir/wal.bin to data_dir/<channel>/wal.bin)
        import os as _os
        if _os.path.exists(_os.path.join(data_dir, "wal.bin")):
            raise ValueError(
                f"{data_dir} holds single-channel-era state (wal.bin at "
                "the data-dir root); move it into "
                f"{data_dir}/{channel_cfg.channel_id}/ or re-provision")

        # bootstrap channel (the registrar manages N chains; more join at
        # runtime via the participation API — registrar.go dynamic chains)
        self.support = self._create_channel(channel_cfg,
                                            self.bundle_source)

        # re-load channels joined at runtime in earlier lives of this
        # node: a restart must not silently drop them from the cluster
        for entry in sorted(_os.listdir(data_dir)):
            cfg_path = _os.path.join(data_dir, entry, "channel_config.bin")
            if entry == channel_cfg.channel_id or not _os.path.exists(
                    cfg_path):
                continue
            try:
                with open(cfg_path, "rb") as f:
                    joined_cfg = ChannelConfig.deserialize(f.read())
                self._create_channel(joined_cfg,
                                     BundleSource(Bundle(joined_cfg)))
                logger.info("restored joined channel %r", entry)
            except Exception:
                logger.exception("could not restore channel %r", entry)

        self.broadcast = BroadcastHandler(self.registrar)
        self.deliver = DeliverHandler(self.registrar)
        self.rpc.serve("broadcast", self._rpc_broadcast)
        self.rpc.serve("broadcast_batch", self._rpc_broadcast_batch)
        self.rpc.serve("status", self._rpc_status)
        self.rpc.serve_stream("deliver", self._rpc_deliver)
        self.rpc.serve("participation.join", self._rpc_join)
        self.rpc.serve("participation.list", self._rpc_list)
        self.rpc.serve("participation.remove", self._rpc_remove)
        # fleet lifecycle + dynamic membership (admin-gated)
        self.rpc.serve("admin.add_consenter", self._rpc_add_consenter)
        self.rpc.serve("admin.remove_consenter", self._rpc_remove_consenter)
        self.rpc.serve("admin.transfer_leadership",
                       self._rpc_transfer_leadership)
        self.rpc.serve("admin.drain", self._rpc_drain)

        # ops plane: /metrics, /healthz (system.go:75-267 parity) + the
        # channelparticipation REST API (channelparticipation/restapi.go)
        # tx tracing + flight recorder (sample rate / capacity via the
        # localconfig `tracing` sub-dict, FABRIC_TPU_ORDERER_TRACING__*)
        from fabric_tpu_torch.ops_plane import tracing as _tracing
        _tracing.configure(cfg.get("tracing", {}))

        self.ops = None
        if cfg.get("ops_port") is not None:
            from fabric_tpu_torch.ops_plane import OperationsServer
            self.ops = OperationsServer(cfg.get("host", "127.0.0.1"),
                                        int(cfg["ops_port"]))
            self.ops.register_checker(
                "raft", lambda: self.support.chain.node.leader_id is not None)
            self.ops.health_fields["bccsp"] = self._bccsp_fields
            self.ops.lifecycle_fn = lambda: self.lifecycle
            # POST /drain: plain-HTTP ops convenience (same trust
            # boundary caveat as the participation REST writes); the
            # authenticated admin.drain RPC is the production surface
            self.ops.register_route(
                "POST", "/drain",
                lambda path, body: (200, self.drain()))
            # profiling surface (orderer/common/server/main.go:408 slot)
            from fabric_tpu_torch.ops_plane.profiling import register_routes
            register_routes(self.ops, enabled=bool(cfg.get("profiling")))
            # /traces, /traces/<id> (Chrome trace JSON), /spans/stats;
            # ?cluster=1 merges the trace across the `cluster_trace`
            # sub-dict's ops endpoints — same route shape as the peer's
            # so one client assembles from any node kind
            ct_cfg = dict(cfg.get("cluster_trace", {}))
            self.trace_peers = list(ct_cfg.get("peers", []))

            def _cluster_trace(tid, _cfg=ct_cfg):
                from fabric_tpu_torch.node import tracecollect
                # the config's peer list may include this node's own
                # endpoint (one shared list for the whole cluster) —
                # serve self in-process, or the same spans would count
                # under two node identities
                own = "%s:%d" % self.ops.addr
                peers = [p for p in self.trace_peers if str(p) != own]
                out = tracecollect.collect_cluster_trace(
                    tid, peers, local_tracer=_tracing.tracer,
                    local_name=f"orderer:{self.raft_id}",
                    timeout_s=float(_cfg.get("timeout_s", 2.0)),
                    max_traces=int(_cfg.get("max_traces", 16)))
                if out is None:
                    return 404, {"error": "unknown trace", "trace_id": tid}
                return 200, out

            _tracing.register_routes(self.ops, cluster_fn=_cluster_trace)
            # GET /faults: active fault plan ({"active": false} outside
            # chaos drills)
            from fabric_tpu_torch.comm import faults as _faults
            _faults.register_routes(self.ops)
            # GET /verify_plane: the verdict cache's live economics
            if self.verify_cache is not None:
                from fabric_tpu_torch import verify_plane as _vp
                _vp.register_ops(
                    self.ops, self.verify_cache,
                    extra=lambda: {
                        "trust_attestations": self._trust_attestations,
                        "attestors": len(self._attestors),
                        "attestors_revoked": (
                            self.attestor_trust.revoked_count()
                            if self.attestor_trust is not None else 0),
                        "attestor_standing": (
                            self.attestor_trust.snapshot()
                            if self.attestor_trust is not None else {})})
            # GET /byzantine: quarantine standings + per-channel witness
            # stats — the SAME route shape as the peer's, so one ops
            # client reads standings across node kinds
            if self.byzantine is not None:
                from fabric_tpu_torch.byzantine import register_ops as _byz_ops
                _byz_ops(self.ops, self.byzantine,
                         monitors_fn=lambda: dict(self.byz_monitors))
            self.ops.register_route("GET", "/participation/v1/channels",
                                    self._rest_channels)
            # the ops server is PLAIN HTTP with no client auth, so the
            # MUTATING participation routes are opt-in (dev/ops networks
            # behind a trusted boundary); the authenticated RPC verbs
            # (admin-gated) are the production surface
            if cfg.get("participation_rest_writes"):
                self.ops.register_route("POST",
                                        "/participation/v1/channels",
                                        self._rest_join)
                self.ops.register_route("DELETE",
                                        "/participation/v1/channels/",
                                        self._rest_remove)

        # SLO plane: GET /slo + /slo/alerts (burn-rate alerting over the
        # metrics registry), FABRIC_TPU_ORDERER_SLO__* env-overridable
        self.slo = None
        slo_cfg = cfg.get("slo", {})
        if self.ops is not None and slo_cfg.get("enabled", True):
            from fabric_tpu_torch.ops_plane import slo as _slo
            self.slo = _slo.SloEvaluator(slo_cfg)
            _slo.register_routes(self.ops, self.slo)
            self.slo.start()

        # metric history + resource telemetry (same knobs as the peer:
        # `timeseries` / `resources` sub-dicts, OFF by default so the
        # disabled /metrics surface and runtime are byte-identical)
        self.timeseries = None
        ts_cfg = cfg.get("timeseries", {})
        if self.ops is not None and ts_cfg.get("enabled", False):
            from fabric_tpu_torch.ops_plane import timeseries as _ts
            self.timeseries = _ts.TimeSeriesStore(ts_cfg)
            _ts.register_routes(self.ops, self.timeseries)
            self.timeseries.start()
        self.resources = None
        res_cfg = cfg.get("resources", {})
        if self.ops is not None and res_cfg.get("enabled", False):
            from fabric_tpu_torch.ops_plane import resources as _res
            self.resources = _res.ResourceCollector(res_cfg)
            if self.verify_cache is not None:
                cache = self.verify_cache
                self.resources.add_source(
                    "verdict_cache_occupancy",
                    lambda: cache.snapshot()["size"])
            _res.register_routes(self.ops, self.resources)
            self.resources.start()

        # continuous sampling profiler + incident capture (same knobs
        # and zero-overhead guards as the peer: `profiler`/`incidents`
        # sub-dicts, OFF by default)
        self.profiler = None
        prof_cfg = cfg.get("profiler", {})
        if self.ops is not None and prof_cfg.get("enabled", False):
            from fabric_tpu_torch.ops_plane import sampler as _sampler
            self.profiler = _sampler.SamplingProfiler(prof_cfg)
            _sampler.register_routes(self.ops, self.profiler)
            self.profiler.start()
        self.incidents = None
        inc_cfg = dict(cfg.get("incidents", {}))
        if self.ops is not None and inc_cfg.get("enabled", False):
            from fabric_tpu_torch.ops_plane import incidents as _inc
            inc_cfg.setdefault(
                "dir", _os.path.join(data_dir, "incidents"))
            if "peers" not in inc_cfg:
                own = "%s:%d" % self.ops.addr
                inc_cfg["peers"] = [
                    p for p in getattr(self, "trace_peers", [])
                    if str(p) != own]
            self.incidents = _inc.IncidentRecorder(
                inc_cfg, node_name=f"orderer:{self.raft_id}",
                profiler=self.profiler, timeseries=self.timeseries)
            if getattr(self, "slo", None) is not None:
                self.incidents.attach_slo(self.slo)
            if self.resources is not None:
                self.incidents.add_source(
                    "resources", self.resources.collect)
            self.incidents.add_source(
                "lifecycle", lambda: {"lifecycle": self.lifecycle})
            _inc.register_routes(self.ops, self.incidents)

    def _bccsp_fields(self) -> dict:
        """/healthz's provider fields: the kind, the live backend and
        whether a DegradingProvider is on its fallback."""
        return {"name": self.provider.name,
                "backend": getattr(self.provider, "backend",
                                   self.provider.name),
                "degraded": bool(getattr(self.provider, "degraded", False))}

    # -- byzantine hooks (cluster entry verifier -> containment plane) -------

    def _on_entry_offense(self, channel_id: str, frm_node: int,
                          reason: str) -> None:
        """A dropped append (unsigned / bad proposer / bad signature)
        scores the SENDING node's consenter identity — repeat offenders
        cross the registry threshold into quarantine."""
        mon = self.byz_monitors.get(channel_id)
        key = self.cluster.consenter_binding(channel_id, frm_node)
        if mon is None or key is None:
            return
        mon.offense(key, "bad_sig" if reason != "unsigned_entry"
                    else "garbage")

    def _on_entry_crime(self, channel_id: str, binding: str,
                        evidence: dict) -> None:
        """Two different payloads validly signed for one (term, index)
        slot: provable equivocation by the PROPOSER — convict and mint
        the portable fraud proof here at the orderer."""
        mon = self.byz_monitors.get(channel_id)
        if mon is None:
            return
        mon.convict_external(binding, "equivocation", evidence)

    # -- channelparticipation REST (restapi.go) ------------------------------

    def _rest_channels(self, path: str, body: bytes):
        parts = path.rstrip("/").split("/")
        if parts[-1] != "channels":          # /channels/<id>
            cid = parts[-1]
            support = self.registrar.get(cid)
            if support is None:
                return 404, {"error": f"no such channel {cid!r}"}
            return 200, {"name": cid, "height": support.ledger.height,
                         "consensus": "raft"}
        return 200, {"channels": [
            {"name": cid, "height": s.ledger.height}
            for cid, s in sorted(self.registrar.channels().items())],
            "systemChannel": None}

    def _rest_join(self, path: str, body: bytes):
        import json as _json
        if path.rstrip("/").split("/")[-1] != "channels":
            return 404, {"error": "POST only on .../channels"}
        cfg_hex = _json.loads(body)["config_hex"]
        cfg = ChannelConfig.deserialize(bytes.fromhex(cfg_hex))
        if self.registrar.get(cfg.channel_id) is not None:
            return 409, {"error": f"channel {cfg.channel_id!r} exists"}
        self.join_channel(cfg)
        return 201, {"name": cfg.channel_id, "status": "joined"}

    def _rest_remove(self, path: str, body: bytes):
        cid = path.rstrip("/").split("/")[-1]
        support = self.registrar.get(cid)
        if support is None:
            return 404, {"error": f"no such channel {cid!r}"}
        self.cluster.remove_chain(cid)
        self.byz_monitors.pop(cid, None)
        support.chain.halt()
        self.registrar.remove(cid)
        return 200, {"name": cid, "status": "removed"}

    # -- channel lifecycle ---------------------------------------------------

    def _load_membership(self, ch_dir: str,
                         channel_cfg: ChannelConfig) -> Dict[int, dict]:
        """THIS channel's raft membership, newest source first: the
        persisted post-reconfig set (membership.json, written every time
        a membership config entry commits), else the channel config's
        rich consenter entries ({raft_id, host, port, mspid, cert_fp} —
        the reference authenticates cluster traffic against per-channel
        consenter sets, orderer/common/cluster/comm.go), else the
        bootstrap cluster list.  A node restarting mid-churn therefore
        comes back with the set as of its last committed conf entry —
        NOT the genesis set — and the raft WAL replay re-fires the same
        conf entries idempotently on top."""
        import os
        path = os.path.join(ch_dir, "membership.json")
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                return {int(e["raft_id"]): dict(e) for e in json.load(f)}
        rich = [c for c in channel_cfg.consenters if isinstance(c, dict)]
        if not rich:
            rich = list(self.cfg["cluster"])
        return {int(c["raft_id"]): dict(c) for c in rich}

    def _persist_membership(self, channel_id: str) -> None:
        import os
        members = self._membership.get(channel_id, {})
        ch_dir = os.path.join(self.data_dir, channel_id)
        path = os.path.join(ch_dir, "membership.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump([members[nid] for nid in sorted(members)], f,
                      sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _membership_maps(self, members: Dict[int, dict]):
        """(raft ids, consenter identity map, peer address map) from a
        membership set — the three views the raft node, the entry
        verifier, and the transport each need."""
        ids = sorted(members)
        consenters = {nid: (m["mspid"], m["cert_fp"])
                      for nid, m in members.items()}
        peers = {nid: (m.get("host", "127.0.0.1"), int(m["port"]))
                 for nid, m in members.items() if nid != self.raft_id}
        return ids, consenters, peers

    def _create_channel(self, channel_cfg: ChannelConfig, bundle_source):
        """One channel's chain: per-channel data dirs + raft instance,
        registered with the shared cluster transport.  The channel config
        is persisted alongside so runtime-joined channels survive
        restarts (participation state, registrar.go)."""
        import os
        cid = channel_cfg.channel_id
        ch_dir = os.path.join(self.data_dir, cid)
        os.makedirs(ch_dir, exist_ok=True)
        cfg_path = os.path.join(ch_dir, "channel_config.bin")
        if not os.path.exists(cfg_path):
            tmp = cfg_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(channel_cfg.serialize())
            os.replace(tmp, cfg_path)
        members = self._load_membership(ch_dir, channel_cfg)
        self._membership[cid] = members
        peer_ids, ch_consenters, ch_peers = self._membership_maps(members)
        # every proposed entry is signed with this consenter's identity;
        # followers verify the chain before applying (cluster.py
        # EntryVerifier) — enforcement keys on entry_signer being set
        from fabric_tpu_torch.orderer.consensus import make_entry_signer
        node = RaftNode(self.raft_id, peer_ids,
                        wal_path=os.path.join(ch_dir, "wal.bin"),
                        snap_path=os.path.join(ch_dir, "snap.bin"),
                        entry_signer=make_entry_signer(self.signer))
        batch = channel_cfg.batch
        support = self.registrar.create_channel(
            cid, bundle_source.current().msps, self.provider,
            writers_policy=None,
            signer=self.signer,
            batch_config=BatchConfig(
                max_message_count=batch.max_message_count,
                absolute_max_bytes=batch.absolute_max_bytes,
                preferred_max_bytes=batch.preferred_max_bytes,
                batch_timeout_s=batch.timeout_s),
            ledger=BlockStore(os.path.join(ch_dir, "ledger")),
            chain_factory=lambda cutter, writer, on_block: RaftChain(
                node, cutter, writer, on_block=on_block,
                on_conf=lambda conf, _cid=cid: self._on_membership(
                    _cid, conf)),
            bundle_source=bundle_source)
        if self.verify_cache is not None:
            support.processor.verify_cache = self.verify_cache
            support.processor.trust_attestations = self._trust_attestations
            support.processor.attestors = \
                support.processor._normalize_attestors(self._attestors)
            support.processor.attestor_trust = self.attestor_trust
        self.cluster.add_chain(cid, support.chain,
                               consenters=ch_consenters, peers=ch_peers)
        if self.byzantine is not None:
            from fabric_tpu_torch.byzantine import ByzantineMonitor, WitnessLog
            self.byz_monitors[cid] = ByzantineMonitor(
                cid,
                WitnessLog(os.path.join(ch_dir, "witness_log.json")),
                self.byzantine,
                ledger=_BlockStoreLedger(support.ledger),
                msps=bundle_source.current().msps, signer=self.signer,
                proof_dir=os.path.join(ch_dir, "fraud_proofs"),
                pardon_window_s=self.byz_pardon_window)
        return support

    def join_channel(self, channel_cfg: ChannelConfig):
        """Runtime channel join (channelparticipation Join): a NEW raft
        instance + ledger under this process's registrar."""
        src = BundleSource(Bundle(channel_cfg))
        return self._create_channel(channel_cfg, src)

    # -- dynamic raft membership (committed through the log itself) ----------

    def _on_membership(self, channel_id: str, conf: dict) -> None:
        """A membership config entry COMMITTED on this channel.  Runs on
        every replica (and re-runs on restart replay — conf entries do
        not advance the chain's applied index — so it must be
        idempotent): update the persisted membership set, then swap the
        transport's consenter identity + address maps and rebind the
        EntryVerifier in one atomic step.  From this instant a removed
        consenter's raft traffic and signed entries are rejected."""
        op = conf.get("op")
        nid = int(conf.get("node", 0))
        members = self._membership.setdefault(channel_id, {})
        if op == "add":
            entry = {"raft_id": nid,
                     "host": conf.get("host", "127.0.0.1"),
                     "port": int(conf.get("port", 0)),
                     "mspid": conf.get("mspid", ""),
                     "cert_fp": conf.get("cert_fp", "")}
            if members.get(nid) == entry:
                return                      # restart replay: already applied
            members[nid] = entry
        elif op == "remove":
            if nid not in members:
                return                      # restart replay: already applied
            members.pop(nid)
        else:
            logger.warning("[%s] unknown membership op %r ignored",
                           channel_id, op)
            return
        self._persist_membership(channel_id)
        _ids, consenters, peers = self._membership_maps(members)
        self.cluster.update_membership(channel_id, consenters, peers)
        logger.info("[%s] membership %s node %d -> consenters %s",
                    channel_id, op, nid, sorted(members))

    def _rpc_add_consenter(self, body: dict, peer_identity) -> dict:
        """Admin: propose an add-consenter config entry (leader only —
        callers retry against the leader hint on not_leader)."""
        self._require_admin(peer_identity)
        cid = body.get("channel", self.channel_id)
        support = self.registrar.get(cid)
        if support is None:
            raise ValueError(f"no such channel {cid!r}")
        for fld in ("raft_id", "port", "mspid", "cert_fp"):
            if not body.get(fld):
                raise ValueError(f"add_consenter requires {fld!r} — an "
                                 "unbound consenter could not be "
                                 "authenticated on the cluster plane")
        from fabric_tpu_torch.orderer import raft as raftmod
        try:
            index = support.chain.propose_membership(
                "add", int(body["raft_id"]),
                host=body.get("host", "127.0.0.1"), port=int(body["port"]),
                mspid=body["mspid"], cert_fp=body["cert_fp"])
        except raftmod.NotLeaderError as exc:
            return {"status": "not_leader", "leader": exc.leader_id or 0}
        return {"status": "proposed", "channel": cid, "index": index}

    def _rpc_remove_consenter(self, body: dict, peer_identity) -> dict:
        """Admin: propose a remove-consenter config entry.  Removing the
        leader itself is legal — it self-evicts at commit and the rest
        of the cluster elects (callers wanting a gap-free handover
        transfer leadership first, as the drain path does)."""
        self._require_admin(peer_identity)
        cid = body.get("channel", self.channel_id)
        support = self.registrar.get(cid)
        if support is None:
            raise ValueError(f"no such channel {cid!r}")
        from fabric_tpu_torch.orderer import raft as raftmod
        try:
            index = support.chain.propose_membership(
                "remove", int(body["raft_id"]))
        except raftmod.NotLeaderError as exc:
            return {"status": "not_leader", "leader": exc.leader_id or 0}
        return {"status": "proposed", "channel": cid, "index": index}

    def _rpc_transfer_leadership(self, body: dict, peer_identity) -> dict:
        self._require_admin(peer_identity)
        cid = body.get("channel", self.channel_id)
        support = self.registrar.get(cid)
        if support is None:
            raise ValueError(f"no such channel {cid!r}")
        sent = support.chain.transfer_leadership(int(body["to"]))
        return {"status": "sent" if sent else "refused",
                "leader": support.chain.node.leader_id or 0}

    def _rpc_drain(self, body: dict, peer_identity) -> dict:
        self._require_admin(peer_identity)
        return self.drain(timeout_s=float(body.get("timeout_s", 10.0)))

    # -- graceful drain ------------------------------------------------------

    def drain(self, timeout_s: float = 10.0) -> dict:
        """Orderly exit ramp: stop admitting broadcasts, hand raft
        leadership to the most caught-up follower, let every committed
        entry apply, then fsync the WALs.  After this returns the
        process can be stopped with nothing in flight — a rolling
        upgrade is drain -> stop -> restart -> rejoin-at-height instead
        of a crash-stop."""
        import time as _time
        from fabric_tpu_torch.orderer import raft as raftmod
        self.lifecycle = "draining"
        deadline = _time.monotonic() + timeout_s
        leaders = {}
        for cid, support in self.registrar.channels().items():
            chain = support.chain
            node = chain.node
            # release leadership via explicit transfer: pick the most
            # caught-up follower; retry until deposed or out of time
            # (transfer_leadership nudges a lagging target's replication)
            while node.role == raftmod.LEADER \
                    and _time.monotonic() < deadline:
                with chain._lock:
                    targets = sorted(
                        (n for n in node.nodes if n != node.id),
                        key=lambda n: -node.match_index.get(n, 0))
                if not targets:
                    break               # single-node channel: nothing to do
                for to in targets:
                    if chain.transfer_leadership(to):
                        break
                _time.sleep(0.05)
            # finish in-flight blocks: everything raft committed must be
            # applied to the ledger before we call the WAL final
            while _time.monotonic() < deadline:
                with chain._lock:
                    if node.applied_index >= node.commit_index:
                        break
                _time.sleep(0.02)
            with chain._lock:
                node._wal.sync()
            leaders[cid] = node.leader_id or 0
        self.lifecycle = "drained"
        return {"lifecycle": self.lifecycle, "leaders": leaders}

    # -- rpc handlers --------------------------------------------------------

    def _require_admin(self, peer_identity) -> None:
        """Participation mutations are ADMIN operations: the caller's
        handshake-verified identity must hold the admin role in some org
        of the bootstrap channel (the reference gates this API behind
        client TLS auth; any-member access would let any org drop
        channels)."""
        from fabric_tpu_torch.msp.msp import Principal
        msps = self.bundle_source.current().msps
        for mspid, msp in msps.items():
            try:
                ident = msp.deserialize_identity(peer_identity.serialize())
                if msp.satisfies_principal(ident, Principal.admin(mspid)):
                    return
            except Exception:
                continue
        raise PermissionError("channel participation requires an admin "
                              "identity")

    def _rpc_join(self, body: dict, peer_identity) -> dict:
        self._require_admin(peer_identity)
        cfg = ChannelConfig.deserialize(body["config"])
        if self.registrar.get(cfg.channel_id) is not None:
            raise ValueError(f"channel {cfg.channel_id!r} already exists")
        self.join_channel(cfg)
        return {"channel": cfg.channel_id, "status": "joined"}

    def _rpc_list(self, body: dict, peer_identity) -> dict:
        out = {}
        for cid, support in self.registrar.channels().items():
            out[cid] = {"height": support.ledger.height}
        return {"channels": out}

    def _rpc_remove(self, body: dict, peer_identity) -> dict:
        self._require_admin(peer_identity)
        cid = body["channel"]
        support = self.registrar.get(cid)
        if support is None:
            raise ValueError(f"no such channel {cid!r}")
        self.cluster.remove_chain(cid)
        self.byz_monitors.pop(cid, None)
        support.chain.halt()
        self.registrar.remove(cid)
        return {"channel": cid, "status": "removed"}

    def _rpc_broadcast(self, body: dict, peer_identity) -> dict:
        if self.lifecycle != "serving":
            # draining: refuse new work so clients fail over NOW; the
            # leader hint points them at whoever holds (or will hold)
            # leadership after our transfer
            return {"status": 503, "info": "draining",
                    "leader": self.support.chain.node.leader_id or 0}
        env = Envelope.deserialize(body["envelope"])
        resp = self.broadcast.handle(env)
        return {"status": resp.status, "info": resp.info or "",
                "leader": getattr(resp, "leader_hint", 0) or 0}

    def _rpc_broadcast_batch(self, body: dict, peer_identity) -> dict:
        """Gateway fan-in: many envelopes per RPC round trip.  Each is
        admitted independently; statuses/infos line up by index."""
        if self.lifecycle != "serving":
            n = len(body.get("envelopes", []))
            return {"statuses": [503] * n, "infos": ["draining"] * n,
                    "leader": self.support.chain.node.leader_id or 0}
        envs = [Envelope.deserialize(e) for e in body["envelopes"]]
        # verdict attestations carry no authority of their own: the
        # msgprocessor only honours them when the frame's handshake-
        # verified sender identity is in the channel's configured
        # attestor set, so the authenticated peer rides along as the
        # vouching party
        attests = body.get("attests") if peer_identity is not None else None
        resps = self.broadcast.handle_batch(envs, tps=body.get("tps"),
                                            attests=attests,
                                            attestor=peer_identity)
        leader = 0
        for r in resps:
            leader = getattr(r, "leader_hint", 0) or leader
        return {"statuses": [r.status for r in resps],
                "infos": [r.info or "" for r in resps],
                "leader": leader}

    def _rpc_deliver(self, body: dict, peer_identity):
        seek = SeekInfo(start=body.get("start", 0), stop=body.get("stop"),
                        behavior=body.get("behavior", "block_until_ready"))
        sd = None
        if body.get("signed_data"):
            s = body["signed_data"]
            sd = SignedData(s["data"], s["identity"], s["signature"])
        cid = body["channel"]
        attesting = (self._attest_deliver and self.verify_cache is not None)
        msps = None
        if attesting:
            support = self.registrar.get(cid)
            src = (getattr(support, "bundle_source", None)
                   or self.bundle_source) if support is not None \
                else self.bundle_source
            try:
                msps = src.current().msps
            except Exception:
                msps = None
        for block in self.deliver.deliver(cid, seek, sd,
                                          timeout_s=body.get("timeout_s", 30)):
            out = {"block": block.serialize()}
            if attesting and msps is not None:
                from fabric_tpu_torch.verify_plane import attest_block
                try:
                    attests = attest_block(self.verify_cache, block, cid,
                                           msps)
                    if attests is not None:
                        out["attests"] = attests
                except Exception:
                    pass
            yield out

    def _rpc_status(self, body: dict, peer_identity) -> dict:
        from fabric_tpu_torch.orderer import raft as raftmod
        node = self.support.chain.node
        return {"raft_id": self.raft_id, "role": node.role,
                "leader": node.leader_id or 0, "term": node.term,
                "height": self.support.ledger.height}

    # -- onboarding replication (cluster/replication.go) ---------------------

    def _replicate_once(self) -> int:
        """For every chain stuck behind a compacted raft log (snapshot
        install set catchup_target), pull the missing blocks from peer
        OSNs over their deliver stream, verify the orderer signatures,
        and hand them to the chain's catch_up — the reference's
        onboarding replication (orderer/common/cluster/replication.go).
        Returns how many blocks were replicated."""
        from fabric_tpu_torch.comm.rpc import connect
        from fabric_tpu_torch.orderer import block_signature_items
        from fabric_tpu_torch.protocol.types import Block

        total = 0
        for cid, support in self.registrar.channels().items():
            target = getattr(support.chain, "catchup_target", None)
            if not target:
                continue
            # per-CHANNEL MSPs: a runtime-joined channel has its own
            # bundle (and its own config rotations)
            src = support.bundle_source or self.bundle_source
            msps = src.current().msps
            start = support.ledger.height
            stop = int(target.get("height", 0)) - 1
            if stop < start:
                continue
            payload = b"seek:%s" % cid.encode()
            sd = {"data": payload, "identity": self.signer.serialize(),
                  "signature": self.signer.sign(payload)}
            # pull from THIS channel's consenters (a runtime-joined
            # channel may have a different orderer set than bootstrap),
            # standing-aware: quarantined consenters sort last, so an
            # onboarding orderer prefers honest sources but can still
            # catch up from a convicted one as a last resort
            monitor = self.byz_monitors.get(cid)
            peer_map = self.cluster.peers_for(cid)
            def _standing(nid):
                key = self.cluster.consenter_binding(cid, nid)
                return 1 if (monitor is not None
                             and monitor.blocked_source(key)) else 0
            for nid in sorted(peer_map, key=lambda n: (_standing(n), n)):
                addr = peer_map[nid]
                src_key = self.cluster.consenter_binding(cid, nid)
                blocks = []
                try:
                    conn = connect(tuple(addr), self.signer, msps,
                                   timeout=3.0)
                    try:
                        for item in conn.call_stream("deliver", {
                                "channel": cid, "start": start,
                                "stop": stop, "timeout_s": 10,
                                "behavior": "fail_if_not_ready",
                                "signed_data": sd}):
                            block = Block.deserialize(item["block"])
                            items = block_signature_items(block, msps)
                            if not items or not bool(
                                    self.provider.batch_verify(items).all()):
                                raise ValueError(
                                    f"bad orderer signature on block "
                                    f"{block.header.number}")
                            if monitor is not None:
                                from fabric_tpu_torch.byzantine.monitor import (
                                    VERDICT_ADMIT, VERDICT_STALE)
                                verdict = monitor.check_block(block, src_key)
                                if verdict == VERDICT_STALE:
                                    continue
                                if verdict != VERDICT_ADMIT:
                                    raise ValueError(
                                        f"block {block.header.number} "
                                        f"held/rejected by byzantine "
                                        f"monitor ({verdict})")
                            blocks.append(block)
                    finally:
                        conn.close()
                except Exception:
                    logger.debug("replication pull from OSN %s failed",
                                 nid, exc_info=True)
                    continue
                if blocks:
                    support.chain.catch_up(blocks)
                    total += len(blocks)
                    logger.info("[%s] onboarded %d blocks from OSN %s",
                                cid, len(blocks), nid)
                    break
        return total

    def _onboard_loop(self) -> None:
        while not self._stop_onboard.is_set():
            try:
                self._replicate_once()
            except Exception:
                logger.exception("onboarding replication failed")
            self._stop_onboard.wait(1.0)

    # -- lifecycle -----------------------------------------------------------

    def warm_kernels(self) -> dict:
        """On the card: build what is stale and load every kernel
        library, then run each signature lane once (KP2, KP3, KE5, KE6)
        -> {"builds_s", "lanes_s"}.  A first-use `nvcc` build or library
        load inside a Raft step would cost elections, so `start()` pays
        it before the cluster's clock runs.  Nothing to do on SW or on a
        provider whose device is the CPU."""
        dev = getattr(self.provider, "device", None)
        if getattr(dev, "type", None) != "cuda":
            return {}
        from fabric_tpu_torch.node import warmup
        builds = warmup.build_all(True)
        lanes = warmup.warm_lanes(self.provider, (1,), (
            "p256", "p256-rows", "ed25519", "ed25519-rows"))
        return {"builds_s": builds, "lanes_s": lanes}

    def start(self) -> "OrdererNode":
        self.warmup = self.warm_kernels()
        self.rpc.start()
        self.cluster.start()
        self._stop_onboard = threading.Event()
        self._onboard_thread = threading.Thread(target=self._onboard_loop,
                                                daemon=True)
        self._onboard_thread.start()
        if self.ops is not None:
            self.ops.start()
        logger.info("orderer %d serving on %s", self.raft_id, self.rpc.addr)
        return self

    def stop(self) -> None:
        if getattr(self, "_stop_onboard", None) is not None:
            self._stop_onboard.set()
        self.cluster.stop()
        for support in self.registrar.channels().values():
            support.chain.halt()
            support.release()
        self.rpc.stop()
        if getattr(self, "_onboard_thread", None) is not None:
            self._onboard_thread.join(10.0)
        if getattr(self, "slo", None) is not None:
            self.slo.stop()
        if getattr(self, "timeseries", None) is not None:
            self.timeseries.stop()
        if getattr(self, "resources", None) is not None:
            self.resources.stop()
        if getattr(self, "profiler", None) is not None:
            self.profiler.stop()
        if getattr(self, "incidents", None) is not None:
            self.incidents.stop()
        if self.ops is not None:
            self.ops.stop()


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m fabric_tpu_torch.node.orderer <node.json>",
              file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO)
    from fabric_tpu_torch.config.localconfig import load_node_config
    cfg = load_node_config(argv[0], "orderer")
    node = OrdererNode(cfg, data_dir=cfg["data_dir"]).start()
    threading.Event().wait()   # serve until killed
    return 0


if __name__ == "__main__":
    sys.exit(main())
