"""Runnable peer node: endorser + deliver client + validator/committer.

Fabric's peer binary (the larger of its two server processes:
cmd/peer/main.go:29, internal/peer/node/start.go:110-860, channel wiring
core/peer/peer.go:207) composed for this framework: a JSON node config +
MSP material on disk produce ONE process that

  - serves the Endorser (`endorse`), qscc/cscc (`qscc.*`, `cscc.*`),
    discovery (`discovery.endorsers`), and the private-data pull/push
    plane (`privdata.fetch` / `privdata.push`) over the authenticated RPC
    plane (fabric_tpu/comm),
  - runs the deliver client against the orderer cluster with failover
    (internal/pkg/peer/blocksprovider semantics: seek from height, batch-
    verify orderer signatures, commit in order),
  - validates + commits through the verify-then-gate TxValidator and the
    privdata Coordinator (missing collections recorded and reconciled on
    a timer, gossip/privdata/reconcile.go),
  - exposes the ops plane (/healthz /metrics /logspec).

Run:  python -m fabric_tpu_torch.node.peer <node.json>
Provision a dev network: fabric_tpu_torch.node.provision.provision_network().

Counterpart of `fabric_tpu/node/peer.py`, whole, on the port's imports;
it reads the reference's config keys and serves its RPC verbs and ops
routes.  Two defaults differ on purpose: the node's provider is the
factory's CUDA kind unless the config names one (`"bccsp": "SW"` asks for
the host), and `bccsp_degrade` unset means fail-stop (the bare
`CudaProvider`; `true` wraps it in `DegradingProvider`).  `/healthz`
carries the provider's `name`, `backend` and `degraded` beside the
reference's fields.  `stop()` closes each channel's deliver client and
joins its deliver loop, so nothing writes under the data directory once
it returns (ROADMAP C25).
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.bccsp.factory import FactoryOpts, init_factories
from fabric_tpu_torch.chaincode import (
    ChaincodeDefinition,
    ChaincodeRegistry,
    LifecyclePolicyProvider,
    SimulationError,
)
from fabric_tpu_torch.chaincode.runtime import FuncContract
from fabric_tpu_torch.comm.rpc import RpcServer, connect
from fabric_tpu_torch.committer import Committer, TxValidator
from fabric_tpu_torch.committer.sbe import statedb_lookup
from fabric_tpu_torch.config import Bundle, BundleSource, ChannelConfig
from fabric_tpu_torch.endorser import Endorser
from fabric_tpu_torch.endorser.proposal import SignedProposal
from fabric_tpu_torch.ledger import KVLedger, LedgerConfig
from fabric_tpu_torch.node.orderer import load_signing_identity
from fabric_tpu_torch.orderer import block_signature_items
from fabric_tpu_torch.policy import SignedData, parse_policy
from fabric_tpu_torch.privdata import (
    CollectionConfig,
    CollectionRegistry,
    Coordinator,
    PvtDataStore,
    TransientStore,
)
from fabric_tpu_torch.protocol import wire
from fabric_tpu_torch.protocol.types import Block
from fabric_tpu_torch.scc.cscc import Cscc
from fabric_tpu_torch.scc.discovery import DiscoveryService
from fabric_tpu_torch.scc.qscc import Qscc

logger = logging.getLogger("fabric_tpu_torch.node.peer")


# -- built-in dev contracts (in-process dev mode; external chaincode is the
#    production path, fabric_tpu/chaincode/extcc.py) -------------------------

def _asset_contract():
    def create(stub, key, value):
        if stub.get_state(key.decode()) is not None:
            raise SimulationError("asset exists")
        stub.put_state(key.decode(), value)
        return b"created"

    def read(stub, key):
        v = stub.get_state(key.decode())
        if v is None:
            raise SimulationError("no such asset")
        return v

    def transfer(stub, key, owner):
        v = stub.get_state(key.decode())
        if v is None:
            raise SimulationError("no such asset")
        stub.put_state(key.decode(), owner)
        return b"transferred"

    def put_private(stub, collection, key, value):
        stub.put_state(key.decode() + ".marker", b"1")
        stub.put_private_data(collection.decode(), key.decode(), value)
        return b"ok"

    def bump(stub, key):
        # read-modify-write upsert: records a read (version None when
        # absent) so two concurrent bumps of one key MVCC-conflict —
        # the workload plane's conflict dial rides on this
        cur = stub.get_state(key.decode())
        n = int(cur or b"0") + 1
        stub.put_state(key.decode(), str(n).encode())
        return str(n).encode()

    def scan(stub, start, end):
        # range read: stages a RangeQueryInfo, so a committed write
        # landing inside [start, end) invalidates this tx (phantoms)
        items = stub.get_state_by_range(start.decode(), end.decode())
        return str(len(items)).encode()

    return FuncContract(create=create, read=read, transfer=transfer,
                        put_private=put_private, bump=bump, scan=scan)


DEV_CONTRACTS = {"asset_demo": _asset_contract}


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
        # the connection of the pull in progress, and whether close()
        # was called: a closed facade dials nothing more
        self._conn = None
        self._closed = False

    def close(self) -> None:
        """End the pull in progress (its stream raises RpcClosed) and
        refuse later pulls: the peer is stopping."""
        self._closed = True
        conn = self._conn
        if conn is not None:
            conn.close()

    def _connect(self, addr):
        if self._closed:
            raise RuntimeError("deliver client closed")
        # stream_views: block bytes arrive as memoryviews into the
        # received frame and go straight to the native span parser —
        # no frame->block copy, no per-tx objects
        self._conn = connect(tuple(addr), self.signer, self.msps,
                             timeout=3.0, stream_views=True)
        if self._closed:
            self._conn.close()
            raise RuntimeError("deliver client closed")
        return self._conn

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
                conn = self._connect(addr)
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
                conn = self._connect(addr)
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


class _LiveHandshakeMsps:
    """Mapping view of the peer's handshake MSPs, resolved through the
    live channel bundles on every access (union across joined channels,
    bootstrap bundle as the floor).  The transport layer authenticates
    against this instead of a one-time snapshot — see PeerNode wiring.
    """

    def __init__(self, node: "PeerNode", boot: dict):
        self._node = node
        self._boot = dict(boot)

    def _snap(self) -> dict:
        out = dict(self._boot)
        for ch in list(getattr(self._node, "channels", {}).values()):
            try:
                out.update(ch.bundle_source.current().msps)
            except Exception:       # a torn channel must not kill auth
                pass
        return out

    def get(self, key, default=None):
        return self._snap().get(key, default)

    def __getitem__(self, key):
        return self._snap()[key]

    def __contains__(self, key):
        return key in self._snap()

    def __iter__(self):
        return iter(self._snap())

    def __len__(self):
        return len(self._snap())

    def items(self):
        return self._snap().items()

    def values(self):
        return self._snap().values()

    def keys(self):
        return self._snap().keys()


class PeerChannel:
    """One channel's kernel inside a peer process: ledger + validator +
    committer + endorser + query/privdata/gossip planes + deliver loop.

    The slot of the reference's per-channel wiring in
    core/peer/peer.go:207-371 CreateChannel — the peer binary hosts N
    of these with independent ledgers, validators, and config bundles.
    """

    def __init__(self, node: "PeerNode", channel_cfg: ChannelConfig,
                 ch_dir: str, config_height: int = 0):
        self.node = node
        self.channel_id = channel_cfg.channel_id
        # Config persistence (core/ledger/confighistory/mgr.go role):
        # every applied config records (block_num, config) here, so a
        # restart resumes from the LATEST applied config — not the
        # join/bootstrap-time one — and config_height survives.  Without
        # this, runtime config updates were silently lost on restart and
        # catch-up replay of historical config blocks got flagged
        # INVALID, diverging from tip peers.
        from fabric_tpu_torch.ledger.confighistory import ConfigHistory
        self.confighistory = ConfigHistory(root=ch_dir)
        entries = self.confighistory.entries()
        if entries:
            h, cfg_bytes = entries[-1]
            try:
                restored = ChannelConfig.deserialize(cfg_bytes)
                if restored.sequence > channel_cfg.sequence:
                    channel_cfg = restored
                config_height = max(config_height, h)
            except Exception:
                logger.exception("[%s] could not restore latest config",
                                 self.channel_id)
        elif config_height > 0 or channel_cfg.sequence > 0:
            # seed the history with the join/bootstrap config so the
            # committer's replay-covered check works after restart
            self.confighistory.record(config_height,
                                      channel_cfg.serialize())
        self.bundle_source = BundleSource(Bundle(channel_cfg),
                                          config_height=config_height)
        self.msps = self.bundle_source.current().msps
        # parallel MVCC commit plane (committer/parallel_commit).  The
        # early_abort sub-knob defaults to the plane's enabled state;
        # NOTE it must be uniform across a channel's peers — a doomed
        # tx's flag byte is MVCC_READ_CONFLICT even where the skipped
        # signature gate would have said otherwise, and flags feed the
        # commit hash (see parallel_commit/earlyabort.py).
        pc_cfg = dict(node.cfg.get("parallel_commit", {}))
        # fused device validation (committer/device_validate.py): gate
        # fold + MVCC as one KV7 launch per block, prepared batch
        # consumed by the ledger.  Same uniformity note as early_abort
        # (demotions fall back bit-identically, so only timing differs,
        # but keep it uniform as an operational convention).
        dv_cfg = dict(node.cfg.get("device_validate", {}))
        dv_on = bool(dv_cfg.get("enabled", False))
        # sharded state plane knobs: `state: {shards, checkpoint_every}`
        st_cfg = dict(node.cfg.get("state", {}))
        ledger_root = f"{ch_dir}/ledger"
        # join-by-snapshot: `bootstrap_snapshot: {enabled, from:[[host,
        # port],...]}` — only attempted when this channel has no chain
        # yet; failure falls back to genesis replay via deliver
        snap_cfg = dict(node.cfg.get("bootstrap_snapshot", {}))
        self.snapshot_bootstrap = None   # install info (or None)
        if snap_cfg.get("enabled"):
            self._bootstrap_from_snapshot(ledger_root, snap_cfg)
        self.ledger = KVLedger(
            self.channel_id,
            LedgerConfig(root=ledger_root,
                         state_shards=int(st_cfg.get("shards", 8)),
                         snapshot_every=int(
                             st_cfg.get("checkpoint_every", 256)),
                         parallel_commit=bool(pc_cfg.get("enabled", False)),
                         commit_workers=int(pc_cfg.get("max_workers", 4)),
                         commit_adaptive=bool(pc_cfg.get("adaptive", True)),
                         commit_serial_fallback=bool(
                             pc_cfg.get("serial_fallback", True)),
                         # cross-block wavefront window (README
                         # "Cross-block wavefront"): W > 0 enables the
                         # pipelined commit_begin/commit_finish entry
                         # points used by PipelinedCommitter drivers
                         commit_window=int(pc_cfg.get("window", 0)),
                         device_validate=dv_on))
        early_abort = None
        if pc_cfg.get("early_abort", pc_cfg.get("enabled", False)):
            from fabric_tpu_torch.committer.parallel_commit import (
                EarlyAbortAnalyzer,
            )
            # overlay_source keeps dooming sound while the pipelined
            # window holds uncommitted predecessors (savepoint lag)
            early_abort = EarlyAbortAnalyzer(
                self.ledger.statedb, self.channel_id,
                overlay_source=self.ledger.pending_overlay)
        device_validate = None
        if dv_on:
            from fabric_tpu_torch.committer.device_validate import DeviceValidator
            device_validate = DeviceValidator(
                self.ledger.statedb, self.channel_id,
                window=int(dv_cfg.get("window", 4096)))
            self.ledger.set_prepared_source(device_validate.take_prepared)

        cfg = node.cfg
        self.policies = LifecyclePolicyProvider(self.ledger.statedb)
        # the `_lifecycle` namespace endorsement policy: majority of the
        # channel's orgs (the reference's default Application/
        # LifecycleEndorsement MAJORITY Endorsement rule)
        from fabric_tpu_torch.chaincode import LIFECYCLE_NS
        _orgs = _app_org_ids(self.bundle_source.current().config)
        if _orgs:
            _maj = len(_orgs) // 2 + 1
            self.policies.set_policy(LIFECYCLE_NS, parse_policy(
                "OutOf(%d, %s)" % (_maj, ", ".join(
                    f"'{o}.member'" for o in _orgs))))
        self._cc_policies: Dict[str, object] = {}
        for cc in cfg.get("chaincodes", []):
            if cc.get("policy"):
                pol = parse_policy(cc["policy"])
                self.policies.set_policy(cc["name"], pol)
                self._cc_policies[cc["name"]] = pol
            # field indexes declared with the chaincode (the reference
            # ships CouchDB index definitions in the chaincode package's
            # META-INF/statedb/couchdb/indexes, created at deploy)
            for field in cc.get("indexes", []):
                self.ledger.statedb.create_index(cc["name"], field)

        # per-channel device placement: when the scheduler is live
        # (bccsp_placement) each channel verifies on its own carved
        # device span; provider_source lets every validator flush
        # re-resolve + report queue depth so spans track demand
        from fabric_tpu_torch.bccsp import factory as bccsp_factory
        ch_provider = (bccsp_factory.provider_for_channel(self.channel_id)
                       or node.provider)
        provider_source = (bccsp_factory.provider_for_channel
                           if bccsp_factory.get_placement() is not None
                           else None)
        # device_validate needs the deep C collect tail, which key-level
        # endorsement (sbe_lookup) disables — enabling the fused path
        # trades away per-key validation-parameter overrides on this
        # peer (README "Device-resident validation")
        sbe = (None if device_validate is not None
               else statedb_lookup(self.ledger.statedb))
        self.validator = TxValidator(
            self.channel_id, None, ch_provider, self.policies,
            bundle_source=self.bundle_source,
            sbe_lookup=sbe,
            provider_source=provider_source,
            verify_cache=node.verify_cache,
            early_abort=early_abort,
            device_validate=device_validate)
        self.committer = Committer(self.ledger, self.validator,
                                   bundle_source=self.bundle_source,
                                   provider=ch_provider,
                                   confighistory=self.confighistory)

        # private data plane
        self.collections = CollectionRegistry()
        for col in cfg.get("collections", []):
            self.collections.define(col["ns"], CollectionConfig(
                col["name"], member_orgs=tuple(col["members"]),
                block_to_live=int(col.get("btl", 0))))
        self.transient = TransientStore()
        self.pvt_store = PvtDataStore()
        self.coordinator = Coordinator(
            self.committer, self.collections, self.transient,
            self.pvt_store, mspid=node.mspid,
            fetch=self._privdata_fetch_remote)

        # aclmgmt: resource-name -> channel-policy authorization, live
        # against the bundle so config-tx ACL changes take effect
        # (core/aclmgmt/aclmgmt.go:15 + resources.go)
        from fabric_tpu_torch.policy import ACLProvider
        self.acl = ACLProvider(self.bundle_source, node.provider)

        self.endorser = Endorser(
            self.channel_id, self.ledger.statedb, node.cc_registry,
            self.msps, node.provider, node.signer,
            transient_store=self.transient, pvt_store=self.pvt_store,
            distribute=self._privdata_distribute,
            ledger_height=lambda: self.ledger.height,
            acl=self.acl)

        self.qscc = Qscc(self.channel_id, self.ledger.blockstore,
                         acl=self.acl)
        self.discovery = DiscoveryService(
            membership=node._membership,
            policy_for=self.policies.policy_for)
        self.deliver_client = RemoteDeliver(node.orderers, node.signer,
                                            self.msps)

        # per-channel gossip node on the SHARED authenticated transport
        # (gossip/comm.ChannelMux — the reference keys gossip state by
        # channel inside one instance, gossip_impl.go channel registry)
        from fabric_tpu_torch.gossip.mcs import MessageCryptoService
        from fabric_tpu_torch.gossip.node import GossipNode

        self.mcs = MessageCryptoService(self.msps, node.provider)
        bootstrap = [f"{p[0]}:{p[1]}" for p in node.peers]
        self.gossip = GossipNode(
            node.gossip_mux.register_for(self.channel_id),
            node.gossip_mux.transport.id, self.coordinator,
            mcs=self.mcs, signer=node.signer,
            bootstrap=bootstrap, msps=self.msps)

        # byzantine containment: per-channel witness log + monitor over
        # the node-scoped quarantine registry.  Judges every block at
        # deliver/gossip intake (after signature verification) and
        # guards the gossip drain so a contested header never commits.
        self.byz_monitor = None
        self.proof_gossip = None
        if node.byzantine is not None:
            from fabric_tpu_torch.byzantine import (ByzantineMonitor, ProofGossip,
                                              WitnessLog)
            self.byz_monitor = ByzantineMonitor(
                self.channel_id,
                WitnessLog(f"{ch_dir}/witness_log.json"),
                node.byzantine, ledger=self.ledger, msps=self.msps,
                signer=node.signer,
                proof_dir=f"{ch_dir}/fraud_proofs",
                pardon_window_s=node.byz_pardon_window)
            self.gossip.state.monitor = self.byz_monitor
            self.deliver_client.blocked = (
                lambda s: self.byz_monitor.blocked_source(
                    self._byz_source(s)))
            # fraud-proof gossip: local convictions broadcast their
            # portable proof; received proofs are independently
            # re-verified (byzantine/proofgossip.py)
            self.proof_gossip = ProofGossip(
                self.gossip.endpoint, self.gossip.discovery,
                self.byz_monitor)
            self.gossip.state.proofs = self.proof_gossip
            self.byz_monitor.on_proof = self.proof_gossip.broadcast
            # proof-backed pardons ride the same plane: a NEW local
            # restoration gossips its signed record, receivers
            # re-verify independently (monitor.accept_remote_pardon)
            self.byz_monitor.on_pardon = self.proof_gossip.broadcast_pardon

        self.deliver_healthy = True
        self._thread = threading.Thread(target=self._deliver_loop,
                                        daemon=True)

    # -- snapshot bootstrap ---------------------------------------------

    def _bootstrap_from_snapshot(self, ledger_root: str,
                                 snap_cfg: dict) -> None:
        """Join-by-snapshot (the reference's `peer node
        join-by-snapshot`): when this channel has no chain yet, fetch +
        install a snapshot from a serving peer so recovery opens at the
        snapshot height and deliver only tail-replays to tip.  Never
        fatal — failure falls back to genesis replay."""
        from fabric_tpu_torch.ledger import snapshot as snapmod
        try:
            if not snapmod.needs_bootstrap(ledger_root, self.channel_id):
                return
            sources = [tuple(a[:2]) for a in snap_cfg.get("from", [])]
            if not sources:
                sources = [tuple(p[:2]) for p in self.node.peers]
            if not sources:
                logger.warning("[%s] bootstrap_snapshot enabled but no "
                               "serving peers configured", self.channel_id)
                return
            info = snapmod.bootstrap_from_peers(
                ledger_root, self.channel_id, sources, self.node.signer,
                self.msps,
                chunk_timeout_s=float(snap_cfg.get("chunk_timeout_s", 2.0)),
                attempts=int(snap_cfg.get("attempts", 12)),
                source_blocked=self._source_blocked)
            self.snapshot_bootstrap = info
            logger.info("[%s] joined by snapshot: %s", self.channel_id,
                        info)
        except Exception:
            logger.exception("[%s] snapshot bootstrap failed; falling "
                             "back to genesis replay", self.channel_id)

    # -- privdata client side -------------------------------------------

    def _privdata_distribute(self, txid: str, pvt_sets: dict) -> None:
        """Push endorsement-time cleartext to collection member peers."""
        recs = []
        for (ns, coll), kv in pvt_sets.items():
            recs.append({"namespace": ns, "collection": coll,
                         "keys": list(kv.keys()),
                         "values": [v if v is not None else b""
                                    for v in kv.values()],
                         "deleted": [v is None for v in kv.values()]})
        if not recs:
            return
        body = {"txid": txid, "height": self.ledger.height, "sets": recs,
                "channel": self.channel_id}
        for addr in self.node.peers:
            try:
                conn = connect(tuple(addr[:2]), self.node.signer,
                               self.msps, timeout=2.0)
                try:
                    conn.cast("privdata.push", body)
                finally:
                    conn.close()
            except Exception:
                logger.debug("privdata push to %s failed", addr,
                             exc_info=True)

    def _privdata_fetch_remote(self, txid: str, ns: str,
                               coll: str) -> Optional[dict]:
        """Reconciliation pull from member peers (reconcile.go)."""
        for addr in self.node.peers:
            try:
                conn = connect(tuple(addr[:2]), self.node.signer,
                               self.msps, timeout=2.0)
                try:
                    out = conn.call("privdata.fetch", {
                        "txid": txid, "namespace": ns, "collection": coll,
                        "channel": self.channel_id}, timeout=5.0)
                finally:
                    conn.close()
            except Exception:
                continue
            if out.get("found"):
                return {k: (None if d else v) for k, v, d in
                        zip(out["keys"], out["values"], out["deleted"])}
        return None

    # -- deliver / commit loop ------------------------------------------

    @staticmethod
    def _byz_source(sender):
        """'mspid|cert-sha256' quarantine key for a transport-verified
        deliver sender, or None (never blocked) without a usable cert."""
        binding = PeerNode._attestor_binding(sender)
        if binding is None:
            return None
        return f"{binding[0]}|{binding[1]}"

    def _source_blocked(self, sender) -> bool:
        """Standing check against the node-scoped quarantine registry
        for transfer sources resolved BEFORE the channel monitor exists
        (snapshot bootstrap runs first in __init__) — the registry
        survives a ledger wipe, so a wiped-and-rejoining peer still
        refuses a convicted snapshot source."""
        if self.node.byzantine is None:
            return False
        key = self._byz_source(sender)
        return key is not None and self.node.byzantine.is_quarantined(key)

    def _seed_attestations(self, block, attests, sender) -> None:
        """Seed the node's verdict cache from an orderer's deliver-time
        admission attestations (verify_plane/attest.py).  A no-op
        unless this peer explicitly trusts attestations AND the
        deliver stream's handshake-verified sender is in the attestor
        allowlist; every digest is re-derived from our own envelope
        bytes before acceptance."""
        cache = self.node.verify_cache
        if cache is None or not self.node._attestor_authorized(sender):
            return
        from fabric_tpu_torch.verify_plane import accept_block_attestations
        try:
            # mint under the channel's live config sequence — the same
            # epoch the commit-time validator will judge against
            cache.set_epoch(self.bundle_source.current().sequence,
                            scope=self.channel_id)
            binding = self.node._attestor_binding(sender)
            accept_block_attestations(
                cache, block, attests, self.channel_id, self.msps,
                trust=self.node.attestor_trust,
                attestor_binding=binding)
            # a digest mismatch just revoked the attestor (trust.py):
            # mirror that provable tamper into the byzantine plane so
            # /byzantine, the metric, and the BYZ column reflect it
            if (self.byz_monitor is not None and binding is not None
                    and self.node.attestor_trust is not None
                    and not self.node.attestor_trust.allowed(binding)):
                self.byz_monitor.convict_external(
                    f"{binding[0]}|{binding[1]}", "tampered_attestation",
                    {"block": int(block.header.number),
                     "channel": self.channel_id})
        except Exception:
            logger.debug("attestation seeding failed", exc_info=True)

    def _deliver_loop(self) -> None:
        from fabric_tpu_torch.orderer.deliver import SeekInfo
        backoff = 0.2
        reconcile_at = time.monotonic() + 5.0
        while not self.node._stop.is_set():
            height = self.ledger.height
            try:
                got = 0
                for block, attests, sender in self.deliver_client.deliver(
                        self.channel_id,
                        SeekInfo(start=height, stop=height + 31,
                                 behavior="block_until_ready"),
                        timeout_s=5):
                    if self.node._stop.is_set():
                        break
                    items = block_signature_items(block, self.msps)
                    if not items or not bool(
                            self.node.provider.batch_verify(items).all()):
                        logger.warning("block %d failed orderer-signature "
                                       "verification; dropping window",
                                       block.header.number)
                        # a KNOWN signer with an invalid signature is an
                        # offense (honest orderers cannot produce it —
                        # the authenticated transport rules out frame
                        # corruption); unknown signers may be config lag
                        # and are never scored
                        if self.byz_monitor is not None and items:
                            src = self._byz_source(sender)
                            if src is not None:
                                self.byz_monitor.offense(src, "bad_sig")
                        break
                    if self.byz_monitor is not None:
                        from fabric_tpu_torch.byzantine.monitor import (
                            VERDICT_ADMIT, VERDICT_STALE)
                        verdict = self.byz_monitor.check_block(
                            block, self._byz_source(sender))
                        if verdict == VERDICT_STALE:
                            got += 1
                            continue
                        if verdict != VERDICT_ADMIT:
                            # hold: disputed height awaiting quorum;
                            # reject: this stream served crime evidence.
                            # Either way re-source from the next
                            # consenter — re-seek from committed height
                            # keeps exactly-once (replay guard dedups)
                            self.deliver_client.advance()
                            break
                    if attests:
                        self._seed_attestations(block, attests, sender)
                    # through the gossip state plane: fans out to peers
                    # and drains strictly in block order
                    self.gossip.state.add_block(block)
                    got += 1
                if got and self.byz_monitor is not None:
                    self.byz_monitor.on_committed(self.ledger.height)
                self.deliver_healthy = True
                backoff = 0.2
                if not got:
                    self.node._stop.wait(0.1)
            except Exception:
                self.deliver_healthy = False
                logger.debug("deliver pull failed; retrying", exc_info=True)
                self.node._stop.wait(backoff)
                backoff = min(backoff * 2, 3.0)
            try:
                self.gossip.tick()
            except Exception:
                logger.exception("gossip tick failed")
            if time.monotonic() >= reconcile_at:
                try:
                    n = self.coordinator.reconcile()
                    if n:
                        logger.info("[%s] reconciled %d private "
                                    "collections", self.channel_id, n)
                except Exception:
                    logger.exception("privdata reconcile failed")
                reconcile_at = time.monotonic() + 5.0

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """After the node's stop event is set: end the pull in progress
        and join the deliver loop, so that nothing of this channel
        writes to the ledger once the node's stop() has returned."""
        close = getattr(self.deliver_client, "close", None)
        if close is not None:
            close()
        if self._thread.is_alive() \
                and self._thread is not threading.current_thread():
            self._thread.join(30.0)


class PeerNode:
    """One peer process hosting N channels (library form; `main` wraps
    it).  Single-channel attribute surface (ledger/validator/...)
    delegates to the bootstrap channel."""

    def __init__(self, cfg: dict, data_dir: str):
        import os

        self.cfg = cfg
        self.data_dir = data_dir
        self.channel_id = cfg.get("channel_id", "ch")
        # the card unless the config asks for the host ("bccsp": "SW").
        # `bccsp_degrade` unset means fail-stop: a failed launch raises
        # instead of moving the batch to SW; `bccsp_degrade: true` wraps
        # the provider in DegradingProvider (healthz then flags it).
        self.provider = init_factories(
            FactoryOpts(default=cfg.get("bccsp", "CUDA"),
                        degrade=bool(cfg.get("bccsp_degrade", False)),
                        use_mesh=bool(cfg.get("bccsp_mesh", False)),
                        placement=bool(cfg.get("bccsp_placement", False)),
                        mesh_devices=cfg.get("bccsp_mesh_devices")))
        self.signer = load_signing_identity(
            cfg["mspid"], cfg["cert_pem"].encode(), cfg["key_pem"].encode())
        self.mspid = cfg["mspid"]

        # verify-once plane: ONE MAC'd verdict cache per peer process,
        # shared by the gateway's ingress stamping, the speculative
        # worker, and every channel's commit-time validator — so a
        # signature verified at submit time is never re-dispatched at
        # commit.  On by default; `verify_once: {"enabled": false}`
        # restores the classic always-verify pipeline.
        vcfg = dict(cfg.get("verify_once", {}))
        self.verify_cache = None
        self.speculative = None
        if vcfg.get("enabled", True):
            from fabric_tpu_torch.verify_plane import VerdictCache
            self.verify_cache = VerdictCache(
                capacity=int(vcfg.get("capacity", 65536)),
                owner=self.mspid)
        # deliver-time attestation trust (the orderer->peer direction of
        # the gateway->orderer scheme in orderer/msgprocessor.py): OFF
        # unless `trust_attestations: true` AND an explicit `attestors`
        # allowlist of {"mspid", "cert_fp"} bindings names the orderer
        # identities allowed to vouch for creator-signature verdicts.
        from fabric_tpu_torch.orderer.msgprocessor import StandardChannelProcessor
        self._trust_attestations = bool(
            vcfg.get("trust_attestations", False))
        self._attestors = StandardChannelProcessor._normalize_attestors(
            vcfg.get("attestors"))
        # per-orderer standing on top of the allowlist (verify_plane/
        # trust.py): a sender whose attested digest ever failed this
        # peer's own re-derivation is revoked, persistently.
        self.attestor_trust = None
        if self._trust_attestations and self._attestors:
            from fabric_tpu_torch.verify_plane import AttestorTrust
            self.attestor_trust = AttestorTrust(
                os.path.join(data_dir, "attestor_trust.json"))

        # byzantine containment plane: ONE persistent quarantine
        # registry per peer process (identities are node-scoped — an
        # orderer convicted on any channel is distrusted on all), with
        # per-channel witness logs/monitors built in PeerChannel.  On by
        # default; `byzantine: {"enabled": false}` restores blind trust.
        byz_cfg = dict(cfg.get("byzantine", {}))
        self.byzantine = None
        # pardon window (seconds of clean observation before an
        # offense-based quarantine is restored); None keeps the
        # permanent-quarantine behaviour
        self.byz_pardon_window = (
            float(byz_cfg["pardon_window_s"])
            if byz_cfg.get("pardon_window_s") is not None else None)
        if byz_cfg.get("enabled", True):
            from fabric_tpu_torch.byzantine import QuarantineRegistry
            self.byzantine = QuarantineRegistry(
                os.path.join(data_dir, "byzantine_quarantine.json"),
                score_threshold=int(byz_cfg.get("score_threshold", 3)))

        channel_cfg = ChannelConfig.deserialize(
            bytes.fromhex(cfg["channel_config_hex"]))

        self.peers = [tuple(p) for p in cfg.get("peers", [])]
        self.peer_orgs = {tuple(p[:2]): p[2] if len(p) > 2 else None
                          for p in cfg.get("peers", [])}
        self.orderers = [tuple(o) for o in cfg.get("orderers", [])]

        # chaincode runtime, shared across channels (installs are
        # peer-scoped in the reference too; per-channel policy state
        # lives in each PeerChannel)
        self.cc_registry = ChaincodeRegistry()
        for cc in cfg.get("chaincodes", []):
            contract = self._make_contract(cc)
            self.cc_registry.install(
                ChaincodeDefinition(cc["name"], cc.get("version", "1.0")),
                contract)
        # `_lifecycle` system contract + hash-addressed package store:
        # the admin CLI's install/approve/commit verbs ride these
        # (core/chaincode/lifecycle + persistence/chaincode_package.go)
        from fabric_tpu_torch.chaincode import LIFECYCLE_NS, LifecycleContract
        from fabric_tpu_torch.chaincode.lifecycle import ChaincodeInstaller
        self.installer = ChaincodeInstaller(
            os.path.join(data_dir, "chaincodes"))
        def _lifecycle_orgs(cid, _boot=channel_cfg):
            ch = self.channels.get(cid) if hasattr(self, "channels") \
                else None
            cfg_now = (ch.bundle_source.current().config
                       if ch is not None else _boot)
            return _app_org_ids(cfg_now)

        self.cc_registry.install(
            ChaincodeDefinition(LIFECYCLE_NS, "1.0"),
            LifecycleContract(_lifecycle_orgs))

        # RPC + shared gossip transport.  Handshake MSPs resolve through
        # the LIVE channel bundles (union across joined channels) at
        # every use, not a construction-time snapshot: orgs present only
        # on a runtime-joined channel can authenticate at the transport
        # layer, and MSP rotations committed via config tx reach the
        # handshake path immediately.
        boot_msps = Bundle(channel_cfg).msps
        live_msps = _LiveHandshakeMsps(self, boot_msps)
        self.rpc = RpcServer(cfg.get("host", "127.0.0.1"), int(cfg["port"]),
                             self.signer, live_msps)
        from fabric_tpu_torch.gossip.comm import ChannelMux, SecureGossipTransport
        transport = SecureGossipTransport(self.rpc, self.signer, live_msps)
        self.gossip_mux = ChannelMux(transport, channel_cfg.channel_id)

        self._stop = threading.Event()
        # serving -> draining -> drained (fleet lifecycle: rolling
        # restarts drain a peer before killing it)
        self.lifecycle = "serving"
        self.channels: Dict[str, PeerChannel] = {}
        self.cscc = Cscc(create_channel=self._cscc_create)

        # bootstrap channel.  config_height: the block number the
        # bootstrap config was taken at (0 = genesis) — a peer
        # bootstrapped at a later config MUST carry it so catch-up
        # replay of older config blocks is recognized (committer.py).
        # Legacy layout detection keys on the OLD LEDGER ITSELF
        # (data_dir/ledger) — a stable marker; keying on the channels/
        # dir would silently relocate the bootstrap ledger after the
        # first runtime join created it.
        self._create_channel(channel_cfg,
                             config_height=int(cfg.get("config_height", 0)),
                             legacy_dir=os.path.isdir(
                                 os.path.join(data_dir, "ledger")))

        # restore channels joined at runtime in earlier lives
        ch_root = os.path.join(data_dir, "channels")
        if os.path.isdir(ch_root):
            for entry in sorted(os.listdir(ch_root)):
                cfg_path = os.path.join(ch_root, entry,
                                        "channel_config.bin")
                if entry in self.channels or not os.path.exists(cfg_path):
                    continue
                try:
                    with open(cfg_path, "rb") as f:
                        joined = ChannelConfig.deserialize(f.read())
                    self._create_channel(joined)
                    logger.info("restored joined channel %r", entry)
                except Exception:
                    logger.exception("could not restore channel %r", entry)

        self.rpc.serve("endorse", self._rpc_endorse)
        self.rpc.serve("status", self._rpc_status)
        self.rpc.serve("qscc.chain_info", self._rpc_chain_info)
        self.rpc.serve("qscc.block_by_number", self._rpc_block_by_number)
        self.rpc.serve("qscc.tx_by_id", self._rpc_tx_by_id)
        self.rpc.serve("cscc.channels", lambda b, p:
                       {"channels": self.cscc.get_channels()})
        self.rpc.serve("cscc.join", self._rpc_cscc_join)
        self.rpc.serve("discovery.endorsers", self._rpc_discovery)
        self.rpc.serve("discovery.peers", self._rpc_discovery_peers)
        self.rpc.serve("discovery.config", self._rpc_discovery_config)
        self.rpc.serve("lifecycle.install", self._rpc_cc_install)
        self.rpc.serve("lifecycle.installed", self._rpc_cc_installed)
        self.rpc.serve("privdata.fetch", self._rpc_privdata_fetch)
        self.rpc.serve_cast("privdata.push", self._rpc_privdata_push)
        # snapshot state-transfer (ledger/snapshot.py): meta + chunked
        # shard-file reads; the transport handshake already restricts
        # callers to channel MSP identities
        self.rpc.serve("state.snapshot_meta", self._rpc_snapshot_meta)
        self.rpc.serve("state.snapshot_chunk", self._rpc_snapshot_chunk)

        # gateway: the batched client front door (needs orderers to
        # broadcast to; a peer with no orderer list serves peers only)
        self.gateway = None
        if self.orderers and cfg.get("gateway_enabled", True):
            from fabric_tpu_torch.gateway import GatewayService
            # `admission {enabled, shed_evaluate_burn, shed_hard_burn,
            # ...}` may live at the node top level (env-overridable as
            # FABRIC_TPU_PEER_ADMISSION__*) or nested under `gateway`;
            # top level wins so one flag flips shedding on a deployment
            gw_cfg = dict(cfg.get("gateway", {}))
            if cfg.get("admission") is not None:
                gw_cfg["admission"] = cfg.get("admission")
            self.gateway = GatewayService(self, gw_cfg)
            self.gateway.register(self.rpc)
        # speculative verifier: stamps creator verdicts at ingress and
        # verifies endorsement sets while the orderer cuts the block —
        # only a gateway-hosting peer sees transactions pre-ordering
        if self.gateway is not None and self.verify_cache is not None:
            from fabric_tpu_torch.verify_plane import SpeculativeVerifier
            self.speculative = SpeculativeVerifier(
                self.verify_cache, lambda: self.provider,
                self._channel_msps, epoch_source=self._channel_epoch)

        # tx tracing + flight recorder: on by default for nodes (the
        # import-time default stays off so libraries/bench pay nothing);
        # sample rate and recorder capacity ride localconfig, e.g.
        # FABRIC_TPU_PEER_TRACING__SAMPLE_RATE=0.1
        from fabric_tpu_torch.ops_plane import tracing as _tracing
        _tracing.configure(cfg.get("tracing", {}))

        self.ops = None
        if cfg.get("ops_port") is not None:
            from fabric_tpu_torch.ops_plane import OperationsServer
            self.ops = OperationsServer(cfg.get("host", "127.0.0.1"),
                                        int(cfg["ops_port"]))
            self.ops.register_checker(
                "deliver", lambda: self._deliver_healthy)
            self.ops.register_checker("orderer_reachable",
                                      self._check_orderers)
            self.ops.register_checker("bccsp", self._check_bccsp)
            self.ops.health_fields["bccsp"] = self._bccsp_fields
            # lifecycle on /healthz (serving/draining/drained — an
            # ORDERLY state, not a failure) + POST /drain to enter it
            self.ops.lifecycle_fn = lambda: self.lifecycle
            self.ops.register_route(
                "POST", "/drain",
                lambda path, body: (200, self.drain()))
            # /debug/profile (torch.profiler) + /debug/pprof (host), the
            # peer.profile.enabled slot (internal/peer/node/start.go:813)
            from fabric_tpu_torch.ops_plane.profiling import register_routes
            register_routes(self.ops, enabled=bool(cfg.get("profiling")))
            # /traces, /traces/<id> (Chrome trace JSON), /spans/stats;
            # ?cluster=1 assembles the trace across every ops endpoint
            # in the `cluster_trace` sub-dict's peer list (orderers
            # included) — one Perfetto export spanning gateway →
            # orderer → committer
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
                    local_name=f"peer:{self.mspid}",
                    timeout_s=float(_cfg.get("timeout_s", 2.0)),
                    max_traces=int(_cfg.get("max_traces", 16)))
                if out is None:
                    return 404, {"error": "unknown trace", "trace_id": tid}
                return 200, out

            _tracing.register_routes(self.ops, cluster_fn=_cluster_trace)
            # GET /faults: the active fault plan ({"active": false} in
            # production — the plan only exists during chaos drills)
            from fabric_tpu_torch.comm import faults as _faults
            _faults.register_routes(self.ops)
            # GET /state: per-channel shard sizes, checkpoint generation/
            # savepoint, and how much the last reopen had to replay
            self.ops.register_route("GET", "/state", self._state_route)
            # GET /byzantine: quarantine standings, per-channel witness
            # stats, fraud proofs
            if self.byzantine is not None:
                from fabric_tpu_torch.byzantine import register_ops as _byz_ops
                _byz_ops(self.ops, self.byzantine,
                         monitors_fn=lambda: {
                             cid: ch.byz_monitor
                             for cid, ch in self.channels.items()
                             if ch.byz_monitor is not None})
            # GET /gateway: front-door queue + breaker snapshot (the
            # gateway shares the peer process and ops surface)
            if self.gateway is not None:
                self.gateway.register_ops(self.ops)
            # GET /verify_plane: verdict-cache economics + speculative
            # worker state
            if self.verify_cache is not None:
                from fabric_tpu_torch import verify_plane as _vp
                _vp.register_ops(
                    self.ops, self.verify_cache, spec=self.speculative,
                    extra=lambda: {
                        "trust_attestations": self._trust_attestations,
                        "attestors": len(self._attestors),
                        "attestors_revoked": (
                            self.attestor_trust.revoked_count()
                            if self.attestor_trust is not None else 0)})

        # SLO plane: GET /slo + /slo/alerts, burn-rate alerting over the
        # metrics registry; config/env via the `slo` sub-dict
        # (FABRIC_TPU_PEER_SLO__SHORT_WINDOW_S=30 etc.)
        self.slo = None
        slo_cfg = cfg.get("slo", {})
        if self.ops is not None and slo_cfg.get("enabled", True):
            from fabric_tpu_torch.ops_plane import slo as _slo
            self.slo = _slo.SloEvaluator(slo_cfg)
            _slo.register_routes(self.ops, self.slo)
            self.slo.start()

        # metric history + resource telemetry: GET /metrics/history
        # (ring store with raw→1m→10m downsampling) and a /proc-based
        # collector feeding RSS/fd/thread/GC/arena/verdict-cache gauges
        # into /metrics and the store.  Both OFF by default: disabled,
        # no thread runs, no gauge registers, /metrics is unchanged.
        # Config/env: FABRIC_TPU_PEER_TIMESERIES__ENABLED=true etc.
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

        # continuous sampling profiler: GET /profile/sampled, a daemon
        # thread folding sys._current_frames() into time-bucketed
        # windows.  OFF by default: disabled, no thread, no counter,
        # /metrics byte-identical.  FABRIC_TPU_PEER_PROFILER__ENABLED=true
        self.profiler = None
        prof_cfg = cfg.get("profiler", {})
        if self.ops is not None and prof_cfg.get("enabled", False):
            from fabric_tpu_torch.ops_plane import sampler as _sampler
            self.profiler = _sampler.SamplingProfiler(prof_cfg)
            _sampler.register_routes(self.ops, self.profiler)
            self.profiler.start()

        # incident capture: on SLO alert fire, write a self-contained
        # incident_NNNN/ bundle (profile windows, slowest traces,
        # metric history, snapshots, peer fan-out) under data_dir.
        # OFF by default with the same zero-overhead guard.
        self.incidents = None
        inc_cfg = dict(cfg.get("incidents", {}))
        if self.ops is not None and inc_cfg.get("enabled", False):
            from fabric_tpu_torch.ops_plane import incidents as _inc
            inc_cfg.setdefault(
                "dir", os.path.join(self.data_dir, "incidents"))
            if "peers" not in inc_cfg:
                own = "%s:%d" % self.ops.addr
                inc_cfg["peers"] = [
                    p for p in getattr(self, "trace_peers", [])
                    if str(p) != own]
            self.incidents = _inc.IncidentRecorder(
                inc_cfg, node_name=f"peer:{self.mspid}",
                profiler=self.profiler, timeseries=self.timeseries)
            if self.slo is not None:
                self.incidents.attach_slo(self.slo)
            if self.resources is not None:
                self.incidents.add_source(
                    "resources", self.resources.collect)
            if self.byzantine is not None:
                self.incidents.add_source(
                    "byzantine", self.byzantine.snapshot)
            if self.gateway is not None:
                gw = self.gateway

                def _gw_snapshot():
                    with gw._lock:
                        depth = len(gw._queue)
                        inflight = len(gw._inflight)
                    return {"queue_depth": depth,
                            "inflight": inflight,
                            "lifecycle": gw.lifecycle,
                            "healthy": gw.broadcaster.healthy(),
                            "admission": gw.admission.snapshot(),
                            "orderers": gw.broadcaster.states()}

                self.incidents.add_source("gateway", _gw_snapshot)
            self.incidents.add_source(
                "lifecycle", lambda: {"lifecycle": self.lifecycle})
            _inc.register_routes(self.ops, self.incidents)

    def _check_orderers(self):
        """healthz: at least one orderer breaker not OPEN (or no
        broadcast plane configured at all)."""
        if self.gateway is None:
            return True
        bc = getattr(self.gateway, "broadcaster", None)
        if bc is None or bc.healthy():
            return True
        raise RuntimeError("all orderer breakers open: %s" % [
            s["addr"] for s in bc.states()])

    def _bccsp_fields(self) -> dict:
        """/healthz's provider fields: the kind, the live backend and
        whether a DegradingProvider is on its fallback."""
        return {"name": self.provider.name,
                "backend": getattr(self.provider, "backend",
                                   self.provider.name),
                "degraded": bool(getattr(self.provider, "degraded", False))}

    def _check_bccsp(self):
        """healthz: which crypto backend is live; FAILs (with the
        backend named in the reason) while degraded to SW."""
        backend = getattr(self.provider, "backend", self.provider.name)
        if getattr(self.provider, "degraded", False):
            raise RuntimeError(f"bccsp backend = {backend}")
        return True

    # -- channel lifecycle ---------------------------------------------------

    def _channel_dir(self, channel_id: str, legacy: bool = False) -> str:
        import os
        if legacy:
            # pre-multichannel layout: the bootstrap channel's ledger
            # lived at data_dir/ledger
            return self.data_dir
        return os.path.join(self.data_dir, "channels", channel_id)

    def _create_channel(self, channel_cfg: ChannelConfig,
                        config_height: int = 0,
                        legacy_dir: bool = False) -> PeerChannel:
        import os
        cid = channel_cfg.channel_id
        ch_dir = self._channel_dir(cid, legacy=legacy_dir)
        os.makedirs(ch_dir, exist_ok=True)
        if not legacy_dir:
            cfg_path = os.path.join(ch_dir, "channel_config.bin")
            if not os.path.exists(cfg_path):
                tmp = cfg_path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(channel_cfg.serialize())
                os.replace(tmp, cfg_path)
        ch = PeerChannel(self, channel_cfg, ch_dir,
                         config_height=config_height)
        self.channels[cid] = ch
        self.cscc.register(cid, ch)
        if not self._stop.is_set() and getattr(self, "_started", False):
            ch.start()
        return ch

    def _cscc_create(self, channel_id: str, channel_config,
                     config_height: int = 0):
        if isinstance(channel_config, (bytes, bytearray)):
            channel_config = ChannelConfig.deserialize(bytes(channel_config))
        if channel_config.channel_id != channel_id:
            raise ValueError("channel id mismatch")
        return self._create_channel(channel_config,
                                    config_height=config_height)

    def join_channel(self, channel_cfg: ChannelConfig,
                     config_height: int = 0) -> PeerChannel:
        """Runtime channel join (cscc JoinChain,
        core/scc/cscc/configure.go) — a new per-channel kernel in this
        process.  config_height: the block number the join config was
        taken at (from a fetched config block), so catch-up replay of
        older config blocks is recognized as historical."""
        if channel_cfg.channel_id in self.channels:
            raise ValueError(
                f"already joined {channel_cfg.channel_id!r}")
        return self.cscc.join_chain(channel_cfg.channel_id, channel_cfg,
                                    config_height=config_height)

    def _chan(self, body: dict) -> PeerChannel:
        cid = body.get("channel") or self.channel_id
        ch = self.channels.get(cid)
        if ch is None:
            raise ValueError(f"peer has not joined channel {cid!r}")
        return ch

    # -- bootstrap-channel delegation (single-channel API compat) ------------

    @property
    def _bootstrap(self) -> PeerChannel:
        return self.channels[self.channel_id]

    @property
    def bundle_source(self):
        return self._bootstrap.bundle_source

    @property
    def msps(self):
        return self._bootstrap.msps

    @property
    def ledger(self):
        return self._bootstrap.ledger

    @property
    def policies(self):
        return self._bootstrap.policies

    @property
    def validator(self):
        return self._bootstrap.validator

    @property
    def committer(self):
        return self._bootstrap.committer

    @property
    def collections(self):
        return self._bootstrap.collections

    @property
    def transient(self):
        return self._bootstrap.transient

    @property
    def pvt_store(self):
        return self._bootstrap.pvt_store

    @property
    def coordinator(self):
        return self._bootstrap.coordinator

    @property
    def acl(self):
        return self._bootstrap.acl

    @property
    def endorser(self):
        return self._bootstrap.endorser

    @property
    def qscc(self):
        return self._bootstrap.qscc

    @property
    def discovery(self):
        return self._bootstrap.discovery

    @property
    def deliver_client(self):
        return self._bootstrap.deliver_client

    @property
    def gossip(self):
        return self._bootstrap.gossip

    @property
    def mcs(self):
        return self._bootstrap.mcs

    @property
    def _deliver_healthy(self):
        return all(ch.deliver_healthy for ch in self.channels.values())

    # -- wiring helpers ------------------------------------------------------

    def _channel_msps(self, channel_id: str):
        """Live MSP set for the speculative verifier's item derivation —
        resolved through the channel bundle at every use so MSP rotations
        reach speculation the same instant they reach the gate."""
        ch = self.channels.get(channel_id)
        if ch is None:
            return {}
        return ch.bundle_source.current().msps

    def _attestor_authorized(self, sender) -> bool:
        """Is this transport-authenticated orderer identity allowed to
        vouch for creator-signature verdicts?  Same rule as the
        orderer's gateway-attestation gate (msgprocessor.py): trust
        must be explicitly enabled, and the sender's (mspid, cert
        sha256) binding must be in the configured allowlist — no
        allowlist means nobody may vouch."""
        if (not self._trust_attestations or sender is None
                or not self._attestors):
            return False
        binding = self._attestor_binding(sender)
        if binding is None or binding not in self._attestors:
            return False
        # allowlisted but revoked (a past digest mismatch) = not honoured
        return (self.attestor_trust is None
                or self.attestor_trust.allowed(binding))

    @staticmethod
    def _attestor_binding(sender):
        """(mspid, cert sha256) of a transport-authenticated sender, or
        None when it carries no usable certificate."""
        try:
            from fabric_tpu_torch.orderer.cluster import cert_fingerprint
            return (sender.mspid, cert_fingerprint(sender.cert))
        except Exception:
            return None

    def _channel_epoch(self, channel_id: str) -> int:
        """Config sequence for the speculative verifier's per-channel
        cache-epoch pin — the same value the commit-time validator will
        judge those entries against."""
        ch = self.channels.get(channel_id)
        if ch is None:
            return 0
        return ch.bundle_source.current().sequence

    def _make_contract(self, cc_cfg: dict):
        kind = cc_cfg.get("contract", "asset_demo")
        if kind in DEV_CONTRACTS:
            return DEV_CONTRACTS[kind]()
        if kind.startswith("extern:"):
            # production mode: the contract runs as its own OS process
            # speaking the Register/Invoke stream FSM (chaincode/extcc.py)
            import shlex
            from fabric_tpu_torch.chaincode.extcc import (
                ChaincodeSupport,
                ExtProcessContract,
            )
            if getattr(self, "cc_support", None) is None:
                self.cc_support = ChaincodeSupport(
                    f"{self.cfg['data_dir']}/cc")
            return ExtProcessContract(self.cc_support, cc_cfg["name"],
                                      shlex.split(kind[len("extern:"):]))
        raise ValueError(f"unknown contract {kind!r}")

    def _membership(self):
        """discovery membership: this peer + its configured neighbors
        (live gossip membership in the reference)."""
        me = f"{self.cfg.get('host', '127.0.0.1')}:{self.cfg['port']}"
        out = [{"id": me, "mspid": self.mspid, "roles": ["peer"]}]
        for p in self.cfg.get("peers", []):
            if len(p) > 2:
                out.append({"id": f"{p[0]}:{p[1]}", "mspid": p[2],
                            "roles": ["peer"]})
        return out

    # -- rpc handlers --------------------------------------------------------

    def _rpc_endorse(self, body: dict, peer_identity) -> dict:
        sp = SignedProposal(body["proposal"], body["signature"])
        resp = self._chan(body).endorser.process_proposal(sp)
        out = {"status": resp.status, "message": resp.message,
               "payload": resp.payload}
        if resp.endorsement is not None:
            out["endorser"] = resp.endorsement.endorser
            out["endorsement_sig"] = resp.endorsement.signature
        return out

    def _rpc_status(self, body: dict, peer_identity) -> dict:
        ch = self._chan(body)
        return {"mspid": self.mspid, "channel": ch.channel_id,
                "channels": sorted(self.channels),
                "height": ch.ledger.height,
                "commit_hash": (ch.ledger.commit_hash or b"").hex()}

    def _rpc_snapshot_meta(self, body: dict, peer_identity) -> dict:
        """Serve a snapshot description: force-checkpoint the channel's
        derived DBs and return manifests + chain metadata at the
        checkpoint height (ledger/snapshot.py protocol)."""
        from fabric_tpu_torch.ledger import snapshot as snapmod
        return snapmod.export_meta(self._chan(body).ledger)

    def _rpc_snapshot_chunk(self, body: dict, peer_identity) -> dict:
        from fabric_tpu_torch.ledger import snapshot as snapmod
        return snapmod.serve_chunk(
            self._chan(body).ledger, str(body["db"]), int(body["gen"]),
            str(body["file"]), int(body["offset"]))

    def _state_route(self, path, body):
        from fabric_tpu_torch.ops_plane import registry
        demotions = registry.counter(
            "validator_device_demotions_total",
            "device-validation demotions to the host path, by reason")
        out = {}
        for cid, ch in sorted(self.channels.items()):
            st = ch.ledger.state_status()
            by_reason = demotions.breakdown("reason", channel=cid)
            if by_reason:
                # policy_width called out: it is the k<=8 truth-table
                # cap's real-world demotion rate (README "Device-
                # resident validation")
                st["device_validate"] = {
                    "demotions": {r: int(n)
                                  for r, n in sorted(by_reason.items())},
                    "policy_width_demotions": int(
                        by_reason.get("policy_width", 0)),
                }
            out[cid] = st
        return 200, {"channels": out}

    def _rpc_chain_info(self, body: dict, peer_identity) -> dict:
        return self._chan(body).qscc.get_chain_info(peer_identity)

    def _rpc_block_by_number(self, body: dict, peer_identity) -> dict:
        blk = self._chan(body).qscc.get_block_by_number(
            int(body["number"]), peer_identity)
        return {"block": blk.serialize()}

    def _rpc_tx_by_id(self, body: dict, peer_identity) -> dict:
        env = self._chan(body).qscc.get_transaction_by_id(
            body["txid"], peer_identity)
        return {"envelope": env.serialize()}

    def _rpc_cscc_join(self, body: dict, peer_identity) -> dict:
        """Runtime channel join over RPC (cscc JoinChain,
        core/scc/cscc/configure.go) — gated by the PEER'S OWN
        cscc/JoinChain ACL (Admins of the bootstrap channel).  The
        incoming config must NEVER authorize its own join: it is
        attacker-supplied, and judging the caller against its MSPs
        would let anyone self-authorize with a crafted config (the
        reference checks JoinChain against the local MSP policy)."""
        self._bootstrap.acl.check("cscc/JoinChain", peer_identity)
        channel_cfg = ChannelConfig.deserialize(body["config"])
        ch = self.join_channel(channel_cfg,
                               config_height=int(body.get(
                                   "config_height", 0)))
        return {"channel": ch.channel_id, "status": "joined"}

    def _rpc_discovery(self, body: dict, peer_identity) -> dict:
        ch = self._chan(body)
        ch.acl.check("discovery/Discover", peer_identity)
        out = ch.discovery.endorsers(body["namespace"])
        out["layouts"] = [l.as_dict() for l in out["layouts"]]
        return out

    def _rpc_discovery_peers(self, body: dict, peer_identity) -> dict:
        """Live-membership peer query (the discover CLI's `peers` verb;
        discovery/client PeersOfChannel)."""
        ch = self._chan(body)
        ch.acl.check("discovery/Discover", peer_identity)
        return {"peers": self._membership()}

    def _rpc_discovery_config(self, body: dict, peer_identity) -> dict:
        """Channel-config summary (the discover CLI's `config` verb;
        discovery/client Config: msps + orderer endpoints)."""
        ch = self._chan(body)
        ch.acl.check("discovery/Discover", peer_identity)
        bundle = ch.bundle_source.current()
        return {"channel": ch.channel_id,
                "sequence": bundle.sequence,
                "msps": sorted(bundle.msps),
                "orderers": [f"{h}:{p}" for h, p in self.orderers]}

    def _check_local_admin(self, resource: str, peer_identity) -> None:
        """Peer-LOCAL admin gate: peer-scoped operations (chaincode
        install / query-installed) are authorized by an admin of the
        peer's OWN org — the reference evaluates these against the
        local MSP's admin policy, not a channel-wide majority
        (core/aclmgmt defaults for _lifecycle install)."""
        from fabric_tpu_torch.msp import Principal, deserialize_from_msps
        from fabric_tpu_torch.policy import ACLError, PolicyEvaluator, signed_by
        if peer_identity is None or not hasattr(peer_identity, "serialize"):
            raise ACLError(f"{resource}: unauthenticated caller")
        bundle = self._bootstrap.bundle_source.current()
        ident = deserialize_from_msps(bundle.msps,
                                      peer_identity.serialize(),
                                      validate=True)
        if ident is None or ident.mspid != self.mspid:
            raise ACLError(f"{resource}: caller is not a local-org "
                           "identity")
        evaluator = PolicyEvaluator(bundle.msps, self.provider)
        if not evaluator.evaluate(signed_by(Principal.admin(self.mspid)),
                                  [ident]):
            raise ACLError(f"{resource}: caller is not a local-org admin")

    def _rpc_cc_install(self, body: dict, peer_identity) -> dict:
        """Hash-addressed chaincode package install (lifecycle.go
        InstallChaincode), local-org-admin-gated."""
        self._check_local_admin("lifecycle/Install", peer_identity)
        pid = self.installer.install(body["package"])
        return {"package_id": pid}

    def _rpc_cc_installed(self, body: dict, peer_identity) -> dict:
        self._check_local_admin("lifecycle/QueryInstalled", peer_identity)
        return {"package_ids": self.installer.installed()}

    def _rpc_privdata_fetch(self, body: dict, peer_identity) -> dict:
        """Collection pull: ONLY collection-member orgs may read cleartext
        (gossip/privdata/pvtdataprovider.go membership check)."""
        ch = self._chan(body)
        ns, coll = body["namespace"], body["collection"]
        cfg = ch.collections.get(ns, coll)
        if cfg is None or not cfg.is_member(
                getattr(peer_identity, "mspid", None)):
            return {"found": False, "denied": True}
        data = ch.pvt_store.get_tx_set(ns, coll, body["txid"])
        if data is None:
            # also try the transient store (pre-commit staging)
            for sets in ch.transient.get(body["txid"]):
                if (ns, coll) in sets:
                    data = sets[(ns, coll)]
                    break
        if data is None:
            return {"found": False}
        return {"found": True,
                "keys": list(data.keys()),
                "values": [v if v is not None else b"" for v in
                           data.values()],
                "deleted": [v is None for v in data.values()]}

    def _rpc_privdata_push(self, body: dict, peer_identity) -> None:
        """Endorsement-time distribution: a member peer pushes cleartext
        into our transient store (gossip/privdata/distributor.go)."""
        ch = self._chan(body)
        sets = {}
        for rec in body["sets"]:
            ns, coll = rec["namespace"], rec["collection"]
            cfg = ch.collections.get(ns, coll)
            if cfg is None or not cfg.is_member(self.mspid):
                continue      # we are not a member: refuse cleartext
            sets[(ns, coll)] = {k: (None if d else v) for k, v, d in
                                zip(rec["keys"], rec["values"],
                                    rec["deleted"])}
        if sets:
            ch.transient.persist(body["txid"], int(body["height"]), sets)

    # -- lifecycle -----------------------------------------------------------

    def drain(self, timeout_s: float = 10.0) -> dict:
        """Graceful drain for rolling restarts: refuse NEW client work
        at the gateway while the batcher flushes everything already
        admitted, wait for in-flight block commits to go quiet, then
        force a checkpoint of every channel ledger (WAL truncated, the
        next recovery opens from the checkpoint instead of replaying).
        Idempotent; deliver/gossip reads keep serving throughout."""
        deadline = time.monotonic() + float(timeout_s)
        self.lifecycle = "draining"
        flushed = {}
        if self.gateway is not None:
            flushed = self.gateway.drain(
                max(0.0, deadline - time.monotonic()))
        heights = {}
        for cid, ch in list(self.channels.items()):
            # in-flight blocks: wait for the commit height to go quiet
            # (the deliver loop applies what it already pulled)
            last = ch.ledger.height
            quiet_at = time.monotonic() + 0.3
            while time.monotonic() < min(deadline, quiet_at):
                time.sleep(0.05)
                h = ch.ledger.height
                if h != last:
                    last, quiet_at = h, time.monotonic() + 0.3
            try:
                ch.ledger.snapshot_export()  # checkpoint + WAL truncate
            except Exception:
                logger.exception("[%s] drain checkpoint failed", cid)
            heights[cid] = ch.ledger.height
        self.lifecycle = "drained"
        return {"lifecycle": self.lifecycle, "gateway": flushed,
                "heights": heights}

    def start(self) -> "PeerNode":
        self.rpc.start()
        if self.ops is not None:
            self.ops.start()
        self._started = True
        if self.speculative is not None:
            self.speculative.start()
        if self.gateway is not None:
            self.gateway.start()
        for ch in self.channels.values():
            ch.start()
        logger.info("peer %s serving on %s (%d channels)", self.mspid,
                    self.rpc.addr, len(self.channels))
        return self

    def stop(self) -> None:
        self._stop.set()
        for ch in self.channels.values():
            ch.stop()
        if self.gateway is not None:
            self.gateway.stop()
        if self.speculative is not None:
            self.speculative.stop()
        self.rpc.stop()
        if getattr(self, "cc_support", None) is not None:
            self.cc_support.stop()      # kills external chaincode processes
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
        print("usage: python -m fabric_tpu_torch.node.peer <node.json>",
              file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.INFO)
    from fabric_tpu_torch.config.localconfig import load_node_config
    cfg = load_node_config(argv[0], "peer")
    PeerNode(cfg, data_dir=cfg["data_dir"]).start()
    threading.Event().wait()   # serve until killed
    return 0


if __name__ == "__main__":
    sys.exit(main())
