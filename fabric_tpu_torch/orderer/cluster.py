"""Socket transport for the Raft orderer cluster.

Round-1 left raft messaging in test callbacks (VERDICT.md component #43);
this promotes it to a production transport: each orderer exposes a
`raft.step` cast over the authenticated RPC plane
(fabric_tpu_torch/comm/{secure,rpc}.py — the slot of the reference's
orderer/common/cluster/comm.go:116 Step RPC over mTLS gRPC), with lazy
dialing, reconnection, and a driver thread that runs the chain clock
(raft ticks, batch timeouts) and ships Ready messages.

Counterpart of `fabric_tpu/orderer/cluster.py`, whole, on the port's
imports: the `raft.step` wire dicts are the reference's, so port and
reference orderers form one cluster.  `EntryVerifier.check` verifies
each new entry's proposer signature through the process's default
provider (`msp.identity`), on the card under the CUDA provider; the one
addition is the counter `orderer_entry_verifies_total{result}` on
/metrics, the count of those checks (and each verifier's own count,
`EntryVerifier.verifies`).  `ClusterService.stop` joins each peer
sender's thread (ROADMAP C25).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.comm.rpc import RpcServer, connect
from fabric_tpu_torch.orderer import raft as raftmod

logger = logging.getLogger("fabric_tpu_torch.orderer.cluster")


def cert_fingerprint(cert) -> str:
    """sha256 hex of the DER certificate — the consenter binding token.

    CN strings are forgeable by any org's CA; the full certificate hash
    is not (the reference authenticates the sender's actual TLS cert
    against the consenter set, cluster/comm.go).
    """
    import hashlib
    from fabric_tpu_torch.crypto import serialization
    der = cert.public_bytes(serialization.Encoding.DER)
    return hashlib.sha256(der).hexdigest()


class _PeerSender:
    """Queue + thread per peer: dials with backoff off the driver thread,
    drops raft messages when the peer is unreachable (raft retransmits),
    and always closes replaced connections (no fd/thread leaks)."""

    MAX_QUEUE = 256

    def __init__(self, nid: int, addr, signer, msps):
        self.nid = nid
        self.addr = tuple(addr)
        self.signer = signer
        self.msps = msps
        self._queue = []
        self._cond = threading.Condition()
        self._stopped = False
        self._conn = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def enqueue(self, body: dict) -> None:
        with self._cond:
            if len(self._queue) >= self.MAX_QUEUE:
                self._queue.pop(0)     # raft tolerates loss; keep newest
            self._queue.append(body)
            self._cond.notify()

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()
        conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def join(self, timeout_s: float = 5.0) -> None:
        """Wait for the sender's thread after stop(); a connection it
        made meanwhile is closed."""
        self._thread.join(timeout_s)
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    def _loop(self) -> None:
        backoff = 0.1
        while True:
            with self._cond:
                self._cond.wait_for(lambda: self._queue or self._stopped)
                if self._stopped:
                    return
                body = self._queue.pop(0)
            if self._conn is None:
                try:
                    self._conn = connect(self.addr, self.signer, self.msps,
                                         timeout=2.0)
                    backoff = 0.1
                except Exception:
                    time.sleep(min(backoff, 1.0))
                    backoff *= 2
                    continue   # message dropped; raft resends
            try:
                self._conn.cast("raft.step", body)
            except Exception:
                try:
                    self._conn.close()
                except Exception:
                    pass
                self._conn = None


# -- raft message serde ------------------------------------------------------

def msg_to_dict(m: raftmod.Message) -> dict:
    ents = []
    for e in m.entries:
        ent = {"term": e.term, "index": e.index, "data": e.data,
               "kind": e.kind}
        if e.sig:
            ent["proposer"], ent["sig"] = e.proposer, e.sig
        ents.append(ent)
    d = {"type": m.type, "frm": m.frm, "to": m.to, "term": m.term,
         "index": m.index, "log_term": m.log_term, "commit": m.commit,
         "reject": 1 if m.reject else 0, "hint": m.hint,
         "entries": ents}
    if m.snapshot is not None:
        d["snapshot"] = {"index": m.snapshot.index, "term": m.snapshot.term,
                         "data": m.snapshot.data,
                         "nodes": list(m.snapshot.nodes)}
    return d


def msg_from_dict(d: dict) -> raftmod.Message:
    snap = None
    if "snapshot" in d:
        s = d["snapshot"]
        snap = raftmod.Snapshot(s["index"], s["term"], s["data"],
                                tuple(s["nodes"]))
    return raftmod.Message(
        type=d["type"], frm=d["frm"], to=d["to"], term=d["term"],
        index=d["index"], log_term=d["log_term"],
        entries=tuple(raftmod.Entry(e["term"], e["index"], e["data"],
                                    e["kind"], e.get("proposer", b""),
                                    e.get("sig", b""))
                      for e in d["entries"]),
        commit=d["commit"], reject=bool(d["reject"]), hint=d["hint"],
        snapshot=snap)


def _count_entry_verify(ok: bool) -> None:
    """`orderer_entry_verifies_total{result}`: proposer signatures this
    process verified (retransmits answered from the slot cache are not
    counted).  Guarded like every observer."""
    try:
        from fabric_tpu_torch.ops_plane import registry
        registry.counter("orderer_entry_verifies_total",
                         "raft entry proposer signatures verified").add(
            1.0, result="ok" if ok else "bad_entry_sig")
    except Exception:
        pass


class EntryVerifier:
    """Per-channel signed-raft-entry guard.

    Every appended entry must carry a proposer identity that (a)
    deserializes and validates against the channel MSPs, (b) binds — by
    full cert hash, never a CN string — to SOME consenter of THIS
    channel (the proposer may legitimately differ from the transport
    sender: a new leader relays its predecessor's entries), and (c)
    actually signed the (term, index, kind, data) slot.  A second
    payload under the same (term, index, proposer) slot is an
    equivocation crime attributable to the proposer from the entries
    alone: both signatures are self-incriminating, so the evidence is a
    portable fraud proof mintable AT THE ORDERER, no peer witness
    needed.

    Legitimate raft behaviours never trip this: conflict truncation
    replaces a slot under a HIGHER term (different cache key), and
    retransmits carry byte-identical payloads (digest match).
    """

    CACHE_MAX = 1024

    def __init__(self, channel_id: str, msps, consenters):
        self.channel_id = channel_id
        self.msps = msps
        self.bindings = {f"{m}|{f}" for m, f in consenters.values()}
        # (term, index, binding) -> first-seen payload record
        self._seen: Dict[tuple, dict] = {}
        self._order: List[tuple] = []
        # proposer bytes -> (binding, identity): one deserialize per
        # consenter, not per retransmitted entry
        self._idents: Dict[bytes, tuple] = {}
        # signatures this verifier checked (this node's share of
        # orderer_entry_verifies_total, which is process-wide)
        self.verifies = 0

    def set_consenters(self, consenters) -> None:
        """Rebind after a committed membership change.  The proposer
        cache is cleared so a RETIRED consenter's cached (binding,
        identity) cannot keep vouching for its entries — from the commit
        point forward its proposals fail the binding check.  The _seen
        slot cache survives: equivocation evidence keyed by (term,
        index, binding) stays valid across reconfigs."""
        self.bindings = {f"{m}|{f}" for m, f in consenters.values()}
        self._idents.clear()

    def _proposer(self, raw: bytes):
        cached = self._idents.get(raw)
        if cached is not None:
            return cached
        from fabric_tpu_torch.msp import deserialize_from_msps
        ident = deserialize_from_msps(self.msps, raw, validate=True)
        binding = f"{ident.mspid}|{cert_fingerprint(ident.cert)}"
        if binding not in self.bindings:
            raise ValueError(f"proposer {binding} is not a consenter "
                             f"of {self.channel_id!r}")
        if len(self._idents) > self.CACHE_MAX:
            self._idents.clear()
        self._idents[raw] = (binding, ident)
        return binding, ident

    def check(self, entries) -> Tuple[bool, Optional[str], List[dict]]:
        """-> (ok, reject_reason, crimes).  `ok` False rejects the whole
        message (raft retransmits; an honest leader never mixes good and
        bad entries).  `crimes` are equivocation evidence dicts, each
        carrying BOTH signed payloads for independent re-verification."""
        import hashlib
        crimes: List[dict] = []
        for e in entries:
            if not e.sig or not e.proposer:
                return False, "unsigned_entry", crimes
            try:
                binding, ident = self._proposer(e.proposer)
            except Exception as exc:
                logger.warning("[%s] entry %d/%d proposer rejected: %s",
                               self.channel_id, e.term, e.index, exc)
                return False, "bad_proposer", crimes
            digest = hashlib.sha256(
                e.kind.encode() + b"\x00" + e.data).hexdigest()
            key = (e.term, e.index, binding)
            prior = self._seen.get(key)
            if prior is not None and prior["digest"] == digest:
                continue             # retransmit: already verified
            try:
                ok = ident.verify(
                    raftmod.entry_signed_bytes(e.term, e.index, e.data,
                                               e.kind), e.sig)
            except Exception:
                ok = False
            _count_entry_verify(ok)
            self.verifies += 1
            if not ok:
                return False, "bad_entry_sig", crimes
            rec = {"digest": digest, "kind": e.kind, "data": e.data,
                   "sig": e.sig}
            if prior is not None:
                # same slot, same signer, two valid signatures over two
                # different payloads: equivocation, proven by the pair
                crimes.append({
                    "kind": "raft_entry_equivocation",
                    "channel": self.channel_id,
                    "term": e.term, "index": e.index,
                    "binding": binding, "proposer": e.proposer.hex(),
                    "a": {"entry_kind": prior["kind"],
                          "data": prior["data"].hex(),
                          "sig": prior["sig"].hex()},
                    "b": {"entry_kind": e.kind, "data": e.data.hex(),
                          "sig": e.sig.hex()}})
                return False, "entry_equivocation", crimes
            self._seen[key] = rec
            self._order.append(key)
            while len(self._order) > self.CACHE_MAX:
                self._seen.pop(self._order.pop(0), None)
        return True, None, crimes


class ClusterService:
    """Drives the node's RaftChains over the network — MULTI-CHANNEL:
    each channel's chain is registered under its id and raft messages
    carry the channel tag (the reference's cluster comm dispatches by
    channel + sender cert, orderer/common/cluster/comm.go:116).

    peers: raft node id -> (host, port).  The service registers the
    `raft.step` cast on the node's RpcServer and runs a driver thread:
      every tick_ms: per-chain election/heartbeat tick + batch-timeout
      tick; after every step/tick: process_ready() and ship outbound
      messages.
    """

    def __init__(self, rpc: RpcServer, signer, msps,
                 peers: Dict[int, Tuple[str, int]],
                 tick_s: float = 0.05,
                 consenters: Dict[int, Tuple[str, str]] = None,
                 chain=None, channel_id: str = None):
        self.chains: Dict[str, object] = {}
        self.rpc = rpc
        self.signer = signer
        self.msps = msps
        self.peers = dict(peers)
        # consenter authorization: raft id -> (mspid, sha256 cert
        # fingerprint).  MANDATORY — without it any channel member could
        # forge raft traffic claiming to be a consenter (cluster/comm.go
        # authenticates the sender's actual cert against the consenter
        # set).  Bound to the full cert hash, not a forgeable CN string.
        # This map is the BOOTSTRAP-channel set; channels registered via
        # add_chain may carry their own set (the reference keys consenter
        # authorization per channel, cluster/comm.go stub-per-channel) —
        # a node authorized on one channel is NOT thereby authorized to
        # step raft on another.
        if not consenters:
            raise ValueError(
                "ClusterService requires the consenter identity map "
                "(raft id -> (mspid, cert sha256)); refusing to run an "
                "unauthenticated raft transport")
        self.consenters = dict(consenters)
        self.tick_s = tick_s
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._drive, daemon=True)
        # per-channel overrides: channel -> (consenters map, peer addrs)
        self._chan_consenters: Dict[str, Dict[int, Tuple[str, str]]] = {}
        self._chan_peers: Dict[str, Dict[int, Tuple[str, int]]] = {}
        # signed-entry enforcement, per channel: installed by add_chain
        # only when the channel's own chain signs its entries (legacy /
        # test chains without an entry signer stay unenforced)
        self._verifiers: Dict[str, EntryVerifier] = {}
        # byzantine hooks (wired by the owning node, both optional):
        #   on_entry_offense(channel_id, frm_node, reason)
        #   on_entry_crime(channel_id, binding, evidence)
        self.on_entry_offense = None
        self.on_entry_crime = None
        # per-ADDRESS sender threads (shared across channels): dial/retry
        # must never block the raft clock (a blackholed peer would
        # otherwise starve heartbeats)
        self._senders: Dict[Tuple[str, int], _PeerSender] = {}
        with self._lock:
            for nid, addr in self.peers.items():
                self._sender_for(tuple(addr))
        rpc.serve_cast("raft.step", self._on_step)
        if chain is not None:
            self.add_chain(channel_id or "ch", chain)

    def _sender_for(self, addr: Tuple[str, int]) -> Optional["_PeerSender"]:
        """Get-or-create the sender thread for an address.  Callers must
        hold self._lock (dynamic growth from add_chain/_send).  Returns
        None once the service is stopping."""
        if self._stop.is_set():
            return None
        addr = tuple(addr)
        sender = self._senders.get(addr)
        if sender is None:
            sender = _PeerSender(0, addr, self.signer, self.msps)
            self._senders[addr] = sender
        return sender

    def peers_for(self, channel_id: str) -> Dict[int, Tuple[str, int]]:
        """THIS channel's raft-id -> address map (bootstrap fallback)."""
        with self._lock:
            return dict(self._chan_peers.get(channel_id, self.peers))

    def consenter_binding(self, channel_id: str,
                          raft_id: int) -> Optional[str]:
        """'mspid|cert-sha256' quarantine key for a channel consenter,
        or None for an unknown raft id."""
        with self._lock:
            consenters = self._chan_consenters.get(channel_id,
                                                   self.consenters)
        ent = consenters.get(raft_id)
        if ent is None:
            return None
        return f"{ent[0]}|{ent[1]}"

    # -- chain registry (multichannel/registrar.go dynamic chains) -----------

    def add_chain(self, channel_id: str, chain,
                  consenters: Dict[int, Tuple[str, str]] = None,
                  peers: Dict[int, Tuple[str, int]] = None) -> None:
        """Register a channel's chain.  `consenters`/`peers` are that
        CHANNEL's consenter identity map and node addresses; when omitted
        the bootstrap channel's maps apply (single-channel deployments)."""
        with self._lock:
            self.chains[channel_id] = chain
            if consenters is not None:
                self._chan_consenters[channel_id] = dict(consenters)
            if peers is not None:
                self._chan_peers[channel_id] = {
                    nid: tuple(a) for nid, a in peers.items()}
            for addr in (peers or self.peers).values():
                self._sender_for(tuple(addr))
            node = getattr(chain, "node", None)
            if getattr(node, "entry_signer", None) is not None:
                self._verifiers[channel_id] = EntryVerifier(
                    channel_id, self.msps,
                    consenters if consenters is not None
                    else self.consenters)
        self._wake.set()

    def update_membership(self, channel_id: str,
                          consenters: Dict[int, Tuple[str, str]],
                          peers: Dict[int, Tuple[str, int]]) -> None:
        """Atomically swap a channel's consenter identity map + peer
        address map and rebind its EntryVerifier — called when a
        membership config entry COMMITS (never on mere proposal).  One
        lock scope so _on_step can never observe a new consenter set
        with a stale verifier (or vice versa): a removed consenter's
        messages are rejected at the consenter-lookup gate and its
        entries at the binding check from the same instant.

        Outbound ADDRESSES merge instead of replacing: the address map
        is plumbing, not authorization (inbound is gated on the
        consenter map above), and the leader's farewell append to a
        just-removed server — the one message that lets it observe its
        own removal and self-evict — must still be deliverable after
        the commit that removed it.  Nothing else addresses a node
        outside the raft node set, so a retired address is inert; a
        re-added node id takes the fresh address."""
        with self._lock:
            self._chan_consenters[channel_id] = dict(consenters)
            merged = dict(self._chan_peers.get(channel_id, {}))
            merged.update({nid: tuple(a) for nid, a in peers.items()})
            self._chan_peers[channel_id] = merged
            verifier = self._verifiers.get(channel_id)
            if verifier is not None:
                verifier.set_consenters(consenters)
            for addr in peers.values():
                self._sender_for(tuple(addr))
        self._wake.set()

    def remove_chain(self, channel_id: str) -> None:
        with self._lock:
            self.chains.pop(channel_id, None)
            self._chan_consenters.pop(channel_id, None)
            self._chan_peers.pop(channel_id, None)
            self._verifiers.pop(channel_id, None)

    @property
    def chain(self):
        """Single-channel convenience: the only (or first) chain."""
        with self._lock:
            for ch in self.chains.values():
                return ch
        return None

    # -- inbound -------------------------------------------------------------

    def _on_step(self, body: dict, peer_identity) -> None:
        msg = msg_from_dict(body["msg"])
        channel_id = body.get("channel", "ch")
        with self._lock:
            chain = self.chains.get(channel_id)
            consenters = self._chan_consenters.get(channel_id,
                                                   self.consenters)
            peers = self._chan_peers.get(channel_id, self.peers)
        if chain is None:
            return       # unknown channel (not yet joined): drop
        if msg.frm not in peers and msg.frm != chain.node.id:
            logger.warning("raft message from unknown node %s", msg.frm)
            return
        # authorization is per CHANNEL: the sender must be in THIS
        # channel's consenter set (not merely some channel's)
        expected = consenters.get(msg.frm)
        if expected is None:
            logger.warning("[%s] raft message from non-consenter node %s "
                           "— dropped", channel_id, msg.frm)
            return
        mspid, fp = expected
        got_msp = getattr(peer_identity, "mspid", None)
        got_fp = cert_fingerprint(peer_identity.cert)
        if got_msp != mspid or got_fp != fp:
            logger.warning(
                "raft message claiming node %s from identity %s/%s... — "
                "dropped (consenter authorization)", msg.frm, got_msp,
                got_fp[:16])
            return
        with self._lock:
            verifier = self._verifiers.get(channel_id)
        if verifier is not None and msg.entries:
            ok, reason, crimes = verifier.check(msg.entries)
            for ev in crimes:
                logger.warning(
                    "[%s] raft entry equivocation by %s at term=%d "
                    "index=%d — fraud proof minted at the orderer",
                    channel_id, ev["binding"], ev["term"], ev["index"])
                if self.on_entry_crime is not None:
                    try:
                        self.on_entry_crime(channel_id, ev["binding"], ev)
                    except Exception:
                        logger.exception("entry-crime hook failed")
            if not ok:
                logger.warning(
                    "[%s] raft append from node %s rejected: %s",
                    channel_id, msg.frm, reason)
                if self.on_entry_offense is not None:
                    try:
                        self.on_entry_offense(channel_id, msg.frm, reason)
                    except Exception:
                        logger.exception("entry-offense hook failed")
                return
        chain.step(msg)
        self._wake.set()

    # -- outbound ------------------------------------------------------------

    def _send(self, channel_id: str, msg: raftmod.Message) -> None:
        with self._lock:
            peers = self._chan_peers.get(channel_id, self.peers)
            addr = peers.get(msg.to)
            sender = self._sender_for(addr) if addr is not None else None
        if sender is not None:
            sender.enqueue({"channel": channel_id,
                            "msg": msg_to_dict(msg)})

    # -- driver --------------------------------------------------------------

    def start(self) -> "ClusterService":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=2.0)
        # snapshot under the lock: _senders grows dynamically (_send /
        # add_chain), and _sender_for refuses creation once _stop is set
        with self._lock:
            senders = list(self._senders.values())
        for s in senders:
            s.stop()
        for s in senders:
            s.join()

    def _drive(self) -> None:
        last_tick = time.monotonic()
        while not self._stop.is_set():
            self._wake.wait(timeout=self.tick_s / 2)
            self._wake.clear()
            now = time.monotonic()
            do_tick = now - last_tick >= self.tick_s
            if do_tick:
                last_tick = now
            with self._lock:
                chains = list(self.chains.items())
            for channel_id, chain in chains:
                if do_tick:
                    try:
                        chain.tick()
                    except Exception:
                        logger.exception("[%s] raft tick failed", channel_id)
                    try:
                        chain.tick_batch(now)
                    except Exception:
                        logger.exception("[%s] batch tick failed", channel_id)
                try:
                    ready = chain.process_ready()
                except Exception:
                    logger.exception("[%s] process_ready failed", channel_id)
                    continue
                for m in ready.messages:
                    self._send(channel_id, m)
