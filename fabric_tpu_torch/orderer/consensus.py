"""Consenter chains: the ordering state machines.

Reference parity: orderer/consensus/consensus.go Chain interface
(Order/Configure/WaitReady/Start/Halt) and orderer/consensus/solo —
a single-node chain that cuts batches by count/bytes/timeout and hands
them to the block writer.  The Raft-replicated chain lives in
fabric_tpu_torch/orderer/raft.py + RaftChain below it in registrar wiring.

Counterpart of `fabric_tpu/orderer/consensus.py`, whole, on the port's
imports.  `RaftChain` builds and signs each block at apply time on every
node, so block numbers and data hashes agree across orderers of either
package.  Entry and block signing stay on the host.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from fabric_tpu_torch.ops_plane import tracing
from fabric_tpu_torch.orderer.blockcutter import BatchConfig, BlockCutter
from fabric_tpu_torch.orderer.blockwriter import BlockWriter
from fabric_tpu_torch.protocol import Envelope


class ChainHaltedError(Exception):
    pass


class Chain:
    """consensus.Chain — what broadcast dispatches into."""

    def order(self, env: Envelope) -> None:
        raise NotImplementedError

    def configure(self, env: Envelope) -> None:
        raise NotImplementedError

    def start(self) -> None:
        pass

    def halt(self) -> None:
        pass


class SoloChain(Chain):
    """Single-consenter dev chain (orderer/consensus/solo/consensus.go).

    Envelopes are cut into blocks synchronously by count/bytes; the batch
    timeout is enforced either by `tick(now)` (deterministic tests) or by
    the optional background timer thread started with `start()`.
    Config envelopes always cut the pending batch first and are written
    as single-tx config blocks, mirroring solo's main loop.
    """

    def __init__(self, cutter: BlockCutter, writer: BlockWriter,
                 on_block: Optional[Callable] = None):
        self.cutter = cutter
        self.writer = writer
        self.on_block = on_block or (lambda block: None)
        self._lock = threading.RLock()
        self._halted = False
        self._timer: Optional[threading.Thread] = None
        self._batch_deadline: Optional[float] = None

    # -- Chain interface ----------------------------------------------------

    def order(self, env: Envelope) -> None:
        with self._lock:
            self._check_running()
            batches, pending = self.cutter.ordered(env)
            for batch in batches:
                self._write(batch)
            self._restart_deadline(bool(batches), pending)

    def configure(self, env: Envelope) -> None:
        with self._lock:
            self._check_running()
            pending = self.cutter.cut()
            if pending:
                self._write(pending)
            self._write([env.serialize()], is_config=True)
            self._batch_deadline = None

    def tick(self, now: Optional[float] = None) -> bool:
        """Cut the pending batch if the batch timeout expired; returns
        whether a block was written."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._halted or self._batch_deadline is None \
                    or now < self._batch_deadline:
                return False
            batch = self.cutter.cut()
            self._batch_deadline = None
            if not batch:
                return False
            self._write(batch)
            return True

    def start(self) -> None:
        if self._timer is not None:
            return
        self._halted = False

        def loop():
            while not self._halted:
                time.sleep(self.cutter.config.batch_timeout_s / 4)
                self.tick()

        self._timer = threading.Thread(target=loop, daemon=True)
        self._timer.start()

    def halt(self) -> None:
        with self._lock:
            self._halted = True
        if self._timer is not None:
            self._timer.join(timeout=2)
            self._timer = None

    # -- internals ----------------------------------------------------------

    def _check_running(self) -> None:
        if self._halted:
            raise ChainHaltedError("chain is halted")

    def _restart_deadline(self, cut_happened: bool, pending: bool) -> None:
        """The batch timer restarts on every cut (the reference resets its
        timer whenever a batch is cut); it only keeps running for an
        already-pending batch when nothing was cut."""
        if not pending:
            self._batch_deadline = None
        elif cut_happened or self._batch_deadline is None:
            self._batch_deadline = (time.monotonic()
                                    + self.cutter.config.batch_timeout_s)

    def _write(self, batch: List[bytes], is_config: bool = False) -> None:
        # consensus cut: spans only when ordered under a traced broadcast
        # (timer-thread cuts have no ambient context and record nothing)
        with tracing.tracer.start_span(
                "orderer.cut_block", require_parent=True,
                attributes={"batch_size": len(batch),
                            "is_config": is_config}) as span:
            block = self.writer.create_next_block(batch)
            if span.recording:
                span.set_attribute("block", int(block.header.number))
            self.writer.write_block(block, is_config=is_config)
            self.on_block(block)


# ---------------------------------------------------------------------------
# Raft-replicated chain (orderer/consensus/etcdraft/chain.go equivalent)

META_RAFT_INDEX = "raft_index"


def make_entry_signer(signer):
    """Build a RaftNode entry_signer from a consenter signing identity:
    returns (serialized identity, signature over the canonical entry
    bytes) — what EntryVerifier checks on the receiving side."""
    from fabric_tpu_torch.orderer import raft as raftmod
    raw = signer.serialize()

    def sign(term: int, index: int, data: bytes, kind: str):
        return raw, signer.sign(
            raftmod.entry_signed_bytes(term, index, data, kind))

    return sign


class RaftChain(Chain):
    """Crash-fault-tolerant ordering over fabric_tpu_torch.orderer.raft.

    Design deviation from the reference (etcdraft/chain.go:378,782): the
    leader proposes the *cut batch* (serialized envelopes + config flag),
    not a pre-built block; every node deterministically builds + signs the
    block at apply time.  Same total order => same block numbers and data
    hashes on every node, with no in-flight block-number tracking and no
    leader-change block reconstruction.

    Replay idempotency: each block records the raft entry index that
    produced it; on restart, re-delivered committed entries at or below
    the recovered index are skipped (the ledger *is* the applied-state
    checkpoint, mirroring SURVEY.md §5 checkpoint/resume).
    """

    def __init__(self, node, cutter: BlockCutter, writer: BlockWriter,
                 on_block: Optional[Callable] = None, entry_signer=None,
                 on_conf: Optional[Callable] = None):
        from fabric_tpu_torch.utils import serde as _serde
        self._serde = _serde
        self.node = node
        self.cutter = cutter
        self.writer = writer
        # membership hook: called with the decoded conf payload
        # ({"op","node",...}) each time a membership entry COMMITS.  Conf
        # entries do not advance _last_applied, so they replay on restart
        # — the hook MUST be idempotent.
        self.on_conf = on_conf or (lambda conf: None)
        # consenter entry signing (round 14): install the signer on the
        # raft node so every local append — proposals, conf changes, the
        # new-leader no-op — carries (proposer, sig); the cluster service
        # enforces the chain on channels whose own chain signs
        if entry_signer is not None:
            node.entry_signer = entry_signer
        self.on_block = on_block or (lambda block: None)
        self._lock = threading.RLock()
        self._halted = False
        self._batch_deadline: Optional[float] = None
        self._last_applied = self._recover_applied_index()
        self.catchup_target: Optional[dict] = None  # set on snapshot install
        self._held_entries: List = []  # entries arriving while catching up
        node.snapshot_data = self._snapshot_state
        # crash window: snapshot installed but catch_up never ran.  The
        # node's persisted snapshot state knows the cluster ledger height;
        # if our ledger is shorter we must re-enter catch-up, else entries
        # after snap_index would land at wrong block numbers.
        if node.snap_data:
            self._maybe_enter_catchup(node.snap_data, fallback_index=0)

    def _recover_applied_index(self) -> int:
        lg = self.writer.ledger
        if lg.height == 0:
            return 0
        tip = lg.get_by_number(lg.height - 1)
        return int(tip.metadata.items.get(META_RAFT_INDEX, 0))

    def _snapshot_state(self, index: int) -> bytes:
        # called from node.maybe_compact() AFTER process_ready applied all
        # entries <= index, so _last_applied/height describe state AT index
        return self._serde.encode({
            "raft_index": self._last_applied,
            "height": self.writer.height,
        })

    # -- Chain interface ----------------------------------------------------

    def order(self, env: Envelope) -> None:
        with self._lock:
            self._check_running()
            self._check_leader()  # followers redirect Submit (chain.go:378)
            batches, pending = self.cutter.ordered(env)
            for batch in batches:
                self._propose(batch, is_config=False)
            self._restart_deadline(bool(batches), pending)

    def configure(self, env: Envelope) -> None:
        with self._lock:
            self._check_running()
            self._check_leader()
            pending = self.cutter.cut()
            if pending:
                self._propose(pending, is_config=False)
            self._propose([env.serialize()], is_config=True)
            self._batch_deadline = None

    def _check_leader(self) -> None:
        from fabric_tpu_torch.orderer import raft as raftmod
        if self.node.role != raftmod.LEADER:
            raise raftmod.NotLeaderError(self.node.leader_id)

    def propose_membership(self, op: str, node_id: int, **meta) -> int:
        """Propose an add/remove-consenter config entry through the log
        (leader only).  Returns the entry's raft index; the change takes
        effect — on every replica, including this one — when the entry
        commits and on_conf fires."""
        with self._lock:
            self._check_running()
            self._check_leader()
            return self.node.propose_conf(op, node_id, **meta)

    def transfer_leadership(self, to: int) -> bool:
        """Ask raft to hand leadership to `to` (drain path)."""
        with self._lock:
            return self.node.transfer_leadership(to)

    def tick_batch(self, now: Optional[float] = None) -> bool:
        """Cut + propose the pending batch when the batch timeout fires."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._halted or self._batch_deadline is None \
                    or now < self._batch_deadline:
                return False
            batch = self.cutter.cut()
            self._batch_deadline = None
            if not batch:
                return False
            from fabric_tpu_torch.orderer import raft as raftmod
            try:
                self._propose(batch, is_config=False)
            except raftmod.NotLeaderError:
                # deposed between the deadline being set and firing: the
                # batch is discarded (clients retry against the new leader)
                return False
            return True

    def halt(self) -> None:
        with self._lock:
            self._halted = True

    def _check_running(self) -> None:
        if self._halted:
            raise ChainHaltedError("chain is halted")

    _restart_deadline = SoloChain._restart_deadline

    # -- raft plumbing -------------------------------------------------------
    # RaftNode has no internal locking; every access — propose (via
    # order/configure), transport-driven step, clock-driven tick, and the
    # ready drain — must hold self._lock.  Transports call chain.step, not
    # node.step.

    def step(self, msg) -> None:
        with self._lock:
            self.node.step(msg)

    def tick(self) -> None:
        """Advance the raft election/heartbeat clock."""
        with self._lock:
            self.node.tick()

    def _propose(self, batch, is_config: bool) -> None:
        with tracing.tracer.start_span(
                "orderer.cut_propose", require_parent=True,
                attributes={"batch_size": len(batch),
                            "is_config": is_config}):
            self.node.propose(self._serde.encode(
                {"cfg": is_config, "batch": list(batch)}))

    def process_ready(self):
        """Drain the raft node: apply committed entries to the ledger and
        return the outbound messages for the cluster transport to send."""
        from fabric_tpu_torch.orderer import raft as raftmod
        with self._lock:
            r = self.node.take_ready()
            if r.lost_leadership:
                # discard the pending batch and stop the batch timer
                # (reference etcdraft chain.go:604-607 becomeFollower):
                # stale envelopes must not be proposed if leadership is
                # later regained, and the timer path must not fire.
                self.cutter.cut()
                self._batch_deadline = None
            for e in r.committed:
                if e.kind == raftmod.ENTRY_SNAPSHOT:
                    self._on_snapshot_entry(e)
                elif e.kind == raftmod.ENTRY_NORMAL:
                    self._apply(e)
                elif e.kind == raftmod.ENTRY_CONF:
                    # the raft-internal effect (node set change) already
                    # ran inside take_ready; surface the full payload so
                    # the owning node can follow — consenter identity
                    # maps, transport addresses, persisted channel state
                    try:
                        self.on_conf(self._serde.decode(e.data))
                    except Exception:
                        import logging
                        logging.getLogger(
                            "fabric_tpu_torch.orderer.consensus").exception(
                            "membership conf hook failed")
            # compact only after the entries above hit the ledger — and
            # never while catching up, when _last_applied/height lag the
            # raft applied index and would bake stale state into the snap
            if self.catchup_target is None:
                self.node.maybe_compact()
        return r

    def _apply(self, entry) -> None:
        if self.catchup_target is not None:
            # ledger is behind the snapshot: hold entries until the missing
            # blocks arrive (replication), else block numbers would skew
            self._held_entries.append(entry)
            return
        if entry.index <= self._last_applied:
            return  # replayed on restart; ledger already has the block
        if not entry.data:
            # leader-change no-op entry (raft _become_leader): no block
            self._last_applied = entry.index
            return
        d = self._serde.decode(entry.data)
        block = self.writer.create_next_block(d["batch"])
        block.metadata.items[META_RAFT_INDEX] = entry.index
        self.writer.write_block(block, is_config=d["cfg"])
        self._last_applied = entry.index
        self.on_block(block)

    def _on_snapshot_entry(self, e) -> None:
        """A snapshot was installed: this node is behind the compacted log
        and must catch up its *ledger* from a peer (the reference's
        orderer/common/cluster/replication.go pull path)."""
        self._maybe_enter_catchup(e.data, fallback_index=e.index)

    def _maybe_enter_catchup(self, state_bytes: bytes,
                             fallback_index: int) -> None:
        """Decode chain snapshot state; if the cluster ledger is ahead of
        ours, enter catch-up.  Tolerates opaque/non-dict app state (raw
        RaftNode snapshots) by doing nothing."""
        try:
            state = self._serde.decode(state_bytes) if state_bytes else {}
        except ValueError:
            return
        if not isinstance(state, dict):
            return
        self._last_applied = max(
            self._last_applied, int(state.get("raft_index", fallback_index)))
        if int(state.get("height", 0)) > self.writer.ledger.height:
            self.catchup_target = state

    def catch_up(self, blocks) -> None:
        """Install blocks fetched from a peer (replication.go equivalent)."""
        with self._lock:
            for block in blocks:
                if block.header.number < self.writer.ledger.height:
                    continue
                self.writer.ledger.add_block(block)
            self.writer.resync()
            # the installed tip's raft index supersedes the snapshot's, or
            # re-delivered entries would re-apply as duplicate blocks
            self._last_applied = max(self._last_applied,
                                     self._recover_applied_index())
            if self.catchup_target and \
                    self.writer.ledger.height >= self.catchup_target["height"]:
                self.catchup_target = None
                held, self._held_entries = self._held_entries, []
                for entry in held:
                    self._apply(entry)
