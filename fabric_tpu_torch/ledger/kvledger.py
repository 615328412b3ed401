"""The channel ledger: block store + state DB + history DB, committed in
lock-step with crash recovery.

Reference parity: core/ledger/kvledger/kv_ledger.go —
  CommitLegacy (:425-508): MVCC validate-and-prepare (:452), commit-hash
  chaining (:459-465), block+pvtdata store (:470), state DB (:477),
  history DB (:487), with per-phase timing metrics (:491-499);
  recovery.go: replay blocks above each DB's savepoint on open;
  rebuild_dbs.go / reset.go / rollback.go admin operations.

The block store is the source of truth; state/history are derived and
self-heal on open (recoverDBs).

Counterpart of `fabric_tpu/ledger/kvledger.py`, whole: the serial
commit, the fused device validation's prepared-batch hand-off
(`set_prepared_source`), the wavefront parallel commit
(`parallel_commit`), the cross-block commit window (`commit_window`:
`pending_overlay`, `commit_begin`, `commit_finish`, `abort_window`),
`snapshot_export`, a durable ledger under `LedgerConfig.root` with its
recovery on open, and the admin operations.  The directory each writes
is the reference's, byte for byte.  `LedgerConfig` takes every field
the reference's does, with the same defaults.  The apply sizes go to
the ops plane as the reference's do (`_observe_apply`).
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from fabric_tpu_torch.protocol import Block
from fabric_tpu_torch.protocol.txflags import TxFlags
from fabric_tpu_torch.protocol.types import META_COMMIT_HASH, META_TXFLAGS

from .blkstorage import BlockStore
from .historydb import HistoryDB
from .mvcc import validate_and_prepare_batch
from .statedb import StateDB

logger = logging.getLogger("fabric_tpu_torch.ledger")


def _safe_envelopes(block: Block):
    """Deserialize leniently: undecodable entries become None — they carry
    a non-VALID flag already, so MVCC never touches them."""
    from fabric_tpu_torch.protocol import Envelope
    out = []
    for raw in block.data:
        try:
            out.append(Envelope.deserialize(raw))
        except Exception:
            out.append(None)
    return out


def _history_writes_from_flags(envelopes, flags: TxFlags):
    """History records of a block's VALID txs, trusting the stored flags
    (used on replay when MVCC must not re-run)."""
    from fabric_tpu_torch.ledger.mvcc import parse_endorser_tx
    history = []
    for tx_num, env in enumerate(envelopes):
        if env is None or not flags.is_valid(tx_num):
            continue
        try:
            parsed = parse_endorser_tx(env)
        except Exception:
            continue
        if parsed is None:
            continue
        txid, rwset = parsed
        for ns_rw in rwset.ns_rwsets:
            for w in ns_rw.writes:
                history.append((tx_num, txid, ns_rw.namespace, w.key,
                                w.value, w.is_delete))
    return history


@dataclass
class LedgerConfig:
    root: Optional[str] = None          # None = fully in-memory
    enable_history: bool = True
    snapshot_every: int = 256
    # key-hash stripe width for the state plane (statedb + historydb):
    # independently locked + independently flushable shards; 1 = the
    # flat store (differential oracle)
    state_shards: int = 8
    # parallel MVCC commit plane (committer/parallel_commit/): wavefront
    # scheduler replaces the serial validate_and_prepare_batch walk —
    # bit-identical output, enforced differentially.  Must be configured
    # uniformly across the peers of a channel only as an operational
    # convention (the OUTPUT is identical; only timing differs).
    parallel_commit: bool = False
    commit_workers: int = 4             # static cap on the worker pool
    # adaptive sizing: the pool tracks the rolling max conflict-graph
    # wave width, clamped to commit_workers (scheduler.target_workers)
    commit_adaptive: bool = True
    # serial fallback: run the oracle walk directly (and count it) when
    # the wave machinery cannot pay off — 1-core host, or the adaptive
    # pool would provision a single worker anyway.  Differential tests
    # that must exercise the wave path set this False.
    commit_serial_fallback: bool = True
    # cross-block wavefront pipelining (committer/parallel_commit
    # CommitWindow): W > 0 enables the commit_begin/commit_finish entry
    # points with at most W blocks admitted-but-unretired.  The serial
    # commit() stays available (and is the differential oracle) but
    # refuses to run while window blocks are in flight.  Output is
    # bit-identical to serial commits of the same stream; only timing
    # differs.  0 = disabled.
    commit_window: int = 0
    # fused device validation (committer/device_validate.py): commit()
    # consumes the validator's prepared UpdateBatch via the registered
    # prepared-source instead of re-running host MVCC — the flags in
    # block metadata and the statedb savepoint must still match what
    # the device validated against, else host MVCC runs (always safe).
    # Default OFF until parity is proven per deployment.
    device_validate: bool = False


@dataclass
class CommitStats:
    """Per-phase timings (kv_ledger.go:491-499 metric parity)."""
    block_num: int = 0
    state_validation_s: float = 0.0
    block_commit_s: float = 0.0
    state_commit_s: float = 0.0
    history_commit_s: float = 0.0
    valid_txs: int = 0
    total_txs: int = 0


class KVLedger:
    def __init__(self, channel_id: str, config: Optional[LedgerConfig] = None):
        self.channel_id = channel_id
        self.config = config or LedgerConfig()
        root = self.config.root
        bdir = sdir = hdir = None
        if root is not None:
            base = os.path.join(root, channel_id)
            bdir = os.path.join(base, "blocks")
            sdir = os.path.join(base, "state")
            hdir = os.path.join(base, "history")
        self.blockstore = BlockStore(bdir)
        self.statedb = self._new_statedb(sdir)
        self.historydb = (self._new_historydb(hdir)
                          if self.config.enable_history else None)
        self._commit_hash = b"\x00" * 32
        self.last_stats = CommitStats()
        # set by _recover: how much work reopening this ledger cost
        self.last_recovery: Dict[str, int] = {
            "replayed_blocks": 0, "start": 0, "height": 0}
        # DeviceValidator.take_prepared when device_validate is wired:
        # (number, flags_bytes, savepoint) -> (final_flags, batch,
        # history) | None
        self._prepared_source = None
        self._commit_scheduler = None
        if self.config.parallel_commit:
            # function-level import: ledger <- committer.parallel_commit
            # <- ledger.mvcc would otherwise cycle at module load
            from fabric_tpu_torch.committer.parallel_commit import (
                ParallelCommitScheduler)
            self._commit_scheduler = ParallelCommitScheduler(
                max_workers=self.config.commit_workers,
                channel_id=channel_id,
                adaptive=self.config.commit_adaptive,
                serial_fallback=self.config.commit_serial_fallback)
        self._commit_window = None
        if self.config.commit_window > 0:
            from fabric_tpu_torch.committer.parallel_commit import (
                CommitWindow)
            self._commit_window = CommitWindow(
                channel_id=channel_id,
                max_window=self.config.commit_window)
        # serializes commit_finish calls (one finishing thread is the
        # intended shape; the lock makes a second one safe, not fast)
        self._finish_lock = threading.Lock()
        self._recover()

    # -- recovery (recovery.go) --------------------------------------------

    def _new_statedb(self, sdir: Optional[str]) -> StateDB:
        return StateDB(sdir, snapshot_every=self.config.snapshot_every,
                       n_shards=self.config.state_shards,
                       channel=self.channel_id)

    def _new_historydb(self, hdir: Optional[str]) -> HistoryDB:
        return HistoryDB(hdir, n_shards=self.config.state_shards,
                         checkpoint_every=self.config.snapshot_every,
                         channel=self.channel_id)

    def _recover(self) -> None:
        """Replay blocks above each derived DB's savepoint (bounded to
        the post-checkpoint tail now that the derived DBs checkpoint)."""
        height = self.blockstore.height
        base = self.blockstore.base
        self.last_recovery = {"replayed_blocks": 0, "start": height,
                              "height": height}
        if height == 0:
            return
        # restore the commit-hash chain: from the last block's metadata
        # when stored, else from the snapshot-bootstrap marker (a freshly
        # installed snapshot has base == height, no blocks yet)
        if height - 1 >= base:
            last = self.blockstore.get_by_number(height - 1)
            self._commit_hash = last.metadata.items.get(
                META_COMMIT_HASH, b"\x00" * 32)
        elif self.blockstore.bootstrap_commit_hash is not None:
            self._commit_hash = self.blockstore.bootstrap_commit_hash
        # replay from the LOWEST derived-DB savepoint: a crash between the
        # state commit and the history commit leaves history one block
        # behind, and both commits are idempotent via their savepoint guards
        savepoints = [self.statedb.savepoint]
        if self.historydb is not None:
            savepoints.append(self.historydb.savepoint)
        lowest = min((-1 if sp is None else sp) for sp in savepoints)
        start = lowest + 1
        if start < base:
            # blocks below the snapshot base are pruned; the installed
            # state checkpoint is the only source for them.  If a derived
            # DB lost its checkpoint this replay CANNOT reconstruct the
            # pre-snapshot writes — re-bootstrap from a serving peer.
            logger.warning(
                "%s: derived-DB savepoint %d below snapshot base %d — "
                "pre-snapshot history is pruned; replaying from base",
                self.channel_id, lowest, base)
            start = base
        replayed = 0
        for num in range(start, height):
            block = self.blockstore.get_by_number(num)
            self._apply_derived(block)
            replayed += 1
            logger.info("%s: recovered block %d into state/history",
                        self.channel_id, num)
        self.last_recovery = {"replayed_blocks": replayed, "start": start,
                              "height": height}

    def _apply_derived(self, block: Block) -> None:
        """Recovery replay of one stored block (final txflags in metadata)
        into the derived DBs.  If the block is already in the state DB
        (<= its savepoint), MVCC must NOT re-run — the state already
        contains this block's writes and every read would falsely
        conflict; the stored flags are authoritative, so history writes
        are extracted directly from the VALID txs."""
        num = block.header.number
        flags = TxFlags.from_bytes(block.metadata.items[META_TXFLAGS])
        envelopes = _safe_envelopes(block)
        state_has_it = (self.statedb.savepoint is not None
                        and num <= self.statedb.savepoint)
        if state_has_it:
            history = _history_writes_from_flags(envelopes, flags)
        else:
            batch, history = self._validate_and_prepare(
                num, envelopes, flags)
            self.statedb.apply_updates(batch, num)
        if self.historydb is not None:
            self.historydb.commit(num, history)  # savepoint-guarded, idempotent

    def set_prepared_source(self, fn) -> None:
        """Register the device validator's prepared-batch source
        (DeviceValidator.take_prepared).  None unregisters."""
        self._prepared_source = fn

    def _take_prepared(self, block: Block):
        """(final_flags_bytes, batch, history) from the device
        validator's stash, or None when absent/stale (host MVCC runs)."""
        if self._prepared_source is None or not self.config.device_validate:
            return None
        try:
            return self._prepared_source(
                block.header.number,
                block.metadata.items[META_TXFLAGS],
                self.statedb.savepoint)
        except Exception:
            logger.exception("prepared-batch source failed; "
                             "falling back to host MVCC")
            return None

    def _validate_and_prepare(self, num: int, envelopes, flags: TxFlags):
        """MVCC pass: the wavefront scheduler when parallel_commit is
        on, the serial oracle otherwise — identical output either way."""
        if self._commit_scheduler is not None:
            return self._commit_scheduler.validate_and_prepare_batch(
                self.statedb, num, envelopes, flags)
        return validate_and_prepare_batch(self.statedb, num,
                                          envelopes, flags)

    _APPLY_BUCKETS = (1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0,
                      16384.0, float("inf"))

    def _observe_apply(self, n_state: int, n_history: int) -> None:
        try:
            from fabric_tpu_torch.ops_plane import registry
            h = registry.histogram(
                "commit_graph_apply_batch_size",
                "coalesced per-block apply sizes (keys / history rows)",
                buckets=self._APPLY_BUCKETS)
            h.observe(float(n_state), db="state", channel=self.channel_id)
            h.observe(float(n_history), db="history",
                      channel=self.channel_id)
        except Exception:
            pass


    # -- commit (kv_ledger.go:425-508) -------------------------------------

    def commit(self, block: Block) -> CommitStats:
        """Commit a block whose metadata txflags were finalized by the
        txvalidator.  MVCC runs here (ValidateAndPrepare), then the
        commit-hash chains, then block store, state, history."""
        if self.paused:
            raise RuntimeError(
                f"channel {self.channel_id!r} is paused (resume() first)")
        if self._commit_window is not None and self._commit_window.depth():
            raise RuntimeError(
                "serial commit while the pipelined window has blocks in "
                "flight (commit_finish them or abort_window() first)")
        if META_TXFLAGS not in block.metadata.items:
            raise ValueError("block metadata missing txflags "
                             "(txvalidator must run first)")
        # reject wrong-numbered / wrong-parent blocks BEFORE any state
        # (incl. the commit-hash chain) advances — duplicate or out-of-order
        # delivery is normal under gossip and must leave the ledger untouched
        info = self.blockstore.chain_info()
        if block.header.number != info.height:
            raise ValueError(
                f"out-of-order commit: got block {block.header.number}, "
                f"expected {info.height}")
        expected_prev = info.current_hash if info.height else b"\x00" * 32
        if block.header.previous_hash != expected_prev:
            raise ValueError(
                f"block {block.header.number} previous_hash mismatch")
        stats = CommitStats(block_num=block.header.number,
                            total_txs=len(block.data))

        t0 = time.perf_counter()
        prepared = self._take_prepared(block)
        if prepared is not None:
            # fused device validation already ran MVCC in the
            # validator's single dispatch: consume the prepared batch —
            # no envelope materialization, no host MVCC walk
            final_bytes, batch, history = prepared
            flags = TxFlags.from_bytes(final_bytes)
        else:
            flags = TxFlags.from_bytes(block.metadata.items[META_TXFLAGS])
            envelopes = _safe_envelopes(block)
            batch, history = self._validate_and_prepare(
                block.header.number, envelopes, flags)
        # split the batch by shard before the apply takes shard locks
        # (the parallel-commit / device-validate planes do the same)
        batch.preshard(self.statedb.n_shards)
        stats.state_validation_s = time.perf_counter() - t0
        stats.valid_txs = flags.valid_count()
        # MVCC may have flipped more flags — write the final bitmap back
        block.metadata.items[META_TXFLAGS] = flags.to_bytes()

        # commit-hash chaining (kv_ledger.go:459-465): binds flags+data to
        # the previous commit hash so divergent peers are detectable
        self._commit_hash = hashlib.sha256(
            self._commit_hash + block.header.data_hash + flags.to_bytes()
        ).digest()
        block.metadata.items[META_COMMIT_HASH] = self._commit_hash

        t0 = time.perf_counter()
        self.blockstore.add_block(block)
        stats.block_commit_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.statedb.apply_updates(batch, block.header.number)
        stats.state_commit_s = time.perf_counter() - t0

        if self.historydb is not None:
            t0 = time.perf_counter()
            self.historydb.commit(block.header.number, history)
            stats.history_commit_s = time.perf_counter() - t0

        self._observe_apply(len(batch), len(history))
        self.last_stats = stats
        logger.info(
            "[%s] committed block %d: %d/%d valid | validation=%.1fms "
            "block=%.1fms state=%.1fms history=%.1fms",
            self.channel_id, stats.block_num, stats.valid_txs,
            stats.total_txs, stats.state_validation_s * 1e3,
            stats.block_commit_s * 1e3, stats.state_commit_s * 1e3,
            stats.history_commit_s * 1e3)
        return stats

    # -- pipelined commit (the cross-block wavefront window) ----------------

    def pending_overlay(self):
        """Frozen write-set snapshot of the window's in-flight blocks
        (PendingOverlay; empty when the window is idle, None when the
        pipelined window is disabled).  The early-abort analyzer's
        overlay_source, and the dooming bound for admit-time waves."""
        if self._commit_window is None:
            return None
        return self._commit_window.pending_overlay()

    def commit_begin(self, block: Block):
        """Admit `block` to the pipelined commit window and validate its
        EARLY waves — the txs whose footprints provably avoid every
        in-flight predecessor's pending write set — typically while the
        predecessor's apply is still running on the finishing thread.
        Returns the window ticket for commit_finish.  Single admitting
        thread; blocks must arrive in chain order."""
        if self._commit_window is None:
            raise RuntimeError(
                "pipelined commit disabled (LedgerConfig.commit_window)")
        if self.paused:
            raise RuntimeError(
                f"channel {self.channel_id!r} is paused (resume() first)")
        if META_TXFLAGS not in block.metadata.items:
            raise ValueError("block metadata missing txflags "
                             "(txvalidator must run first)")
        from fabric_tpu_torch.protocol import block_header_hash
        tail = self._commit_window.tail()
        if tail is not None:
            expected_num = tail.num + 1
            expected_prev = tail.header_hash
        else:
            # window empty: no concurrent finish can be in flight, so
            # the chain tip is stable here
            info = self.blockstore.chain_info()
            expected_num = info.height
            expected_prev = (info.current_hash if info.height
                             else b"\x00" * 32)
        if block.header.number != expected_num:
            raise ValueError(
                f"out-of-order commit_begin: got block "
                f"{block.header.number}, expected {expected_num}")
        if block.header.previous_hash != expected_prev:
            raise ValueError(
                f"block {block.header.number} previous_hash mismatch")
        flags = TxFlags.from_bytes(block.metadata.items[META_TXFLAGS])
        envelopes = _safe_envelopes(block)
        entry = self._commit_window.admit(
            self.statedb, block.header.number,
            block_header_hash(block.header), envelopes, flags)
        # the block rides the ticket un-mutated: metadata (final flags,
        # commit hash) is only stamped at finish, so an aborted window
        # leaves it pristine for the exactly-once replay
        return (entry, block)

    def commit_finish(self, ticket) -> CommitStats:
        """Promote the ticket's deferred waves, then retire it: rebuild
        the final batch in strict tx order, chain the commit hash, store
        the block, and apply state + history.  Strictly in admit order
        (head of window only) — that ordering is what keeps the windowed
        stream bit-identical to serial commits."""
        entry, block = ticket
        with self._finish_lock:
            t0 = time.perf_counter()
            batch, history = self._commit_window.finish(
                self.statedb, entry)
            batch.preshard(self.statedb.n_shards)
            flags = entry.flags
            stats = CommitStats(block_num=entry.num,
                                total_txs=len(block.data))
            stats.state_validation_s = (entry.validate_s
                                        + time.perf_counter() - t0)
            stats.valid_txs = flags.valid_count()
            block.metadata.items[META_TXFLAGS] = flags.to_bytes()
            self._commit_hash = hashlib.sha256(
                self._commit_hash + block.header.data_hash
                + flags.to_bytes()).digest()
            block.metadata.items[META_COMMIT_HASH] = self._commit_hash

            # the retirement tail is the window's overlap counterpart:
            # admits of successor blocks time their validation against
            # this span
            self._commit_window.apply_started()
            try:
                t1 = time.perf_counter()
                self.blockstore.add_block(block)
                stats.block_commit_s = time.perf_counter() - t1

                t1 = time.perf_counter()
                self.statedb.apply_updates(batch, entry.num)
                stats.state_commit_s = time.perf_counter() - t1

                if self.historydb is not None:
                    t1 = time.perf_counter()
                    self.historydb.commit(entry.num, history)
                    stats.history_commit_s = time.perf_counter() - t1
            finally:
                self._commit_window.apply_ended()
            self._commit_window.retire(entry)

            self._observe_apply(len(batch), len(history))
            self.last_stats = stats
            logger.info(
                "[%s] committed block %d (windowed, %d early / %d "
                "deferred): %d/%d valid",
                self.channel_id, stats.block_num, entry.early_n,
                entry.deferred_n, stats.valid_txs, stats.total_txs)
            return stats

    def abort_window(self) -> int:
        """Drop every admitted-but-unfinished window block (pipeline
        teardown or error recovery).  None of them reached the block
        store, so they replay later exactly once; returns the count."""
        if self._commit_window is None:
            return 0
        return self._commit_window.reset()

    # -- queries ------------------------------------------------------------

    @property
    def height(self) -> int:
        return self.blockstore.height

    @property
    def commit_hash(self) -> bytes:
        return self._commit_hash

    def get_state(self, ns: str, key: str) -> Optional[bytes]:
        vv = self.statedb.get(ns, key)
        return None if vv is None else vv.value

    def range_query(self, ns: str, start_key: str, end_key: str, limit: int = 0):
        return self.statedb.range_scan(ns, start_key, end_key, limit)

    def get_history(self, ns: str, key: str):
        if self.historydb is None:
            raise RuntimeError("history DB disabled")
        return self.historydb.get_history(ns, key)

    def state_status(self) -> dict:
        """Shard/checkpoint/recovery introspection (the /state ops route)."""
        out = {
            "channel": self.channel_id,
            "height": self.height,
            "commit_hash": self._commit_hash.hex(),
            "block_base": self.blockstore.base,
            "last_recovery": dict(self.last_recovery),
            "state": self.statedb.status(),
        }
        if self.historydb is not None:
            out["history"] = self.historydb.status()
        if self._commit_scheduler is not None:
            out["commit_serial_fallbacks"] = (
                self._commit_scheduler.serial_fallbacks)
        if self._commit_window is not None:
            out["commit_window"] = self._commit_window.stats()
        return out

    def snapshot_export(self):
        """Force a checkpoint of both derived DBs so a consistent
        (manifest + shard files) set exists on disk for state transfer.
        -> (state_manifest, history_manifest|None); None when in-memory
        or before the first block."""
        sm = self.statedb.checkpoint()
        hm = self.historydb.checkpoint() if self.historydb is not None else None
        return sm, hm

    # -- admin (reset.go / rollback.go / pause_resume.go / rebuild_dbs.go) --

    @property
    def paused(self) -> bool:
        """pause_resume.go: a paused channel refuses commits until
        resumed; the flag survives restarts via a marker file."""
        if self.config.root is None:
            return getattr(self, "_paused_mem", False)
        return os.path.exists(os.path.join(self.config.root, "PAUSED"))

    def pause(self) -> None:
        if self.config.root is None:
            self._paused_mem = True
            return
        with open(os.path.join(self.config.root, "PAUSED"), "w") as f:
            f.write("paused")

    def resume(self) -> None:
        if self.config.root is None:
            self._paused_mem = False
            return
        try:
            os.unlink(os.path.join(self.config.root, "PAUSED"))
        except FileNotFoundError:
            pass

    def rollback(self, target_height: int) -> None:
        """Roll the channel back to `target_height` blocks and rebuild
        the derived DBs from the retained chain (kvledger/rollback.go —
        there the peer re-fetches dropped blocks from ordering; here the
        deliver client does the same on restart)."""
        if target_height >= self.height:
            return
        self.blockstore.truncate(target_height)
        self.rebuild_dbs()

    def reset(self) -> None:
        """Reset to the genesis block only (kvledger/reset.go): all state
        re-derivable, blocks re-fetched from ordering by the deliver
        client."""
        self.rollback(1 if self.height else 0)

    def rebuild_dbs(self) -> None:
        """Drop state+history and rebuild from the block store."""
        sdir, hdir = self.statedb.root, None
        if self.historydb is not None:
            hdir = self.historydb.root
        for d in (sdir, hdir):
            if d and os.path.isdir(d):
                shutil.rmtree(d)
        self.statedb = self._new_statedb(sdir)
        if self.config.enable_history:
            self.historydb = self._new_historydb(hdir)
        self._commit_hash = b"\x00" * 32
        self._recover()
