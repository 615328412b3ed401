"""Wavefront-parallel MVCC validation + batched prepare.

Drop-in replacement for `mvcc.validate_and_prepare_batch` (same
signature, same mutation contract on `flags`, same return value — the
differential tests in tests/test_parallel_commit.py hold it to
bit-identity against the serial oracle):

  1. parse every still-valid tx once (BAD_RWSET parity with the oracle's
     lazy walk — parsing is state-independent, so hoisting it is exact);
  2. build the block's conflict graph and partition it into waves
     (graph.py): every tx's conflicting predecessors sit in strictly
     earlier waves;
  3. validate each wave's txs concurrently against the shared working
     batch — the batch is only ever mutated BETWEEN waves (valid writes
     applied in tx order), so wave workers see a frozen snapshot that,
     for the keys and ranges in their own footprint, is exactly the
     state the serial walk would have shown them;
  4. rebuild the returned UpdateBatch + history list in strict tx order
     from the per-tx write lists, so even dict insertion order matches
     the oracle's output literally.

Thread safety: wave workers only call UpdateBatch.get / .items() and
StateDB reads (lock-guarded); TxFlags is written by the coordinating
thread only.

Counterpart of `fabric_tpu/committer/parallel_commit/scheduler.py`,
copied with its ops-plane hooks.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.protocol import Version
from fabric_tpu_torch.protocol.txflags import TxFlags, ValidationCode

from fabric_tpu_torch.ledger.mvcc import (
    _validate_range_query,
    _validate_read,
    parse_endorser_tx,
    validate_and_prepare_batch as _serial_oracle,
)
from fabric_tpu_torch.ledger.statedb import StateDB, UpdateBatch

from .graph import ConflictGraph, PendingOverlay, footprint_of

_HOST_CORES = os.cpu_count() or 1

_WIDTH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                  1024.0, float("inf"))


def _parse_still_valid(envelopes, flags: TxFlags
                       ) -> List[Tuple[int, str, object, list]]:
    """Pass 0 shared by the per-block scheduler and the commit window:
    parse every still-valid tx once (BAD_RWSET parity with the oracle's
    lazy walk — parsing is state-independent, so hoisting it is exact).
    -> [(tx_num, txid, rwset, [(ns, key, value, is_delete), ...])]."""
    parsed: List[Tuple[int, str, object, list]] = []
    for tx_num, env in enumerate(envelopes):
        if env is None or not flags.is_valid(tx_num):
            continue
        try:
            p = parse_endorser_tx(env)
        except Exception:
            flags.set(tx_num, ValidationCode.BAD_RWSET)
            continue
        if p is None:
            continue                    # config txs etc.
        txid, rwset = p
        writes = [(ns_rw.namespace, w.key, w.value, w.is_delete)
                  for ns_rw in rwset.ns_rwsets for w in ns_rw.writes]
        parsed.append((tx_num, txid, rwset, writes))
    return parsed


def _validate_tx(db: StateDB, batch: UpdateBatch, rwset) -> Optional[int]:
    """One tx's MVCC check against a frozen batch — the exact walk order
    of the oracle's inner loop (per ns_rw: reads, then range queries;
    first failure decides the code)."""
    for ns_rw in rwset.ns_rwsets:
        ns = ns_rw.namespace
        for read in ns_rw.reads:
            if not _validate_read(db, batch, ns, read):
                return int(ValidationCode.MVCC_READ_CONFLICT)
        for rq in ns_rw.range_queries:
            if not _validate_range_query(db, batch, ns, rq):
                return int(ValidationCode.PHANTOM_READ_CONFLICT)
    return None


class ParallelCommitScheduler:
    """One per ledger (channel); owns the worker pool.

    Pool sizing is adaptive: `max_workers` is the static OVERRIDE CAP,
    and the pool actually provisioned tracks the rolling maximum of the
    observed conflict-graph wave widths (workers beyond the widest wave
    can never have work).  Low-contention channels whose blocks fan out
    wide grow toward the cap; serial workloads (chained writes, single
    hot key) idle at a one-thread pool instead of parking cap-1 threads
    per channel.  `adaptive=False` pins the pool at the cap (the
    pre-adaptive behavior)."""

    def __init__(self, max_workers: int = 4, channel_id: str = "",
                 adaptive: bool = True, width_window: int = 32,
                 serial_fallback: bool = True,
                 host_cores: Optional[int] = None):
        self.max_workers = max(1, int(max_workers))
        self.channel_id = channel_id
        self.adaptive = bool(adaptive)
        # serial fallback: on a 1-core host (or when the adaptive pool
        # would provision a single worker anyway) the wave machinery can
        # only ever add coordination overhead on top of the oracle's
        # walk — BENCH_r12 measured it at 0.73x — so the scheduler runs
        # the serial oracle directly and counts the fallback.  Tests
        # that hold the wave path to bit-identity pass False to keep
        # exercising it regardless of the host.
        self.serial_fallback = bool(serial_fallback)
        self.host_cores = int(host_cores) if host_cores else _HOST_CORES
        self.serial_fallbacks = 0
        # rolling window of per-block max wave widths (the demand signal)
        self._widths: deque = deque(maxlen=max(1, int(width_window)))
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_size = 0
        # last-block stats, surfaced by the committer
        self.last_waves = 0
        self.last_edges = 0
        self.last_max_width = 0

    def target_workers(self, width: int) -> int:
        """Worker count for a block whose widest wave is `width`: the
        rolling demand maximum, clamped to [1, max_workers]."""
        self._widths.append(int(width))
        if not self.adaptive:
            return self.max_workers
        return max(1, min(self.max_workers, max(self._widths)))

    def _executor(self, workers: int) -> ThreadPoolExecutor:
        if self._pool is not None and self._pool_size != workers:
            # ThreadPoolExecutor cannot resize: swap pools.  The rolling
            # window damps churn — shrink happens only after width_window
            # consecutive narrower blocks age the wide ones out.
            self._pool.shutdown(wait=False)
            self._pool = None
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix=f"mvcc-{self.channel_id}")
            self._pool_size = workers
            try:
                from fabric_tpu_torch.ops_plane import registry
                registry.gauge(
                    "commit_workers_effective",
                    "adaptive MVCC pool size (cap: commit_workers)").set(
                        workers, channel=self.channel_id)
            except Exception:
                pass
        return self._pool

    def close(self) -> None:
        pool, self._pool = self._pool, None
        self._pool_size = 0
        if pool is not None:
            pool.shutdown(wait=False)

    def _note_serial_fallback(self, reason: str) -> None:
        self.serial_fallbacks += 1
        try:
            from fabric_tpu_torch.ops_plane import registry
            registry.counter(
                "commit_serial_fallbacks_total",
                "blocks MVCC-validated on the serial path because the "
                "wave machinery could not pay off, by reason").add(
                    1, reason=reason, channel=self.channel_id)
        except Exception:
            pass

    def _serial(self, db: StateDB, block_num: int, envelopes,
                flags: TxFlags, reason: str):
        """The oracle walk verbatim (plus the preshard the parallel
        plane contracts to do) — bit-identical by definition."""
        self._note_serial_fallback(reason)
        batch, history = _serial_oracle(db, block_num, envelopes, flags)
        self.last_waves = 0
        self.last_edges = 0
        self.last_max_width = 0
        batch.preshard(getattr(db, "n_shards", 1))
        return batch, history

    # -- the entry point (signature-compatible with the serial oracle) ------

    def validate_and_prepare_batch(
            self, db: StateDB, block_num: int, envelopes, flags: TxFlags,
    ) -> Tuple[UpdateBatch, List[Tuple[int, str, str, str, bytes, bool]]]:
        from fabric_tpu_torch.ops_plane import tracing

        if self.serial_fallback and self.host_cores <= 1:
            # a 1-core host can never validate two txs concurrently:
            # graph building + pool map are pure overhead (BENCH_r12's
            # 0.73x commit_parallel_speedup), so skip them wholesale
            return self._serial(db, block_num, envelopes, flags,
                                "one_core")

        # pass 0: parse still-valid txs once (oracle's lazy-parse parity)
        parsed = _parse_still_valid(envelopes, flags)

        t0 = time.perf_counter()
        graph = ConflictGraph(
            [footprint_of(tx_num, rwset)
             for tx_num, _txid, rwset, _w in parsed])
        t1 = time.perf_counter()
        tracing.tracer.record_span(
            "mvcc.graph", t0, t1,
            attributes={"block": int(block_num), "txs": len(parsed),
                        "edges": graph.n_edges,
                        "waves": len(graph.waves)})

        by_tx = {tx_num: (txid, rwset, writes)
                 for tx_num, txid, rwset, writes in parsed}
        working = UpdateBatch()
        valid: Dict[int, bool] = {}
        workers = self.target_workers(graph.max_wave_width)
        pool = (self._executor(workers)
                if workers > 1 and graph.max_wave_width > 1
                else None)
        if pool is None and self.serial_fallback:
            # narrow block (rolling wave width says one worker): the
            # wave loop below degenerates to a serial walk — count it so
            # operators can see how often the graph pays for nothing
            self._note_serial_fallback("narrow")
        for wave in graph.waves:
            tw = time.perf_counter()
            if pool is not None and len(wave) > 1:
                codes = list(pool.map(
                    lambda tx: _validate_tx(db, working, by_tx[tx][1]),
                    wave))
            else:
                codes = [_validate_tx(db, working, by_tx[tx][1])
                         for tx in wave]
            # apply this wave's outcomes in tx order, between waves only
            for tx, code in zip(wave, codes):
                if code is not None:
                    flags.set(tx, ValidationCode(code))
                    valid[tx] = False
                    continue
                valid[tx] = True
                version = Version(block_num, tx)
                for ns, key, value, is_delete in by_tx[tx][2]:
                    if is_delete:
                        working.delete(ns, key, version)
                    else:
                        working.put(ns, key, value, version)
            tracing.tracer.record_span(
                "mvcc.wave", tw, time.perf_counter(),
                attributes={"block": int(block_num), "width": len(wave)})

        # final batch + history rebuilt in strict tx order: literal
        # (insertion-order included) identity with the serial oracle
        batch = UpdateBatch()
        history: List[Tuple[int, str, str, str, bytes, bool]] = []
        for tx_num, txid, _rwset, writes in parsed:
            if not valid.get(tx_num, False):
                continue
            version = Version(block_num, tx_num)
            for ns, key, value, is_delete in writes:
                if is_delete:
                    batch.delete(ns, key, version)
                else:
                    batch.put(ns, key, value, version)
                history.append((tx_num, txid, ns, key, value, is_delete))

        self.last_waves = len(graph.waves)
        self.last_edges = graph.n_edges
        self.last_max_width = graph.max_wave_width
        self._observe(graph)
        # pre-split the batch by state shard here, off the ledger's
        # commit lock path — apply_updates consumes the cached split
        batch.preshard(getattr(db, "n_shards", 1))
        return batch, history

    def _observe(self, graph: ConflictGraph) -> None:
        try:
            from fabric_tpu_torch.ops_plane import registry
            ch = self.channel_id
            edges = registry.counter(
                "commit_graph_edges_total",
                "MVCC conflict-graph edges by kind")
            for kind, n in graph.edge_counts.items():
                if n:
                    edges.add(n, kind=kind, channel=ch)
            registry.counter(
                "commit_graph_waves_total",
                "MVCC wavefront count").add(len(graph.waves), channel=ch)
            width = registry.histogram(
                "commit_graph_wave_width",
                "txs per MVCC validation wave", buckets=_WIDTH_BUCKETS)
            for wave in graph.waves:
                width.observe(float(len(wave)), channel=ch)
        except Exception:
            pass


# -- the cross-block commit window (admit / validate / promote / retire) ----

class WindowEntry:
    """One admitted block's in-flight validation state.  Lifecycle:

        admit    -> early waves validated, entry appended to the window
        promote  -> deferred waves validated (commit_finish, head only)
        retire   -> popped after the state/history apply lands

    `flags`, `working`, and `valid` are owned by the admitting thread
    until `finish` hands the entry to the retiring thread; the strict
    head-only finish order is the synchronization point."""

    __slots__ = ("num", "header_hash", "flags", "parsed", "by_tx",
                 "graph", "working", "valid", "deferred_waves",
                 "overlay_keys", "early_n", "deferred_n", "validate_s",
                 "finished")

    def __init__(self, num: int, header_hash: bytes, flags: TxFlags,
                 parsed, graph: ConflictGraph):
        self.num = int(num)
        self.header_hash = header_hash
        self.flags = flags
        self.parsed = parsed
        self.by_tx = {tx_num: (txid, rwset, writes)
                      for tx_num, txid, rwset, writes in parsed}
        self.graph = graph
        self.working = UpdateBatch()
        self.valid: Dict[int, bool] = {}
        self.deferred_waves: List[List[int]] = []
        # SUPERSET of this block's eventual write set (every write of
        # every tx still valid at admit): what successors defer against
        self.overlay_keys = frozenset(
            (ns, key) for _t, _x, _r, writes in parsed
            for ns, key, _v, _d in writes)
        self.early_n = 0
        self.deferred_n = 0
        self.validate_s = 0.0
        self.finished = False


class CommitWindow:
    """Sliding window of admitted-but-unretired blocks — the cross-block
    wavefront pipeline's state machine (one per windowed ledger).

    admit(N+1) runs while block N's apply is still in flight: N+1's
    conflict graph is built against the frozen PendingOverlay (union
    write-set of every in-flight block) and the EARLY waves — txs with
    no cross-block wr/range hazard, transitively — validate immediately:
    their footprint is disjoint from every pending write, so committed
    state shows them exactly what the post-apply world would.  finish()
    PROMOTES the deferred waves once every predecessor has retired (the
    overlay they conflicted with has landed, so plain db reads now see
    it), then rebuilds the final batch + history in strict tx order.
    Retirement is strictly in admit order, which is what keeps flags,
    state, history, and the commit hash bit-identical to the serial
    oracle: the apply order, the hash chain order, and every same-key
    write order are exactly the serial schedule's.

    Threading contract: one admitting thread, one finishing thread
    (KVLedger.commit_begin / commit_finish enforce this shape); the
    window lock guards the entry list, the overlay snapshot, and the
    apply-span overlap accounting."""

    def __init__(self, channel_id: str = "", max_window: int = 4):
        self.channel_id = channel_id
        self.max_window = max(1, int(max_window))
        self._lock = threading.RLock()
        self._entries: List[WindowEntry] = []
        # wall-clock apply spans (+ the live one) for overlap accounting
        self._apply_spans: deque = deque(maxlen=256)
        self._apply_active: Optional[float] = None
        self.admitted = 0
        self.retired = 0
        self.early_txs = 0
        self.deferred_txs = 0
        self.validate_busy_s = 0.0
        self.validate_overlap_s = 0.0

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)

    def tail(self) -> Optional[WindowEntry]:
        with self._lock:
            return self._entries[-1] if self._entries else None

    def pending_overlay(self) -> PendingOverlay:
        """Frozen union write-set of every in-flight block.  A snapshot
        taken just before an entry retires stays a SUPERSET of the truly
        pending writes — over-deferral is safe, so no fence is needed
        between this and a concurrent finish."""
        with self._lock:
            return PendingOverlay(
                (e.num for e in self._entries),
                (k for e in self._entries for k in e.overlay_keys))

    # -- admit (commit_begin) ----------------------------------------------

    def admit(self, db: StateDB, block_num: int, header_hash: bytes,
              envelopes, flags: TxFlags) -> WindowEntry:
        from fabric_tpu_torch.ops_plane import tracing
        parsed = _parse_still_valid(envelopes, flags)
        overlay = self.pending_overlay()
        t0 = time.perf_counter()
        graph = ConflictGraph(
            [footprint_of(tx_num, rwset)
             for tx_num, _txid, rwset, _w in parsed],
            overlay=overlay)
        early, deferred = graph.split_waves()
        entry = WindowEntry(block_num, header_hash, flags, parsed, graph)
        entry.deferred_waves = deferred
        entry.early_n = sum(len(w) for w in early)
        entry.deferred_n = sum(len(w) for w in deferred)
        with self._lock:
            if len(self._entries) >= self.max_window:
                raise RuntimeError(
                    f"commit window full ({self.max_window} in flight)")
            self._entries.append(entry)
            self.admitted += 1
        # EARLY waves: provably disjoint from every pending write, so
        # they validate now — typically while a predecessor's apply is
        # still running on the finishing thread
        self._run_waves(db, entry, early)
        t1 = time.perf_counter()
        entry.validate_s = t1 - t0
        with self._lock:
            self.validate_busy_s += t1 - t0
            self.validate_overlap_s += self._overlapped_locked(t0, t1)
            self.early_txs += entry.early_n
            self.deferred_txs += entry.deferred_n
        tracing.tracer.record_span(
            "mvcc.window.admit", t0, t1,
            attributes={"block": int(block_num), "txs": len(parsed),
                        "early": entry.early_n,
                        "deferred": entry.deferred_n,
                        "window_depth": self.depth()})
        self._observe_admit(graph, entry)
        return entry

    # -- promote + retire (commit_finish) ----------------------------------

    def finish(self, db: StateDB, entry: WindowEntry):
        """Promote the entry's deferred waves (every predecessor has
        retired, so committed state now includes the overlay they were
        deferred against) and rebuild the final batch + history in
        strict tx order.  Head-of-window only — strict in-order
        retirement is the bit-identity invariant."""
        with self._lock:
            if not self._entries or self._entries[0] is not entry:
                raise RuntimeError(
                    "commit_finish out of order: block "
                    f"{entry.num} is not the window head")
        t0 = time.perf_counter()
        self._run_waves(db, entry, entry.deferred_waves)
        batch = UpdateBatch()
        history: List[Tuple[int, str, str, str, bytes, bool]] = []
        for tx_num, txid, _rwset, writes in entry.parsed:
            if not entry.valid.get(tx_num, False):
                continue
            version = Version(entry.num, tx_num)
            for ns, key, value, is_delete in writes:
                if is_delete:
                    batch.delete(ns, key, version)
                else:
                    batch.put(ns, key, value, version)
                history.append((tx_num, txid, ns, key, value, is_delete))
        entry.finished = True
        with self._lock:
            self.validate_busy_s += time.perf_counter() - t0
        return batch, history

    def apply_started(self) -> None:
        with self._lock:
            self._apply_active = time.perf_counter()

    def apply_ended(self) -> None:
        with self._lock:
            if self._apply_active is not None:
                self._apply_spans.append(
                    (self._apply_active, time.perf_counter()))
                self._apply_active = None

    def retire(self, entry: WindowEntry) -> None:
        with self._lock:
            if not self._entries or self._entries[0] is not entry:
                raise RuntimeError("retire out of order")
            self._entries.pop(0)
            self.retired += 1

    def reset(self) -> int:
        """Drop every in-flight entry (pipeline teardown / crash path);
        nothing admitted-but-unfinished ever reached the block store, so
        the dropped blocks simply replay later, exactly once."""
        with self._lock:
            n, self._entries = len(self._entries), []
            self._apply_active = None
            return n

    # -- accounting ---------------------------------------------------------

    def _run_waves(self, db: StateDB, entry: WindowEntry,
                   waves: List[List[int]]) -> None:
        """The scheduler's wave loop, serial in the calling thread (the
        window's concurrency axis is across blocks, not within a wave):
        outcomes applied to the working batch in tx order between waves."""
        for wave in waves:
            codes = [_validate_tx(db, entry.working, entry.by_tx[tx][1])
                     for tx in wave]
            for tx, code in zip(wave, codes):
                if code is not None:
                    entry.flags.set(tx, ValidationCode(code))
                    entry.valid[tx] = False
                    continue
                entry.valid[tx] = True
                version = Version(entry.num, tx)
                for ns, key, value, is_delete in entry.by_tx[tx][2]:
                    if is_delete:
                        entry.working.delete(ns, key, version)
                    else:
                        entry.working.put(ns, key, value, version)

    def _overlapped_locked(self, t0: float, t1: float) -> float:
        spans = list(self._apply_spans)
        if self._apply_active is not None:
            spans.append((self._apply_active, time.perf_counter()))
        return sum(max(0.0, min(t1, b) - max(t0, a)) for a, b in spans)

    def overlap_frac(self) -> float:
        with self._lock:
            if self.validate_busy_s <= 0.0:
                return 0.0
            return min(1.0, self.validate_overlap_s / self.validate_busy_s)

    def stats(self) -> dict:
        with self._lock:
            busy = self.validate_busy_s
            return {
                "depth": len(self._entries),
                "max_window": self.max_window,
                "admitted": self.admitted,
                "retired": self.retired,
                "early_txs": self.early_txs,
                "deferred_txs": self.deferred_txs,
                "validate_busy_s": round(busy, 6),
                "validate_overlap_s": round(self.validate_overlap_s, 6),
                "overlap_frac": (round(min(
                    1.0, self.validate_overlap_s / busy), 4)
                    if busy > 0 else 0.0),
            }

    def _observe_admit(self, graph: ConflictGraph,
                       entry: WindowEntry) -> None:
        try:
            from fabric_tpu_torch.ops_plane import registry
            ch = self.channel_id
            edges = registry.counter(
                "commit_graph_edges_total",
                "MVCC conflict-graph edges by kind")
            for kind, n in graph.xblock_counts.items():
                if n:
                    edges.add(n, kind=kind, channel=ch)
            registry.counter(
                "commit_window_admitted_total",
                "blocks admitted to the pipelined commit window").add(
                    1, channel=ch)
            registry.counter(
                "commit_window_txs_total",
                "window txs by validation timing").add(
                    entry.early_n, timing="early", channel=ch)
            registry.counter(
                "commit_window_txs_total",
                "window txs by validation timing").add(
                    entry.deferred_n, timing="deferred", channel=ch)
            registry.gauge(
                "commit_window_depth",
                "in-flight blocks in the commit window").set(
                    self.depth(), channel=ch)
            registry.gauge(
                "commit_window_overlap_frac",
                "fraction of window validation wall time overlapped "
                "with a predecessor's apply").set(
                    self.overlap_frac(), channel=ch)
        except Exception:
            pass
