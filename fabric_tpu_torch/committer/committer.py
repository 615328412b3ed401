"""Committer: validate + commit, the StoreBlock composition.

Reference parity: core/committer/committer_impl.go LedgerCommitter plus
the gossip/state coordinator hand-off (state.go:781 commitBlock ->
coordinator.StoreBlock -> txvalidator.Validate -> CommitLegacy).

Counterpart of `fabric_tpu/committer/committer.py`: `store_block` with
the idempotent-replay check, validation, commit-time config-block
application (`bundle_source`, `provider`, `confighistory`; the
`_precommit` / `_postcommit` split), the commit listeners, and the
cross-block pipeline over a windowed ledger (`PipelinedCommitter`), with
the reference's structured logs, spans and metrics.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Optional

from fabric_tpu_torch.ledger import KVLedger
from fabric_tpu_torch.ops_plane import tracing
from fabric_tpu_torch.ops_plane.logging import jlog
from fabric_tpu_torch.protocol import Block, block_header_hash
from fabric_tpu_torch.protocol.txflags import TxFlags, ValidationCode
from fabric_tpu_torch.protocol.types import META_TXFLAGS
from fabric_tpu_torch.protocol.wire import n_txs

from .txvalidator import TxValidator, ValidationResult

logger = logging.getLogger("fabric_tpu_torch.committer")


@dataclass
class BlockCommitResult:
    validation: ValidationResult  # flags as of the sig/policy gate
    commit_stats: object          # ledger CommitStats
    final_flags: object           # TxFlags after MVCC (what the block stores)
    commit_s: float = 0.0         # wall time of the ledger commit


class Committer:
    def __init__(self, ledger: KVLedger, validator: TxValidator,
                 bundle_source=None, provider=None, confighistory=None):
        self.ledger = ledger
        self.validator = validator
        self.bundle_source = bundle_source
        self.provider = provider
        # height-indexed config log (core/ledger/confighistory/mgr.go)
        self.confighistory = confighistory
        # wire the duplicate-txid oracle to the block store
        self.validator.ledger_has_txid = ledger.blockstore.has_txid
        # post-commit hooks fed (block, final TxFlags); the gateway's
        # commit-status notifier rides here so clients learn a txid's
        # validation code without polling the ledger
        self._commit_listeners = []

    def add_commit_listener(self, fn) -> None:
        """Register fn(block, final_flags), called after every commit."""
        self._commit_listeners.append(fn)

    def store_block(self, block: Block) -> BlockCommitResult:
        """Validate (verify-then-gate) and commit one block.

        Committed config blocks are applied to the channel bundle AFTER the
        commit (core/peer: channel config takes effect at the block
        boundary), so the config tx itself is validated under the previous
        configuration — matching configtx/validator.go sequencing.
        """
        # root of the block-domain trace: everything downstream (VSCC
        # batch verify, MVCC, ledger append, commit notification) hangs
        # off this span
        with tracing.tracer.start_span(
                "committer.store_block",
                attributes={"channel": self.validator.channel_id,
                            "block": int(block.header.number),
                            "txs": n_txs(block)}) as span:
            result = self._store_block_inner(block)
            if span.recording:
                span.set_attribute("valid",
                                   result.final_flags.valid_count())
                sched = getattr(self.ledger, "_commit_scheduler", None)
                if sched is not None:
                    span.set_attribute("mvcc_waves", sched.last_waves)
                    span.set_attribute("mvcc_edges", sched.last_edges)
                    span.set_attribute("mvcc_max_wave_width",
                                       sched.last_max_width)
            return result

    def _store_block_inner(self, block: Block) -> BlockCommitResult:
        pre = self._precommit(block)
        if isinstance(pre, BlockCommitResult):
            return pre
        vr, new_cfg = pre
        t_commit = time.perf_counter()
        stats = self.ledger.commit(block)
        return self._postcommit(block, vr, stats, new_cfg, t_commit)

    def _precommit(self, block: Block):
        """Everything that must happen BEFORE the ledger commit: the
        idempotent-replay check, signature/policy validation, and
        commit-time config-tx validation (which may flip tx 0's flag).
        -> BlockCommitResult for an acknowledged replay, else
        (ValidationResult, new_cfg|None)."""
        replayed = self._check_replay(block)
        if replayed is not None:
            return replayed
        vr = self.validator.validate(block)
        # Commit-time config validation happens BEFORE the commit: a config
        # tx that fails (wrong sequence, Admins unsatisfied) must be
        # recorded with an INVALID flag, never committed as VALID with the
        # failure merely logged (the reference invalidates the config tx;
        # an unauthorized config tx permanently recorded valid would be a
        # ledger integrity violation).
        new_cfg = None
        cfg_env = None
        if self.bundle_source is not None:
            from fabric_tpu_torch.config import config_envelope_of
            cfg_env = config_envelope_of(block)
        if cfg_env is not None:
            flags = TxFlags.from_bytes(block.metadata.items[META_TXFLAGS])
            if flags.is_valid(0):
                from fabric_tpu_torch.config import (
                    ConfigError,
                    parse_config_envelope,
                    validate_parsed_config_update,
                )
                bundle = self.bundle_source.current()
                try:
                    cfg, sds = parse_config_envelope(cfg_env)
                except Exception as exc:
                    cfg = None
                    err = ConfigError(f"malformed config envelope: {exc}")
                else:
                    err = None
                if cfg is not None and cfg.sequence <= bundle.sequence:
                    # A stale-sequence config tx is only acceptable as
                    # HISTORICAL REPLAY — a peer bootstrapped at a later
                    # config catching up through the old config blocks
                    # that produced it.  Genuine replay is recognizable:
                    # the block number is at or below the height the
                    # current config was taken/applied at (BundleSource
                    # .config_height, advanced on every application, or
                    # covered by confighistory).  A brand-NEW block above
                    # that height carrying a stale-sequence config tx is
                    # a wrong-sequence config (e.g. a byzantine orderer
                    # replaying an old authorized update) and is flagged
                    # INVALID like any other wrong-sequence config — the
                    # reference invalidates it at commit
                    # (configtx/validator.go sequence check).
                    covered = block.header.number <= getattr(
                        self.bundle_source, "config_height", 0)
                    if not covered and self.confighistory is not None:
                        latest = self.confighistory.latest_height()
                        covered = (latest is not None
                                   and block.header.number <= latest)
                    if (not covered and cfg is not None
                            and cfg.sequence == bundle.sequence
                            and cfg.serialize()
                            == bundle.config.serialize()):
                        # byte-identical to the live config: this is the
                        # very config block that produced the bootstrap
                        # bundle (a fresh peer bootstrapped at sequence S
                        # replaying the block that applied S) — a
                        # harmless idempotent replay, and flagging it
                        # INVALID would diverge from tip peers.  Configs
                        # strictly OLDER than the bootstrap one still
                        # need config_height seeded in the node config.
                        covered = True
                        self.bundle_source.config_height = max(
                            getattr(self.bundle_source, "config_height", 0),
                            block.header.number)
                    if covered:
                        logger.debug(
                            "config block %d sequence %d <= bundle "
                            "sequence %d: catch-up replay, skipping",
                            block.header.number, cfg.sequence,
                            bundle.sequence)
                    else:
                        err = ConfigError(
                            f"config sequence {cfg.sequence} <= current "
                            f"{bundle.sequence} in new block "
                            f"{block.header.number}")
                elif err is None:
                    try:
                        new_cfg = validate_parsed_config_update(
                            bundle, cfg, sds,
                            self.provider or self.validator.provider)
                    except ConfigError as exc:
                        err = exc
                if err is not None:
                    logger.warning(
                        "config tx in block %d invalid at commit: %s",
                        block.header.number, err)
                    jlog(logger, "committer.config_tx_invalid",
                         level=logging.WARNING, exc=err,
                         channel=self.validator.channel_id,
                         block=int(block.header.number))
                    flags.set(0, ValidationCode.INVALID_CONFIG_TRANSACTION)
                    block.metadata.items[META_TXFLAGS] = flags.to_bytes()
        return vr, new_cfg

    def _postcommit(self, block: Block, vr, stats, new_cfg,
                    t_commit: float) -> BlockCommitResult:
        """Everything AFTER the ledger commit: phase spans, metrics,
        commit listeners, and (for a valid config tx) the channel bundle
        application.  Runs on the retire thread under the pipeline."""
        commit_s = time.perf_counter() - t_commit
        self._record_phase_spans(t_commit, stats)
        final = TxFlags.from_bytes(block.metadata.items[META_TXFLAGS])
        self._observe_metrics(block, vr, stats)
        with tracing.tracer.start_span(
                "committer.notify", require_parent=True,
                attributes={"listeners": len(self._commit_listeners)}):
            for fn in self._commit_listeners:
                try:
                    fn(block, final)
                except Exception as exc:
                    logger.exception("commit listener failed for block %d",
                                     block.header.number)
                    jlog(logger, "committer.listener_failed",
                         level=logging.ERROR, exc=exc,
                         channel=self.validator.channel_id,
                         block=int(block.header.number))
        if new_cfg is not None and final.is_valid(0):
            try:
                from fabric_tpu_torch.config import Bundle
                self.bundle_source.update(Bundle(new_cfg),
                                          config_height=block.header.number)
                if self.confighistory is not None:
                    self.confighistory.record(block.header.number,
                                              new_cfg.serialize())
            except Exception:
                # the block is already committed; a config-plane failure
                # must not make the caller believe the commit failed
                logger.exception("config application failed for block %d",
                                 block.header.number)
        return BlockCommitResult(vr, stats, final, commit_s)

    def _check_replay(self, block: Block) -> Optional[BlockCommitResult]:
        """Idempotent re-commit: a block we already hold (deliver retry
        after a severed stream, duplicated gossip push, orderer resend
        after crash recovery) is acknowledged without re-validating,
        re-committing, or re-notifying listeners — IF it is the same
        block.  The same number with a different header hash is a fork
        and stays a hard error."""
        num = int(block.header.number)
        if num >= self.ledger.height:
            return None
        stored = self.ledger.blockstore.get_by_number(num)
        if block_header_hash(stored.header) != block_header_hash(
                block.header):
            raise ValueError(
                f"replayed block {num} does not match the committed "
                f"block (divergent header hash)")
        jlog(logger, "committer.replayed_block",
             channel=self.validator.channel_id, block=num,
             height=self.ledger.height)
        try:
            from fabric_tpu_torch.ops_plane import registry
            registry.counter(
                "committer_replayed_blocks_total",
                "duplicate blocks acknowledged idempotently").add(
                    1, channel=self.validator.channel_id)
        except Exception:
            pass
        tracing.event("committer.replay", block=num)
        final = TxFlags.from_bytes(stored.metadata.items[META_TXFLAGS])
        return BlockCommitResult(None, None, final)

    @staticmethod
    def _record_phase_spans(t0: float, stats) -> None:
        """Retroactive child spans for the sequential ledger commit
        phases, laid end-to-end from the commit start using the wall
        times CommitStats already measured (kvledger.commit)."""
        base = t0
        for attr, name in (("state_validation_s", "ledger.mvcc"),
                           ("block_commit_s", "ledger.block_commit"),
                           ("state_commit_s", "ledger.state_commit"),
                           ("history_commit_s", "ledger.history_commit")):
            dur = getattr(stats, attr, None)
            if dur is None:
                continue
            tracing.tracer.record_span(name, base, base + dur)
            base += dur

    def _observe_metrics(self, block, vr, stats) -> None:
        """Per-phase commit metrics (metric parity: the reference's
        ledger_block_processing_time / gossip state commit duration and
        validation duration, kv_ledger.go:491-499, validator.go:262)."""
        try:
            from fabric_tpu_torch.ops_plane import registry
            ch = self.validator.channel_id
            registry.histogram(
                "validation_duration_seconds",
                "txvalidator.Validate wall time").observe(
                    vr.total_s, channel=ch)
            registry.histogram(
                "validation_dispatch_seconds",
                "batched signature dispatch time").observe(
                    vr.dispatch_s, channel=ch)
            commit_s = 0.0
            for phase in ("state_validation_s", "block_commit_s",
                          "state_commit_s", "history_commit_s"):
                v = getattr(stats, phase, None)
                if v is not None:
                    commit_s += v
                    registry.histogram(
                        "commit_phase_seconds",
                        "per-phase ledger commit time").observe(
                            v, channel=ch, phase=phase[:-2])
            # the "commit" stage of the validator_stage_seconds family
            # (collect/dispatch/gate land in txvalidator._observe_block)
            registry.histogram(
                "validator_stage_seconds",
                "per-block validation stage latency",
                buckets=self.validator._STAGE_BUCKETS).observe(
                    commit_s, stage="commit", channel=ch)
            registry.counter(
                "committed_blocks_total", "blocks committed").add(1, channel=ch)
            registry.counter(
                "committed_txs_total", "txs committed").add(
                    n_txs(block), channel=ch)
            registry.gauge("ledger_height", "block height").set(
                self.ledger.height, channel=ch)
        except Exception:
            logger.exception("metrics observation failed")

    @property
    def height(self) -> int:
        return self.ledger.height


class PipelinedCommitter:
    """Cross-block wavefront pipeline driver over a windowed ledger
    (LedgerConfig.commit_window > 0): the SUBMITTING thread runs the
    deep-C validate path + commit_begin — collect/verify/graph and the
    block's EARLY waves — while a single RETIRE thread finishes blocks
    strictly in admit order (deferred waves + batched apply).  Adjacent
    blocks therefore overlap: block N+1 validates while block N's state
    apply is still running.

    submit(block) -> Future[BlockCommitResult].  Admission is bounded by
    the ledger's window depth (submit blocks when the window is full).
    Config blocks cannot pipeline — channel config takes effect at the
    block boundary, so every successor must validate under it: submit
    drains the window, commits the config block serially, and resumes.

    A retire-side failure breaks the pipeline: the failing block's
    future carries the exception, every queued successor is failed too
    (their early validation ran against an overlay that never landed),
    and the window is aborted — none of the dropped blocks reached the
    block store, so redelivery replays them exactly once."""

    def __init__(self, committer: Committer):
        if getattr(committer.ledger, "_commit_window", None) is None:
            raise RuntimeError(
                "PipelinedCommitter needs LedgerConfig.commit_window > 0")
        self.committer = committer
        self.ledger = committer.ledger
        window = self.ledger._commit_window
        self.depth = window.max_window
        self._sem = threading.Semaphore(self.depth)
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._inflight = 0
        self._broken: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._retire_loop, daemon=True,
            name=f"commit-retire-{committer.validator.channel_id}")
        self._thread.start()

    # -- submit (the admitting thread) --------------------------------------

    def submit(self, block: Block) -> "_CommitFuture":
        fut = _CommitFuture(int(block.header.number))
        with self._lock:
            if self._closed:
                raise RuntimeError("pipeline closed")
            if self._broken is not None:
                raise RuntimeError(
                    "commit pipeline broken (abort_window + redeliver): "
                    f"{self._broken}")
        if self._is_config(block):
            # drain, then the serial path end-to-end: the config must be
            # applied before any successor validates
            self.drain()
            try:
                fut._set(self.committer.store_block(block))
            except BaseException as exc:  # noqa: BLE001 — future carries it
                fut._fail(exc)
            return fut
        pre = self.committer._precommit(block)
        if isinstance(pre, BlockCommitResult):
            fut._set(pre)                 # idempotent replay, nothing queued
            return fut
        vr, new_cfg = pre
        self._sem.acquire()               # bounds admits to the window depth
        try:
            ticket = self.ledger.commit_begin(block)
        except BaseException:
            self._sem.release()
            raise
        with self._lock:
            self._inflight += 1
        self._queue.put((fut, block, ticket, vr, new_cfg))
        return fut

    def _is_config(self, block: Block) -> bool:
        if self.committer.bundle_source is None:
            return False
        try:
            from fabric_tpu_torch.config import config_envelope_of
            return config_envelope_of(block) is not None
        except Exception:
            return False

    # -- retire (the single finishing thread) -------------------------------

    def _retire_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            fut, block, ticket, vr, new_cfg = item
            try:
                t_commit = time.perf_counter()
                stats = self.ledger.commit_finish(ticket)
                result = self.committer._postcommit(
                    block, vr, stats, new_cfg, t_commit)
                fut._set(result)
            except BaseException as exc:  # noqa: BLE001
                self._break(exc, fut)
            finally:
                self._sem.release()
                with self._idle:
                    self._inflight -= 1
                    self._idle.notify_all()

    def _break(self, exc: BaseException, fut: "_CommitFuture") -> None:
        logger.exception("commit pipeline broken at block %d", fut.block_num)
        jlog(logger, "committer.pipeline_broken", level=logging.ERROR,
             exc=exc, channel=self.committer.validator.channel_id,
             block=fut.block_num)
        with self._lock:
            self._broken = exc
        fut._fail(exc)
        dropped = self.ledger.abort_window()
        # every queued successor validated against an overlay that never
        # landed — fail them all; redelivery replays from the chain tip
        while True:
            try:
                nfut, _b, _t, _vr, _cfg = self._queue.get_nowait()
            except queue.Empty:
                break
            nfut._fail(RuntimeError(
                f"pipeline broken at block {fut.block_num}: {exc}"))
            self._sem.release()
            with self._idle:
                self._inflight -= 1
                self._idle.notify_all()
        try:
            from fabric_tpu_torch.ops_plane import registry
            registry.counter(
                "commit_pipeline_breaks_total",
                "commit pipeline aborts (window dropped, redeliver)").add(
                    1, channel=self.committer.validator.channel_id)
        except Exception:
            pass
        logger.warning("aborted commit window (%d blocks dropped)", dropped)

    # -- lifecycle ----------------------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted block has retired (or failed)."""
        with self._idle:
            if not self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout):
                raise TimeoutError("commit pipeline drain timed out")

    def close(self) -> None:
        """Drain and stop the retire thread; the pipeline cannot be
        reused afterwards (build a new one to resume)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.drain()
        self._queue.put(None)
        self._thread.join(timeout=30)

    @property
    def broken(self) -> Optional[BaseException]:
        return self._broken


class _CommitFuture:
    """Minimal single-shot future for PipelinedCommitter.submit."""

    __slots__ = ("block_num", "_event", "_result", "_exc")

    def __init__(self, block_num: int):
        self.block_num = block_num
        self._event = threading.Event()
        self._result: Optional[BlockCommitResult] = None
        self._exc: Optional[BaseException] = None

    def _set(self, result: BlockCommitResult) -> None:
        self._result = result
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> BlockCommitResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"block {self.block_num} not retired in time")
        if self._exc is not None:
            raise self._exc
        return self._result
