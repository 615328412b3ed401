"""GatewayService: peer-hosted client verbs + bounded admission queue.

The receive half of the gateway.  Submissions land in a bounded queue
(full queue -> immediate backpressure error, never unbounded buffering)
and a single batcher thread coalesces them — up to `max_batch`
envelopes or `linger_s` of accumulation — into one orderer
`broadcast_batch` call, sized to feed the device verify lanes with big
blocks instead of trickling singleton envelopes at the consenter.
A txid dedup window makes submission idempotent: a duplicate of an
in-flight txid attaches to the existing entry, a duplicate of a
recently-finished one replays its recorded outcome.

Every verb records per-verb latency; the queue depth gauge, batch-size
histogram, retry/dedup/backpressure counters land in the same
ops_plane registry the /metrics endpoint exposes.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from fabric_tpu_torch.comm import connect
from fabric_tpu_torch.endorser.proposal import SignedProposal
from fabric_tpu_torch.gateway import admission as _admission
from fabric_tpu_torch.gateway.broadcaster import BatchBroadcaster
from fabric_tpu_torch.gateway.notifier import CommitNotifier
from fabric_tpu_torch.ops_plane import registry, tracing
from fabric_tpu_torch.ops_plane.logging import jlog
from fabric_tpu_torch.protocol import Envelope
from fabric_tpu_torch.protocol import wire
from fabric_tpu_torch.protocol.txflags import ValidationCode

logger = logging.getLogger("fabric_tpu_torch.gateway")


class _Pending:
    """One admitted submission.  `raw` keeps the client's wire bytes as
    received — the batcher rebroadcasts those exact bytes and the
    speculative verifier's native extractor walks them in place, so the
    covered submit path never materializes an Envelope object."""

    __slots__ = ("raw", "txid", "channel_id", "event", "status", "info",
                 "ctx", "span_queue", "t_in")

    def __init__(self, raw: bytes, txid: str, channel_id: str):
        self.raw = raw
        self.txid = txid
        self.channel_id = channel_id
        self.event = threading.Event()
        self.status = 0
        self.info = ""
        self.t_in = time.monotonic()   # gateway-sojourn start (admission)
        # tracing: the submitter's span context + its queue-wait span,
        # started on the submit thread and ended by the batcher thread
        self.ctx = tracing.tracer.current_context()
        self.span_queue = tracing.tracer.start_span(
            "gateway.queue_wait", require_parent=True,
            attributes={"txid": txid})


class GatewayService:
    """Hosts the four gateway verbs on a PeerNode's RPC server."""

    def __init__(self, node, cfg: Optional[dict] = None):
        cfg = dict(cfg or {})
        self.node = node
        self.max_queue = int(cfg.get("max_queue", 256))
        self.max_batch = int(cfg.get("max_batch", 64))
        self.linger_s = float(cfg.get("linger_s", 0.005))
        self.recent_window = int(cfg.get("dedup_window", 8192))
        self.submit_timeout_s = float(cfg.get("submit_timeout_s", 20.0))
        self.broadcaster = BatchBroadcaster(
            node.orderers, node.signer, node.msps,
            backoff_base_s=float(cfg.get("backoff_base_s", 0.05)),
            backoff_max_s=float(cfg.get("backoff_max_s", 2.0)),
            deadline_s=float(cfg.get("broadcast_deadline_s", 10.0)),
            rpc_timeout_s=float(cfg.get("rpc_timeout_s", 10.0)))
        # endorse fan-out budgets: a dropped org endorsement silently
        # weakens the policy sig-set and only surfaces at COMMIT time
        # (ENDORSEMENT_POLICY_FAILURE), so on slow verify providers these
        # must cover the authenticated handshake, not a bare TCP dial
        self.fan_dial_timeout_s = float(cfg.get(
            "fan_dial_timeout_s", max(3.0, float(cfg.get("rpc_timeout_s",
                                                         3.0)))))
        self.fan_call_timeout_s = float(cfg.get(
            "fan_call_timeout_s", max(10.0, self.fan_dial_timeout_s)))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # serving -> draining -> drained: a draining gateway refuses NEW
        # admissions (clients retry another peer) while the batcher
        # keeps flushing what was already admitted — overload shedding
        # is probabilistic and retryable, drain is absolute and orderly
        self.lifecycle = "serving"
        self._queue: List[_Pending] = []
        self._inflight: Dict[str, _Pending] = {}
        # txid -> (status, info) of finished submissions (dedup window)
        self._recent: "OrderedDict[str, tuple]" = OrderedDict()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._batch_loop, name="gateway-batcher", daemon=True)
        # metrics (ops_plane singleton registry -> /metrics exposition)
        self._m_latency = registry.histogram(
            "gateway_request_duration_seconds", "gateway verb latency")
        self._m_requests = registry.counter(
            "gateway_requests_total", "gateway verb calls")
        self._m_depth = registry.gauge(
            "gateway_queue_depth", "admission queue occupancy")
        self._m_batch = registry.histogram(
            "gateway_batch_size", "envelopes per orderer broadcast",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, float("inf")))
        self._m_dedup = registry.counter(
            "gateway_dedup_total", "duplicate txid submissions absorbed")
        self._m_backpressure = registry.counter(
            "gateway_backpressure_total",
            "submissions rejected on a full admission queue")
        # SLO-driven admission control: typed shed verdicts BEFORE the
        # queue-full cliff.  The burn source reads the node's
        # SloEvaluator lazily (peer wiring creates slo after the
        # gateway); queue occupancy reads the list length lock-free
        # (len() is atomic; the controller EWMAs it).
        self.admission = _admission.AdmissionController(
            cfg.get("admission"),
            burn_source=self._admission_burn,
            queue_source=lambda: len(self._queue) / float(
                max(1, self.max_queue)))
        # commit notifiers attach per channel as channels are touched
        for ch in getattr(node, "channels", {}).values():
            self._notifier(ch)

    # lifecycle ---------------------------------------------------------

    def register(self, rpc) -> None:
        rpc.serve("gateway.evaluate", self._rpc_evaluate)
        rpc.serve("gateway.endorse", self._rpc_endorse)
        rpc.serve("gateway.submit", self._rpc_submit)
        rpc.serve("gateway.commit_status", self._rpc_commit_status)

    def register_ops(self, ops) -> None:
        """Mount GET /gateway on the hosting node's ops server: live
        front-door state (admission queue, in-flight, dedup window,
        per-orderer breaker snapshot).  The gateway shares the node
        process, so /metrics and /slo on the same server already carry
        its registry series — this adds the structured view."""
        def _gateway(path, body):
            with self._lock:
                depth = len(self._queue)
                inflight = len(self._inflight)
                recent = len(self._recent)
            return 200, {"queue_depth": depth,
                         "lifecycle": self.lifecycle,
                         "max_queue": self.max_queue,
                         "inflight": inflight,
                         "dedup_window": recent,
                         "healthy": self.broadcaster.healthy(),
                         "admission": self.admission.snapshot(),
                         "orderers": self.broadcaster.states()}
        ops.register_route("GET", "/gateway", _gateway)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
        self.broadcaster.close()

    def drain(self, timeout_s: float = 10.0) -> dict:
        """Stop admitting new work and flush: the batcher keeps running
        so already-admitted submissions finish against the orderer;
        drained when queue + in-flight are both empty (a lapsed deadline
        reports the remainder, nothing is dropped)."""
        self.lifecycle = "draining"
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            with self._lock:
                if not self._queue and not self._inflight:
                    break
            time.sleep(0.02)
        with self._lock:
            left = {"queue": len(self._queue),
                    "inflight": len(self._inflight)}
        self.lifecycle = "drained"
        return left

    # helpers -----------------------------------------------------------

    def _admission_burn(self):
        """Max short-window SLO burn from the hosting node's evaluator
        (None when the node has no SLO plane or no data yet)."""
        slo = getattr(self.node, "slo", None)
        if slo is None:
            return None
        try:
            return slo.burn_state().get("max_burn_short")
        except Exception:
            return None

    def _notifier(self, ch) -> CommitNotifier:
        with self._lock:
            n = getattr(ch, "commit_notifier", None)
            if n is None:
                n = CommitNotifier(ch.channel_id)
                ch.committer.add_commit_listener(n.on_block)
                ch.commit_notifier = n
            return n

    def _observe(self, verb: str, t0: float) -> None:
        try:
            self._m_requests.add(1, verb=verb)
            self._m_latency.observe(time.monotonic() - t0, verb=verb)
        except Exception:
            pass

    # verbs -------------------------------------------------------------

    def _rpc_evaluate(self, body: dict, peer_identity) -> dict:
        """Endorse-only: simulate on this peer and hand the result back;
        nothing reaches the orderer (read path / queries)."""
        t0 = time.monotonic()
        try:
            if self.lifecycle != "serving":
                return {"status": 503, "message":
                        "gateway draining: retry another peer",
                        "payload": b""}
            # evaluates shed FIRST under overload: queries can retry on
            # any peer, and rejecting them frees endorsement simulation
            # capacity for submits that already paid for theirs
            shed = self.admission.admit("evaluate")
            if shed is not None:
                return dict(shed.body(), status=_admission.SHED_STATUS,
                            message=f"admission shed ({shed.mode}): "
                                    "gateway overloaded, retry later",
                            payload=b"")
            ch = self.node._chan(body)
            sp = SignedProposal(body["proposal"], body["signature"])
            resp = ch.endorser.process_proposal(sp)
            return {"status": resp.status, "message": resp.message,
                    "payload": resp.payload}
        finally:
            self._observe("evaluate", t0)

    def _rpc_endorse(self, body: dict, peer_identity) -> dict:
        """Collect endorsements: this peer first, then the org peers it
        is configured with, so a client reaches every org through ONE
        gateway round trip (gateway/endorse.go's plan execution)."""
        t0 = time.monotonic()
        try:
            if self.lifecycle != "serving":
                return {"status": 503, "message":
                        "gateway draining: retry another peer",
                        "payload": b"", "endorsements": []}
            shed = self.admission.admit("endorse")
            if shed is not None:
                return dict(shed.body(), status=_admission.SHED_STATUS,
                            message=f"admission shed ({shed.mode}): "
                                    "gateway overloaded, retry later",
                            payload=b"", endorsements=[])
            ch = self.node._chan(body)
            sp = SignedProposal(body["proposal"], body["signature"])
            resp = ch.endorser.process_proposal(sp)
            if resp.status != 200 or resp.endorsement is None:
                return {"status": resp.status, "message": resp.message,
                        "payload": resp.payload, "endorsements": []}
            endorsements = [{"endorser": resp.endorsement.endorser,
                             "signature": resp.endorsement.signature}]
            errors = []
            fan_body = {"proposal": body["proposal"],
                        "signature": body["signature"],
                        "channel": ch.channel_id}
            for addr in self.node.peers:
                try:
                    conn = connect(tuple(addr[:2]), self.node.signer,
                                   ch.msps, timeout=self.fan_dial_timeout_s)
                    try:
                        out = conn.call("endorse", fan_body,
                                        timeout=self.fan_call_timeout_s)
                    finally:
                        conn.close()
                except Exception as exc:
                    errors.append(f"{addr[0]}:{addr[1]}: {exc}")
                    continue
                if out.get("status") != 200:
                    errors.append(f"{addr[0]}:{addr[1]}: "
                                  f"{out.get('message', 'endorse failed')}")
                elif out.get("payload") != resp.payload:
                    errors.append(f"{addr[0]}:{addr[1]}: divergent "
                                  "simulation payload")
                else:
                    endorsements.append({
                        "endorser": out["endorser"],
                        "signature": out["endorsement_sig"]})
            return {"status": 200, "message": "; ".join(errors),
                    "payload": resp.payload, "endorsements": endorsements}
        finally:
            self._observe("endorse", t0)

    def _rpc_submit(self, body: dict, peer_identity) -> dict:
        """Admit an assembled envelope; blocks until its batch clears the
        orderer (or the submit timeout lapses with it still queued)."""
        t0 = time.monotonic()
        try:
            raw = body["envelope"]
            # native header peek: (type, channel_id, txid) straight off
            # the wire bytes; a native reject re-runs the full Python
            # deserialize so malformed submissions fail with the same
            # exceptions as before
            summary = wire.envelope_summary(raw)
            if summary is not None:
                channel_id, txid = summary[1], summary[2]
            else:
                header = Envelope.deserialize(raw).header().channel_header
                txid = header.txid
                channel_id = header.channel_id
            if not txid:
                raise ValueError("envelope has no txid")
            ch = self.node.channels.get(channel_id)
            if ch is not None:
                self._notifier(ch)   # attach before ordering can commit it
            with self._cv:
                pending = self._inflight.get(txid)
                deduped = pending is not None
                if pending is None and txid in self._recent:
                    st, info = self._recent[txid]
                    self._m_dedup.add(1)
                    return {"txid": txid, "status": st, "info": info,
                            "deduped": True}
                if pending is None:
                    # drain check AFTER the dedup window, same rationale
                    # as shed below: a retry of an admitted txid still
                    # attaches/replays, only NEW work is refused
                    if self.lifecycle != "serving":
                        return {"txid": txid, "status": 503,
                                "info": "gateway draining: new submissions"
                                        " refused, retry another peer"}
                    # shed check AFTER the dedup window: a retry of an
                    # already-admitted txid must attach/replay, never be
                    # shed — overload control cannot break idempotency.
                    # Distinct from queue-full backpressure below: shed
                    # is a typed retryable verdict with a retry-after
                    # hint, backpressure is "lost the race this instant".
                    shed = self.admission.admit("submit")
                    if shed is not None:
                        jlog(logger, "gateway.shed",
                             level=logging.WARNING, txid=txid,
                             channel=channel_id, mode=shed.mode,
                             retry_after_ms=shed.retry_after_ms,
                             severity=round(shed.severity, 3))
                        return dict(
                            shed.body(), txid=txid,
                            status=_admission.SHED_STATUS,
                            info=f"admission shed ({shed.mode}): gateway "
                                 "overloaded, retry after "
                                 f"{shed.retry_after_ms}ms")
                    if len(self._queue) >= self.max_queue:
                        self._m_backpressure.add(1)
                        jlog(logger, "gateway.backpressure",
                             level=logging.WARNING, txid=txid,
                             channel=channel_id,
                             queue_depth=len(self._queue))
                        raise RuntimeError(
                            "gateway admission queue full "
                            f"({self.max_queue}): backpressure, retry later")
                    pending = _Pending(raw, txid, channel_id)
                    self._inflight[txid] = pending
                    self._queue.append(pending)
                    self._m_depth.set(len(self._queue))
                    self._cv.notify()
            if deduped:
                self._m_dedup.add(1)
            if "timeout_ms" in body:
                timeout = min(int(body["timeout_ms"]) / 1000.0, 120.0)
            else:
                timeout = self.submit_timeout_s
            if not pending.event.wait(timeout):
                return {"txid": txid, "status": 0,
                        "info": "submit still in flight (timeout waiting "
                                "for orderer ack)", "deduped": deduped}
            return {"txid": txid, "status": pending.status,
                    "info": pending.info, "deduped": deduped}
        finally:
            self._observe("submit", t0)

    def _rpc_commit_status(self, body: dict, peer_identity) -> dict:
        """Block until the committer records the txid's validation code
        (VALID / MVCC_READ_CONFLICT / ...), no ledger polling."""
        t0 = time.monotonic()
        try:
            ch = self.node._chan(body)
            txid = str(body["txid"])
            timeout = min(int(body.get("timeout_ms", 15000)) / 1000.0, 120.0)
            notifier = self._notifier(ch)
            with tracing.tracer.start_span(
                    "gateway.commit_wait", require_parent=True,
                    attributes={"txid": txid}) as span:
                got = notifier.peek(txid)
                if got is None:
                    # committed before this gateway attached its notifier
                    # (or long ago): the block store is authoritative
                    try:
                        if ch.ledger.blockstore.has_txid(txid):
                            code = \
                                ch.ledger.blockstore.get_tx_validation_code(
                                    txid)
                            got = (int(code), -1, None)
                    except Exception:
                        got = None
                if got is None:
                    got = notifier.wait(txid, timeout)
                if got is None:
                    span.set_attribute("found", False)
                    return {"found": False, "txid": txid}
                code, block_num, block_trace = got
                span.set_attribute("found", True)
                span.set_attribute("code", int(code))
                span.set_attribute("block", block_num)
                # stitch the request trace to the block's pipeline trace
                span.add_link(block_trace)
            try:
                name = ValidationCode(code).name
            except ValueError:
                name = str(code)
            out = {"found": True, "txid": txid, "code": int(code),
                   "code_name": name, "block": block_num}
            if block_trace:
                out["block_trace_id"] = block_trace
            return out
        finally:
            self._observe("commit_status", t0)

    # batcher -----------------------------------------------------------

    def _drain(self) -> List[_Pending]:
        with self._cv:
            while not self._queue and not self._stop.is_set():
                self._cv.wait(0.2)
            if self._stop.is_set() and not self._queue:
                return []
        # linger briefly so concurrent submitters coalesce into one
        # orderer call (the admission layer's whole point)
        if self.linger_s > 0:
            time.sleep(self.linger_s)
        with self._cv:
            batch = self._queue[:self.max_batch]
            del self._queue[:len(batch)]
            self._m_depth.set(len(self._queue))
            return batch

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            try:
                self._m_batch.observe(len(batch))
            except Exception:
                pass
            # batch coalesce point: close each tx's queue-wait span and
            # open its ordering span (parented to that tx's own trace)
            spans_order = []
            for p in batch:
                p.span_queue.set_attribute("batch_size", len(batch))
                p.span_queue.end()
                spans_order.append(tracing.tracer.start_span(
                    "gateway.order", parent=p.ctx, require_parent=True,
                    attributes={"txid": p.txid, "batch_size": len(batch)}))
            # each envelope's traceparent rides beside it in the batch
            # frame: the batcher thread has no ambient context, so this
            # is how orderer-side spans join the right per-tx trace
            tps = [tracing.format_traceparent(sp.context)
                   if sp.recording else "" for sp in spans_order]
            # verify-once plane: stamp creator verdicts at ingress (one
            # batched dispatch), queue endorsement sets for speculative
            # verification while the orderer cuts the block, and send
            # the verdict attestations alongside the envelopes so the
            # orderer can skip its own device verify
            attests = None
            spec = getattr(self.node, "speculative", None)
            if spec is not None:
                try:
                    attests = spec.stamp(
                        [p.raw for p in batch],
                        [p.channel_id for p in batch],
                        spans=spans_order)
                except Exception:
                    logger.exception("verify-plane ingress stamp failed")
                    attests = None
            try:
                results = self.broadcaster.broadcast_batch(
                    [p.raw for p in batch], tps=tps, attests=attests)
            except Exception as exc:
                logger.exception("broadcast batch failed")
                jlog(logger, "gateway.broadcast_failed",
                     level=logging.ERROR, exc=exc, batch_size=len(batch),
                     txids=[p.txid for p in batch[:8]])
                results = [(500, f"gateway broadcast error: {exc}")] \
                    * len(batch)
            with self._cv:
                for p, sp, (st, info) in zip(batch, spans_order, results):
                    p.status, p.info = int(st), str(info)
                    sp.set_attribute("status", p.status)
                    sp.end("OK" if p.status == 200 else "ERROR")
                    self._inflight.pop(p.txid, None)
                    self._recent[p.txid] = (p.status, p.info)
                while len(self._recent) > self.recent_window:
                    self._recent.popitem(last=False)
            # feed per-tx gateway sojourn (queue wait + broadcast) into
            # the admission controller's latency EWMA
            done = time.monotonic()
            for p in batch:
                try:
                    self.admission.observe_latency(done - p.t_in)
                except Exception:
                    pass
            for p in batch:
                p.event.set()
