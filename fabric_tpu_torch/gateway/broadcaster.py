"""Batched orderer broadcast behind per-orderer circuit breakers.

The transmit half of the gateway: coalesced envelope batches go to one
orderer as a single `broadcast_batch` RPC.  Where a first design rotated blindly
through the orderer list under one shared backoff, each orderer now has
its own breaker + health score:

  CLOSED      normal traffic; consecutive failures are counted
  OPEN        `failure_threshold` consecutive failures tripped it; no
              traffic until `open_until` (exponential per-trip cooldown)
  HALF_OPEN   cooldown lapsed; ONE probe batch is allowed through —
              success closes the breaker, failure re-opens it with a
              longer cooldown

Selection is sticky on the current orderer while its breaker is CLOSED
(keeps one warm connection, preserves batch affinity), and otherwise
prefers the healthiest candidate: CLOSED beats HALF_OPEN beats OPEN,
ties broken by latency EWMA then failure history.  When every breaker
is OPEN the earliest-expiring one is force-probed — a fully-failed
orderer set degrades to slow retries, never to a wedge.

Failure classification uses the typed RPC errors (`RpcClosed` → the
connection died, re-dial; `RpcTimeout` → frame lost or orderer wedged)
instead of the old string matching.  Every breaker transition emits a
metric, a jlog line, and a span event on the ambient trace.

Per-envelope outcomes stay independent: a 4xx (bad envelope, unknown
channel, filter veto) is final for that envelope only, while 503s
requeue for the next attempt until the deadline lapses.

Leader hint: a follower that answers 503 includes the raft leader's id
in its response (`BroadcastResponse.leader_hint`).  The broadcaster maps
raft ids to endpoints by lazily probing each orderer's `status` RPC, and
the next rotation jumps STRAIGHT to the leader instead of walking the
list — without the hint a 5-orderer set wastes up to 4 failed attempts
(plus backoffs) per leadership change before landing on the node that
can actually order.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Sequence, Tuple

from fabric_tpu_torch.comm import RpcClosed, RpcTimeout, connect
from fabric_tpu_torch.ops_plane import tracing
from fabric_tpu_torch.ops_plane.logging import jlog

logger = logging.getLogger("fabric_tpu_torch.gateway")

CLOSED, OPEN, HALF_OPEN = "CLOSED", "OPEN", "HALF_OPEN"


class _OrdererState:
    """Breaker + health score for one orderer endpoint."""

    __slots__ = ("addr", "state", "consec_fails", "trips", "open_until",
                 "ewma_s", "ok_total", "fail_total")

    def __init__(self, addr):
        self.addr = tuple(addr)
        self.state = CLOSED
        self.consec_fails = 0
        self.trips = 0             # lifetime breaker openings
        self.open_until = 0.0
        self.ewma_s = 0.0          # smoothed broadcast latency
        self.ok_total = 0
        self.fail_total = 0

    def usable(self, now: float) -> bool:
        """May traffic be sent to this orderer right now?"""
        if self.state == CLOSED:
            return True
        return now >= self.open_until        # OPEN past cooldown => probe

    def score(self) -> Tuple:
        """Lower is better; total order over candidates."""
        rank = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}[self.state]
        return (rank, self.ewma_s, self.consec_fails, self.fail_total)

    def as_dict(self) -> dict:
        return {"addr": "%s:%s" % self.addr, "state": self.state,
                "consec_fails": self.consec_fails, "trips": self.trips,
                "ewma_ms": round(self.ewma_s * 1e3, 3),
                "ok_total": self.ok_total, "fail_total": self.fail_total}


class BatchBroadcaster:
    def __init__(self, orderers: Sequence[Tuple[str, int]], signer, msps,
                 backoff_base_s: float = 0.05, backoff_max_s: float = 2.0,
                 deadline_s: float = 10.0, rpc_timeout_s: float = 10.0,
                 failure_threshold: int = 3,
                 cooldown_base_s: float = 0.25, cooldown_max_s: float = 8.0):
        if not orderers:
            raise ValueError("gateway needs at least one orderer")
        self.orderers = [tuple(o) for o in orderers]
        self.signer = signer
        self.msps = msps
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.deadline_s = deadline_s
        self.rpc_timeout_s = rpc_timeout_s
        self.failure_threshold = int(failure_threshold)
        self.cooldown_base_s = cooldown_base_s
        self.cooldown_max_s = cooldown_max_s
        self._lock = threading.Lock()
        self._states = [_OrdererState(a) for a in self.orderers]
        self._idx = 0          # current orderer (sticky while healthy)
        self._conn = None
        self._failures = 0     # consecutive rotate count (drives backoff)
        self._raft_ids = {}    # orderer idx -> raft id (from status probes)
        self._leader_idx = None  # where the last leader hint points

    # breaker -----------------------------------------------------------

    def _set_state(self, st: _OrdererState, new: str, reason: str) -> None:
        """Caller holds self._lock.  Observability is best-effort."""
        old, st.state = st.state, new
        if old == new:
            return
        addr = "%s:%s" % st.addr
        try:
            from fabric_tpu_torch.ops_plane import registry
            registry.counter(
                "gateway_breaker_transitions_total",
                "orderer circuit-breaker state changes").add(
                    1, orderer=addr, to=new)
            registry.gauge(
                "gateway_orderer_breaker_open",
                "1 while the orderer's breaker is open").set(
                    1.0 if new == OPEN else 0.0, orderer=addr)
            jlog(logger, "gateway.breaker", orderer=addr,
                 level=logging.WARNING if new == OPEN else logging.INFO,
                 old=old, new=new, reason=reason, trips=st.trips)
            tracing.event("breaker." + new.lower(), orderer=addr,
                          reason=reason)
        except Exception:
            pass

    def _on_success(self, idx: int, latency_s: float) -> None:
        with self._lock:
            st = self._states[idx]
            st.ok_total += 1
            st.consec_fails = 0
            st.ewma_s = latency_s if st.ewma_s == 0.0 else \
                0.8 * st.ewma_s + 0.2 * latency_s
            self._set_state(st, CLOSED, "success")
            self._failures = 0
            self._leader_idx = None   # hint consumed; stickiness takes over

    def _on_failure(self, idx: int, reason: str) -> None:
        now = time.monotonic()
        with self._lock:
            st = self._states[idx]
            st.fail_total += 1
            st.consec_fails += 1
            if st.state == HALF_OPEN or \
                    st.consec_fails >= self.failure_threshold:
                st.trips += 1
                st.open_until = now + min(
                    self.cooldown_max_s,
                    self.cooldown_base_s * (2 ** min(st.trips - 1, 16)))
                self._set_state(st, OPEN, reason)

    def _select(self) -> int:
        """Pick the orderer for the next attempt (caller holds lock)."""
        now = time.monotonic()
        cur = self._states[self._idx]
        if cur.state == CLOSED:
            return self._idx
        candidates = []
        for i, st in enumerate(self._states):
            if st.state == OPEN and st.usable(now):
                # cooldown lapsed: promote to HALF_OPEN, allow one probe
                self._set_state(st, HALF_OPEN, "cooldown_elapsed")
            if st.usable(now) or st.state == HALF_OPEN:
                candidates.append(i)
        if candidates:
            # the last leader hint beats the health score while the
            # leader's own breaker is CLOSED — the healthiest follower
            # still answers 503 to every broadcast
            li = self._leader_idx
            if li in candidates and self._states[li].state == CLOSED:
                return li
            return min(candidates, key=lambda i: self._states[i].score())
        # everything OPEN inside cooldown: force-probe the one expiring
        # first so a total outage recovers without operator action
        return min(range(len(self._states)),
                   key=lambda i: self._states[i].open_until)

    # introspection ------------------------------------------------------

    def healthy(self) -> bool:
        """True while at least one orderer's breaker is not OPEN — the
        `/healthz` "orderer reachable" signal."""
        with self._lock:
            return any(st.state != OPEN for st in self._states)

    def states(self) -> List[dict]:
        with self._lock:
            return [st.as_dict() for st in self._states]

    def latency_ewma(self) -> float:
        """Smoothed broadcast latency (seconds) of the current orderer,
        falling back to the best-known peer — the admission plane's
        downstream-backpressure signal.  0.0 until a broadcast lands."""
        with self._lock:
            st = self._states[self._idx]
            if st.ewma_s > 0.0:
                return st.ewma_s
            vals = [s.ewma_s for s in self._states if s.ewma_s > 0.0]
            return min(vals) if vals else 0.0

    # connection management --------------------------------------------

    def _backoff(self) -> float:
        return min(self.backoff_max_s,
                   self.backoff_base_s * (2 ** min(self._failures, 16)))

    def _connection(self):
        with self._lock:
            target = self._select()
            if self._conn is not None and target == self._idx:
                return self._idx, self._conn
            if self._conn is not None:
                try:
                    self._conn.close()
                except Exception:
                    pass
                self._conn = None
            self._idx = target
            addr = self.orderers[self._idx]
            self._conn = connect(addr, self.signer, self.msps,
                                 timeout=min(self.rpc_timeout_s, 5.0))
            return self._idx, self._conn

    def _rotate(self, reason: str, prefer: Optional[int] = None) -> None:
        followed = False
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except Exception:
                    pass
                self._conn = None
            if prefer is not None and prefer != self._idx:
                # leader hint: jump straight to the node that can order
                # instead of walking the list one failed attempt at a time
                self._idx = prefer
                followed = True
            else:
                # legacy rotation: advance off the failed orderer so the
                # next _connection() re-selects; _select may override
                self._idx = (self._idx + 1) % len(self.orderers)
            self._failures += 1
        try:
            from fabric_tpu_torch.ops_plane import registry
            registry.counter(
                "gateway_broadcast_retries_total",
                "orderer broadcast attempts that failed over").add(
                    1, reason=reason)
            if followed:
                registry.counter(
                    "gateway_leader_follows_total",
                    "rotations that jumped to the hinted raft leader").add(
                        1, orderer="%s:%s" % self.orderers[prefer])
        except Exception:
            pass

    def _learn_leader(self, raft_id) -> Optional[int]:
        """Map a raft leader id from a broadcast response to an orderer
        index, lazily probing unprobed endpoints' `status` RPC to build
        the raft-id -> endpoint table.  Returns the index (and records
        it as the rotation preference) or None when unknown/stale."""
        try:
            raft_id = int(raft_id or 0)
        except (TypeError, ValueError):
            return None
        if raft_id <= 0:
            return None
        with self._lock:
            known = dict(self._raft_ids)
        for i, rid in known.items():
            if rid == raft_id:
                with self._lock:
                    self._leader_idx = i
                return i
        # probe outside the lock: status is a fast metadata RPC, but a
        # dead endpoint costs a dial timeout we must not serialize the
        # breaker plane behind
        for i, addr in enumerate(self.orderers):
            if i in known or self._states[i].state == OPEN:
                continue
            try:
                conn = connect(addr, self.signer, self.msps, timeout=2.0)
                try:
                    out = conn.call("status", {}, timeout=2.0)
                finally:
                    conn.close()
                rid = int(out.get("raft_id", 0))
            except Exception:
                continue
            with self._lock:
                self._raft_ids[i] = rid
            if rid == raft_id:
                with self._lock:
                    self._leader_idx = i
                return i
        return None

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except Exception:
                    pass
                self._conn = None

    # broadcast ---------------------------------------------------------

    def broadcast_batch(
            self, envs: Sequence,
            deadline_s: Optional[float] = None,
            tps: Optional[Sequence[str]] = None,
            attests: Optional[Sequence[str]] = None
    ) -> List[Tuple[int, str]]:
        """Send every envelope, retrying transient failures across the
        orderer set; returns one (status, info) per envelope in order.

        `tps` (optional, aligned with envs) carries each envelope's
        traceparent so the orderer can continue per-tx traces even
        though the whole batch rides one RPC frame.  `attests` (same
        alignment) carries the verify-once plane's per-envelope verdict
        attestations; both are re-aligned by pending index on every 503
        retry so a partial requeue never shifts an attestation onto a
        different envelope."""
        results: List[Optional[Tuple[int, str]]] = [None] * len(envs)
        pending = list(enumerate(envs))
        deadline = time.monotonic() + (deadline_s if deadline_s is not None
                                       else self.deadline_s)
        while pending:
            try:
                # _connection sets self._idx to the dial target before it
                # can raise, so failure paths charge the right orderer
                idx, conn = self._connection()
                # raw wire bytes pass through untouched (zero-copy submit
                # path); Envelope objects serialize here as before
                body = {"envelopes": [
                    e if isinstance(e, (bytes, bytearray, memoryview))
                    else e.serialize() for _, e in pending]}
                if tps and any(tps):
                    body["tps"] = [tps[i] if i < len(tps) else ""
                                   for i, _ in pending]
                if attests and any(attests):
                    body["attests"] = [attests[i] if i < len(attests)
                                       else "" for i, _ in pending]
                t0 = time.monotonic()
                out = conn.call(
                    "broadcast_batch", body,
                    timeout=self.rpc_timeout_s)
                latency = time.monotonic() - t0
                statuses = [int(s) for s in out["statuses"]]
                infos = [str(s) for s in out.get(
                    "infos", [""] * len(statuses))]
            except RpcClosed as exc:
                logger.debug("broadcast: connection closed: %s", exc)
                self._on_failure(self._idx, "closed")
                self._rotate("closed")
                if time.monotonic() >= deadline:
                    break
                time.sleep(self._backoff())
                continue
            except RpcTimeout as exc:
                logger.debug("broadcast: rpc timeout: %s", exc)
                self._on_failure(self._idx, "timeout")
                self._rotate("timeout")
                if time.monotonic() >= deadline:
                    break
                time.sleep(self._backoff())
                continue
            except Exception as exc:
                logger.debug("broadcast to orderer failed: %s", exc)
                self._on_failure(self._idx, "connection")
                self._rotate("connection")
                if time.monotonic() >= deadline:
                    break
                time.sleep(self._backoff())
                continue
            retry = []
            for (i, env), st, info in zip(pending, statuses, infos):
                if st == 503:
                    retry.append((i, env))
                    results[i] = (st, info)   # stands if the deadline hits
                else:
                    results[i] = (st, info)
            if not retry:
                self._on_success(idx, latency)
                break
            pending = retry
            # the orderer answered but can't order (no leader / halted):
            # transport is fine, service is not — count against health.
            # Follow its leader hint so the retry lands on the raft
            # leader instead of the next follower in the list.
            self._on_failure(idx, "unavailable")
            self._rotate("unavailable",
                         prefer=self._learn_leader(out.get("leader")))
            if time.monotonic() >= deadline:
                break
            time.sleep(self._backoff())
        for i, _ in pending:
            if results[i] is None:
                results[i] = (503, "broadcast deadline exceeded")
        return [r if r is not None else (503, "not attempted")
                for r in results]
