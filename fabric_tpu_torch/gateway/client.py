"""GatewayClient: the thin client SDK over the gateway verbs.

What the Fabric v2.4 client libraries (fabric-gateway) became once the
gateway absorbed the transaction lifecycle: the client builds and signs
the proposal and the final envelope (signing NEVER delegates to the
gateway — the peer must not hold client keys), while endorsement
fan-out, ordering, retry, and commit tracking all happen server-side.

    gw = GatewayClient(("127.0.0.1", 7051), signer, msps, channel_id="ch")
    value = gw.evaluate("assets", "read", [b"a1"])
    code, block = gw.submit_transaction("assets", "create",
                                        [b"a1", b"owner", b"100"])
    gw.close()
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from fabric_tpu_torch.comm import RpcError, connect
from fabric_tpu_torch.comm.rpc import RpcClosed
from fabric_tpu_torch.ops_plane import tracing
from fabric_tpu_torch.endorser.proposal import (
    ProposalResponse,
    SignedProposal,
    assemble_transaction,
    signed_proposal,
)
from fabric_tpu_torch.protocol import Endorsement, Envelope
from fabric_tpu_torch.protocol.txflags import ValidationCode

logger = logging.getLogger("fabric_tpu_torch.gateway")


class GatewayError(Exception):
    """A gateway verb failed (endorsement, ordering, or commit)."""

    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status


class GatewayShedError(GatewayError):
    """The gateway's admission controller shed the request: a TYPED,
    RETRYABLE overload verdict (not a failure of the request itself),
    carrying the shed mode and the server's retry-after hint.  Distinct
    from queue-full backpressure, which surfaces as a plain RpcError —
    shed means "the node is overloaded, stay away for a while"."""

    def __init__(self, message: str, mode: str = "",
                 retry_after_ms: int = 0, severity: float = 0.0):
        super().__init__(message, status=429)
        self.mode = mode
        self.retry_after_ms = int(retry_after_ms)
        self.severity = float(severity)


class GatewayClient:
    """Client handle onto one peer's gateway service.

    Thread-safe: concurrent submit_transaction calls share the single
    authenticated connection (the RPC plane multiplexes by request id,
    but calls here serialize on a lock for the blocking-reply pattern).
    """

    def __init__(self, peer_addr: Tuple[str, int], signer, msps,
                 channel_id: Optional[str] = None,
                 timeout: float = 5.0, call_timeout: float = 30.0,
                 shed_retry_max: int = 2,
                 shed_backoff_cap_s: float = 2.0, seed: int = 0):
        self.peer_addr = tuple(peer_addr)
        self.signer = signer
        self.msps = msps
        self.channel_id = channel_id
        self._timeout = timeout
        self._call_timeout = call_timeout
        # shed handling: retries honor the server's retry-after hint
        # with capped jittered backoff (NEVER an immediate retry — that
        # just re-offers the load the node asked us to withhold)
        self.shed_retry_max = int(shed_retry_max)
        self.shed_backoff_cap_s = float(shed_backoff_cap_s)
        self._rand = random.Random(seed)
        self._lock = threading.Lock()
        self._conn = None
        self._stats_lock = threading.Lock()
        self._stats = {"shed_seen": 0, "shed_retries": 0,
                       "shed_exhausted": 0}

    # plumbing ----------------------------------------------------------

    def warm(self) -> None:
        """Dial the connection NOW instead of on the first call — pool
        warm-up must actually establish the socket, or "warmed" clients
        still ramp connections (and handshake latency) into the first
        measured requests."""
        with self._lock:
            if self._conn is None:
                self._conn = connect(self.peer_addr, self.signer,
                                     self.msps, timeout=self._timeout)

    def _call(self, verb: str, body: dict,
              timeout: Optional[float] = None) -> dict:
        if timeout is None:
            timeout = self._call_timeout
        # hold the lock only around dial/teardown: RpcConnection
        # multiplexes concurrent requests over one channel, so calls
        # themselves must overlap — a population of simulated clients
        # on one socket otherwise serializes into a closed loop
        with self._lock:
            conn = self._conn
            if conn is None:
                conn = connect(self.peer_addr, self.signer, self.msps,
                               timeout=self._timeout)
                self._conn = conn
        try:
            return conn.call(verb, body, timeout=timeout)
        except RpcClosed:
            # the peer went away (crash, drain+restart): drop the dead
            # channel so the NEXT call redials — a client pinned to a
            # rolling-restarted peer must recover when it returns
            with self._lock:
                if self._conn is conn:
                    self._conn = None
            try:
                conn.close()
            except Exception:
                pass
            raise
        except RpcError:
            raise
        except Exception:
            # connection damaged: drop it so the next call redials
            with self._lock:
                if self._conn is conn:
                    self._conn = None
            try:
                conn.close()
            except Exception:
                pass
            raise

    def _shed_guard(self, out: dict, what: str) -> None:
        """Raise the typed shed error when a verb answered with an
        admission shed verdict (status 429 + shed marker)."""
        if not out.get("shed"):
            return
        with self._stats_lock:
            self._stats["shed_seen"] += 1
        raise GatewayShedError(
            f"{what} shed by gateway admission "
            f"({out.get('mode', '?')}): retry after "
            f"{out.get('retry_after_ms', 0)}ms",
            mode=str(out.get("mode", "")),
            retry_after_ms=int(out.get("retry_after_ms", 0)),
            severity=int(out.get("severity_milli", 0)) / 1000.0)

    def _with_shed_retry(self, fn: Callable[[], dict]) -> dict:
        """Run a verb, honoring shed verdicts with capped jittered
        backoff seeded per client: delay = min(hint, cap) * U[0.5, 1.5)
        * 2^(attempt-1), capped — so a shed population de-synchronizes
        instead of re-stampeding in lockstep at the hint boundary."""
        attempt = 0
        while True:
            try:
                return fn()
            except GatewayShedError as exc:
                if attempt >= self.shed_retry_max:
                    with self._stats_lock:
                        self._stats["shed_exhausted"] += 1
                    raise
                attempt += 1
                with self._stats_lock:
                    self._stats["shed_retries"] += 1
                base = min(max(exc.retry_after_ms, 50) / 1000.0,
                           self.shed_backoff_cap_s)
                delay = base * (0.5 + self._rand.random()) \
                    * (2 ** (attempt - 1))
                time.sleep(min(delay, self.shed_backoff_cap_s))

    def stats(self) -> dict:
        """Client-perceived shed counters (the workload runner's view of
        admission behaviour from outside the node)."""
        with self._stats_lock:
            return dict(self._stats)

    def _channel(self, channel: Optional[str]) -> str:
        ch = channel or self.channel_id
        if not ch:
            raise GatewayError("no channel: pass channel= or set channel_id")
        return ch

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except Exception:
                    pass
                self._conn = None

    # verbs -------------------------------------------------------------

    def evaluate(self, chaincode_id: str, fn: str, args: Sequence[bytes],
                 channel: Optional[str] = None) -> bytes:
        """Query: endorse on the gateway peer only, return the payload."""
        ch = self._channel(channel)
        sp = signed_proposal(ch, chaincode_id, fn, args, self.signer)

        def _once() -> dict:
            out = self._call("gateway.evaluate",
                             {"channel": ch, "proposal": sp.proposal_bytes,
                              "signature": sp.signature})
            self._shed_guard(out, "evaluate")
            return out

        out = self._with_shed_retry(_once)
        if out.get("status") != 200:
            raise GatewayError(
                f"evaluate failed: {out.get('message', '')}",
                status=int(out.get("status", 0)))
        return out["payload"]

    def endorse(self, chaincode_id: str, fn: str, args: Sequence[bytes],
                channel: Optional[str] = None
                ) -> Tuple[SignedProposal, List[ProposalResponse]]:
        """Collect endorsements via the gateway; returns the signed
        proposal plus responses ready for assemble_transaction."""
        ch = self._channel(channel)
        sp = signed_proposal(ch, chaincode_id, fn, args, self.signer)

        def _once() -> dict:
            out = self._call("gateway.endorse",
                             {"channel": ch, "proposal": sp.proposal_bytes,
                              "signature": sp.signature})
            self._shed_guard(out, "endorse")
            return out

        out = self._with_shed_retry(_once)
        if out.get("status") != 200 or not out.get("endorsements"):
            raise GatewayError(
                f"endorse failed: {out.get('message', '')}",
                status=int(out.get("status", 0)))
        responses = [
            ProposalResponse(200, "", out["payload"],
                             Endorsement(e["endorser"], e["signature"]))
            for e in out["endorsements"]]
        return sp, responses

    def submit_envelope(self, env: Envelope,
                        timeout_s: Optional[float] = None) -> dict:
        """Hand an assembled envelope to the gateway's admission queue;
        returns {"txid", "status", "info", "deduped"} once ordered."""
        body = {"envelope": env.serialize()}
        if timeout_s is not None:
            # serde is float-free by design: timeouts ride as int ms
            body["timeout_ms"] = int(timeout_s * 1000)

        def _once() -> dict:
            out = self._call("gateway.submit", body,
                             timeout=max((timeout_s or 20.0) + 10.0,
                                         self._call_timeout))
            self._shed_guard(out, "submit")
            return out

        out = self._with_shed_retry(_once)
        if out.get("status") != 200:
            raise GatewayError(
                f"submit failed ({out.get('status')}): "
                f"{out.get('info', '')}", status=int(out.get("status", 0)))
        return out

    def commit_status(self, txid: str, channel: Optional[str] = None,
                      timeout_s: float = 15.0) -> Tuple[int, int]:
        """Block until the txid commits; returns (validation code, block
        number).  Raises GatewayError if the wait times out."""
        ch = self._channel(channel)
        out = self._call("gateway.commit_status",
                         {"channel": ch, "txid": txid,
                          "timeout_ms": int(timeout_s * 1000)},
                         timeout=timeout_s + 10.0)
        if not out.get("found"):
            raise GatewayError(f"txid {txid} not committed within "
                               f"{timeout_s}s")
        return int(out["code"]), int(out["block"])

    # the full lifecycle -------------------------------------------------

    def submit_transaction(self, chaincode_id: str, fn: str,
                           args: Sequence[bytes],
                           channel: Optional[str] = None,
                           commit_timeout_s: float = 15.0
                           ) -> Tuple[int, int]:
        """endorse -> assemble -> submit -> wait for commit.

        Returns (validation code, block number); raises GatewayError if
        the tx commits with a non-VALID code.
        """
        ch = self._channel(channel)
        # one root span per lifecycle: endorse/submit/commit_status all
        # propagate this context in their RPC frames, so the whole tx
        # lands in ONE trace in the peer's flight recorder
        with tracing.tracer.start_span(
                "client.tx", attributes={"channel": ch,
                                         "chaincode": chaincode_id,
                                         "fn": fn}) as span:
            sp, responses = self.endorse(chaincode_id, fn, args, channel=ch)
            env = assemble_transaction(sp, responses, self.signer)
            txid = env.header().channel_header.txid
            span.set_attribute("txid", txid)
            # the commit budget bounds the ordering ack too: on a slow
            # verify provider the default in-flight window is too short
            self.submit_envelope(env, timeout_s=commit_timeout_s)
            code, block = self.commit_status(txid, channel=ch,
                                             timeout_s=commit_timeout_s)
        if code != int(ValidationCode.VALID):
            try:
                name = ValidationCode(code).name
            except ValueError:
                name = str(code)
            raise GatewayError(
                f"tx {txid} invalidated at commit: {name}", status=code)
        return code, block
