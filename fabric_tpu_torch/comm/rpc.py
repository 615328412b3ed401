"""Request/response + one-way messaging over SecureChannel.

The service plane of the framework: Broadcast/Deliver/Endorser/cluster
RPCs all speak this little protocol, the role the reference gives gRPC
(Fabric's internal/pkg/comm/server.go, orderer/common/cluster/comm.go:116).

Frames (inside the encrypted channel) are serde dicts:
  {"kind": "req",  "id": n, "method": str, "body": dict}
  {"kind": "resp", "id": n, "ok": bool, "body": dict | "error": str}
  {"kind": "cast", "method": str, "body": dict}      (one-way)
Responses may be streamed: {"kind": "stream", "id": n, "body": dict,
"done": bool} — used by Deliver.

Counterpart of `fabric_tpu/comm/rpc.py`, the same code on the port's
imports, but for `RpcServer.stop` and `RpcConnection.close`, which join
the threads they started (ROADMAP C25).
"""

from __future__ import annotations

import logging
import time as _time
import threading
import weakref
from typing import Callable, Dict, Optional

from fabric_tpu_torch.ops_plane import tracing
from fabric_tpu_torch.utils import serde

from . import faults as _faults
from .secure import SecureChannel, SecureServer, dial

logger = logging.getLogger("fabric_tpu_torch.comm.rpc")


class RpcError(Exception):
    pass


class RpcTimeout(RpcError):
    """No response within the deadline (frame lost, peer wedged, or the
    reply is still in flight)."""


class RpcClosed(RpcError):
    """The underlying channel is gone — retry means re-dialing, not
    waiting.  Replaces the old string-matched 'connection closed'."""


def _send_frame(ch: SecureChannel, frame: dict, method: str,
                kind: str) -> None:
    """All outbound frames funnel through here so the fault plane sees
    them.  Production cost: one module-attribute load when no plan is
    installed."""
    data = serde.encode(frame)
    plan = _faults._PLAN
    if plan is None:
        ch.send(data)
    else:
        plan.apply(id(ch), method, getattr(ch, "remote_addr_str", None),
                   kind, lambda: ch.send(data),
                   src=getattr(ch, "local_src_str", ""))


class RpcConnection:
    """Client side: concurrent requests over one channel.

    stream_views=True decodes incoming frames with serde.decode_views:
    bytes values arrive as read-only memoryviews into the received frame
    buffer instead of copies.  Opt-in per connection — only consumers
    that treat frame bytes as immutable spans (the deliver stream's
    zero-copy block ingest) should ask for it.
    """

    def __init__(self, channel: SecureChannel, stream_views: bool = False):
        self.channel = channel
        self.stream_views = bool(stream_views)
        self._next_id = 1
        self._lock = threading.Lock()
        self._waiters: Dict[int, "_Waiter"] = {}
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        decode = serde.decode_views if self.stream_views else serde.decode
        try:
            while True:
                msg = decode(self.channel.recv())
                wid = msg.get("id")
                with self._lock:
                    w = self._waiters.get(wid)
                if w is not None:
                    w.push(msg)
        except Exception:
            with self._lock:
                self._closed = True
                waiters = list(self._waiters.values())
            for w in waiters:
                w.push({"kind": "resp", "ok": False, "closed": True,
                        "error": "connection closed"})

    def call(self, method: str, body: dict, timeout: float = 30.0) -> dict:
        w = self._start(method, body)
        msg = w.next(timeout)
        self._finish(w)
        if msg.get("kind") == "resp" and not msg.get("ok", False):
            if msg.get("closed"):
                raise RpcClosed(msg.get("error", "connection closed"))
            raise RpcError(msg.get("error", "remote error"))
        return msg.get("body", {})

    def call_stream(self, method: str, body: dict):
        """Generator of streamed bodies until done.  Abandoning the
        generator sends a cancel so the server stops producing."""
        w = self._start(method, body)
        finished = False
        try:
            while True:
                msg = w.next(timeout=60.0)
                if msg.get("kind") == "resp":
                    finished = True
                    if not msg.get("ok", False):
                        if msg.get("closed"):
                            raise RpcClosed(
                                msg.get("error", "connection closed"))
                        raise RpcError(msg.get("error", "remote error"))
                    return
                yield msg.get("body", {})
                if msg.get("done"):
                    finished = True
                    return
        finally:
            self._finish(w)
            if not finished:
                try:
                    self.channel.send(serde.encode(
                        {"kind": "cancel", "id": w.rid}))
                except Exception:
                    pass

    def cast(self, method: str, body: dict,
             fault_label: Optional[str] = None) -> None:
        """fault_label refines what the fault plane matches as the
        `method` of this frame (e.g. "gossip.msg/gossip.block" for a
        multiplexed gossip cast) — the wire method is unchanged."""
        frame = {"kind": "cast", "method": method, "body": body}
        tp = tracing.tracer.traceparent()
        if tp:
            frame["tp"] = tp
        try:
            _send_frame(self.channel, frame, fault_label or method, "cast")
        except _faults.FaultInjected as exc:
            raise RpcError(str(exc)) from None
        except OSError as exc:
            raise RpcClosed(f"connection closed: {exc}") from None

    def _start(self, method, body) -> "_Waiter":
        with self._lock:
            if self._closed:
                raise RpcClosed("connection closed")
            rid = self._next_id
            self._next_id += 1
            w = _Waiter(rid)
            self._waiters[rid] = w
        frame = {"kind": "req", "id": rid, "method": method, "body": body}
        tp = tracing.tracer.traceparent()
        if tp:
            frame["tp"] = tp
        try:
            _send_frame(self.channel, frame, method, "req")
        except _faults.FaultInjected as exc:
            self._finish(w)
            raise RpcError(str(exc)) from None
        except OSError as exc:
            self._finish(w)
            raise RpcClosed(f"connection closed: {exc}") from None
        return w

    def _finish(self, w: "_Waiter") -> None:
        with self._lock:
            self._waiters.pop(w.rid, None)

    def close(self) -> None:
        """Close the channel and join the reader (it ends as the
        channel's recv fails), unless called from the reader itself."""
        self.channel.close()
        if self._reader is not threading.current_thread():
            self._reader.join(5.0)


class _Waiter:
    def __init__(self, rid: int):
        self.rid = rid
        self._cond = threading.Condition()
        self._queue = []

    def push(self, msg) -> None:
        with self._cond:
            self._queue.append(msg)
            self._cond.notify()

    def next(self, timeout: float):
        with self._cond:
            if not self._cond.wait_for(lambda: self._queue, timeout=timeout):
                raise RpcTimeout("rpc timeout")
            return self._queue.pop(0)


class RpcServer:
    """Server side: SecureServer + method dispatch.

    handler(method, body, peer_identity) -> dict           (unary)
    stream handlers yield dicts; register with `serve_stream`.
    cast handlers return None; register with `serve_cast`.
    """

    def __init__(self, host: str, port: int, signer, msps: Dict):
        self._unary: Dict[str, Callable] = {}
        self._stream: Dict[str, Callable] = {}
        self._cast: Dict[str, Callable] = {}
        self._cancelled: dict = {}         # (channel id, rid) -> True
        self._cancel_lock = threading.Lock()
        # accepted channels, so stop() can tear down live connections —
        # without this a stopped server's port stays claimed by
        # ESTABLISHED sockets and a restart on the same port fails
        self._channels: "weakref.WeakSet" = weakref.WeakSet()
        # connection loops and request handlers, so stop() can join them
        self._threads: set = set()
        self._threads_lock = threading.Lock()
        self.server = SecureServer(host, port, signer, msps, self._on_channel)

    @property
    def addr(self):
        return self.server.addr

    def serve(self, method: str, fn: Callable) -> None:
        self._unary[method] = fn

    def serve_stream(self, method: str, fn: Callable) -> None:
        self._stream[method] = fn

    def serve_cast(self, method: str, fn: Callable) -> None:
        self._cast[method] = fn

    def start(self) -> "RpcServer":
        self.server.start()
        return self

    def stop(self) -> None:
        """Stop accepting, close every live connection, and join the
        connection loops and the request handlers still running, for at
        most 10 s in all (a handler blocked past it is left)."""
        self.server.stop()
        for ch in list(self._channels):
            try:
                ch.close()
            except OSError:
                pass
        deadline = _time.monotonic() + 10.0
        with self._threads_lock:
            threads = list(self._threads)
        for th in threads:
            if th is not threading.current_thread():
                th.join(max(0.0, deadline - _time.monotonic()))

    def _spawn(self, target, *args) -> None:
        def run():
            try:
                target(*args)
            finally:
                with self._threads_lock:
                    self._threads.discard(threading.current_thread())
        th = threading.Thread(target=run, daemon=True)
        with self._threads_lock:
            self._threads.add(th)
        th.start()

    def _on_channel(self, ch: SecureChannel) -> None:
        self._channels.add(ch)
        self._spawn(self._conn_loop, ch)

    def _conn_loop(self, ch: SecureChannel) -> None:
        try:
            while True:
                msg = serde.decode(ch.recv())
                kind = msg.get("kind")
                if kind == "cast":
                    fn = self._cast.get(msg["method"])
                    if fn is not None:
                        ctx = tracing.tracer.context_from(msg.get("tp"))
                        try:
                            with tracing.tracer.start_span(
                                    "rpc." + msg["method"], parent=ctx,
                                    require_parent=True):
                                fn(msg.get("body", {}), ch.peer_identity)
                        except Exception:
                            logger.exception("cast handler %s failed",
                                             msg["method"])
                    continue
                if kind == "cancel":
                    with self._cancel_lock:
                        self._cancelled[(id(ch), msg.get("id"))] = True
                    continue
                if kind != "req":
                    continue
                self._spawn(self._handle_req, ch, msg)
        except Exception:
            ch.close()

    def _handle_req(self, ch: SecureChannel, msg: dict) -> None:
        rid = msg["id"]
        method = msg["method"]
        body = msg.get("body", {})
        t0 = _time.perf_counter()
        ok = True
        # continue the caller's trace (W3C traceparent carried in the
        # frame's "tp" field); no tp => no span, untraced traffic is free
        ctx = tracing.tracer.context_from(msg.get("tp"))
        span = tracing.tracer.start_span("rpc." + method, parent=ctx,
                                         require_parent=True)
        span.__enter__()
        try:
            if method in self._stream:
                key = (id(ch), rid)
                for item in self._stream[method](body, ch.peer_identity):
                    with self._cancel_lock:
                        if self._cancelled.pop(key, False):
                            return
                    _send_frame(ch, {"kind": "stream", "id": rid,
                                     "body": item, "done": False},
                                method, "stream")
                _send_frame(ch, {"kind": "resp", "id": rid, "ok": True,
                                 "body": {}}, method, "resp")
                return
            fn = self._unary.get(method)
            if fn is None:
                raise RpcError(f"unknown method {method!r}")
            out = fn(body, ch.peer_identity)
            _send_frame(ch, {"kind": "resp", "id": rid, "ok": True,
                             "body": out or {}}, method, "resp")
        except Exception as exc:
            ok = False
            if span.recording:
                span.set_attribute("error", str(exc)[:200])
            try:
                ch.send(serde.encode({"kind": "resp", "id": rid, "ok": False,
                                      "error": str(exc)[:500]}))
            except Exception:
                pass
        finally:
            if span.recording:
                span.set_attribute("ok", ok)
                span.status = "OK" if ok else "ERROR"
            span.__exit__(None, None, None)
            _observe_rpc(method, ok, _time.perf_counter() - t0)


def _observe_rpc(method: str, ok: bool, seconds: float) -> None:
    """RPC interceptor metrics (the reference's grpcmetrics unary/stream
    interceptors, common/grpcmetrics/interceptor.go): per-method request
    counts by outcome + duration histograms into the ops-plane registry."""
    try:
        from fabric_tpu_torch.ops_plane import registry
        registry.counter(
            "rpc_requests_total", "RPC requests served").add(
                1, method=method, code="OK" if ok else "ERROR")
        registry.histogram(
            "rpc_request_duration_seconds",
            "RPC handler wall time").observe(seconds, method=method)
    except Exception:
        pass      # metrics must never break the request path


def connect(addr, signer, msps: Dict, timeout: float = 10.0,
            stream_views: bool = False) -> RpcConnection:
    return RpcConnection(dial(addr, signer, msps, timeout=timeout),
                         stream_views=stream_views)
