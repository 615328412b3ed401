"""Gossip transport layer.

Reference parity: gossip/comm/comm_impl.go — a bidirectional message
stream between peers with an authenticated connection handshake.  Three
transports share one interface:

  InProcNetwork: N in-process endpoints with explicit `deliver_all()`
    pumping — how the reference's gossip tests run N instances in one
    process (gossip_test.go), deterministic for fault injection.
  SecureGossipTransport: THE production path — gossip casts ride the
    node's authenticated AEAD channel plane (fabric_tpu_torch/comm: X25519 +
    signed transcript bound to MSP identities, the slot of the
    reference's mTLS + signed handshake, comm_impl.go:134-169).  Peers
    outside the channel MSPs are rejected at handshake; each inbound
    message carries the handshake-verified sender org.
  TcpTransport: length-prefixed cleartext TCP frames — DEV/TEST ONLY
    (message signatures are still checked above this layer, but there is
    no transport confidentiality or org gating).

Counterpart of `fabric_tpu/gossip/comm.py`, the same code on the port's
imports.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

from fabric_tpu_torch.utils import serde

_FRAME = struct.Struct("<I")
MAX_FRAME = 64 * 1024 * 1024

# message envelope on the wire: {"type": str, "frm": str, "body": dict}
Handler = Callable[[str, str, dict], None]  # (msg_type, from_id, body)


class InProcNetwork:
    """Deterministic in-process message fabric for tests/simulation."""

    def __init__(self):
        self._handlers: Dict[str, Handler] = {}
        self._queues: Dict[str, List[Tuple[str, str, dict]]] = {}
        self.dropped: set = set()      # unreachable endpoints
        self.partitions: List[set] = []  # optional partition groups

    def register(self, peer_id: str, handler: Handler) -> "InProcEndpoint":
        self._handlers[peer_id] = handler
        self._queues[peer_id] = []
        return InProcEndpoint(self, peer_id)

    def _reachable(self, frm: str, to: str) -> bool:
        if frm in self.dropped or to in self.dropped:
            return False
        if self.partitions:
            for group in self.partitions:
                if frm in group:
                    return to in group
        return True

    def send(self, frm: str, to: str, msg_type: str, body: dict) -> None:
        if to in self._queues and self._reachable(frm, to):
            self._queues[to].append((msg_type, frm, body))

    def deliver_all(self, max_rounds: int = 100) -> None:
        for _ in range(max_rounds):
            any_msg = False
            for peer_id in list(self._queues):
                queue, self._queues[peer_id] = self._queues[peer_id], []
                for msg_type, frm, body in queue:
                    any_msg = True
                    if peer_id not in self.dropped:
                        self._handlers[peer_id](msg_type, frm, body)
            if not any_msg:
                return

    def peer_ids(self) -> List[str]:
        return sorted(self._handlers)


class InProcEndpoint:
    def __init__(self, net: InProcNetwork, peer_id: str):
        self.net = net
        self.id = peer_id

    def send(self, to: str, msg_type: str, body: dict) -> None:
        self.net.send(self.id, to, msg_type, body)


class SecureGossipTransport:
    """Gossip endpoint on the authenticated RPC plane.

    Registers a `gossip.msg` cast on the node's RpcServer and sends via
    cached authenticated connections (dropped and re-dialed on failure —
    gossip tolerates loss).  peer ids are "host:port" strings of peers'
    RPC endpoints.  The AEAD channel handshake enforces channel-MSP
    membership (rogue orgs never reach the handler); the verified sender
    mspid rides to the handler in body["_from_mspid"] for org-scoped
    decisions above this layer.
    """

    DIAL_BACKOFF_S = 5.0

    def __init__(self, rpc_server, signer, msps):
        self.rpc = rpc_server
        self.signer = signer
        self.msps = msps
        self.id = f"{rpc_server.addr[0]}:{rpc_server.addr[1]}"
        self._handler: Optional[Handler] = None
        self._conns: Dict[str, object] = {}
        self._down_until: Dict[str, float] = {}
        self._lock = threading.Lock()
        rpc_server.serve_cast("gossip.msg", self._on_msg)

    def start(self, handler: Handler) -> None:
        self._handler = handler

    def _on_msg(self, body: dict, peer_identity) -> None:
        if self._handler is None:
            return
        try:
            msg_type = body["type"]
            frm = body["frm"]
            inner = dict(body["body"])
        except (KeyError, TypeError, ValueError):
            return    # malformed gossip frame: ignore (peer msgs untrusted)
        inner["_from_mspid"] = getattr(peer_identity, "mspid", None)
        try:
            self._handler(msg_type, frm, inner)
        except Exception:
            # a processing bug must be VISIBLE, not mistaken for noise
            import logging
            logging.getLogger("fabric_tpu_torch.gossip.comm").exception(
                "gossip handler failed for %s from %s", msg_type, frm)

    def send(self, to: str, msg_type: str, body: dict) -> None:
        import time as _time
        from fabric_tpu_torch.comm.rpc import connect
        payload = {"type": msg_type, "frm": self.id, "body": body}
        now = _time.monotonic()
        with self._lock:
            conn = self._conns.get(to)
            if conn is None and now < self._down_until.get(to, 0.0):
                return    # recent dial failure: skip (gossip tolerates loss)
        try:
            if conn is None:
                host, port = to.rsplit(":", 1)
                conn = connect((host, int(port)), self.signer, self.msps,
                               timeout=1.0)
                with self._lock:
                    existing = self._conns.get(to)
                    if existing is not None:
                        # lost a dial race: keep the first connection
                        conn.close()
                        conn = existing
                    else:
                        self._conns[to] = conn
                        self._down_until.pop(to, None)
            # fault_label exposes the inner gossip type to the fault
            # plane: rules can target e.g. "gossip.msg/gossip.block"
            # instead of the opaque multiplexed wire method
            conn.cast("gossip.msg", payload,
                      fault_label=f"gossip.msg/{msg_type}")
        except Exception:
            with self._lock:
                conn = self._conns.pop(to, None)
                self._down_until[to] = _time.monotonic() + self.DIAL_BACKOFF_S
            if conn is not None:
                try:
                    conn.close()
                except Exception:
                    pass
            # dropped: gossip tolerates message loss

    def close(self) -> None:
        with self._lock:
            for conn in self._conns.values():
                try:
                    conn.close()
                except Exception:
                    pass
            self._conns.clear()


class ChannelMux:
    """Channel multiplexer over ONE underlying transport.

    The reference runs one gossip instance per peer with per-CHANNEL
    state inside it (gossip/gossip_impl.go channel registry); here each
    channel keeps its own GossipNode, and this mux lets them share one
    authenticated transport: outbound messages carry a "_ch" tag,
    inbound messages route to the owning channel's handler.  Untagged
    messages route to the default (bootstrap) channel.
    """

    def __init__(self, transport, default_channel: str):
        self.transport = transport
        self.default_channel = default_channel
        self._handlers: Dict[str, Handler] = {}
        self._started = False
        self._lock = threading.Lock()

    def _route(self, msg_type: str, frm: str, body: dict) -> None:
        ch = body.pop("_ch", None) or self.default_channel
        handler = self._handlers.get(ch)
        if handler is not None:
            handler(msg_type, frm, body)

    def register_for(self, channel_id: str):
        """-> a `register(peer_id, handler)` callable for GossipNode."""
        mux = self

        class _Facade:
            id = self.transport.id

            @staticmethod
            def send(to: str, msg_type: str, body: dict) -> None:
                tagged = dict(body)
                tagged["_ch"] = channel_id
                mux.transport.send(to, msg_type, tagged)

        def register(peer_id, handler):
            with mux._lock:
                mux._handlers[channel_id] = handler
                if not mux._started:
                    mux.transport.start(mux._route)
                    mux._started = True
            return _Facade()

        return register


class TcpTransport:
    """Real-socket endpoint: serde frames over TCP, handler per message.

    Address book maps peer_id -> (host, port); connections are opened per
    send and cached.  Wire frame: u32 len ‖ serde{"type","frm","body"}.
    """

    def __init__(self, peer_id: str, host: str = "127.0.0.1", port: int = 0):
        self.id = peer_id
        self._handler: Optional[Handler] = None
        self._addrs: Dict[str, Tuple[str, int]] = {}
        self._conns: Dict[str, socket.socket] = {}
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.address = self._srv.getsockname()
        self._closing = False
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)

    def start(self, handler: Handler) -> None:
        self._handler = handler
        self._accept_thread.start()

    def add_peer(self, peer_id: str, address: Tuple[str, int]) -> None:
        self._addrs[peer_id] = tuple(address)

    def send(self, to: str, msg_type: str, body: dict) -> None:
        raw = serde.encode({"type": msg_type, "frm": self.id, "body": body})
        frame = _FRAME.pack(len(raw)) + raw
        with self._lock:
            sock = self._conns.get(to)
            if sock is None:
                addr = self._addrs.get(to)
                if addr is None:
                    return  # unknown peer: drop, discovery will re-learn
                try:
                    sock = socket.create_connection(addr, timeout=5)
                except OSError:
                    return  # unreachable: gossip tolerates message loss
                self._conns[to] = sock
            try:
                sock.sendall(frame)
            except OSError:
                self._conns.pop(to, None)

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True).start()

    def _read_loop(self, conn: socket.socket) -> None:
        buf = b""
        while not self._closing:
            try:
                chunk = conn.recv(65536)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while len(buf) >= _FRAME.size:
                (n,) = _FRAME.unpack_from(buf)
                if n > MAX_FRAME:
                    return  # protocol violation: drop connection
                if len(buf) < _FRAME.size + n:
                    break
                raw, buf = buf[_FRAME.size:_FRAME.size + n], \
                    buf[_FRAME.size + n:]
                try:
                    msg = serde.decode(raw)
                    self._handler(msg["type"], msg["frm"], msg["body"])
                except (ValueError, KeyError, TypeError):
                    pass  # malformed frame: ignore (peer msgs are untrusted)

    def close(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            for sock in self._conns.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._conns.clear()
