"""Authenticated, encrypted point-to-point channels over TCP.

Reference parity: Fabric runs
every plane over gRPC with mutual TLS plus, for gossip, a signed
connection handshake binding the TLS channel to the peer's MSP identity
(Fabric's internal/pkg/comm/creds.go, gossip/comm/comm_impl.go:134-169).

A redesign rather than a TLS stack: a direct mutually
authenticated key agreement using the framework's own identity plane —
  1. each side sends  hello = {identity: <serialized MSP identity>,
     eph: <X25519 public>, nonce}
  2. each side signs the transcript hash H(client_hello || server_hello)
     with its MSP signing key and sends the signature,
  3. both verify the peer's certificate chain against the channel MSPs
     and the transcript signature with the certificate's key — the
     channel is now bound to the MSP identity (no unknown-org peers),
  4. traffic keys = HKDF(X25519 shared secret, transcript hash), one
     ChaCha20-Poly1305 key per direction, counter nonces; frames are
     length-prefixed ciphertexts.

This gives the same guarantees the reference's mTLS+handshake does
(mutual authentication to the MSP trust roots, confidentiality,
integrity, replay protection within a connection) with one fewer
moving part (no X.509-for-TLS second certificate hierarchy).

Counterpart of `fabric_tpu/comm/secure.py`, the same code on the port's
imports, but for `SecureServer.stop`, which shuts the listener down and
joins the accept loop and the handshakes in flight (ROADMAP C25).
"""

from __future__ import annotations

import hashlib
import os
import socket
import struct
import threading
from typing import Callable, Dict, Optional

from fabric_tpu_torch.crypto import (
    Aead,
    X25519PrivateKey,
    X25519PublicKey,
    hkdf_sha256,
)

from fabric_tpu_torch.utils import serde

from . import faults as _faults

_FRAME = struct.Struct("<I")
MAX_FRAME = 64 * 1024 * 1024


class HandshakeError(Exception):
    pass


def _hkdf(secret: bytes, transcript: bytes, label: bytes) -> bytes:
    return hkdf_sha256(secret, salt=transcript, info=label, length=32)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _read_frame(sock) -> bytes:
    (ln,) = _FRAME.unpack(_read_exact(sock, 4))
    if ln > MAX_FRAME:
        raise ConnectionError("oversized frame")
    return _read_exact(sock, ln)


def _write_frame(sock, data: bytes) -> None:
    sock.sendall(_FRAME.pack(len(data)) + data)


class SecureChannel:
    """One established, authenticated connection."""

    def __init__(self, sock: socket.socket, peer_identity, send_key: bytes,
                 recv_key: bytes):
        self._sock = sock
        self.peer_identity = peer_identity      # verified msp Identity
        self._send = Aead(send_key)
        self._recv = Aead(recv_key)
        self._send_ctr = 0
        self._recv_ctr = 0
        self._wlock = threading.Lock()
        # "host:port" this channel was dialed to (None on the accept side);
        # lets the fault plane sever by endpoint
        self.remote_addr_str: Optional[str] = None

    def send(self, payload: bytes) -> None:
        with self._wlock:
            nonce = self._send_ctr.to_bytes(12, "little")
            self._send_ctr += 1
            _write_frame(self._sock, self._send.encrypt(nonce, payload, b""))

    def recv(self) -> bytes:
        ct = _read_frame(self._sock)
        nonce = self._recv_ctr.to_bytes(12, "little")
        self._recv_ctr += 1
        return self._recv.decrypt(nonce, ct, b"")

    def close(self) -> None:
        # shutdown BEFORE close: a reader thread blocked in recv()
        # keeps the kernel file alive through close(), so bare close()
        # never sends FIN — the reader (and the peer's) blocks forever
        # and the socket + thread pair leaks.  shutdown() wakes it.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def _verify_peer(hello: dict, transcript: bytes, sig: bytes, msps: Dict):
    """Deserialize + chain-validate the peer identity against the channel
    MSPs, then check the transcript signature.  Returns the Identity."""
    from fabric_tpu_torch.msp import deserialize_from_msps

    ident = deserialize_from_msps(msps, hello["identity"])
    if ident is None:
        raise HandshakeError("peer identity not valid in any channel MSP")
    from fabric_tpu_torch.bccsp.factory import get_default
    item = ident.verify_item(transcript, sig)
    ok = get_default().batch_verify([item])
    if not bool(ok[0]):
        raise HandshakeError("bad handshake transcript signature")
    return ident


def _handshake(sock: socket.socket, signer, msps: Dict,
               initiator: bool) -> SecureChannel:
    eph = X25519PrivateKey.generate()
    my_hello = serde.encode({
        "identity": signer.serialize(),
        "eph": eph.public_key().public_bytes_raw(),
        "nonce": os.urandom(16),
    })
    if initiator:
        _write_frame(sock, my_hello)
        peer_hello_b = _read_frame(sock)
        transcript = hashlib.sha256(my_hello + peer_hello_b).digest()
    else:
        peer_hello_b = _read_frame(sock)
        _write_frame(sock, my_hello)
        transcript = hashlib.sha256(peer_hello_b + my_hello).digest()
    peer_hello = serde.decode(peer_hello_b)

    my_sig = signer.sign(transcript)
    _write_frame(sock, my_sig)
    peer_sig = _read_frame(sock)
    ident = _verify_peer(peer_hello, transcript, peer_sig, msps)

    shared = eph.exchange(X25519PublicKey.from_public_bytes(peer_hello["eph"]))
    k_init = _hkdf(shared, transcript, b"fabric-tpu-i2r")
    k_resp = _hkdf(shared, transcript, b"fabric-tpu-r2i")
    if initiator:
        return SecureChannel(sock, ident, k_init, k_resp)
    return SecureChannel(sock, ident, k_resp, k_init)


def dial(addr, signer, msps: Dict, timeout: float = 10.0) -> SecureChannel:
    plan = _faults._PLAN
    if plan is not None and plan.is_severed(addr):
        plan.fired["sever_refused"] += 1
        raise ConnectionRefusedError(
            f"fault plane: endpoint {_faults._addr_str(addr)} is severed")
    sock = socket.create_connection(addr, timeout=timeout)
    sock.settimeout(timeout)
    ch = _handshake(sock, signer, msps, initiator=True)
    sock.settimeout(None)
    ch.remote_addr_str = _faults._addr_str(addr)
    # source tag for per-link fault matrices: the dialing identity's
    # mspid (the only source name available at dial time — in-process
    # topologies share one fault plan, so link rules are scoped
    # src=mspid -> dst="host:port")
    ch.local_src_str = getattr(signer, "mspid", "") or ""
    _faults.register_channel(ch)
    return ch


class SecureServer:
    """Accept loop running handshakes; hands channels to `on_channel`."""

    def __init__(self, host: str, port: int, signer, msps: Dict,
                 on_channel: Callable[[SecureChannel], None]):
        self.signer = signer
        self.msps = msps
        self.on_channel = on_channel
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(64)
        self.addr = self._lsock.getsockname()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        # handshakes in flight: stop() closes their sockets and joins
        # them, so no channel is handed on after it returns
        self._pending: Dict[threading.Thread, socket.socket] = {}
        self._pending_lock = threading.Lock()

    def start(self) -> "SecureServer":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._lsock.accept()
            except OSError:
                return
            th = threading.Thread(target=self._accept_one, args=(sock,),
                                  daemon=True)
            with self._pending_lock:
                if self._stop.is_set():
                    sock.close()
                    return
                self._pending[th] = sock
            th.start()

    def _accept_one(self, sock) -> None:
        try:
            sock.settimeout(10.0)
            ch = _handshake(sock, self.signer, self.msps, initiator=False)
            sock.settimeout(None)
            if self._stop.is_set():
                ch.close()
            else:
                self.on_channel(ch)
        except Exception:
            try:
                sock.close()
            except OSError:
                pass
        finally:
            with self._pending_lock:
                self._pending.pop(threading.current_thread(), None)

    def stop(self) -> None:
        """Close the listener and every handshake in flight, and join
        the accept loop and the handshake threads (5 s each at most).
        shutdown() wakes a thread blocked in accept(), which close()
        alone does not."""
        self._stop.set()
        for fn in (lambda: self._lsock.shutdown(socket.SHUT_RDWR),
                   self._lsock.close):
            try:
                fn()
            except OSError:
                pass
        with self._pending_lock:
            pending = dict(self._pending)
        for sock in pending.values():
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for th in [self._thread, *pending]:
            if th.is_alive() and th is not threading.current_thread():
                th.join(5.0)
