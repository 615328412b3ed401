"""Out-of-process chaincode: launch, stream FSM, shim.

Reference parity: core/chaincode/chaincode_support.go (:129 Register,
:154 Execute, launch timeout), core/chaincode/handler.go (the
peer<->chaincode message FSM: the chaincode calls GetState/PutState/...
back over the SAME stream while an Invoke is in flight), and
core/container/externalbuilder (running the contract as its own OS
process).  The reference speaks gRPC bidi streams; here the stream is a
u32-length-framed serde message socket over a unix domain socket —
chaincode processes are co-located with their peer by definition, and
the authenticated RPC plane stays reserved for the network.

Peer side: ChaincodeSupport serves the socket, launches chaincode
processes (waiting for their Register within the launch timeout),
drives invocations, and relaunches dead chaincodes on the next Execute.
Chaincode side: `shim_main` connects, registers, and dispatches
invocations to a Contract-like callable via a proxy stub.

Message protocol (all serde dicts, u32-framed):
  cc -> peer   {"type": "register", "name": str}
  peer -> cc   {"type": "registered"}
  peer -> cc   {"type": "invoke", "txid", "fn", "args": [bytes]}
  cc -> peer   {"type": "get_state" | "del_state" | "get_private" |
                "put_state" | "put_private" | "del_private" |
                "range" | "set_event" | ...}       (callbacks, see FSM)
  peer -> cc   {"type": "resp", ...}               (callback answers)
  cc -> peer   {"type": "complete", "payload"} | {"type": "error", "message"}
  either way   {"type": "ping"} / {"type": "pong"} (keepalive)

Counterpart of `fabric_tpu/chaincode/extcc.py`, the same code on the
port's imports.  The protocol and the launch environment
(`FABRIC_TPU_CC_SOCK`, `_NAME`, `_TOKEN`) are the reference's byte for
byte, so a chaincode process built on either package registers with
either package's `ChaincodeSupport`.  A chaincode process of the port
imports `fabric_tpu_torch.chaincode.extcc.shim_main`.
"""

from __future__ import annotations

import hmac
import logging
import os
import secrets
import socket
import struct
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.utils import serde

from .runtime import Contract
from .stub import SimulationError

logger = logging.getLogger("fabric_tpu_torch.chaincode.extcc")

_FRAME = struct.Struct("<I")
MAX_FRAME = 64 * 1024 * 1024


def _send(sock: socket.socket, msg: dict) -> None:
    raw = serde.encode(msg)
    sock.sendall(_FRAME.pack(len(raw)) + raw)


def _recv(sock: socket.socket, timeout: Optional[float] = None) -> dict:
    sock.settimeout(timeout)
    hdr = b""
    while len(hdr) < _FRAME.size:
        chunk = sock.recv(_FRAME.size - len(hdr))
        if not chunk:
            raise ConnectionError("chaincode stream closed")
        hdr += chunk
    (n,) = _FRAME.unpack(hdr)
    if n > MAX_FRAME:
        raise ConnectionError("oversized chaincode frame")
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("chaincode stream closed")
        buf += chunk
    return serde.decode(buf)


class _CCHandle:
    """One registered chaincode process: its stream + process handle."""

    def __init__(self, name: str, sock: socket.socket,
                 proc: Optional[subprocess.Popen] = None):
        self.name = name
        self.sock = sock
        self.proc = proc
        self.lock = threading.Lock()    # one invocation at a time

    def alive(self) -> bool:
        """Cheap liveness: process state only.  No ping round trip per
        invoke — a dead stream surfaces as a failed invoke, whose error
        path already tears the handle down for relaunch."""
        return self.proc is None or self.proc.poll() is None

    def ping(self) -> bool:
        """Explicit keepalive probe (used by periodic health checks, not
        the per-invoke hot path)."""
        if not self.alive():
            return False
        try:
            with self.lock:
                _send(self.sock, {"type": "ping"})
                msg = _recv(self.sock, timeout=2.0)
            return msg.get("type") == "pong"
        except (OSError, ValueError, ConnectionError):
            return False

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()


class ChaincodeSupport:
    """Peer-side chaincode process manager (chaincode_support.go)."""

    def __init__(self, sock_dir: str, launch_timeout_s: float = 10.0,
                 invoke_timeout_s: float = 30.0):
        os.makedirs(sock_dir, mode=0o700, exist_ok=True)
        os.chmod(sock_dir, 0o700)
        self.sock_path = os.path.join(sock_dir, "chaincode.sock")
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)
        self.launch_timeout_s = launch_timeout_s
        self.invoke_timeout_s = invoke_timeout_s
        self._handles: Dict[str, _CCHandle] = {}
        self._launch_cmds: Dict[str, List[str]] = {}
        self._pending: Dict[str, socket.socket] = {}
        # per-launch registration tokens: a registration for `name` is
        # only accepted while a launch() for that name is in flight AND
        # the register message carries the token handed to that child
        # via env — the reference authenticates chaincode streams with
        # peer-generated TLS client certs (core/chaincode handler auth);
        # here the unix-socket analogue is a random bearer token.
        self._expected_tokens: Dict[str, str] = {}
        self._cond = threading.Condition()
        self._closing = False
        old_umask = os.umask(0o077)
        try:
            self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._srv.bind(self.sock_path)
        finally:
            os.umask(old_umask)
        self._srv.listen(16)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # -- registration (chaincode_support.go:129) -----------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._register_conn, args=(conn,),
                             daemon=True).start()

    def _register_conn(self, conn: socket.socket) -> None:
        try:
            msg = _recv(conn, timeout=self.launch_timeout_s)
            if msg.get("type") != "register" or not msg.get("name"):
                conn.close()
                return
            name = msg["name"]
            token = msg.get("token", "")
            with self._cond:
                expected = self._expected_tokens.get(name)
            if expected is None or not hmac.compare_digest(
                    str(token), expected):
                logger.warning(
                    "rejecting chaincode registration for %r: no launch "
                    "in flight or bad token", name)
                conn.close()
                return
            _send(conn, {"type": "registered"})
        except (OSError, ValueError, ConnectionError):
            conn.close()
            return
        with self._cond:
            self._pending[name] = conn
            self._cond.notify_all()

    def launch(self, name: str, argv: List[str]) -> None:
        """Spawn the chaincode process and wait for its Register (launch
        timeout parity: chaincode_support.go Launch)."""
        self._launch_cmds[name] = list(argv)
        token = secrets.token_hex(16)
        env = dict(os.environ)
        env["FABRIC_TPU_CC_SOCK"] = self.sock_path
        env["FABRIC_TPU_CC_NAME"] = name
        env["FABRIC_TPU_CC_TOKEN"] = token
        with self._cond:
            # purge any stale registration from a PREVIOUS launch whose
            # child passed the token check but registered after that
            # launch timed out — pairing a new process with the old
            # child's socket would route invokes to the wrong process
            stale = self._pending.pop(name, None)
            self._expected_tokens[name] = token
        if stale is not None:
            try:
                stale.close()
            except OSError:
                pass
        try:
            proc = subprocess.Popen(argv, env=env)
            deadline = time.monotonic() + self.launch_timeout_s
            with self._cond:
                while name not in self._pending:
                    left = deadline - time.monotonic()
                    if left <= 0 or proc.poll() is not None:
                        proc.kill()
                        raise SimulationError(
                            f"chaincode {name!r} failed to register within "
                            f"{self.launch_timeout_s}s")
                    self._cond.wait(timeout=min(left, 0.5))
                conn = self._pending.pop(name)
        finally:
            with self._cond:
                self._expected_tokens.pop(name, None)
                late = self._pending.pop(name, None)
            if late is not None:
                # registered between the timeout and the token purge:
                # nothing will ever consume this socket — close it
                try:
                    late.close()
                except OSError:
                    pass
        old = self._handles.get(name)
        if old is not None:
            old.close()
        self._handles[name] = _CCHandle(name, conn, proc)
        logger.info("chaincode %s registered (pid %s)", name, proc.pid)

    # -- execution FSM (handler.go) ------------------------------------------

    def execute(self, stub, name: str, fn: str, args: List[bytes]) -> bytes:
        handle = self._handles.get(name)
        if handle is None or not handle.alive():
            argv = self._launch_cmds.get(name)
            if argv is None:
                raise SimulationError(
                    f"chaincode {name!r} not launched and no launch "
                    "command known")
            logger.warning("chaincode %s dead; relaunching", name)
            self.launch(name, argv)
            handle = self._handles[name]
        with handle.lock:
            try:
                return self._drive(handle, stub, fn, args)
            except (OSError, ConnectionError, ValueError) as e:
                handle.close()
                self._handles.pop(name, None)
                raise SimulationError(
                    f"chaincode {name!r} stream failed: {e}") from e

    def _drive(self, handle: _CCHandle, stub, fn: str,
               args: List[bytes]) -> bytes:
        _send(handle.sock, {"type": "invoke", "txid": stub.txid or "",
                            "fn": fn, "args": [bytes(a) for a in args]})
        deadline = time.monotonic() + self.invoke_timeout_s
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise ConnectionError("invoke timeout")
            msg = _recv(handle.sock, timeout=left)
            t = msg.get("type")
            if t == "complete":
                return msg.get("payload", b"")
            if t == "error":
                raise SimulationError(str(msg.get("message", "chaincode "
                                                             "error")))
            if t == "ping":
                _send(handle.sock, {"type": "pong"})
            elif t == "get_state":
                v = stub.get_state(msg["key"])
                _send(handle.sock, {"type": "resp",
                                    "value": v if v is not None else b"",
                                    "found": v is not None})
            elif t == "put_state":
                stub.put_state(msg["key"], msg["value"])
                _send(handle.sock, {"type": "resp"})
            elif t == "del_state":
                stub.del_state(msg["key"])
                _send(handle.sock, {"type": "resp"})
            elif t == "range":
                items = [[k, v] for k, v in stub.get_state_by_range(
                    msg["start"], msg["end"], limit=int(msg.get("limit", 0)))]
                _send(handle.sock, {"type": "resp", "items": items})
            elif t == "get_private":
                v = stub.get_private_data(msg["collection"], msg["key"])
                _send(handle.sock, {"type": "resp",
                                    "value": v if v is not None else b"",
                                    "found": v is not None})
            elif t == "put_private":
                stub.put_private_data(msg["collection"], msg["key"],
                                      msg["value"])
                _send(handle.sock, {"type": "resp"})
            elif t == "del_private":
                stub.del_private_data(msg["collection"], msg["key"])
                _send(handle.sock, {"type": "resp"})
            elif t == "set_event":
                stub.set_event(msg["name"], msg["payload"])
                _send(handle.sock, {"type": "resp"})
            else:
                raise ConnectionError(f"unknown chaincode message {t!r}")

    def stop(self) -> None:
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass
        for handle in self._handles.values():
            handle.close()
        self._handles.clear()


class ExtProcessContract(Contract):
    """Registry adapter: routes invoke() through a ChaincodeSupport-managed
    external process (the in-process registry stays the dev mode)."""

    def __init__(self, support: ChaincodeSupport, name: str,
                 argv: List[str]):
        self.support = support
        self.name = name
        self.argv = argv
        self._launched = False

    def invoke(self, stub, fn: str, args: List[bytes]) -> bytes:
        if not self._launched:
            self.support.launch(self.name, self.argv)
            self._launched = True
        return self.support.execute(stub, self.name, fn, args)


# ---------------------------------------------------------------------------
# chaincode-side shim
# ---------------------------------------------------------------------------

class ShimStub:
    """The chaincode process's view of the peer stub: every call is a
    callback message over the registration stream (handler.go FSM)."""

    def __init__(self, sock: socket.socket, txid: str):
        self._sock = sock
        self.txid = txid

    def _call(self, msg: dict) -> dict:
        _send(self._sock, msg)
        return _recv(self._sock, timeout=30.0)

    def get_state(self, key: str) -> Optional[bytes]:
        r = self._call({"type": "get_state", "key": key})
        return r["value"] if r.get("found") else None

    def put_state(self, key: str, value: bytes) -> None:
        self._call({"type": "put_state", "key": key, "value": value})

    def del_state(self, key: str) -> None:
        self._call({"type": "del_state", "key": key})

    def get_state_by_range(self, start: str, end: str, limit: int = 0):
        r = self._call({"type": "range", "start": start, "end": end,
                        "limit": limit})
        return [(k, v) for k, v in r.get("items", [])]

    def get_private_data(self, collection: str, key: str) -> Optional[bytes]:
        r = self._call({"type": "get_private", "collection": collection,
                        "key": key})
        return r["value"] if r.get("found") else None

    def put_private_data(self, collection: str, key: str,
                         value: bytes) -> None:
        self._call({"type": "put_private", "collection": collection,
                    "key": key, "value": value})

    def del_private_data(self, collection: str, key: str) -> None:
        self._call({"type": "del_private", "collection": collection,
                    "key": key})

    def set_event(self, name: str, payload: bytes) -> None:
        self._call({"type": "set_event", "name": name, "payload": payload})


def shim_main(contract, name: Optional[str] = None,
              sock_path: Optional[str] = None) -> None:
    """Chaincode process entry point: connect, register, serve invokes.

    `contract` is anything with invoke(stub, fn, args) -> bytes (the
    Contract interface) or a plain callable(stub, fn, args).
    """
    name = name or os.environ["FABRIC_TPU_CC_NAME"]
    sock_path = sock_path or os.environ["FABRIC_TPU_CC_SOCK"]
    token = os.environ.get("FABRIC_TPU_CC_TOKEN", "")
    invoke = (contract.invoke if hasattr(contract, "invoke") else contract)
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(sock_path)
    _send(sock, {"type": "register", "name": name, "token": token})
    msg = _recv(sock, timeout=10.0)
    if msg.get("type") != "registered":
        raise RuntimeError("registration rejected")
    while True:
        msg = _recv(sock, timeout=None)
        t = msg.get("type")
        if t == "ping":
            _send(sock, {"type": "pong"})
            continue
        if t != "invoke":
            continue
        stub = ShimStub(sock, msg.get("txid", ""))
        try:
            payload = invoke(stub, msg["fn"], list(msg.get("args", [])))
            _send(sock, {"type": "complete",
                         "payload": payload if payload else b""})
        except Exception as e:                     # noqa: BLE001
            _send(sock, {"type": "error", "message": str(e)})
