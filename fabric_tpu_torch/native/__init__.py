"""Host C helpers of the port, built on first use.

Counterpart of `fabric_tpu/native/__init__.py`: each `<name>.c` here is
compiled with the host C compiler (`cc`, else `gcc`) into
`build/native/lib<name>.so` at the repository root (git-ignored) and
loaded with `ctypes`.  The sources use no CPython API, so a build takes
about a second and needs no Python headers.  A library is rebuilt when
its source is newer.  There is no pure-Python fallback: without a
compiler, or when the build fails, `load` raises.

Libraries:
  der — `parse_der_sigs`, the batch strict-DER ECDSA signature parser
        (counterpart of `_fastcollect.parse_der_sigs`)
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ["-O3", "-shared", "-fPIC", "-Wall", "-Wextra", "-Werror"]

# C entry points of each library: name -> (argument types, return type)
_P = ctypes.c_void_p
SIGNATURES = {
    "der": {
        "parse_der_sigs": ([_P, _P, ctypes.c_int64, _P, _P], ctypes.c_int),
    },
}

_lock = threading.Lock()
_libs: dict = {}


def find_cc() -> str:
    for name in ("cc", "gcc"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C compiler (cc or gcc) on PATH: the port's host "
                       "C helpers are built on first use")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(name: str) -> str:
    """Compile <name>.c into its library; -> the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    cmd = [find_cc(), *CFLAGS, str(SRC_DIR / f"{name}.c"), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cc failed for {name}.c (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path(name))
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for <name>.c, building it if it is missing or
    older than its source."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out = lib_path(name)
        src = SRC_DIR / f"{name}.c"
        if not out.exists() or src.stat().st_mtime > out.stat().st_mtime:
            build(name)
        lib = ctypes.CDLL(str(out))
        for fn_name, (argtypes, restype) in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[name] = lib
        return lib


def parse_der_sigs(sigs) -> tuple:
    """Strict-DER parse of a sequence of ECDSA signatures in one C call.

    -> (ok: (N,) bool, rs: (N, 64) uint8), rs holding r and s as 32-byte
    big-endian integers for the well-formed entries and zeros elsewhere.
    An entry is well-formed when it is `bytes`, a DER SEQUENCE of two
    INTEGERs in minimal encoding with nothing after it, and 0 < r, s <
    2^256; entries of any other type are rejected."""
    parts = [s if isinstance(s, bytes) else b"" for s in sigs]
    n = len(parts)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(np.fromiter(map(len, parts), np.int64, n), out=offs[1:])
    buf = np.frombuffer(b"".join(parts) or b"\0", np.uint8)
    ok = np.zeros(n, np.uint8)
    rs = np.zeros((n, 64), np.uint8)
    rc = load("der").parse_der_sigs(buf.ctypes.data, offs.ctypes.data, n,
                                    ok.ctypes.data, rs.ctypes.data)
    if rc:
        raise RuntimeError(f"parse_der_sigs failed: {rc}")
    return ok.view(bool), rs
