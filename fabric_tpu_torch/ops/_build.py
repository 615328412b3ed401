"""Build-on-first-use for the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into
its own shared library with a plain C interface, `build/kernels/lib<name>.so`
at the repository root (git-ignored), and loaded with `ctypes`.  A library
is rebuilt when any source in `csrc/` is newer than it.  Nothing here runs
at import time: the CPU tests import every module on hosts without `nvcc`.

The idea follows `fabric_tpu/native/__init__.py` (build C extensions on
first use); the compiler is `nvcc` and the binding is `ctypes` rather
than the CPython C API, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

# C entry points of each library: name -> argument types (int return)
_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "field_chain": {
        "field_mul_chain_group_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                         _P],
    },
    "field_chain_variants": {
        "field_chain_variant_group_launch": [_I, _I, _P, _P, _P, _I, _I, _I,
                                             _I, _P, _P],
        "field_chain_variant_attrs": [_I, _I, _I, _P],
    },
    "isa_probe": {
        "isa_probe_layout_launch": [_I, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _P],
        "isa_probe_attrs": [_I, _I, _P],
    },
    "p256_verify": {
        "p256_verify_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
        "p256_field_probe_plan_launch": [_I, _I, _P, _P, _P, _I, _P],
    },
    "p256_verify_rows": {
        "p256_verify_rows_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    },
    "ed25519_verify": {
        "ed25519_verify_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    },
    "ed25519_verify_rows": {
        "ed25519_verify_rows_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _P],
    },
    "bn254_pairing": {
        "bn254_pairing_launch": [*[_P] * 8, _I, _I, _I, _I, _P],
        "bn254_tower_probe_launch": [_I, _P, _P, _P, _I, _I, _P],
    },
    "block_validate": {
        "block_validate_launch": [_P, *[_I] * 9, _P, _P, _I, _P],
        "block_validate_phase1_launch": [_P, *[_I] * 9, _P, _P, _I, _P],
        "block_validate_walk_launch": [_P, *[_I] * 9, _P, _P, _I, _P],
        "block_validate_fold_range_launch": [_P, *[_I] * 13, _P, _P, _P],
        "block_validate_finish_launch": [_P, *[_I] * 9, _P, _P, _I, _P, _I,
                                         _P, _P],
        "block_validate_smem_slots": [],
    },
}

_lock = threading.Lock()
_libs: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return newest > out.stat().st_mtime


def _start(name: str):
    """Start nvcc for one source into a temporary file; -> (proc, tmp)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
    cmd = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: Path) -> str:
    log, _ = proc.communicate()
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib_path(name))
    return log


def build_all(force: bool = False) -> dict:
    """Compile every kernel library, one nvcc per source, all started
    together.  -> {name: {"seconds": s, "log": nvcc output}}; a library
    that is up to date is reported with seconds 0 and an empty log
    unless force is set."""
    with _lock:
        t0 = time.perf_counter()
        started = {name: _start(name) for name in SIGNATURES
                   if force or _stale(name)}
        out = {name: {"seconds": 0.0, "log": ""} for name in SIGNATURES}
        for name, (proc, tmp) in started.items():
            out[name]["log"] = _finish(name, proc, tmp)
            out[name]["seconds"] = time.perf_counter() - t0
            _libs.pop(name, None)
        return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if _stale(name):
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def kernel_resources(log: str, fragment: str) -> dict:
    """`nvcc -Xptxas -v`'s figures for the entry function whose mangled
    name holds `fragment`, from a build log -> {"regs", "frame_bytes",
    "spill_store_bytes", "spill_load_bytes"}.  Raises if the log has no
    such function (a build that printed nothing, or a renamed kernel)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None or fragment not in cur:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.update(frame_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["regs"] = int(m.group(1))
    if len(out) != 4:
        raise ValueError(f"no ptxas figures for {fragment!r} in the log")
    return out
