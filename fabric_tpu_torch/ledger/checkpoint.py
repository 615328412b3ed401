"""Crash-consistent sharded checkpoints: content-hashed shard files plus
an atomically-renamed manifest.

The durability contract shared by the state and history DBs (and by the
snapshot state-transfer path, which ships these exact files):

  1. every shard payload is written to ``ckpt/<gen>/shard_NNNN.bin`` via
     tmp-file + fsync + rename, then the generation directory is fsynced
     — the files are durable BEFORE anything points at them;
  2. the manifest (generation number, savepoint, per-shard sha256) is
     written to ``MANIFEST.tmp`` + fsync, the old ``MANIFEST`` is renamed
     to ``MANIFEST.prev``, and the tmp renamed over ``MANIFEST``.

A kill at ANY instant therefore leaves one of three recoverable states:
the new manifest (complete), no manifest but a ``.prev`` (killed between
the two renames), or the old manifest (killed any earlier).  `recover`
walks current → previous, verifying every shard file against its
recorded hash, and returns the newest checkpoint whose bytes all check
out — a torn shard file, a bitflipped payload, or a manifest pointing at
a missing generation all fall through to the previous good state (and
ultimately to "no checkpoint": full replay from the block store, which
is always correct, just slow).

Reference parity: the role of core/ledger/kvledger/snapshot.go's
signed file hashes + metadata, with leveldb's MANIFEST/CURRENT rename
discipline standing in for the atomic pointer flip.

Counterpart of `fabric_tpu/ledger/checkpoint.py`, whole: the same files
byte for byte (the manifest is the same serde encoding), so either
package recovers the other's checkpoints.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.utils import serde

MANIFEST = "MANIFEST"
PREV_SUFFIX = ".prev"
CKPT_DIR = "ckpt"


def shard_file(i: int) -> str:
    return f"shard_{i:04d}.bin"


def gen_dir(root: str, gen: int) -> str:
    return os.path.join(root, CKPT_DIR, f"{int(gen):08d}")


def _fsync_dir(path: str) -> None:
    """Durably record renames/creates inside a directory (no-op on
    platforms that refuse O_RDONLY dir fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_durable(path: str, payload: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_checkpoint(root: str, gen: int, payloads: List[bytes],
                     meta: Optional[dict] = None) -> dict:
    """Write one checkpoint generation + flip the manifest to it.
    `meta` keys (savepoint etc.) are merged into the manifest.  Returns
    the manifest dict as written."""
    d = gen_dir(root, gen)
    os.makedirs(d, exist_ok=True)
    shards = []
    for i, payload in enumerate(payloads):
        name = shard_file(i)
        _write_durable(os.path.join(d, name), payload)
        shards.append({"file": name,
                       "sha256": hashlib.sha256(payload).hexdigest(),
                       "bytes": len(payload)})
    _fsync_dir(d)
    manifest = dict(meta or {})
    manifest.update({"gen": int(gen), "n_shards": len(payloads),
                     "shards": shards})
    mpath = os.path.join(root, MANIFEST)
    _write_durable(mpath + ".new", serde.encode(manifest))
    if os.path.exists(mpath):
        os.replace(mpath, mpath + PREV_SUFFIX)
    os.replace(mpath + ".new", mpath)
    _fsync_dir(root)
    return manifest


def read_manifest(root: str, previous: bool = False) -> Optional[dict]:
    """Decode MANIFEST (or MANIFEST.prev); None when absent, torn, or
    not a structurally valid manifest."""
    path = os.path.join(root, MANIFEST) + (PREV_SUFFIX if previous else "")
    try:
        with open(path, "rb") as f:
            m = serde.decode(f.read())
    except (OSError, ValueError):
        return None
    if not isinstance(m, dict) or not isinstance(m.get("shards"), list):
        return None
    try:
        int(m["gen"])
    except (KeyError, TypeError, ValueError):
        return None
    for ent in m["shards"]:
        if (not isinstance(ent, dict) or "file" not in ent
                or "sha256" not in ent):
            return None
    return m


def load_payloads(root: str, manifest: dict) -> Optional[List[bytes]]:
    """Read + hash-verify every shard file of `manifest`; None if any is
    missing, torn, or corrupted (all-or-nothing: a checkpoint is only
    usable whole)."""
    d = gen_dir(root, manifest["gen"])
    out = []
    for ent in manifest["shards"]:
        name = os.path.basename(str(ent["file"]))
        try:
            with open(os.path.join(d, name), "rb") as f:
                data = f.read()
        except OSError:
            return None
        if hashlib.sha256(data).hexdigest() != ent["sha256"]:
            return None
        out.append(data)
    return out


def recover(root: str) -> Tuple[Optional[dict], Optional[List[bytes]], str]:
    """-> (manifest, payloads, source): the newest fully-verifiable
    checkpoint, source in {"manifest", "manifest_prev", "none"}."""
    for previous, source in ((False, "manifest"), (True, "manifest_prev")):
        m = read_manifest(root, previous=previous)
        if m is None:
            continue
        payloads = load_payloads(root, m)
        if payloads is not None:
            return m, payloads, source
    return None, None, "none"


def gc_generations(root: str, keep) -> None:
    """Remove checkpoint generations not in `keep` (current + previous
    stay referenced by MANIFEST / MANIFEST.prev)."""
    base = os.path.join(root, CKPT_DIR)
    if not os.path.isdir(base):
        return
    keep = {int(g) for g in keep}
    for name in os.listdir(base):
        try:
            gen = int(name)
        except ValueError:
            continue
        if gen not in keep:
            shutil.rmtree(os.path.join(base, name), ignore_errors=True)


def install(root: str, manifest: dict, payloads: List[bytes]) -> dict:
    """Install a TRANSFERRED checkpoint (snapshot-ship receive side):
    verify every payload against the manifest's recorded hashes, then
    write it with the same durable ordering as a local checkpoint."""
    if len(payloads) != len(manifest.get("shards", [])):
        raise ValueError("snapshot install: shard count mismatch")
    for ent, payload in zip(manifest["shards"], payloads):
        if hashlib.sha256(payload).hexdigest() != ent["sha256"]:
            raise ValueError(
                f"snapshot install: hash mismatch for {ent['file']!r}")
    os.makedirs(root, exist_ok=True)
    meta = {k: v for k, v in manifest.items()
            if k not in ("gen", "n_shards", "shards")}
    return write_checkpoint(root, int(manifest["gen"]), payloads, meta=meta)
