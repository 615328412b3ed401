"""Snapshot state-transfer: bootstrap a new/wiped peer from a serving
peer's checkpoint instead of replaying the chain from genesis.

Reference parity: core/ledger/kvledger snapshot generation +
`peer node join-by-snapshot` — a snapshot is the derived DBs at one
block height plus enough chain metadata (block hash, commit hash) to
verify and continue from there.

Protocol (two unary verbs over the existing authenticated comm/rpc
plane — the transport handshake already restricts callers to channel
MSPs):

  state.snapshot_meta  {channel} ->
      {height, base, current_hash, previous_hash, commit_hash,
       state_manifest, history_manifest, files:[{db,gen,file,sha256,bytes}]}
  state.snapshot_chunk {channel, db, gen, file, offset} ->
      {data, eof, size}          (CHUNK_BYTES per call)

The serving peer reuses the newest COMPLETE on-disk checkpoint pair
when one exists (forcing one via kvledger.snapshot_export only when
none does) and streams the exact on-disk files; served generations are
lease-pinned against checkpoint GC so a new generation can be written
mid-fetch without deleting the one being streamed.  Integrity is
end-to-end:
the manifest carries each shard file's sha256 and the installer refuses
any assembled file whose hash mismatches — a corrupted/truncated
transfer is re-fetched, never installed.

Install ordering is the commit protocol: state files → state MANIFEST →
history files → history MANIFEST → blocks/BOOTSTRAP.json LAST.  The
bootstrap marker is the commit point — a kill mid-install leaves no
marker, `needs_bootstrap` stays true, and the next attempt wipes the
partial install and re-fetches.  After install the peer opens its
ledger at the snapshot height and the deliver/gossip plane tail-replays
to tip (blocks below the base read as pruned).

Counterpart of `fabric_tpu/ledger/snapshot.py`: the serving side
(`export_meta`, `serve_chunk`, the handlers of the two verbs) and the
receiving side's `needs_bootstrap` and `install`.  Not ported yet: the
fetch over comm/rpc (`_Fetcher`, `bootstrap_from_peers`,
`_fetch_and_install`) and the verbs' names, which come with the port's
peer.  The ops-plane events and counters are the reference's.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.ledger import checkpoint as ckpt
from fabric_tpu_torch.ledger.blkstorage import BOOTSTRAP_FILE, BlockStore
from fabric_tpu_torch.protocol import block_header_hash
from fabric_tpu_torch.protocol.types import META_COMMIT_HASH

CHUNK_BYTES = 256 * 1024


class SnapshotError(Exception):
    pass


# -- serving side -----------------------------------------------------------

def _manifest_on_disk(root: Optional[str],
                      manifest: Optional[dict]) -> bool:
    """True when every shard file the manifest lists is present with
    the advertised size (content hashes are verified end-to-end by the
    fetching client, so an existence+size probe is enough here)."""
    if root is None or manifest is None:
        return False
    d = ckpt.gen_dir(root, int(manifest["gen"]))
    for ent in manifest["shards"]:
        try:
            if os.path.getsize(
                    os.path.join(d, os.path.basename(str(ent["file"])))) \
                    != int(ent["bytes"]):
                return False
        except (OSError, KeyError, TypeError, ValueError):
            return False
    return True


def _reusable_manifests(ledger) -> Tuple[Optional[dict], Optional[dict]]:
    """The newest COMPLETE on-disk checkpoint pair, or (None, None).

    Serving an existing generation instead of force-checkpointing per
    meta request is what lets N peers bootstrap concurrently under
    load: each forced checkpoint mints a new generation and GC keeps
    only {gen, gen-1}, so concurrent exports used to delete the very
    files another bootstrapper was mid-fetch — a refetch livelock.  A
    STALE savepoint is harmless: the joiner simply joins at the
    manifest's height and tail-replays more blocks to tip."""
    sm = ckpt.read_manifest(ledger.statedb.root) \
        if ledger.statedb.root is not None else None
    if not _manifest_on_disk(ledger.statedb.root, sm):
        return None, None
    if ledger.historydb is None or ledger.historydb.root is None:
        return sm, None
    hm = ckpt.read_manifest(ledger.historydb.root)
    # both DBs must describe the SAME savepoint for a coherent install
    if (not _manifest_on_disk(ledger.historydb.root, hm)
            or hm.get("savepoint") != sm.get("savepoint")):
        return None, None
    return sm, hm


def export_meta(ledger) -> dict:
    """Describe a servable snapshot (the state.snapshot_meta handler):
    reuse the newest complete on-disk checkpoint generation when one
    exists, force-checkpoint both derived DBs only when none does."""
    t0 = time.monotonic()
    state_manifest, history_manifest = _reusable_manifests(ledger)
    if state_manifest is not None:
        try:
            blk = ledger.blockstore.get_by_number(
                int(state_manifest["savepoint"]))
        except Exception:
            # savepoint block pruned/unavailable (e.g. this peer itself
            # snapshot-bootstrapped above it) — fall back to forcing
            state_manifest = history_manifest = None
    if state_manifest is None:
        state_manifest, history_manifest = ledger.snapshot_export()
        if state_manifest is None:
            raise SnapshotError(
                "nothing to snapshot (empty or in-memory ledger)")
        blk = ledger.blockstore.get_by_number(
            int(state_manifest["savepoint"]))
    savepoint = int(state_manifest["savepoint"])
    # lease the served generations against concurrent checkpoint GC;
    # serve_chunk refreshes the lease per chunk for the fetch duration
    ledger.statedb.pin_generation(int(state_manifest["gen"]))
    if history_manifest is not None:
        ledger.historydb.pin_generation(int(history_manifest["gen"]))
    files = [{"db": "state", "gen": state_manifest["gen"],
              "file": ent["file"], "sha256": ent["sha256"],
              "bytes": ent["bytes"]}
             for ent in state_manifest["shards"]]
    if history_manifest is not None:
        files += [{"db": "history", "gen": history_manifest["gen"],
                   "file": ent["file"], "sha256": ent["sha256"],
                   "bytes": ent["bytes"]}
                  for ent in history_manifest["shards"]]
    meta = {
        "channel": ledger.channel_id,
        "height": savepoint + 1,          # ledger height at the snapshot
        "current_hash": block_header_hash(blk.header),
        "previous_hash": blk.header.previous_hash,
        "commit_hash": blk.metadata.items.get(META_COMMIT_HASH,
                                              b"\x00" * 32),
        "state_manifest": state_manifest,
        "history_manifest": history_manifest,
        "files": files,
    }
    try:
        from fabric_tpu_torch.ops_plane import tracing
        tracing.event("state.snapshot_export", channel=ledger.channel_id,
                      height=savepoint + 1, files=len(files),
                      seconds=round(time.monotonic() - t0, 6))
    except Exception:
        pass
    return meta


def serve_chunk(ledger, db: str, gen: int, file: str, offset: int) -> dict:
    """One CHUNK_BYTES read of a checkpoint shard file (the
    state.snapshot_chunk handler)."""
    if db == "state":
        droot = ledger.statedb.root
        store = ledger.statedb
    elif db == "history":
        droot = None if ledger.historydb is None else ledger.historydb.root
        store = ledger.historydb
    else:
        raise SnapshotError(f"unknown snapshot db {db!r}")
    if droot is None:
        raise SnapshotError(f"{db} store is not durable on this peer")
    # refresh the GC lease while the fetch is in flight (export_meta
    # took the initial lease; a slow bootstrap keeps renewing it)
    store.pin_generation(int(gen))
    # only shard payload files live in a generation dir; reject anything
    # that could traverse out of it
    if (os.path.basename(file) != file or not file.startswith("shard_")
            or not file.endswith(".bin")):
        raise SnapshotError(f"invalid snapshot file name {file!r}")
    path = os.path.join(ckpt.gen_dir(droot, int(gen)), file)
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(int(offset))
            data = f.read(CHUNK_BYTES)
    except OSError as exc:
        # the generation may have been GC'd by later checkpoints; the
        # client re-fetches meta and restarts
        raise SnapshotError(f"snapshot file gone: {exc}") from None
    try:
        from fabric_tpu_torch.ops_plane import registry
        registry.counter("state_snapshot_chunks_total",
                         "Snapshot chunks served").add(
                             1, channel=ledger.channel_id, db=db)
        registry.counter("state_snapshot_bytes_total",
                         "Snapshot bytes served").add(
                             float(len(data)), channel=ledger.channel_id,
                             db=db)
    except Exception:
        pass
    return {"data": bytes(data), "eof": int(offset) + len(data) >= size,
            "size": size}


# -- receiving side ---------------------------------------------------------

def needs_bootstrap(ledger_root: str, channel_id: str) -> bool:
    """True when this channel has no blocks AND no installed snapshot —
    the states in which joining by snapshot is safe (never clobbers an
    existing chain)."""
    bdir = os.path.join(ledger_root, channel_id, "blocks")
    if not os.path.isdir(bdir):
        return True
    names = os.listdir(bdir)
    has_segments = any(n.startswith("blocks_") and n.endswith(".bin")
                       for n in names)
    return not has_segments and BOOTSTRAP_FILE not in names


def install(ledger_root: str, channel_id: str, meta: dict,
            payloads: Dict[str, List[bytes]]) -> None:
    """Install fetched snapshot payloads; BOOTSTRAP.json written last is
    the commit point.  Any pre-existing partial install is wiped first."""
    t0 = time.monotonic()
    base = os.path.join(ledger_root, channel_id)
    for sub in ("state", "history", "blocks"):
        shutil.rmtree(os.path.join(base, sub), ignore_errors=True)
    ckpt.install(os.path.join(base, "state"), meta["state_manifest"],
                 payloads["state"])
    if meta.get("history_manifest") is not None and "history" in payloads:
        ckpt.install(os.path.join(base, "history"),
                     meta["history_manifest"], payloads["history"])
    BlockStore.write_bootstrap(
        os.path.join(base, "blocks"), int(meta["height"]),
        meta["current_hash"], meta["previous_hash"], meta["commit_hash"])
    try:
        from fabric_tpu_torch.ops_plane import tracing
        tracing.event("state.snapshot_install", channel=channel_id,
                      height=int(meta["height"]),
                      seconds=round(time.monotonic() - t0, 6))
    except Exception:
        pass
