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

Counterpart of `fabric_tpu/ledger/snapshot.py`, whole: the serving
side (`export_meta`, `serve_chunk`, the handlers of the two verbs), the
receiving side's `needs_bootstrap` and `install`, and the fetch over
the authenticated RPC plane (`bootstrap_from_peers`, `_Fetcher`,
`_fetch_and_install`), which speaks the reference's verbs byte for byte,
so a port peer bootstraps from a reference peer and the reverse.  The
ops-plane events and counters are the reference's.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.ledger import checkpoint as ckpt
from fabric_tpu_torch.ledger.blkstorage import BOOTSTRAP_FILE, BlockStore
from fabric_tpu_torch.protocol import block_header_hash
from fabric_tpu_torch.protocol.types import META_COMMIT_HASH

logger = logging.getLogger("fabric_tpu_torch.ledger.snapshot")

CHUNK_BYTES = 256 * 1024
META_VERB = "state.snapshot_meta"
CHUNK_VERB = "state.snapshot_chunk"


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


class _Fetcher:
    """One peer's fetch session: short per-chunk timeouts + redial-on-
    close so seeded transfer faults (drop/delay/dup) cost a retry, not
    the drill."""

    def __init__(self, addr, signer, msps, chunk_timeout_s: float,
                 attempts: int):
        self.addr = addr
        self.signer = signer
        self.msps = msps
        self.chunk_timeout_s = chunk_timeout_s
        self.attempts = attempts
        self._conn = None

    def _connection(self):
        if self._conn is None:
            from fabric_tpu_torch.comm.rpc import connect
            self._conn = connect(tuple(self.addr), self.signer, self.msps,
                                 timeout=self.chunk_timeout_s)
        return self._conn

    def peer_identity(self):
        """Handshake-verified identity of the serving peer (dials if
        needed) — the standing check keys on WHO signed the handshake,
        not the address we dialed."""
        return getattr(self._connection().channel, "peer_identity", None)

    def call(self, method: str, body: dict) -> dict:
        from fabric_tpu_torch.comm.rpc import RpcError
        last: Optional[Exception] = None
        for attempt in range(self.attempts):
            try:
                return self._connection().call(
                    method, body, timeout=self.chunk_timeout_s)
            except RpcError as exc:      # includes RpcTimeout/RpcClosed
                last = exc
                self.close()
                time.sleep(min(0.05 * (attempt + 1), 0.5))
        raise SnapshotError(
            f"{method} failed after {self.attempts} attempts "
            f"against {self.addr}: {last}")

    def fetch_file(self, channel_id: str, ent: dict) -> bytes:
        buf = bytearray()
        while True:
            resp = self.call(CHUNK_VERB, {
                "channel": channel_id, "db": ent["db"],
                "gen": ent["gen"], "file": ent["file"],
                "offset": len(buf)})
            buf += resp["data"]
            if resp["eof"]:
                return bytes(buf)

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = None


def bootstrap_from_peers(ledger_root: str, channel_id: str, peers,
                         signer, msps, chunk_timeout_s: float = 2.0,
                         attempts: int = 12,
                         source_blocked=None) -> dict:
    """Fetch + verify + install a snapshot from the first peer that can
    serve one.  -> {"height", "from", "files", "bytes", "seconds"}.

    `source_blocked`: optional callable(handshake identity) -> bool.
    Sources it flags (quarantined signers) are DEFERRED, not refused:
    they are retried only after every honest source has failed, so a
    convicted peer degrades the rejoin before it can strand it — and a
    wiped peer (whose quarantine registry outlives its ledger) never
    bootstraps from its convicted adversary while an honest source is
    alive."""
    t0 = time.monotonic()
    last: Optional[Exception] = None
    quarantined = []
    for source_pass, addrs in (("honest", list(peers)), ("last-resort",
                                                         quarantined)):
        for addr in addrs:
            fetcher = _Fetcher(addr, signer, msps, chunk_timeout_s,
                               attempts)
            try:
                if (source_blocked is not None and source_pass == "honest"
                        and source_blocked(fetcher.peer_identity())):
                    quarantined.append(addr)
                    last = SnapshotError(
                        f"snapshot source {addr} is quarantined")
                    logger.warning(
                        "[%s] snapshot source %s is quarantined; "
                        "deferring to last resort", channel_id, addr)
                    continue
                if source_pass == "last-resort":
                    logger.warning(
                        "[%s] no honest snapshot source left; last-"
                        "resort fetch from quarantined %s", channel_id,
                        addr)
                return _fetch_and_install(fetcher, ledger_root,
                                          channel_id, addr, t0)
            except Exception as exc:
                last = exc
                logger.warning("[%s] snapshot fetch from %s failed: %s",
                               channel_id, addr, exc)
            finally:
                fetcher.close()
    raise SnapshotError(
        f"no peer could serve a snapshot for {channel_id!r}: {last}")


def _fetch_and_install(fetcher: "_Fetcher", ledger_root: str,
                       channel_id: str, addr, t0: float) -> dict:
    meta = fetcher.call(META_VERB, {"channel": channel_id})
    payloads: Dict[str, List[bytes]] = {"state": [], "history": []}
    total = 0
    for ent in meta["files"]:
        data = fetcher.fetch_file(channel_id, ent)
        import hashlib
        if hashlib.sha256(data).hexdigest() != ent["sha256"]:
            raise SnapshotError(
                f"hash mismatch for {ent['db']}/{ent['file']} "
                f"from {addr}")
        payloads[ent["db"]].append(data)
        total += len(data)
    install(ledger_root, channel_id, meta, payloads)
    seconds = time.monotonic() - t0
    logger.info(
        "[%s] snapshot installed from %s: height=%d files=%d "
        "bytes=%d in %.2fs", channel_id, addr, int(meta["height"]),
        len(meta["files"]), total, seconds)
    return {"height": int(meta["height"]), "from": list(addr),
            "files": len(meta["files"]), "bytes": total,
            "seconds": seconds}
