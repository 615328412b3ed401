"""Key-history index: which (block, tx) wrote each (ns, key).

Reference parity: core/ledger/kvledger/history/ — a write-only index
committed per block, queried by GetHistoryForKey (qscc / chaincode shim).
Only VALID transactions' writes are indexed, newest first on query.

Sharded by the same key-hash as the state DB (ledger/statedb.shard_of)
and durable via the same WAL + crash-consistent checkpoint pattern
(ledger/checkpoint.py): per-shard content-hashed flush files behind an
atomically-renamed manifest.  Checkpoints bound recovery to savepoint +
WAL tail replay — previously this store replayed its ENTIRE WAL on
every open.  Rebuildable from the block store (rebuild_dbs.go parity is
handled by kvledger).

Counterpart of `fabric_tpu/ledger/historydb.py`, writing the
reference's WAL records and checkpoint files byte for byte.  Left out:
the tracing event of a checkpoint.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.ledger import checkpoint as ckpt
from fabric_tpu_torch.ledger.statedb import shard_of
from fabric_tpu_torch.utils import serde

_LEN = struct.Struct("<Q")
CHECKPOINT_EVERY = 256  # blocks between checkpoint compactions


@dataclass(frozen=True)
class KeyMod:
    """One historical modification (history.KeyModification)."""
    block_num: int
    tx_num: int
    txid: str
    value: bytes
    is_delete: bool


class HistoryDB:
    def __init__(self, root: Optional[str] = None,
                 n_shards: int = 1,
                 checkpoint_every: int = CHECKPOINT_EVERY,
                 channel: str = ""):
        self.root = root
        self.n_shards = max(1, int(n_shards))
        self.checkpoint_every = checkpoint_every
        self.channel = channel
        self._lock = threading.RLock()
        # one index stripe per shard; queries are rare enough that a
        # single store lock covers them (the sharding buys independently
        # flushable checkpoint files + placement agreement with statedb)
        self._shards: List[Dict[Tuple[str, str], List[KeyMod]]] = [
            {} for _ in range(self.n_shards)]
        self._savepoint: Optional[int] = None
        self._blocks_since_ckpt = 0
        self._ckpt_gen = 0
        # gen -> lease expiry: see statedb.pin_generation
        self._gen_pins: dict = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        self.last_recovery = {"source": "fresh", "wal_blocks": 0,
                              "savepoint": None}
        if root is not None:
            os.makedirs(root, exist_ok=True)
            self._recover()

    @property
    def savepoint(self) -> Optional[int]:
        with self._lock:
            return self._savepoint

    def commit(self, block_num: int,
               writes: List[Tuple[int, str, str, str, bytes, bool]]) -> None:
        """writes: (tx_num, txid, ns, key, value, is_delete) of VALID txs."""
        with self._lock:
            if self._savepoint is not None and block_num <= self._savepoint:
                return  # already committed (recovery replay)
            if self.root is not None:
                payload = serde.encode(
                    {"block": block_num,
                     "writes": [[t, x, n, k, v, d]
                                for t, x, n, k, v, d in writes]})
                with open(self._wal_path(), "ab") as f:
                    f.write(_LEN.pack(len(payload)))
                    f.write(payload)
                    f.flush()
                    os.fsync(f.fileno())
            self._apply(block_num, writes)
            if self.root is not None:
                self._blocks_since_ckpt += 1
                if self._blocks_since_ckpt >= self.checkpoint_every:
                    self._checkpoint_locked()

    def _apply(self, block_num, writes) -> None:
        # group the block's writes per key first, then extend each
        # key's list ONCE — one dict probe per touched key instead of
        # one per write (walk order within a key is preserved, so query
        # order is unchanged)
        grouped: Dict[Tuple[str, str], List[KeyMod]] = {}
        for tx_num, txid, ns, key, value, is_delete in writes:
            grouped.setdefault((ns, key), []).append(
                KeyMod(block_num, tx_num, txid, value, is_delete))
        for k, mods in grouped.items():
            index = self._shards[shard_of(k[0], k[1], self.n_shards)]
            prev = index.get(k)
            if prev is None:
                index[k] = mods
            else:
                prev.extend(mods)
        self._savepoint = block_num

    def get_history(self, ns: str, key: str) -> List[KeyMod]:
        """Newest-first modification list (GetHistoryForKey)."""
        with self._lock:
            index = self._shards[shard_of(ns, key, self.n_shards)]
            return list(reversed(index.get((ns, key), [])))

    @property
    def _index(self) -> Dict[Tuple[str, str], List[KeyMod]]:
        """Merged read-only view of every shard (flat-store compat for
        tests/tooling; the shards are the real storage)."""
        merged: Dict[Tuple[str, str], List[KeyMod]] = {}
        with self._lock:
            for index in self._shards:
                merged.update(index)
        return merged

    def status(self) -> dict:
        with self._lock:
            return {
                "n_shards": self.n_shards,
                "savepoint": self._savepoint,
                "keys": sum(len(s) for s in self._shards),
                "checkpoint_gen": self._ckpt_gen,
                "last_recovery": dict(self.last_recovery),
            }

    # -- persistence --------------------------------------------------------

    def _wal_path(self) -> str:
        return os.path.join(self.root, "history.wal")

    def checkpoint(self) -> Optional[dict]:
        """Flush every shard + flip the manifest (see statedb.checkpoint)."""
        with self._lock:
            if self.root is None or self._savepoint is None:
                return None
            if self._blocks_since_ckpt == 0:
                m = ckpt.read_manifest(self.root)
                if m is not None and m.get("savepoint") == self._savepoint:
                    return m
            return self._checkpoint_locked()

    def pin_generation(self, gen: int, ttl_s: float = 60.0) -> None:
        """Lease-pin a checkpoint generation against GC (see
        statedb.pin_generation — same contract, history store)."""
        with self._lock:
            self._gen_pins[int(gen)] = time.monotonic() + float(ttl_s)

    def _live_pins(self) -> set:
        now = time.monotonic()
        self._gen_pins = {g: t for g, t in self._gen_pins.items()
                          if t > now}
        return set(self._gen_pins)

    # shard-parallel checkpoint serialization: mirrors statedb's
    # core-count gate so single-core hosts never pay pool overhead
    _PARALLEL_CKPT_MIN = 512
    _HOST_CORES = os.cpu_count() or 1

    def _get_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            workers = min(self.n_shards, max(2, os.cpu_count() or 2))
            self._pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="historydb-ckpt")
        return self._pool

    def _checkpoint_locked(self) -> dict:
        gen = self._ckpt_gen + 1

        def _encode_shard(i: int) -> bytes:
            index = self._shards[i]
            recs = []
            for (ns, key) in sorted(index.keys()):
                recs.append(
                    [ns, key,
                     [[m.block_num, m.tx_num, m.txid, m.value, m.is_delete]
                      for m in index[(ns, key)]]])
            return serde.encode(
                {"savepoint": self._savepoint, "shard": i,
                 "n_shards": self.n_shards, "data": recs})

        # shards are read-only for the duration of the lock; pool.map
        # preserves order so the payload list is bit-identical to the
        # serial build
        total = sum(len(s) for s in self._shards)
        if (self._HOST_CORES > 1 and len(self._shards) > 1
                and total >= self._PARALLEL_CKPT_MIN):
            payloads = list(self._get_pool().map(
                _encode_shard, range(len(self._shards))))
        else:
            payloads = [_encode_shard(i) for i in range(len(self._shards))]
        manifest = ckpt.write_checkpoint(
            self.root, gen, payloads,
            meta={"savepoint": self._savepoint, "kind": "history"})
        with open(self._wal_path(), "wb") as f:
            f.truncate(0)
        ckpt.gc_generations(self.root, {gen, gen - 1} | self._live_pins())
        self._ckpt_gen = gen
        self._blocks_since_ckpt = 0
        # the reference records a tracing event here; the port has no
        # ops plane yet
        return manifest

    def _recover(self) -> None:
        source = "empty"
        manifest, payloads, src = ckpt.recover(self.root)
        if manifest is not None and manifest.get("kind") == "history":
            for d in (serde.decode(p) for p in payloads):
                for ns, key, mods in d["data"]:
                    index = self._shards[shard_of(ns, key, self.n_shards)]
                    index[(ns, key)] = [
                        KeyMod(b, t, x, v, bool(dl))
                        for b, t, x, v, dl in mods]
            self._savepoint = manifest.get("savepoint")
            self._ckpt_gen = int(manifest["gen"])
            source = src
        wal_blocks = 0
        if os.path.exists(self._wal_path()):
            with open(self._wal_path(), "rb") as f:
                data = f.read()
            off, good_end = 0, 0
            while off + _LEN.size <= len(data):
                (n,) = _LEN.unpack_from(data, off)
                if off + _LEN.size + n > len(data):
                    break
                try:
                    rec = serde.decode(
                        data[off + _LEN.size:off + _LEN.size + n])
                except ValueError:
                    break
                off += _LEN.size + n
                good_end = off
                if (self._savepoint is not None
                        and rec["block"] <= self._savepoint):
                    continue  # already in checkpoint
                self._apply(rec["block"],
                            [tuple(w) for w in rec["writes"]])
                wal_blocks += 1
            if good_end != len(data):
                with open(self._wal_path(), "r+b") as f:
                    f.truncate(good_end)
        self.last_recovery = {"source": source, "wal_blocks": wal_blocks,
                              "savepoint": self._savepoint}
