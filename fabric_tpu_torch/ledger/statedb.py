"""Versioned key-value state database: key-hash sharded, savepoint +
crash-consistent checkpoint recovery.

Reference parity: core/ledger/kvledger/txmgmt/statedb/statedb.go interface
and the stateleveldb implementation — versioned values (value, Height),
update batches applied atomically with a savepoint, ordered range scans.

Layout: keys stripe across ``n_shards`` independently-locked shards by a
deterministic hash of (namespace, key) — `shard_of`.  Batched applies
land shard-parallel (the device-validate plane pre-splits its prepared
batches with `UpdateBatch.preshard`, so the split cost is off the commit
lock path), while point reads take only the owning shard's lock.

Durability model: ONE append-only WAL of update batches (a single fsync
per block keeps the savepoint atomic ACROSS shards — per-shard WALs
could tear a block between shards on crash), plus periodic sharded
checkpoints for compaction: every shard flushed to its own
content-hashed file and an atomically-renamed manifest recording
(generation, savepoint, per-shard sha256) — see ledger/checkpoint.py for
the kill-at-any-instant story.  On open: load the newest verifiable
manifest (falling back MANIFEST → MANIFEST.prev → legacy state.snapshot
→ empty), replay WAL records past its savepoint, truncate any torn
tail.  Savepoint = block number of the last applied batch; the kvledger
recovery path replays blocks above the savepoint from the block store
(core/ledger/kvledger/recovery.go semantics), so losing a checkpoint
never loses data — only recovery time.

Keys are (namespace, key) pairs, ordered lexicographically for range
scans (leveldb iterator parity); cross-shard scans are heap-merged back
into one ordered stream, bit-identical to the flat store's iteration
order.

Consistency note: `get` synchronizes only on the owning shard, so a
reader racing a multi-shard apply may observe a block partially applied
across shards (never within one).  Commit-path correctness does not
ride on this — MVCC re-validates reads at commit, same as the
reference's leveldb store, and the global lock covers scans/queries.

Counterpart of `fabric_tpu/ledger/statedb.py`: the whole store with its
rich-query engine, writing the reference's WAL records and checkpoint
files byte for byte, with the reference's ops-plane observers
(`_observe_shards`, `_observe_checkpoint`).
"""

from __future__ import annotations

import bisect
import heapq
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from fabric_tpu_torch.ledger import checkpoint as ckpt
from fabric_tpu_torch.protocol import Version
from fabric_tpu_torch.utils import serde

_LEN = struct.Struct("<Q")
SNAPSHOT_EVERY = 256  # batches between checkpoint compactions
N_SHARDS = 8          # default key-hash stripe width

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF


def shard_of(ns: str, key: str, n_shards: int) -> int:
    """Deterministic shard for a (namespace, key): FNV-1a 64 over the
    NUL-joined pair.  Stable across processes/restarts — checkpoints,
    prepared batches, and snapshot transfers all agree on placement."""
    if n_shards <= 1:
        return 0
    h = _FNV_OFFSET
    for b in (ns + "\x00" + key).encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h % n_shards


@dataclass(frozen=True)
class VersionedValue:
    value: bytes
    version: Version


class UpdateBatch:
    """statedb.UpdateBatch: puts/deletes staged by MVCC validation.

    `preshard` / `items_by_shard` cache the per-shard split so the
    device-validate rebuild can pay the hash cost outside the store's
    apply lock."""

    def __init__(self):
        self._updates: Dict[Tuple[str, str], Optional[VersionedValue]] = {}
        self._by_shard = None  # (n_shards, per-shard item lists)

    def put(self, ns: str, key: str, value: bytes, version: Version) -> None:
        self._updates[(ns, key)] = VersionedValue(value, version)
        self._by_shard = None

    def delete(self, ns: str, key: str, version: Version) -> None:
        # deletes still carry the deleting tx's version (stateleveldb tombstone)
        self._updates[(ns, key)] = None
        self._by_shard = None

    def get(self, ns: str, key: str):
        """(found, vv) — distinguishes absent from staged-delete."""
        k = (ns, key)
        return (k in self._updates), self._updates.get(k)

    def items(self):
        return self._updates.items()

    def __len__(self):
        return len(self._updates)

    def items_by_shard(self, n_shards: int) -> List[list]:
        cached = self._by_shard
        if cached is not None and cached[0] == n_shards:
            return cached[1]
        lists: List[list] = [[] for _ in range(n_shards)]
        if n_shards <= 1:
            lists[0] = list(self._updates.items())
        else:
            for item in self._updates.items():
                ns, key = item[0]
                lists[shard_of(ns, key, n_shards)].append(item)
        self._by_shard = (n_shards, lists)
        return lists

    def preshard(self, n_shards: int) -> "UpdateBatch":
        """Warm the per-shard split (idempotent; invalidated by put/delete)."""
        if n_shards > 1:
            self.items_by_shard(n_shards)
        return self


def _doc_of(value) -> Optional[dict]:
    """Parse a state value as a JSON document; None when not one."""
    import json as _json
    try:
        doc = _json.loads(value.decode("utf-8"))
    except (ValueError, UnicodeDecodeError, AttributeError):
        return None
    return doc if isinstance(doc, dict) else None


def _match_selector(doc: dict, selector: dict) -> bool:
    """Mango-selector subset evaluation (implicit AND across fields)."""
    for field_name, cond in selector.items():
        if field_name == "$or":
            if not any(_match_selector(doc, alt) for alt in cond):
                return False
            continue
        if field_name == "$and":
            if not all(_match_selector(doc, alt) for alt in cond):
                return False
            continue
        have = doc.get(field_name)
        if isinstance(cond, dict):
            for op, want in cond.items():
                try:
                    if op == "$gt" and not have > want:
                        return False
                    elif op == "$gte" and not have >= want:
                        return False
                    elif op == "$lt" and not have < want:
                        return False
                    elif op == "$lte" and not have <= want:
                        return False
                    elif op == "$ne" and not have != want:
                        return False
                    elif op == "$eq" and not have == want:
                        return False
                    elif op == "$in" and have not in want:
                        return False
                except TypeError:
                    return False      # cross-type comparison: no match
        else:
            if have != cond:
                return False
    return True


def _index_sort_key(v):
    """Type-tagged sort key for an indexable scalar, or None when the
    value is not indexable.  Numbers (incl. bool — Python equality
    semantics, which _match_selector uses) share one collation class;
    strings another."""
    if isinstance(v, (int, float)) and not isinstance(v, complex):
        try:
            return (0, float(v))
        except (OverflowError, ValueError):
            return None
    if isinstance(v, str):
        return (1, v)
    return None


class _FieldIndex:
    """Sorted (sort_key, key) entries for one (namespace, field).

    Lossy float collation is fine: index lookups return a SUPERSET of
    candidates (inclusive bounds) and execute_query re-checks each doc
    with the exact selector — mirroring how the reference's CouchDB
    indexes only narrow the scan (statecouchdb query with index hint).
    """

    def __init__(self):
        self.by_key: Dict[str, tuple] = {}      # key -> sort_key
        self.sorted: List[Tuple[tuple, str]] = []

    def remove(self, key: str) -> None:
        sk = self.by_key.pop(key, None)
        if sk is not None:
            i = bisect.bisect_left(self.sorted, (sk, key))
            if i < len(self.sorted) and self.sorted[i] == (sk, key):
                self.sorted.pop(i)

    def put(self, key: str, value) -> None:
        self.remove(key)
        sk = _index_sort_key(value)
        if sk is not None:
            self.by_key[key] = sk
            bisect.insort(self.sorted, (sk, key))

    def candidates(self, lo, hi) -> List[str]:
        """Keys whose sort key is within [lo, hi] (inclusive; None =
        unbounded on that side)."""
        i = 0 if lo is None else bisect.bisect_left(self.sorted, (lo,))
        if hi is None:
            j = len(self.sorted)
        else:
            j = bisect.bisect_right(self.sorted, (hi,))
            while j < len(self.sorted) and self.sorted[j][0] == hi:
                j += 1
        return [k for _, k in self.sorted[i:j]]


class _StateShard:
    """One stripe: its own lock, key map, ordered key list, and slice of
    every registered field index."""

    __slots__ = ("lock", "data", "sorted_keys", "indexes")

    def __init__(self):
        self.lock = threading.RLock()
        self.data: Dict[Tuple[str, str], VersionedValue] = {}
        self.sorted_keys: List[Tuple[str, str]] = []
        self.indexes: Dict[Tuple[str, str], _FieldIndex] = {}


class StateDB:
    """Versioned state store (VersionedDB iface, statedb.go)."""

    def __init__(self, root: Optional[str] = None,
                 snapshot_every: int = SNAPSHOT_EVERY,
                 n_shards: int = N_SHARDS,
                 channel: str = ""):
        self.root = root
        self.snapshot_every = snapshot_every
        self.n_shards = max(1, int(n_shards))
        self.channel = channel  # metric label only; "" = unlabeled/quiet
        self._lock = threading.RLock()
        self._shards = [_StateShard() for _ in range(self.n_shards)]
        self._savepoint: Optional[int] = None
        self._batches_since_ckpt = 0
        self._ckpt_gen = 0
        # gen -> lease-expiry monotonic time: generations a snapshot
        # fetch is streaming from; checkpoint GC keeps them alive until
        # the lease lapses (ledger/snapshot.py refreshes per chunk)
        self._gen_pins: dict = {}
        # registered (ns, field) pairs; each shard holds its own
        # _FieldIndex slice (the statecouchdb index slot — reference
        # indexes ship in chaincode META-INF/statedb/couchdb/indexes and
        # are created at deploy; here create_index is called at
        # chaincode install, node/peer.py)
        self._index_fields: set = set()
        self._pool: Optional[ThreadPoolExecutor] = None
        self.last_recovery = {"source": "fresh", "wal_blocks": 0,
                              "savepoint": None}
        if root is not None:
            os.makedirs(root, exist_ok=True)
            self._recover()

    # -- reads --------------------------------------------------------------

    def get(self, ns: str, key: str) -> Optional[VersionedValue]:
        sh = self._shards[shard_of(ns, key, self.n_shards)]
        with sh.lock:
            return sh.data.get((ns, key))

    def get_version(self, ns: str, key: str) -> Optional[Version]:
        vv = self.get(ns, key)
        return None if vv is None else vv.version

    def range_scan(self, ns: str, start_key: str, end_key: str,
                   limit: int = 0) -> Iterator[Tuple[str, VersionedValue]]:
        """Ordered scan over [start_key, end_key) within a namespace;
        empty end_key = scan to namespace end (stateleveldb iterator).
        Per-shard ordered slices are heap-merged — identical order to
        the flat store (keys are globally unique, so the merge never
        compares VersionedValues)."""
        with self._lock:
            slices = []
            for sh in self._shards:
                part = []
                lo = bisect.bisect_left(sh.sorted_keys, (ns, start_key))
                for i in range(lo, len(sh.sorted_keys)):
                    kns, key = sh.sorted_keys[i]
                    if kns != ns or (end_key and key >= end_key):
                        break
                    part.append((key, sh.data[(kns, key)]))
                    if limit and len(part) >= limit:
                        break
                if part:
                    slices.append(part)
            out = list(heapq.merge(*slices))
            if limit:
                out = out[:limit]
        return iter(out)

    # -- field indexes + rich queries ---------------------------------------

    def create_index(self, ns: str, field: str) -> None:
        """Register (and build from current state) a field index for a
        namespace.  Idempotent — peers re-register at startup and the
        index rebuilds from the recovered state."""
        with self._lock:
            self._index_fields.add((ns, field))
            for sh in self._shards:
                idx = _FieldIndex()
                sh.indexes[(ns, field)] = idx
                lo = bisect.bisect_left(sh.sorted_keys, (ns, ""))
                for i in range(lo, len(sh.sorted_keys)):
                    kns, key = sh.sorted_keys[i]
                    if kns != ns:
                        break
                    doc = _doc_of(sh.data[(kns, key)].value)
                    if doc is not None:
                        idx.put(key, doc.get(field))

    def indexes_for(self, ns: str) -> List[str]:
        with self._lock:
            return [f for (n, f) in self._index_fields if n == ns]

    def _gather_candidates(self, ns: str, field: str, lo, hi) -> List[str]:
        out: List[str] = []
        for sh in self._shards:
            idx = sh.indexes.get((ns, field))
            if idx is not None:
                out.extend(idx.candidates(lo, hi))
        return out

    def _index_candidates(self, ns: str, selector: dict):
        """Planner: if some top-level selector field is indexed with an
        index-coverable condition, return the candidate key list (a
        SUPERSET of matches, re-checked by the caller); else None.

        Coverable: scalar $eq / bare equality, $gt/$gte/$lt/$lte, and
        $in over scalars — conditions a field-missing or non-scalar
        document can never satisfy.  ($ne and friends match missing
        fields, so they cannot be served from the index alone.)
        """
        for field_name, cond in selector.items():
            if field_name.startswith("$"):
                continue
            if (ns, field_name) not in self._index_fields:
                continue
            if not isinstance(cond, dict):
                sk = _index_sort_key(cond)
                if sk is None:
                    continue
                return self._gather_candidates(ns, field_name, sk, sk)
            lo = hi = None
            usable = False
            bad = False
            for op, want in cond.items():
                sk = None
                if op in ("$eq", "$gt", "$gte", "$lt", "$lte"):
                    sk = _index_sort_key(want)
                    if sk is None:
                        bad = True
                        break
                if op == "$eq":
                    lo = sk if lo is None or sk > lo else lo
                    hi = sk if hi is None or sk < hi else hi
                    usable = True
                elif op in ("$gt", "$gte"):
                    lo = sk if lo is None or sk > lo else lo
                    usable = True
                elif op in ("$lt", "$lte"):
                    hi = sk if hi is None or sk < hi else hi
                    usable = True
                elif op == "$in":
                    if (isinstance(want, (list, tuple))
                            and all(_index_sort_key(w) is not None
                                    for w in want)):
                        out = []
                        for w in want:
                            sw = _index_sort_key(w)
                            out.extend(
                                self._gather_candidates(ns, field_name,
                                                        sw, sw))
                        return sorted(set(out))
            if bad or not usable:
                continue
            # inclusive float bounds: candidate superset, exact
            # re-check downstream (strictness enforced by the matcher)
            return self._gather_candidates(ns, field_name, lo, hi)
        return None

    def execute_query(self, ns: str, selector: dict, limit: int = 0,
                      bookmark: str = ""):
        """Rich query over JSON-document values (the statecouchdb option,
        core/ledger/.../statedb/statecouchdb/statecouchdb.go — Mango
        selector subset: field equality, $gt/$gte/$lt/$lte/$ne/$in, with
        implicit AND across fields and $or for alternatives).

        Field indexes (create_index) make constrained queries sublinear:
        the planner takes candidates from one indexed field and re-checks
        the full selector — full-namespace scans only happen for
        unindexed selectors, like a CouchDB query with no matching index.

        Pagination: results come in key order; `bookmark` resumes AFTER
        the given key and `limit` caps the page (statecouchdb paginated
        queries, QueryResultsIteratorWithBookmark).  Use query_page() to
        also receive the next bookmark.

        Values that do not parse as JSON objects simply never match —
        byte-valued keys coexist with document-valued keys, exactly like
        a CouchDB-backed channel with mixed chaincodes.

        NOTE: like the reference's rich queries, results are NOT
        re-checked by MVCC phantom protection — rich queries are for
        reads/audit, not for range-protected simulation.
        """
        return iter(self._query(ns, selector, limit, bookmark))

    def query_page(self, ns: str, selector: dict, limit: int,
                   bookmark: str = ""):
        """-> (results, next_bookmark); next_bookmark '' when the result
        set is exhausted."""
        out = self._query(ns, selector, limit, bookmark)
        nb = out[-1][0] if (limit and len(out) == limit) else ""
        return out, nb

    def _query(self, ns: str, selector: dict, limit: int,
               bookmark: str) -> list:
        with self._lock:
            cand = self._index_candidates(ns, selector)
            if cand is None:
                per_shard = []
                for sh in self._shards:
                    part = []
                    lo = bisect.bisect_left(sh.sorted_keys, (ns, ""))
                    for i in range(lo, len(sh.sorted_keys)):
                        kns, key = sh.sorted_keys[i]
                        if kns != ns:
                            break
                        part.append(key)
                    if part:
                        per_shard.append(part)
                keys = list(heapq.merge(*per_shard))
            else:
                keys = sorted(cand)
            pairs = []
            for k in keys:
                if k <= bookmark:
                    continue
                sh = self._shards[shard_of(ns, k, self.n_shards)]
                pairs.append((k, sh.data.get((ns, k))))
        out = []
        for key, vv in pairs:
            if vv is None:
                continue
            doc = _doc_of(vv.value)
            if doc is None or not _match_selector(doc, selector):
                continue
            out.append((key, vv))
            if limit and len(out) >= limit:
                break
        return out

    @property
    def savepoint(self) -> Optional[int]:
        with self._lock:
            return self._savepoint

    def __len__(self):
        return sum(len(sh.data) for sh in self._shards)

    @property
    def _data(self) -> Dict[Tuple[str, str], VersionedValue]:
        """Merged read-only view of every shard (flat-store compat for
        tests/tooling; the shards are the real storage)."""
        merged: Dict[Tuple[str, str], VersionedValue] = {}
        for sh in self._shards:
            merged.update(sh.data)
        return merged

    def shard_sizes(self) -> List[int]:
        return [len(sh.data) for sh in self._shards]

    def status(self) -> dict:
        with self._lock:
            return {
                "n_shards": self.n_shards,
                "savepoint": self._savepoint,
                "keys": sum(len(sh.data) for sh in self._shards),
                "shard_keys": [len(sh.data) for sh in self._shards],
                "checkpoint_gen": self._ckpt_gen,
                "batches_since_checkpoint": self._batches_since_ckpt,
                "last_recovery": dict(self.last_recovery),
            }

    # -- writes -------------------------------------------------------------

    def apply_updates(self, batch: UpdateBatch, block_num: int) -> None:
        """Atomically apply one block's updates + advance the savepoint
        (statedb ApplyUpdates with sp).  One WAL record + fsync covers
        every shard; the in-memory apply fans out shard-parallel for
        large batches."""
        with self._lock:
            if self._savepoint is not None and block_num <= self._savepoint:
                raise ValueError(
                    f"batch for block {block_num} <= savepoint {self._savepoint}")
            if self.root is not None:
                self._wal_append(batch, block_num)
            self._apply_in_memory(batch, block_num)
            if self.root is not None:
                self._batches_since_ckpt += 1
                if self._batches_since_ckpt >= self.snapshot_every:
                    self._checkpoint_locked()
        self._observe_shards()

    # below this many updates the per-key bisect path wins; above it the
    # coalesced one-pass merge of sorted_keys is O(N + B log B) instead
    # of O(B * N) list insert/pop churn
    _BATCH_APPLY_MIN = 64
    # below this many TOTAL updates (or with only one busy shard) the
    # thread fan-out costs more than it buys
    _PARALLEL_APPLY_MIN = 512
    # on a single-core host the fan-out is pure GIL thrash — the serial
    # per-shard loop (still sharded: smaller sorted-key merges) wins
    _HOST_CORES = os.cpu_count() or 1

    def _apply_in_memory(self, batch: UpdateBatch, block_num: int) -> None:
        per_shard = batch.items_by_shard(self.n_shards)
        busy = [i for i, items in enumerate(per_shard) if items]
        if (self._HOST_CORES > 1 and len(busy) > 1
                and len(batch) >= self._PARALLEL_APPLY_MIN):
            pool = self._get_pool()
            futs = [pool.submit(self._apply_shard, self._shards[i],
                                per_shard[i])
                    for i in busy]
            for f in futs:
                f.result()
        else:
            for i in busy:
                self._apply_shard(self._shards[i], per_shard[i])
        self._savepoint = block_num

    @classmethod
    def _apply_shard(cls, shard: _StateShard, items: list) -> None:
        with shard.lock:
            if len(items) >= cls._BATCH_APPLY_MIN:
                cls._apply_shard_batched(shard, items)
            else:
                cls._apply_shard_per_key(shard, items)

    @staticmethod
    def _apply_shard_per_key(shard: _StateShard, items: list) -> None:
        ns_indexed = {n for (n, _f) in shard.indexes}
        data = shard.data
        sorted_keys = shard.sorted_keys
        for k, vv in items:
            ns, key = k
            if vv is None:
                if k in data:
                    del data[k]
                    i = bisect.bisect_left(sorted_keys, k)
                    if i < len(sorted_keys) and sorted_keys[i] == k:
                        sorted_keys.pop(i)
                if ns in ns_indexed:
                    for (n, f), idx in shard.indexes.items():
                        if n == ns:
                            idx.remove(key)
            else:
                if k not in data:
                    bisect.insort(sorted_keys, k)
                data[k] = vv
                if ns in ns_indexed:
                    doc = _doc_of(vv.value)
                    for (n, f), idx in shard.indexes.items():
                        if n != ns:
                            continue
                        if doc is None:
                            idx.remove(key)
                        else:
                            idx.put(key, doc.get(f))

    @staticmethod
    def _apply_shard_batched(shard: _StateShard, items: list) -> None:
        """One coalesced pass: mutate data/_FieldIndexes per key, then
        rebuild sorted_keys with a single merge of the surviving keys
        and the sorted set of newly-added ones."""
        ns_indexed = {n for (n, _f) in shard.indexes}
        removed = set()
        added = set()
        data = shard.data
        for k, vv in items:
            ns, key = k
            if vv is None:
                if k in data:
                    del data[k]
                    removed.add(k)
                if ns in ns_indexed:
                    for (n, f), idx in shard.indexes.items():
                        if n == ns:
                            idx.remove(key)
            else:
                if k not in data:
                    added.add(k)
                data[k] = vv
                if ns in ns_indexed:
                    doc = _doc_of(vv.value)
                    for (n, f), idx in shard.indexes.items():
                        if n != ns:
                            continue
                        if doc is None:
                            idx.remove(key)
                        else:
                            idx.put(key, doc.get(f))
        if not removed and not added:
            return
        new_keys = sorted(added)
        merged: List[Tuple[str, str]] = []
        append = merged.append
        i = 0
        n_new = len(new_keys)
        for k in shard.sorted_keys:
            if k in removed:
                continue
            while i < n_new and new_keys[i] < k:
                append(new_keys[i])
                i += 1
            append(k)
        merged.extend(new_keys[i:])
        shard.sorted_keys = merged

    def _get_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            workers = min(self.n_shards, max(2, os.cpu_count() or 2))
            self._pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="statedb-apply")
        return self._pool

    # -- persistence --------------------------------------------------------

    def _wal_path(self) -> str:
        return os.path.join(self.root, "state.wal")

    def _snap_path(self) -> str:
        # legacy (pre-sharding) single-file snapshot; read-only fallback
        return os.path.join(self.root, "state.snapshot")

    @staticmethod
    def _encode_batch(batch: UpdateBatch, block_num: int) -> bytes:
        recs = []
        for (ns, key), vv in sorted(batch.items()):
            recs.append({"ns": ns, "key": key,
                         "value": None if vv is None else vv.value,
                         "version": None if vv is None else vv.version.to_list()})
        return serde.encode({"block": block_num, "updates": recs})

    def _wal_append(self, batch: UpdateBatch, block_num: int) -> None:
        payload = self._encode_batch(batch, block_num)
        with open(self._wal_path(), "ab") as f:
            f.write(_LEN.pack(len(payload)))
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())

    def checkpoint(self) -> Optional[dict]:
        """Flush every shard + flip the manifest; returns the manifest
        (reusing the current one when nothing changed since the last
        checkpoint).  None for in-memory stores or before any block."""
        with self._lock:
            if self.root is None or self._savepoint is None:
                return None
            if self._batches_since_ckpt == 0:
                m = ckpt.read_manifest(self.root)
                if m is not None and m.get("savepoint") == self._savepoint:
                    return m
            return self._checkpoint_locked()

    def pin_generation(self, gen: int, ttl_s: float = 60.0) -> None:
        """Lease-pin a checkpoint generation against GC: while the lease
        is live, later checkpoints keep the generation's directory on
        disk.  The snapshot chunk server refreshes the lease on every
        chunk it serves, so an in-flight bootstrap fetch survives any
        number of concurrent checkpoints; an abandoned fetch merely
        delays GC by the TTL."""
        with self._lock:
            self._gen_pins[int(gen)] = time.monotonic() + float(ttl_s)

    def _live_pins(self) -> set:
        """Drop lapsed leases, return pinned gens (caller holds _lock)."""
        now = time.monotonic()
        self._gen_pins = {g: t for g, t in self._gen_pins.items()
                          if t > now}
        return set(self._gen_pins)

    def _checkpoint_locked(self) -> dict:
        t0 = time.monotonic()
        gen = self._ckpt_gen + 1

        def _encode_shard(i: int) -> bytes:
            sh = self._shards[i]
            recs = []
            for k in sh.sorted_keys:
                vv = sh.data[k]
                recs.append({"ns": k[0], "key": k[1], "value": vv.value,
                             "version": vv.version.to_list()})
            return serde.encode(
                {"savepoint": self._savepoint, "shard": i,
                 "n_shards": self.n_shards, "data": recs})

        # per-shard payloads are independent pure functions of shard
        # content, so the rec-build + serde.encode fans out across the
        # apply pool on multi-core hosts; pool.map preserves shard
        # order, so the payload list — and the manifest digests — are
        # bit-identical to the serial path
        total = sum(len(sh.sorted_keys) for sh in self._shards)
        if (self._HOST_CORES > 1 and len(self._shards) > 1
                and total >= self._PARALLEL_APPLY_MIN):
            payloads = list(self._get_pool().map(
                _encode_shard, range(len(self._shards))))
        else:
            payloads = [_encode_shard(i) for i in range(len(self._shards))]
        manifest = ckpt.write_checkpoint(
            self.root, gen, payloads,
            meta={"savepoint": self._savepoint, "kind": "state"})
        # WAL content is now ≤ the manifest savepoint: safe to drop.  A
        # crash before this truncate only re-skips records on recovery.
        with open(self._wal_path(), "wb") as f:
            f.truncate(0)
        try:
            os.remove(self._snap_path())   # retire any legacy snapshot
        except OSError:
            pass
        ckpt.gc_generations(self.root, {gen, gen - 1} | self._live_pins())
        self._ckpt_gen = gen
        self._batches_since_ckpt = 0
        self._observe_checkpoint(time.monotonic() - t0, gen)
        return manifest

    def _recover(self) -> None:
        source = "empty"
        manifest, payloads, src = ckpt.recover(self.root)
        if manifest is not None and manifest.get("kind", "state") == "state":
            self._load_checkpoint_payloads(payloads)
            self._savepoint = manifest.get("savepoint")
            self._ckpt_gen = int(manifest["gen"])
            source = src
        elif os.path.exists(self._snap_path()):
            with open(self._snap_path(), "rb") as f:
                snap = serde.decode(f.read())
            self._savepoint = snap["savepoint"]
            for rec in snap["data"]:
                sh = self._shards[shard_of(rec["ns"], rec["key"],
                                           self.n_shards)]
                sh.data[(rec["ns"], rec["key"])] = VersionedValue(
                    rec["value"], Version.from_list(rec["version"]))
            for sh in self._shards:
                sh.sorted_keys = sorted(sh.data.keys())
            source = "legacy_snapshot"
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
                batch = UpdateBatch()
                for u in rec["updates"]:
                    if u["value"] is None:
                        batch.delete(u["ns"], u["key"],
                                     Version(rec["block"], 0))
                    else:
                        batch.put(u["ns"], u["key"], u["value"],
                                  Version.from_list(u["version"]))
                self._apply_in_memory(batch, rec["block"])
                wal_blocks += 1
            if good_end != len(data):
                with open(self._wal_path(), "r+b") as f:
                    f.truncate(good_end)
        self.last_recovery = {"source": source, "wal_blocks": wal_blocks,
                              "savepoint": self._savepoint}

    def _load_checkpoint_payloads(self, payloads: List[bytes]) -> None:
        decoded = [serde.decode(p) for p in payloads]
        direct = (len(decoded) == self.n_shards
                  and all(d.get("n_shards") == self.n_shards
                          and d.get("shard") == i
                          for i, d in enumerate(decoded)))
        if direct:
            for sh, d in zip(self._shards, decoded):
                for rec in d["data"]:
                    sh.data[(rec["ns"], rec["key"])] = VersionedValue(
                        rec["value"], Version.from_list(rec["version"]))
        else:
            # shard count changed since the checkpoint: re-stripe
            for d in decoded:
                for rec in d["data"]:
                    sh = self._shards[shard_of(rec["ns"], rec["key"],
                                               self.n_shards)]
                    sh.data[(rec["ns"], rec["key"])] = VersionedValue(
                        rec["value"], Version.from_list(rec["version"]))
        for sh in self._shards:
            sh.sorted_keys = sorted(sh.data.keys())

    # -- observability ------------------------------------------------------

    def _observe_shards(self) -> None:
        if not self.channel:
            return
        try:
            from fabric_tpu_torch.ops_plane.metrics import registry
            g = registry.gauge("state_shard_keys",
                               "Keys resident per state shard")
            for i, sh in enumerate(self._shards):
                g.set(float(len(sh.data)), channel=self.channel,
                      shard=str(i))
        except Exception:
            pass

    def _observe_checkpoint(self, seconds: float, gen: int) -> None:
        try:
            from fabric_tpu_torch.ops_plane import tracing
            tracing.event("state.checkpoint", channel=self.channel,
                          gen=gen, savepoint=self._savepoint,
                          seconds=round(seconds, 6))
        except Exception:
            pass
        if not self.channel:
            return
        try:
            from fabric_tpu_torch.ops_plane.metrics import registry
            registry.counter("state_checkpoint_total",
                             "State checkpoints written").add(
                                 1, channel=self.channel)
            registry.gauge("state_checkpoint_height",
                           "Savepoint of the newest state checkpoint").set(
                               float(self._savepoint or 0),
                               channel=self.channel)
            registry.histogram("state_checkpoint_seconds",
                               "Wall time per state checkpoint").observe(
                                   seconds, channel=self.channel)
        except Exception:
            pass
