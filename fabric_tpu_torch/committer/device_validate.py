"""Fused device validation: the gate fold and MVCC of a block in one
KV7 launch.

A block's journey on the port's deep path is C parse -> device
sig-verify -> gate -> MVCC.  This module runs the policy-gate verdict
fold AND MVCC conflict detection as one kernel launch per block (KV7,
`ops/block_validate.py` over `ops/csrc/block_validate.cu`), so the only
host work between wire intake and commit-apply is building the lanes
and the final state write.

Inputs come from the zero-copy lane tables emitted by
native/fastparse.c `rwset_lanes` (protocol/wire.BlockView.rwset_lanes):
rw-set keys hashed to uint64 and interned to dense slots, read versions
and write spans as fixed-width integer lanes.

Correctness contract: flags, UpdateBatch insertion order, state/history
rows, and the commit-hash must be literally identical to
`ledger/mvcc.validate_and_prepare_batch` run after `fastcollect.gate`.
Correctness never depends on key-hash uniqueness: a uint64 collision is
detected host-side while interning (byte compare under equal hash) and
the block DEMOTES to the host path.  Every other inexpressible shape
(range queries, non-i32 versions, >8-wide policy sig-sets, stale
savepoint...) demotes the same way, counted per reason in
`stats["validator_device_demotions_total"]`.

Policy equivalence: fastcollect.gate evaluates `plugin(policy,
valid_idents, evaluator)` per plan entry with a per-block memo keyed
`(id(policy), *map(id, valid))`.  A sig-set of k live items has only
2^k possible valid subsets, so the fold is expressible as a k-bit
truth table per entry (k <= 8, else demote): the kernel ORs verdict
bits into a mask and gathers table[mask].  Tables are built host-side
with the same memo key shape, so an impure-but-memoised plugin sees
the same call pattern per unique subset.

Exactly-one-launch: all demotion checks run BEFORE the launch; a
device-validated block therefore issues exactly one dispatch
(`stats["validator_device_dispatches_total"]`).

Devices: one, or a mesh.  `device` alone is one torch device
(`device.py`: CUDA unless the caller names the CPU, where the plain
version of KV7 runs).  `devices`, a list of any length with repeats
allowed (`["cuda:0"] * 2` is two shards on one card, `["cpu"] * 3`
three plain shards), builds a `parallel.mesh.DeviceMesh`; with more
than one shard every block goes through KV7's multi-device branch
(`ops/block_validate.py` `block_validate_sharded`: the sig and read
lanes split over the shards, each shard's fold on its own device and
stream, the partial masks summed and the walk run on the first shard's
device), the counterpart of the reference's `shard_map` of its program
over the batch axis.  With neither, the reference's rule: every visible
card when their count is above 1 and a power of two, else the one
resolved device.  Either way a device-validated block is one dispatch.

Counterpart of `fabric_tpu/committer/device_validate.py`, with the same
`run`/`take_prepared` contract, demotion reasons and host helpers
(`_build_gate`, `_gather_committed`, `_rebuild`, copied).  Differences:
the reference's jitted program becomes one KV7 call; the counters go
to the process-wide registry under the reference's names and labels, as
the reference's do, and each validator also keeps its own in `stats`
(the tests' and `chip_smoke.py`'s per-stack counts); an explicit device
list of any length builds a mesh (the reference shards only over a
power-of-two count); there is no padding (the shards take
`torch.tensor_split`'s sizes) and no program cache.  And an error from
KV7's build, launch, copy or synchronisation, on any shard, propagates
out of `run`, where the reference demotes any exception to the host
path (reason `error`); that catch-all covers the host steps only (lane
extraction, key decoding, the committed-state gather, the truth tables
and the rebuild).
"""

from __future__ import annotations

import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from fabric_tpu_torch.device import resolve_device, visible_devices
from fabric_tpu_torch.ops import block_validate as kv7
from fabric_tpu_torch.parallel.mesh import make_mesh
from fabric_tpu_torch.protocol import Version
from fabric_tpu_torch.protocol.txflags import TxFlags

# lane status codes (native/fastparse.c rwset_lanes / wire.LANE_*)
_OK, _SKIP, _BAD, _RANGE, _UNKNOWN = 0, 1, 2, 3, 4

_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1

DEMOTION_REASONS = ("savepoint", "block_num", "window", "extract",
                    "hash_collision", "range_query", "inexpressible",
                    "policy_width", "policy_error", "version_range", "error")


class _Demote(Exception):
    """Block cannot (or must not) take the device path; fall back to the
    host gate + serial MVCC.  Never an error: the host path is always
    correct."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def _i32(col: np.ndarray) -> np.ndarray:
    # u64 lane -> i32 (two's complement; walkers enforce i32 range for
    # version fields, and offsets/slots are small positives)
    return col.astype(np.int64).astype(np.int32)


def _note(kind: tuple, n: int = 1, **labels) -> None:
    try:
        from fabric_tpu_torch.ops_plane import registry
        registry.counter(*kind).add(n, **labels)
    except Exception:
        pass


_C_DISPATCH = ("validator_device_dispatches_total",
               "fused gate+MVCC device dispatches (one per "
               "device-validated block)")
_C_BLOCKS = ("validator_device_blocks_total",
             "blocks fully validated by the fused device program")
_C_DEMOTE = ("validator_device_demotions_total",
             "blocks demoted to the host validation path, by reason")
_C_STASH_MISS = ("validator_device_stash_misses_total",
                 "prepared-batch stash lookups that missed (flags or "
                 "savepoint changed between validate and commit)")


class DeviceValidator:
    """Per-channel fused gate+MVCC validator.

    Wiring: construct one per channel, pass it to
    TxValidator(device_validate=...) and register `take_prepared` with
    KVLedger.set_prepared_source so commit() can consume the prepared
    UpdateBatch instead of re-running host MVCC.
    """

    # stash of prepared commits awaiting ledger consumption
    _STASH_CAP = 16

    def __init__(self, statedb, channel_id: str = "", device=None,
                 devices=None, window: int = 4096):
        self.statedb = statedb
        self.channel_id = channel_id
        self.window = window          # max txs per launch
        if device is not None and devices is not None:
            raise ValueError("give device or devices, not both")
        if device is None and devices is None:
            # the reference's rule (_get_mesh): shard over every visible
            # card when their count is > 1 and a power of two
            vis = visible_devices()
            n = len(vis)
            if n > 1 and n & (n - 1) == 0:
                devices = vis
        # the mesh KV7 runs over, None for one device
        self.mesh = None
        if devices is not None:
            mesh = make_mesh(list(devices))
            if len({dev.type for dev in mesh.devices}) != 1:
                raise ValueError(f"devices mixes device types: {devices}")
            device = mesh.devices[0]
            if len(mesh) > 1:
                self.mesh = mesh
        self.device = resolve_device(device)
        self._stash: Dict[int, tuple] = {}
        self._lock = threading.Lock()
        self.stats = {
            "validator_device_dispatches_total": 0,
            "validator_device_blocks_total": 0,
            "validator_device_stash_misses_total": 0,
            "validator_device_demotions_total": dict.fromkeys(
                DEMOTION_REASONS, 0),
        }
        # wall seconds of the host stages and the launch, last block;
        # over a mesh also the shards and each one's fold ms, the gather
        # and finish ms (block_validate_sharded)
        self.last_timings: Dict[str, object] = {}

    @property
    def shards(self) -> int:
        """The shards each block's KV7 call runs over."""
        return 1 if self.mesh is None else len(self.mesh)

    def _demoted(self, reason: str) -> None:
        with self._lock:
            self.stats["validator_device_demotions_total"][reason] += 1
        _note(_C_DEMOTE, channel=self.channel_id, reason=reason)

    # -- lane extraction ----------------------------------------------------

    @staticmethod
    def _lanes_of(block):
        """(lanes_tuple, base_bytes) for a BlockView (zero-copy) or a
        materialized protocol Block (spans synthesized once)."""
        lanes = getattr(block, "rwset_lanes", None)
        if lanes is not None:
            return lanes, block.raw
        from fabric_tpu_torch.protocol import wire
        parts: List[bytes] = []
        spans = bytearray()
        off = 0
        for raw in block.data:
            if not isinstance(raw, (bytes, bytearray, memoryview)):
                raw = raw.serialize()
            raw = bytes(raw)
            spans += struct.pack("QQ", off, len(raw))
            parts.append(raw)
            off += len(raw)
        base = b"".join(parts)
        return wire.rwset_lanes(base, bytes(spans)), base

    # -- the public entry points --------------------------------------------

    def run(self, state: dict, verdict, plugin, evaluator
            ) -> Optional[TxFlags]:
        """Validate one deep-collected block on the device.

        Returns the post-gate (pre-MVCC) TxFlags the txvalidator should
        stamp into block metadata — exactly what fastcollect.gate would
        have produced — or None to demote to the host path.  On success
        the final flags + prepared UpdateBatch/history rows are stashed
        for the ledger (take_prepared).  An error of KV7 propagates."""
        num = int(state["block"].header.number)
        self.last_timings = {}
        try:
            prep = self._prepare(state, verdict, plugin, evaluator, num)
        except _Demote as d:
            self._demoted(d.reason)
            return None
        except Exception:
            # correctness never depends on this path existing
            self._demoted("error")
            return None
        gate_bytes, final = self._dispatch(prep["lanes"], num)
        try:
            return self._finish(prep, gate_bytes, final, num)
        except Exception:
            self._demoted("error")
            return None

    def take_prepared(self, number: int, flags_bytes: bytes,
                      savepoint) -> Optional[tuple]:
        """Ledger-side consumption: (final_flags_bytes, batch, history)
        for `number` iff the metadata flags and the statedb savepoint
        still match what the device program validated against; else None
        (host MVCC re-runs — always safe)."""
        with self._lock:
            ent = self._stash.pop(number, None)
        if ent is None:
            return None
        gate_bytes, sp, final_bytes, batch, history = ent
        if bytes(flags_bytes) != gate_bytes or savepoint != sp:
            with self._lock:
                self.stats["validator_device_stash_misses_total"] += 1
            _note(_C_STASH_MISS, channel=self.channel_id)
            return None
        return final_bytes, batch, history

    # -- the block walk -----------------------------------------------------

    def _prepare(self, state, verdict, plugin, evaluator, num) -> dict:
        """Every host step before the launch, demotion checks included:
        -> the kernel's lanes and what the rebuild needs."""
        db = self.statedb
        sp = db.savepoint
        if (-1 if sp is None else sp) != num - 1:
            raise _Demote("savepoint")
        if not (0 <= num <= _I32_MAX):
            raise _Demote("block_num")

        block = state["block"]
        pre = np.frombuffer(bytes(state["codes"]), dtype=np.uint8)
        T = pre.shape[0]
        if T == 0 or T > self.window:
            raise _Demote("window")

        lanes, base = self._lanes_of(block)
        if lanes is None:
            raise _Demote("extract")
        lflags, lt, lk, lr, lw, arena = lanes
        if lflags:
            raise _Demote("hash_collision")
        if lt != T:
            raise _Demote("extract")

        arr = np.frombuffer(arena, dtype=np.uint64)
        o = 0
        tx_sec = arr[o:o + 3 * lt].reshape(lt, 3); o += 3 * lt
        rd = arr[o:o + 5 * lr].reshape(lr, 5); o += 5 * lr
        wr = arr[o:o + 5 * lw].reshape(lw, 5); o += 5 * lw
        ky = arr[o:o + 5 * lk].reshape(lk, 5)
        status = tx_sec[:, 0].astype(np.int32)

        plans = state["plans"]
        for plan in plans:
            st = status[plan[0]]
            if st == _RANGE:
                raise _Demote("range_query")
            if st == _UNKNOWN:
                raise _Demote("inexpressible")

        t0 = time.perf_counter()
        g = self._build_gate(plans, verdict, plugin, evaluator, T)
        t1 = time.perf_counter()
        key_strs, (c_has, c_blk, c_txn) = self._gather_committed(
            db, ky, base, lk)
        t2 = time.perf_counter()
        self.last_timings.update(build_gate_s=t1 - t0, gather_s=t2 - t1)
        lanes = {
            "pre": pre.astype(np.int32), "status": status,
            "has_plan": g["has_plan"], "c_idx": g["c_idx"],
            "c_live": g["c_live"], "ent_tx": g["ent_tx"],
            "ent_off": g["ent_off"], "sig_ent": g["sig_ent"],
            "sig_item": g["sig_item"], "sig_bit": g["sig_bit"],
            "r_tx": _i32(rd[:, 0]), "r_slot": _i32(rd[:, 1]),
            "r_has": _i32(rd[:, 2]), "r_blk": _i32(rd[:, 3]),
            "r_txn": _i32(rd[:, 4]), "w_tx": _i32(wr[:, 0]),
            "w_slot": _i32(wr[:, 1]), "w_del": _i32(wr[:, 2]),
            "tables": g["tables"], "verdict": g["verdict"],
            "c_has": c_has, "c_blk": c_blk, "c_txn": c_txn,
        }
        return {"lanes": lanes, "sp": sp, "tx_sec": tx_sec, "wr": wr,
                "key_strs": key_strs, "base": base, "lw": lw}

    def _finish(self, prep, gate_bytes, final, num) -> TxFlags:
        t0 = time.perf_counter()
        batch, history = self._rebuild(final, prep["tx_sec"], prep["wr"],
                                       prep["key_strs"], prep["base"], num,
                                       prep["lw"])
        # pre-split by state shard off the commit lock path; the
        # ledger's apply_updates consumes the cached split
        batch.preshard(getattr(self.statedb, "n_shards", 1))
        self.last_timings["rebuild_s"] = time.perf_counter() - t0
        final_bytes = bytes(final)
        with self._lock:
            self._stash[num] = (gate_bytes, prep["sp"], final_bytes, batch,
                                history)
            while len(self._stash) > self._STASH_CAP:
                self._stash.pop(min(self._stash))
            self.stats["validator_device_blocks_total"] += 1
        _note(_C_BLOCKS, channel=self.channel_id)
        return TxFlags.from_bytes(gate_bytes)

    # -- gate plan -> truth tables ------------------------------------------

    @staticmethod
    def _build_gate(plans, verdict, plugin, evaluator, T):
        """Flatten fastcollect.assemble plans into entry/sig lanes plus
        per-entry truth tables.  Memo key shape matches gate()'s
        per-block memo: (id(policy), *map(id, valid))."""
        nv = len(verdict)
        has_plan = np.zeros(T, dtype=np.int32)
        c_idx = np.zeros(T, dtype=np.int32)
        c_live = np.zeros(T, dtype=np.int32)
        ent_tx: List[int] = []
        ent_off: List[int] = []
        sig_ent: List[int] = []
        sig_item: List[int] = []
        sig_bit: List[int] = []
        tables: List[np.ndarray] = []
        tbl_off = 0
        memo: dict = {}
        for tx, cidx, entries in plans:
            has_plan[tx] = 1
            if 0 <= cidx < nv:
                c_idx[tx] = cidx
                c_live[tx] = 1
            for pol, sigset in entries:
                live = [(idx, ident) for idx, ident in sigset
                        if 0 <= idx < nv]
                k = len(live)
                if k > 8:
                    raise _Demote("policy_width")
                tbl = np.zeros(1 << k, dtype=np.int32)
                for mask in range(1 << k):
                    valid = [ident for i, (_idx, ident) in enumerate(live)
                             if (mask >> i) & 1]
                    mkey = (id(pol),) + tuple(map(id, valid))
                    r = memo.get(mkey)
                    if r is None:
                        try:
                            r = 1 if plugin(pol, valid, evaluator) else 0
                        except Exception:
                            raise _Demote("policy_error")
                        memo[mkey] = r
                    tbl[mask] = r
                erow = len(ent_tx)
                ent_tx.append(tx)
                ent_off.append(tbl_off)
                for i, (idx, _ident) in enumerate(live):
                    sig_ent.append(erow)
                    sig_item.append(idx)
                    sig_bit.append(i)
                tables.append(tbl)
                tbl_off += tbl.shape[0]
        cat = (np.concatenate(tables) if tables
               else np.zeros(1, dtype=np.int32))
        return {"has_plan": has_plan, "c_idx": c_idx, "c_live": c_live,
                "ent_tx": np.asarray(ent_tx, dtype=np.int32),
                "ent_off": np.asarray(ent_off, dtype=np.int32),
                "sig_ent": np.asarray(sig_ent, dtype=np.int32),
                "sig_item": np.asarray(sig_item, dtype=np.int32),
                "sig_bit": np.asarray(sig_bit, dtype=np.int32),
                "tables": cat,
                "verdict": np.asarray(verdict, dtype=np.int32)}

    # -- committed-state gather ---------------------------------------------

    @staticmethod
    def _gather_committed(db, ky, base, K):
        """Decode each interned key slot once and snapshot its committed
        version as i32 lanes; out-of-range versions demote."""
        key_strs: List[Tuple[str, str]] = []
        c_has = np.zeros(K, dtype=np.int32)
        c_blk = np.zeros(K, dtype=np.int32)
        c_txn = np.zeros(K, dtype=np.int32)
        for s in range(K):
            _h, no, nn, ko, kn = (int(x) for x in ky[s])
            ns = bytes(base[no:no + nn]).decode("utf-8")
            key = bytes(base[ko:ko + kn]).decode("utf-8")
            key_strs.append((ns, key))
            vv = db.get(ns, key)
            if vv is None:
                continue
            bn, tn = vv.version.block_num, vv.version.tx_num
            if not (_I32_MIN <= bn <= _I32_MAX
                    and _I32_MIN <= tn <= _I32_MAX):
                raise _Demote("version_range")
            c_has[s] = 1
            c_blk[s] = bn
            c_txn[s] = tn
        return key_strs, (c_has, c_blk, c_txn)

    # -- the launch ---------------------------------------------------------

    def _dispatch(self, lanes, num):
        """One KV7 call, over the mesh when there is one (the plain
        versions on the CPU): -> (gate code bytes, final codes).  Errors
        propagate (no demotion)."""
        with self._lock:
            self.stats["validator_device_dispatches_total"] += 1
        _note(_C_DISPATCH, channel=self.channel_id)
        if self.mesh is not None:
            gate, final = kv7.block_validate_sharded(lanes, num, self.mesh,
                                                     self.last_timings)
        else:
            gate, final = kv7.block_validate(lanes, num, self.device,
                                             self.last_timings)
        return bytes(gate), final

    # -- batch / history rebuild (oracle insertion order) --------------------

    @staticmethod
    def _rebuild(final, tx_sec, wr, key_strs, base, num, W):
        """Replay the write lanes of final-valid txs in global lane
        order: identical put/delete call sequence (and therefore
        identical UpdateBatch dict order) and identical history rows to
        validate_and_prepare_batch."""
        from fabric_tpu_torch.ledger.statedb import UpdateBatch
        batch = UpdateBatch()
        history: List[tuple] = []
        txids: Dict[int, str] = {}
        for j in range(W):
            t = int(wr[j, 0])
            if final[t] != 0:
                continue
            txid = txids.get(t)
            if txid is None:
                toff, tlen = int(tx_sec[t, 1]), int(tx_sec[t, 2])
                txid = bytes(base[toff:toff + tlen]).decode("utf-8")
                txids[t] = txid
            slot = int(wr[j, 1])
            is_del = bool(wr[j, 2])
            voff, vlen = int(wr[j, 3]), int(wr[j, 4])
            ns, key = key_strs[slot]
            value = bytes(base[voff:voff + vlen])
            version = Version(num, t)
            if is_del:
                batch.delete(ns, key, version)
            else:
                batch.put(ns, key, value, version)
            history.append((t, txid, ns, key, value, is_del))
        return batch, history
