"""CUDA batched BCCSP provider: the two P-256 lanes, the two Ed25519
lanes and the idemix pairing lane on the GPU.

Counterpart of the P-256 and Ed25519 parts of `fabric_tpu/bccsp/
jaxtpu.py` (`_verify_p256` with its vectorized lane split,
`_verify_ed25519`, `_verify_idemix`, `_idemix_packed`,
`_idemix_g2_packed`, `idemix_pair_probe`, `_dispatch`,
`batch_verify_async`, `batch_verify`, `ProviderStats`,
`stats_snapshot`).  Per batch:

* P-256 items take one host pass: a single C call parses every DER
  signature (`native.parse_der_sigs`); items with a malformed signature,
  key or digest stay False and count as `host_rejects`.  Then, biggest
  key groups first, a key whose comb table is resident in the device bank
  (`key_tables`), or that brings at least `fast_key_threshold`
  signatures and so earns a slot, sends its signatures to kernel KP3;
  the rest go to kernel KP2.
* Ed25519 items with a 32-byte key and a 64-byte signature are packed
  on the host (`ed25519.pack_verify_inputs`: words, sign bits,
  k = SHA-512(R || A || M) mod L); the rest stay False and count as
  `host_rejects`.  Then, as for P-256, a key whose table of -A is
  resident in the Ed25519 bank (`ed_key_tables`), or that brings at
  least `fast_key_threshold` signatures, sends its signatures to kernel
  KE6, key-major; the rest go to kernel KE5, which decompresses A on the
  device.  A key that does not decompress gets no table and stays on
  KE5, which rejects it.
* Each lane's words are copied to the device and launched in chunks of
  at most `MAX_CHUNK` signatures, the fixed-key lanes' batches
  key-major.  A slot stays pinned from the lane choice until its launch
  is enqueued.  `resolve()` waits for the device and scatters the
  verdicts.  No item goes to the software provider.
* Idemix items run the host checks of `idemix.msp.collect_item_parts`
  (decoding, the disclosed attributes, the zero-knowledge proofs, the
  revocation epoch; serially, as the reference does); an item they
  refuse stays False without reaching the card.  The rest become one
  pairing check each, e(A', w) * e(-Abar, g2) == 1, launched together
  in kernel KB8 whatever their issuers: each check names the slot of its
  issuer's w lines in a device-resident line tensor whose slot 0 holds
  g2's (`_idemix_packed`; an issuer's lines are precomputed on the host
  once, ~0.2 s, and uploaded, 35,072 bytes).
* Unknown schemes are False and count as `host_rejects`.

With a mesh (`CudaProvider(mesh=parallel.mesh.make_mesh(...))`, the
counterpart of `JaxTpuProvider(mesh=...)`), the host passes and the lane
choice run once, as above, against the one slot map; each lane's chunk
then goes to the lane's sharded function (`parallel/mesh.py`), which
splits it over the mesh's shards, each on its own stream, with each
distinct device's replica of the banks, of G's and B's tables and of the
idemix lines.  Without a mesh, every launch is the wrapper's own, on the
current stream.

All device work of one call (the five kernels, the banks' slot writes
and the idemix line uploads) runs on the current CUDA stream, or, for
the kernels under a mesh, on the shard streams, whose verdicts are
gathered on the current stream of the mesh's first device; `resolve()`
waits for that stream's work whatever stream is current when it is
called.  A slot rebuilt for one batch is written only after every
launch of an earlier batch that reads it, on any stream (`DeviceBank`).

Unlike the reference, nothing falls back: a failed build of the C parser
or of a kernel, a failed launch or a failed resolve raises, and
`stats["fallbacks"]` stays 0.  The reference's (R, C) row grids, its
bucket padding and its per-issuer idemix dispatches have no counterpart
here (ROADMAP C5, C9).  The `stats` keys are the reference's; the
port's degrading wrapper (`bccsp/degrade.py`, only when the factory is
asked for it) does not read `fallbacks`, since this provider raises.

Telemetry, as the reference's (`jaxtpu.py` `_observe_lane`,
`batch_verify_async`): a `bccsp.batch_verify` span per call;
`provider_dispatch_queue_depth` while launches wait for `resolve()`;
`provider_resolve_seconds`, `provider_device_sync_seconds` and
`provider_device_sigs_total` at resolve; and per launch, under the
reference's lane names (`generic`: KP2, KE5; `rows`: KP3, KE6;
`idemix`: KB8), `provider_lane_fill_fraction`, `provider_pad_slots_total`,
`provider_lane_slots_total` and `provider_lane_fill`.  The port pads to
no buckets, so a launch's slots are the item slots its grid carries:
blocks x items a block (`GRID_ITEMS`; KE5 and KE6 count signatures, four
threads each), and on the CPU's plain path the items themselves.  Each
device is labelled `str(with_index(device))` ("cuda:0"); under a mesh
each shard's slots go to its own device.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from .. import native
from ..crypto import decode_dss_signature
from ..device import resolve_device, with_index
from ..idemix import bn254 as hbn
from ..ops import bn254 as kb8
from ..ops import ed25519, ed25519_tables, p256_fixed, p256_tables
from ..ops import p256 as p256mod
from ..ops.device_bank import DeviceBank
from ..parallel import mesh as meshmod
from . import provider as prov
from .provider import (VerifyItem, SCHEME_P256, SCHEME_ED25519,
                       SCHEME_IDEMIX)
from .sw import SoftwareProvider

MAX_CHUNK = 1 << 17
_ZERO32 = b"\x00" * 32

# items a block of each lane's kernel grid (the launch functions of
# ops/csrc: 128 threads a block, one a P-256 signature or pairing check,
# four an Ed25519 signature), by the mesh's lane names
GRID_ITEMS = {"p256": 128, "p256-rows": 128, "ed25519": 32,
              "ed25519-rows": 32, "idemix-pair": 128}
# the reference's telemetry label of each lane
LANE_LABELS = {"p256": "generic", "p256-rows": "rows", "ed25519": "generic",
               "ed25519-rows": "rows", "idemix-pair": "idemix"}
# lane-fill histogram bins (the reference's)
_FILL_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0,
                 float("inf"))


def grid_slots(kind: str, n: int, device: torch.device) -> int:
    """The item slots one launch of `n` items carries on `device`: blocks
    x items a block on CUDA, the items themselves on the CPU."""
    if device.type != "cuda":
        return n
    per = GRID_ITEMS[kind]
    return -(-n // per) * per


def parse_p256(items: Sequence[VerifyItem], idxs: Sequence[int]):
    """Pure-Python parse, the oracle of the C parse in the tests ->
    (recs, n_rejected); recs are (idx, pubkey, r32, s32, e32) for the
    well-formed items, in idxs order."""
    out = []
    rejected = 0
    for i in idxs:
        it = items[i]
        pk = it.pubkey
        if len(pk) != 65 or pk[0] != 0x04 or len(it.payload) != 32:
            rejected += 1
            continue
        try:
            ri, si = decode_dss_signature(it.signature)
        except (ValueError, TypeError):
            rejected += 1
            continue
        if not (0 < ri < (1 << 256) and 0 < si < (1 << 256)):
            rejected += 1
            continue
        out.append((i, pk, ri.to_bytes(32, "big"), si.to_bytes(32, "big"),
                    it.payload))
    return out, rejected


def pack_p256_recs(recs):
    """recs -> (keep indices, [qx, qy, r, s, e] (8, B) uint32 arrays)."""
    if not recs:
        return [], None
    keep = [rec[0] for rec in recs]
    qx = p256mod.bytes32_to_words([rec[1][1:33] for rec in recs])
    qy = p256mod.bytes32_to_words([rec[1][33:65] for rec in recs])
    r = p256mod.bytes32_to_words([rec[2] for rec in recs])
    s = p256mod.bytes32_to_words([rec[3] for rec in recs])
    e = p256mod.bytes32_to_words([rec[4] for rec in recs])
    return keep, [qx, qy, r, s, e]


def _be_words(b: np.ndarray) -> np.ndarray:
    """(B, 32k) uint8 big-endian -> (B, 8k) uint32 words."""
    return np.ascontiguousarray(b).view(">u4").astype(np.uint32)


@dataclass(frozen=True)
class ProviderStats:
    """Immutable point-in-time snapshot of a CudaProvider's counters and
    its lane settings (the reference's `ProviderStats`)."""
    dispatches: int = 0
    device_sigs: int = 0
    host_rejects: int = 0
    fallbacks: int = 0
    fast_key_sigs: int = 0        # sigs that rode the fixed-key lane
    h2d_bytes: int = 0
    p256_table_builds: int = 0
    ed25519_table_builds: int = 0
    tuning: dict = field(default_factory=dict)


@dataclass
class LanePass:
    """The host pass over a batch's items of one curve.  fast: (keep,
    arrays, slot) for the fixed-key kernel (KP3: [r, s, e]; KE6: [ry,
    r_sign, s, k]), key-major; generic: (keep, arrays) for the generic
    kernel (KP2: [qx, qy, r, s, e]; KE5: [ay, a_sign, ry, r_sign, s, k]);
    either None when empty.  keep holds item indices; word arrays are
    (8, B) uint32 big-endian, sign bits and slots (B,) int32.  pinned:
    the bank slots this batch holds until its launches are enqueued."""
    rejected: int
    fast: tuple = None
    generic: tuple = None
    pinned: list = field(default_factory=list)


def _claim_slots(bank, pks, counts, threshold, pinned) -> np.ndarray:
    """Biggest groups first, a key with a resident table, or with at
    least `threshold` signatures and so a table built now, gets its
    bank slot pinned (appended to `pinned`) -> (len(pks),) slots, -1 for
    none.  Releases what it pinned if it raises."""
    slots = np.full(len(pks), -1, np.int64)
    try:
        # each claimed slot stays pinned until the batch's launch is
        # enqueued, so a later build (this batch's or a concurrent one's)
        # cannot evict it
        for g in np.argsort(-counts, kind="stable"):
            if not counts[g]:
                break
            slot = bank.lookup(pks[g], pin=True)
            if slot is None and counts[g] >= threshold:
                slot = bank.get_or_build(pks[g], pin=True)
            if slot is not None:
                pinned.append(slot)
                slots[g] = slot
    except BaseException:
        bank.unpin(pinned)
        raise
    return slots


def _key_major(sel, key_ids):
    """Indices sel reordered so that each key's run is contiguous."""
    return sel[np.argsort(key_ids[sel], kind="stable")]


class CudaProvider(prov.Provider):
    name = "cuda"

    def __init__(self, require_low_s: bool = True, device=None,
                 fast_key_threshold: int = 64, max_cached_keys: int = 256,
                 mesh=None):
        """device: where the lanes run (default CUDA; raises when there
        is none).  device="cpu" runs the kernels' plain PyTorch
        versions, for tests.  mesh: a `parallel.mesh.DeviceMesh` whose
        shards run the lanes, in place of device.

          fast_key_threshold  signatures a key must bring to one batch to
                              earn a table slot (a P-256 build costs
                              ~0.15 s of host time and one 512 KB upload,
                              an Ed25519 one ~0.05 s and 230,880 bytes)
          max_cached_keys     slots of each device-resident table bank,
                              P-256's and Ed25519's
        """
        self.require_low_s = require_low_s
        if mesh is not None and device is not None:
            raise ValueError("give device or mesh, not both")
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            devices = (self.device,)
        else:
            self.device = mesh.devices[0]
            devices = mesh.distinct_devices
            self._sharded = {
                "p256": meshmod.sharded_p256_verify(mesh, require_low_s),
                "p256-rows": meshmod.sharded_p256_rows_verify(
                    mesh, require_low_s),
                "ed25519": meshmod.sharded_ed25519_verify(mesh),
                "ed25519-rows": meshmod.sharded_ed25519_rows_verify(mesh),
                "idemix-pair": meshmod.sharded_idemix_pair_verify(mesh)}
        self.sw = SoftwareProvider(require_low_s=require_low_s)
        self.stats = {"dispatches": 0, "device_sigs": 0, "host_rejects": 0,
                      "fallbacks": 0, "fast_key_sigs": 0, "h2d_bytes": 0}
        self.fast_key_threshold = int(fast_key_threshold)
        self.max_cached_keys = int(max_cached_keys)
        self.key_tables = DeviceBank(
            self.max_cached_keys, (p256_tables.ROWS, p256_tables.ROW_WORDS),
            p256_tables.table_for_pubkey, devices=devices)
        self.ed_key_tables = DeviceBank(
            self.max_cached_keys, (ed25519.ROWS, ed25519.ROW_WORDS),
            ed25519_tables.table_for_pubkey, devices=devices)
        # one replica per device of G's and B's tables and of the idemix
        # lane's lines (slot 0 g2's, then one slot per issuer's w in order
        # of first sight) and their flags
        self._g_tables = {d: p256_tables.g_table(d) for d in devices}
        self._b_tables = {d: ed25519_tables.b_table(d) for d in devices}
        self._g_table = self._g_tables[devices[0]]
        self._b_table = self._b_tables[devices[0]]
        g2 = self._idemix_g2_packed()
        self._idemix_lock = threading.Lock()
        self._idemix_slots: dict = {}
        self._idemix_flag_reps = {d: torch.from_numpy(g2["flags"]).to(d)
                                  for d in devices}
        self._idemix_line_reps = {
            d: torch.from_numpy(g2["lines"][None]).to(d) for d in devices}

    @property
    def _idemix_flags(self) -> torch.Tensor:
        return self._idemix_flag_reps[self.device]

    @property
    def _idemix_lines(self) -> torch.Tensor:
        return self._idemix_line_reps[self.device]

    def stats_snapshot(self) -> ProviderStats:
        """Point-in-time copy of the counters plus the bank's builds."""
        return ProviderStats(
            **self.stats,
            p256_table_builds=self.key_tables.stats["builds"],
            ed25519_table_builds=self.ed_key_tables.stats["builds"],
            tuning={"fast_key_threshold": self.fast_key_threshold,
                    "max_cached_keys": self.max_cached_keys})

    # signing / key-gen are host-side: delegate
    def key_gen(self, scheme: str):
        return self.sw.key_gen(scheme)

    def sign(self, private_key, payload: bytes) -> bytes:
        return self.sw.sign(private_key, payload)

    def pass_p256(self, items, idxs) -> LanePass:
        """The host pass (no device work but the bank's table uploads):
        one C DER parse over the items, the validity mask, the lane
        choice and the packing of both lanes' words.  The caller launches
        and then releases `pinned` with `key_tables.unpin`."""
        n = len(idxs)
        sigs, pays = [None] * n, [None] * n
        key_ids = np.empty(n, np.int64)
        pay_ok = np.empty(n, bool)
        pk_map, pks = {}, []
        for j, i in enumerate(idxs):
            it = items[i]
            sigs[j] = it.signature
            p = it.payload
            pay_ok[j] = len(p) == 32
            pays[j] = p if pay_ok[j] else _ZERO32
            gid = pk_map.get(it.pubkey)
            if gid is None:
                gid = pk_map[it.pubkey] = len(pks)
                pks.append(it.pubkey)
            key_ids[j] = gid
        ok, rs = native.parse_der_sigs(sigs)
        pk_ok = np.fromiter((len(pk) == 65 and pk[0] == 0x04 for pk in pks),
                            bool, len(pks))
        valid = ok & pay_ok & pk_ok[key_ids]
        out = LanePass(rejected=n - int(valid.sum()))
        if not valid.any():
            return out
        rsw = _be_words(rs)                                    # (n, 16)
        ew = _be_words(np.frombuffer(b"".join(pays), np.uint8).reshape(n, 32))
        idxs_np = np.asarray(idxs, np.int64)
        counts = np.bincount(key_ids[valid], minlength=len(pks))
        slots = _claim_slots(self.key_tables, pks, counts,
                             self.fast_key_threshold, out.pinned)
        fast = valid & (slots[key_ids] >= 0)
        fsel = np.nonzero(fast)[0]
        if fsel.size:
            fsel = _key_major(fsel, key_ids)
            out.fast = (idxs_np[fsel],
                        [np.ascontiguousarray(rsw[fsel, :8].T),
                         np.ascontiguousarray(rsw[fsel, 8:].T),
                         np.ascontiguousarray(ew[fsel].T)],
                        slots[key_ids[fsel]].astype(np.int32))
        gsel = np.nonzero(valid & ~fast)[0]
        if gsel.size:
            gids, rows = np.unique(key_ids[gsel], return_inverse=True)
            pkb = np.frombuffer(b"".join(pks[g] for g in gids),
                                np.uint8).reshape(-1, 65)
            out.generic = (idxs_np[gsel],
                           [_be_words(pkb[:, 1:33])[rows].T.copy(),
                            _be_words(pkb[:, 33:65])[rows].T.copy(),
                            np.ascontiguousarray(rsw[gsel, :8].T),
                            np.ascontiguousarray(rsw[gsel, 8:].T),
                            np.ascontiguousarray(ew[gsel].T)])
        return out

    def pass_ed25519(self, items, idxs) -> LanePass:
        """The host pass over the Ed25519 items (no device work but the
        bank's table uploads): the length screen, the packing of words,
        sign bits and k = SHA-512(R || A || M) mod L, and the lane choice.
        The caller launches and then releases `pinned` with
        `ed_key_tables.unpin`."""
        keep, pks, sigs, msgs, key_ids = [], [], [], [], []
        pk_map, keys = {}, []
        for i in idxs:
            it = items[i]
            if len(it.pubkey) != 32 or len(it.signature) != 64:
                continue
            keep.append(i)
            pks.append(it.pubkey)
            sigs.append(it.signature)
            msgs.append(it.payload)
            gid = pk_map.get(it.pubkey)
            if gid is None:
                gid = pk_map[it.pubkey] = len(keys)
                keys.append(it.pubkey)
            key_ids.append(gid)
        out = LanePass(rejected=len(idxs) - len(keep))
        if not keep:
            return out
        ay, a_sign, ry, r_sign, s, k = ed25519.pack_verify_inputs(
            pks, sigs, msgs)
        keep = np.asarray(keep, np.int64)
        key_ids = np.asarray(key_ids, np.int64)
        counts = np.bincount(key_ids, minlength=len(keys))
        slots = _claim_slots(self.ed_key_tables, keys, counts,
                             self.fast_key_threshold, out.pinned)
        fast = slots[key_ids] >= 0
        fsel = np.nonzero(fast)[0]
        if fsel.size:
            fsel = _key_major(fsel, key_ids)
            out.fast = (keep[fsel],
                        [ry[:, fsel], r_sign[fsel], s[:, fsel], k[:, fsel]],
                        slots[key_ids[fsel]].astype(np.int32))
        gsel = np.nonzero(~fast)[0]
        if gsel.size:
            out.generic = (keep[gsel],
                           [ay[:, gsel], a_sign[gsel], ry[:, gsel],
                            r_sign[gsel], s[:, gsel], k[:, gsel]])
        return out

    def _per_device_slots(self, kind: str, n: int) -> list:
        """[(device label, real, slots)] of one launch of n items: the
        provider's device, or under a mesh each device's shards
        (`mesh.shard_bounds`; an empty shard launches nothing)."""
        if self.mesh is None:
            return [(str(with_index(self.device)), n,
                     grid_slots(kind, n, self.device))]
        per = {}
        for (lo, hi), dev in zip(meshmod.shard_bounds(n, len(self.mesh)),
                                 self.mesh.devices):
            if hi > lo:
                r, sl = per.get(str(dev), (0, 0))
                per[str(dev)] = (r + hi - lo, sl + grid_slots(kind, hi - lo,
                                                             dev))
        return [(dev, r, sl) for dev, (r, sl) in per.items()]

    def _observe_lane(self, kind: str, n: int) -> None:
        """Per-launch batching-economics telemetry (the reference's
        `_observe_lane`): lane fill fraction and slots carrying no item,
        per device.  Guarded: observability must never break the dispatch
        hot path."""
        try:
            from ..ops_plane import registry
            lane = LANE_LABELS[kind]
            per_device = self._per_device_slots(kind, n)
            slots = sum(sl for _, _, sl in per_device)
            fill_g = registry.gauge(
                "provider_lane_fill_fraction",
                "real signatures / padded device slots, last dispatch")
            pad_c = registry.counter(
                "provider_pad_slots_total",
                "padded device slots carrying no real signature")
            slot_c = registry.counter(
                "provider_lane_slots_total",
                "device slots dispatched (real + pad)")
            for dev, r_d, s_d in per_device:
                fill_g.set((r_d / s_d) if s_d else 1.0,
                           lane=lane, device=dev)
                pad_c.add(float(s_d - r_d), lane=lane, device=dev)
                slot_c.add(float(s_d), lane=lane, device=dev)
            registry.histogram(
                "provider_lane_fill",
                "per-dispatch lane fill fraction",
                buckets=_FILL_BUCKETS).observe(
                    (n / slots) if slots else 1.0, lane=lane)
        except Exception:
            pass

    def _upload(self, arrays, lo, hi):
        """Columns lo:hi of each host array (the last axis indexes the
        signatures) -> tensors on the device (under a mesh, host tensors:
        each shard's columns are copied on its own stream)."""
        words = [torch.from_numpy(np.ascontiguousarray(a[..., lo:hi]))
                 for a in arrays]
        self.stats["h2d_bytes"] += sum(w.nbytes for w in words)
        if self.mesh is None and self.device.type == "cuda":
            words = [w.pin_memory().to(self.device, non_blocking=True)
                     for w in words]
        return words

    def _launch_lane(self, kind, lane, launch, pending) -> None:
        """Upload and launch one lane (`kind`, a key of GRID_ITEMS) in
        chunks of at most MAX_CHUNK signatures.  lane: (keep, arrays) or,
        for a fixed-key lane, (keep, arrays, slot); launch(*words[, slot])
        -> (B,) bool."""
        keep, arrays = lane[0], lane[1]
        slot = lane[2] if len(lane) > 2 else None
        for lo in range(0, len(keep), MAX_CHUNK):
            hi = min(lo + MAX_CHUNK, len(keep))
            args = self._upload(arrays, lo, hi)
            if slot is not None:
                args.append(torch.from_numpy(slot[lo:hi]))
                self.stats["h2d_bytes"] += args[-1].nbytes
                self.stats["fast_key_sigs"] += hi - lo
            out = launch(*args)
            self.stats["dispatches"] += 1
            self.stats["device_sigs"] += hi - lo
            self._observe_lane(kind, hi - lo)
            pending.append((keep[lo:hi], out))

    def _run_lanes(self, kind, batch, bank, fast, generic, pending) -> None:
        """Launch a host pass's two lanes (`kind`, "p256" or "ed25519"):
        fast(*words, slot, bank) for the fixed-key lane, generic(*words)
        for the other; bank is the
        bank's tensor, or under a mesh its {device: replica} map.  The
        batch's bank pins are released once the fixed-key launches are
        enqueued (on the current stream, or on the mesh's shard streams),
        or when one raises."""
        self.stats["host_rejects"] += batch.rejected
        streams = None
        if self.mesh is not None:
            streams = [s for s in self.mesh.streams if s is not None]
        try:
            if batch.fast is not None:
                arr = bank.array() if self.mesh is None else bank.replicas()
                self._launch_lane(kind + "-rows", batch.fast,
                                  lambda *a: fast(*a, arr), pending)
        finally:
            bank.unpin(batch.pinned, streams)
        if batch.generic is not None:
            self._launch_lane(kind, batch.generic, generic, pending)

    def _verify_p256(self, items, idxs, pending) -> None:
        batch = self.pass_p256(items, idxs)
        if self.mesh is not None:
            rows, gen = self._sharded["p256-rows"], self._sharded["p256"]
            self._run_lanes(
                "p256", batch, self.key_tables,
                lambda *a: rows(*a, self._g_tables)[0],
                lambda *w: gen(*w, self._g_tables)[0], pending)
            return
        low_s = self.require_low_s
        self._run_lanes(
            "p256", batch, self.key_tables,
            lambda r, s, e, slot, bank: p256_fixed.p256_verify_rows(
                r, s, e, slot, bank, self._g_table, require_low_s=low_s),
            lambda *w: p256mod.p256_verify(*w, self._g_table,
                                           require_low_s=low_s), pending)

    def _verify_ed25519(self, items, idxs, pending) -> None:
        batch = self.pass_ed25519(items, idxs)
        if self.mesh is not None:
            rows = self._sharded["ed25519-rows"]
            gen = self._sharded["ed25519"]
            self._run_lanes(
                "ed25519", batch, self.ed_key_tables,
                lambda *a: rows(*a, self._b_tables)[0],
                lambda *w: gen(*w, self._b_tables)[0], pending)
            return
        self._run_lanes(
            "ed25519", batch, self.ed_key_tables,
            lambda ry, r_sign, s, k, slot, bank: ed25519.ed25519_verify_rows(
                ry, r_sign, s, k, slot, bank, self._b_table),
            lambda *w: ed25519.ed25519_verify(*w, self._b_table), pending)

    # -- idemix: batched BN254 pairing checks (BASELINE config 4) -----------

    @staticmethod
    def _idemix_g2_packed() -> dict:
        """g2's line constants (`bn254.g2_packed`, built once)."""
        return kb8.g2_packed()

    def _idemix_packed(self, ipk_bytes: bytes) -> int:
        """The device slot of an issuer's w lines, precomputed on the
        host and appended to every replica of the device line tensor on
        first sight, under the same slot."""
        from ..idemix.msp import deserialize_ipk
        with self._idemix_lock:
            slot = self._idemix_slots.get(ipk_bytes)
            if slot is None:
                packed = kb8.pack_steps(hbn.ate_precompute(
                    deserialize_ipk(ipk_bytes).w))
                kb8.stack_lines([self._idemix_g2_packed(), packed])
                host = torch.from_numpy(packed["lines"][None])
                reps = self._idemix_line_reps
                for dev, old in reps.items():
                    lines = host.to(dev)
                    self.stats["h2d_bytes"] += lines.nbytes
                    # a new tensor: launches already enqueued keep the old
                    # one
                    reps[dev] = torch.cat([old, lines])
                slot = self._idemix_slots[ipk_bytes] = \
                    self._idemix_lines.shape[0] - 1
            return slot

    def _verify_idemix(self, items, idxs, pending) -> None:
        """Host checks per item, then every check of the batch in KB8
        launches of at most MAX_CHUNK: e(A', w) * e(-Abar, g2) == 1."""
        from ..idemix.msp import collect_item_parts
        keep, slots, p1, p2 = [], [], [], []
        for i in idxs:
            ok, ipk_bytes, pair = collect_item_parts(items[i])
            if not ok:
                continue                    # the verdict stays False
            keep.append(i)
            slots.append(self._idemix_packed(ipk_bytes))
            p1.append(pair[0])
            p2.append(pair[1])
        if not keep:
            return
        keep = np.asarray(keep, np.int64)
        slots = np.asarray(slots, np.int32)
        words = [kb8.ints_to_words([p[0] for p in p1]),
                 kb8.ints_to_words([p[1] for p in p1]),
                 kb8.ints_to_words([p[0] for p in p2]),
                 kb8.ints_to_words([(hbn.P - p[1]) % hbn.P for p in p2])]
        check, flags, lines = self._pairing()
        for lo in range(0, len(keep), MAX_CHUNK):
            hi = min(lo + MAX_CHUNK, len(keep))
            args = self._upload(words, lo, hi)
            slot = torch.from_numpy(slots[lo:hi])
            self.stats["h2d_bytes"] += slot.nbytes
            out = check(flags, lines, slot, *args)
            self.stats["dispatches"] += 1
            self.stats["device_sigs"] += hi - lo
            self._observe_lane("idemix-pair", hi - lo)
            pending.append((keep[lo:hi], out))

    def idemix_pair_probe(self, batch: int):
        """(fn, green_args, red_args) for the BN254 pairing lane on this
        provider's device (under a mesh: the sharded lane, fn -> its
        verdicts): green checks e(G1, g2) * e(-G1, g2) == 1, red
        e(G1, g2)^2 == 1, both at `batch` checks with g2's lines on both
        sides (slot 0)."""
        gx, gy = hbn.G1_GEN
        dev = self.device if self.mesh is None else "cpu"

        def col(v):
            return torch.from_numpy(kb8.ints_to_words([v] * batch)).to(dev)

        x, y, y_neg = col(gx), col(gy), col(hbn.P - gy)
        fn, flags, lines = self._pairing()
        base = (flags, lines, torch.zeros(batch, dtype=torch.int32), x, y, x)
        return fn, base + (y_neg,), base + (y,)

    def _pairing(self):
        """(fn, flags, lines) of the idemix lane: KB8's wrapper over the
        device's line tensor, or under a mesh the sharded lane (its
        verdicts) over every replica; fn(flags, lines, slot, x1, y1, x2,
        y2) -> (B,) bool."""
        if self.mesh is None:
            return (kb8.bn254_pairing_check, self._idemix_flags,
                    self._idemix_lines)
        sharded = self._sharded["idemix-pair"]
        return (lambda *a: sharded(*a)[0], dict(self._idemix_flag_reps),
                dict(self._idemix_line_reps))

    def batch_verify_async(self, items: Sequence[VerifyItem]):
        """Enqueue the device work and return resolve() -> bool[N].

        One `bccsp.batch_verify` span a call, started at enqueue on the
        caller's trace and ended by whichever thread resolves it, with
        the reference's attributes; a failure at enqueue or at resolve
        ends it as an error and raises."""
        from ..ops_plane import tracing
        items = list(items)
        verdicts = np.zeros(len(items), dtype=bool)
        span = tracing.tracer.start_span(
            "bccsp.batch_verify", require_parent=True,
            attributes={"provider": self.name, "batch_size": len(items)})
        snap0 = self.stats_snapshot() if span.recording else None
        by_scheme = {}
        for i, it in enumerate(items):
            by_scheme.setdefault(it.scheme, []).append(i)
        pending = []
        try:
            for scheme, idxs in by_scheme.items():
                if scheme == SCHEME_P256:
                    self._verify_p256(items, idxs, pending)
                elif scheme == SCHEME_ED25519:
                    self._verify_ed25519(items, idxs, pending)
                elif scheme == SCHEME_IDEMIX:
                    self._verify_idemix(items, idxs, pending)
                else:
                    self.stats["host_rejects"] += len(idxs)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        except BaseException as exc:
            span.set_attribute("error", repr(exc))
            span.end(status="ERROR")
            raise
        self._queue_depth_add(len(pending))

        def resolve():
            import time as _time
            t0 = _time.perf_counter()
            try:
                if done is not None:
                    done.synchronize()
                for keep, out in pending:
                    verdicts[np.asarray(keep)] = out.cpu().numpy()
            except BaseException as exc:
                self._queue_depth_add(-len(pending))
                span.set_attribute("error", repr(exc))
                span.end(status="ERROR")
                raise
            wall = _time.perf_counter() - t0
            self._queue_depth_add(-len(pending))
            if span.recording:
                snap1 = self.stats_snapshot()
                span.set_attribute("block_until_ready_s", round(wall, 6))
                span.set_attribute(
                    "dispatches", snap1.dispatches - snap0.dispatches)
                span.set_attribute(
                    "device_sigs", snap1.device_sigs - snap0.device_sigs)
                span.set_attribute(
                    "fast_key_sigs",
                    snap1.fast_key_sigs - snap0.fast_key_sigs)
                span.set_attribute(
                    "table_builds",
                    (snap1.p256_table_builds - snap0.p256_table_builds)
                    + (snap1.ed25519_table_builds
                       - snap0.ed25519_table_builds))
                span.end()
            try:
                # the always-on device-phase numbers (torch.profiler is
                # the deep view): resolve wall time ~= the device tail
                # not hidden by overlap
                from ..ops_plane import registry
                registry.histogram(
                    "provider_resolve_seconds",
                    "batch_verify device resolve wait").observe(wall)
                registry.gauge(
                    "provider_device_sync_seconds",
                    "last batch_verify device-sync (resolve) wait"
                    ).set(wall)
                registry.counter(
                    "provider_device_sigs_total",
                    "signatures resolved on device").add(len(items))
            except Exception:
                pass
            return verdicts

        return resolve

    @staticmethod
    def _queue_depth_add(n: int) -> None:
        """Launches enqueued and not yet resolved (the placement's demand
        sample reads this gauge).  Guarded like every observer."""
        if not n:
            return
        try:
            from ..ops_plane import registry
            registry.gauge("provider_dispatch_queue_depth",
                           "device dispatches enqueued, not yet resolved"
                           ).add(float(n))
        except Exception:
            pass

    def batch_verify(self, items: Sequence[VerifyItem]) -> np.ndarray:
        return self.batch_verify_async(items)()
