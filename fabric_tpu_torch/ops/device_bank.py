"""K4: the device-resident bank of per-key comb tables (slot allocator).

Counterpart of `fabric_tpu/ops/device_bank.py` (`DeviceBank`), with the
same API, LRU over whole slots, refcounted pins, `RLock` and `stats`
keys.  The provider keeps two: P-256's of (8192, 16) comb tables and
Ed25519's of (2405, 24) niels tables of -A.  Each key's table is
uploaded once, when it is built (or rebuilt after an eviction), into
one fixed-shape uint32 tensor on the device; a fixed-key lane then
carries only an int32 slot per signature.

What differs from the reference: the bank is mutable.  JAX arrays are
immutable, so the reference copies the whole bank to set one slot
(`b.at[i].set(t)`) and in-flight dispatches keep the old copy.  Here a
build writes its slot in place, `bank[slot].copy_(table)`: a plain
host-to-device copy, no kernel.  The pins keep a slot from being chosen
for eviction between the lane choice and the launch of the batch that
chose it.  `unpin`, called once those launches are enqueued, records an
event for each slot it releases on every stream that launched against
it (the current stream, or the shard streams of a mesh); a rewrite of
the slot makes its own stream wait for every such event first, so it
lands after every launch that may still read the old table, on
whichever streams the launches and the rewrite run.  The copy comes
from pageable host memory and so returns only when it is done: every
launch enqueued after it, on any stream, reads the new table.

Replicated (`devices=mesh.distinct_devices`, `parallel/mesh.py`): one
host slot map (the same LRU, pins and stats) over one uint32 tensor per
distinct device.  A build writes its table into every replica, each
after the readers of that replica; `array(device)` is that device's
replica.  With one device the bank is the one it was before.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, with_index


class DeviceBank:
    """Fixed-capacity slot allocator over one device-resident uint32 bank.

    build_fn(pubkey) -> np.ndarray of `entry_shape` (host comb table), or
    None for malformed or off-curve keys (the fixed-key lane's one
    on-curve gate).  Thread-safe.  device: where the bank lives (default
    CUDA; raises without it); devices: the distinct devices of a mesh,
    one replica on each, in place of device.
    """

    def __init__(self, max_keys: int, entry_shape: Tuple[int, ...],
                 build_fn: Callable[[bytes], Optional[np.ndarray]],
                 device=None, devices=None):
        self.max_keys = int(max_keys)
        self.entry_shape = tuple(entry_shape)
        self.build_fn = build_fn
        if devices is not None and device is not None:
            raise ValueError("give device or devices, not both")
        self.devices = tuple(dict.fromkeys(
            with_index(resolve_device(d)) for d in (devices or (device,))))
        self.device = self.devices[0]
        self._slots: "OrderedDict[bytes, int]" = OrderedDict()
        self._free = list(range(self.max_keys - 1, -1, -1))
        self._banks: dict = {}
        self._lock = threading.RLock()
        # refcounted pins: a slot claimed by an in-flight batch (from lane
        # choice until its launch is enqueued) must not be evicted, by
        # this batch's later builds or by a concurrent batch on another
        # thread.  Callers pin via lookup/get_or_build(pin=True) and
        # release with unpin() after launching.
        self._pinned: dict = {}
        # slot -> {stream handle: (its device, an event after the last
        # launches enqueued there that read it)}; a rewrite of the slot's
        # replica on a device waits for that device's events
        self._readers: dict = {}
        self.stats = {"hits": 0, "builds": 0, "rejects": 0,
                      "evictions": 0, "pinned_spills": 0, "h2d_bytes": 0}

    def __contains__(self, pubkey: bytes) -> bool:
        with self._lock:
            return pubkey in self._slots

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def array(self, device=None) -> torch.Tensor:
        """The (max_keys, *entry_shape) uint32 bank on `device` (default:
        the first), allocated (zeroed) on first use."""
        dev = self.device if device is None else with_index(
            torch.device(device))
        with self._lock:
            bank = self._banks.get(dev)
            if bank is None:
                if dev not in self.devices:
                    raise ValueError(f"the bank has no replica on {dev}")
                bank = self._banks[dev] = torch.zeros(
                    (self.max_keys,) + self.entry_shape, dtype=torch.uint32,
                    device=dev)
            return bank

    def replicas(self) -> dict:
        """{device: bank} over every replica."""
        return {d: self.array(d) for d in self.devices}

    def lookup(self, pubkey: bytes, pin: bool = False) -> Optional[int]:
        """Slot index for a resident key (refreshes LRU), else None.
        pin=True atomically pins the returned slot against eviction."""
        with self._lock:
            slot = self._slots.get(pubkey)
            if slot is not None:
                self._slots.move_to_end(pubkey)
                self.stats["hits"] += 1
                if pin:
                    self._pinned[slot] = self._pinned.get(slot, 0) + 1
            return slot

    def unpin(self, slots, streams=None) -> None:
        """Release pins taken via lookup/get_or_build(pin=True), once the
        launches that read these slots are enqueued on `streams` (default:
        the current stream of each replica's device)."""
        slots = list(slots)
        marks = []                      # (stream handle, device, event)
        if slots:
            if streams is None:
                streams = [torch.cuda.current_stream(d) for d in self.devices
                           if d.type == "cuda"]
            for stream in streams:
                ev = torch.cuda.Event()
                ev.record(stream)
                marks.append((stream.cuda_stream, stream.device, ev))
        with self._lock:
            for s in slots:
                for handle, dev, ev in marks:
                    self._readers.setdefault(s, {})[handle] = (dev, ev)
                n = self._pinned.get(s, 0) - 1
                if n <= 0:
                    self._pinned.pop(s, None)
                else:
                    self._pinned[s] = n

    def get_or_build(self, pubkey: bytes,
                     pin: bool = False) -> Optional[int]:
        """Slot index for the key, building and uploading its table if
        needed; None for malformed/off-curve keys or when every
        evictable slot is pinned by an in-flight batch (the key's
        signatures then take the generic lane).  The table is built on
        the host before a slot is sought, as in the reference."""
        slot = self.lookup(pubkey, pin=pin)
        if slot is not None:
            return slot
        tab = self.build_fn(pubkey)
        if tab is None:
            with self._lock:
                self.stats["rejects"] += 1
            return None
        tab = np.ascontiguousarray(tab, dtype=np.uint32)
        if tab.shape != self.entry_shape:
            raise ValueError(
                f"table shape {tab.shape} != bank entry {self.entry_shape}")
        with self._lock:
            # lost race: another thread built it while we were building
            got = self._slots.get(pubkey)
            if got is not None:
                if pin:
                    self._pinned[got] = self._pinned.get(got, 0) + 1
                return got
            banks = self.replicas()
            if self._free:
                slot = self._free.pop()
            else:
                slot = None
                for old_pk, s in self._slots.items():      # LRU order
                    if not self._pinned.get(s):
                        slot = s
                        del self._slots[old_pk]
                        break
                if slot is None:
                    self.stats["pinned_spills"] += 1
                    return None
                self.stats["evictions"] += 1
            self.stats["builds"] += 1
            self.stats["h2d_bytes"] += tab.nbytes * len(banks)
            # in place: after every launch that may still read the old
            # table, before every later one (see the module docstring)
            readers = self._readers.pop(slot, {}).values()
            host = torch.from_numpy(tab)
            for dev, bank in banks.items():
                if dev.type == "cuda":
                    stream = torch.cuda.current_stream(dev)
                    for rdev, ev in readers:
                        if rdev == dev:
                            stream.wait_event(ev)
                bank[slot].copy_(host)
            self._slots[pubkey] = slot
            if pin:
                self._pinned[slot] = self._pinned.get(slot, 0) + 1
        return slot
