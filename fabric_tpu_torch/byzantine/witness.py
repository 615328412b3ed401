"""Per-channel witness log: (block_num -> header-hash) plus who vouched.

The detection substrate for equivocation: every block admitted past
signature verification is witnessed as (height, header-hash hex,
transport source, signer bindings).  One height, one hash is the
invariant of an honest ordering service — a second, DIFFERENT hash at a
witnessed height makes the height *disputed*, and the monitor
(monitor.py) decides which vouchers committed a provable crime.

The log is compact by construction: heights below the committed chain
are pruned on every observe (the blockstore itself is the witness for
committed heights — fork checks against it read the stored block), so
the in-memory and on-disk footprint is O(uncommitted tail + live
disputes), not O(chain length).

Persistence piggybacks the trust.py discipline (atomic tmp +
os.replace) but is throttled to every `flush_every` mutations plus
every dispute transition — witnessing is on the block intake path and
must not add an fsync per block.

Counterpart of `fabric_tpu/byzantine/witness.py`, the same code on the
port's imports.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, List, Optional

logger = logging.getLogger("fabric_tpu_torch.byzantine")


class WitnessLog:
    """Thread-safe witness log for one channel."""

    def __init__(self, path: Optional[str] = None, keep_tail: int = 512,
                 flush_every: int = 64):
        self.path = path
        self.keep_tail = int(keep_tail)
        self.flush_every = max(1, int(flush_every))
        self._lock = threading.Lock()
        # height -> {"hashes": {hex: {"sources": [..], "signers": [..]}},
        #            "confirmed": hex|None}
        self._entries: Dict[int, dict] = {}
        self._dirty = 0
        if path is not None and os.path.exists(path):
            try:
                with open(path, "r", encoding="utf-8") as f:
                    data = json.load(f)
                if isinstance(data, dict):
                    self._entries = {int(k): v for k, v in data.items()
                                     if isinstance(v, dict)}
            except Exception:
                logger.exception("witness log unreadable: %s", path)

    # -- recording -----------------------------------------------------------

    def vouch(self, num: int, hhex: str, source: str,
              signers: List[str]) -> dict:
        """Record that `source` delivered (and `signers` signed) header
        `hhex` at height `num`.  Returns a copy of the height's entry
        AFTER the vouch — the monitor reads conflict state off it."""
        with self._lock:
            ent = self._entries.setdefault(
                num, {"hashes": {}, "confirmed": None})
            was_disputed = len(ent["hashes"]) > 1
            rec = ent["hashes"].setdefault(
                hhex, {"sources": [], "signers": []})
            if source and source not in rec["sources"]:
                rec["sources"].append(source)
            for s in signers:
                if s and s not in rec["signers"]:
                    rec["signers"].append(s)
            disputed = len(ent["hashes"]) > 1 and ent["confirmed"] is None
            self._dirty += 1
            flush = (disputed and not was_disputed) \
                or self._dirty >= self.flush_every
            out = self._copy_entry(ent)
            if flush:
                self._save()
        return out

    def confirm(self, num: int, hhex: str) -> None:
        """Pin the winning hash at a (formerly disputed) height."""
        with self._lock:
            ent = self._entries.setdefault(
                num, {"hashes": {}, "confirmed": None})
            ent["confirmed"] = hhex
            self._save()

    def prune_below(self, height: int) -> None:
        """Drop entries the committed chain already witnesses (keep a
        short tail so late dup frames still hit a fast in-memory path)."""
        floor = height - self.keep_tail
        if floor <= 0:
            return
        with self._lock:
            stale = [n for n in self._entries if n < floor]
            for n in stale:
                del self._entries[n]
            if stale:
                self._dirty += len(stale)
                if self._dirty >= self.flush_every:
                    self._save()

    # -- reading -------------------------------------------------------------

    def get(self, num: int) -> Optional[dict]:
        with self._lock:
            ent = self._entries.get(num)
            return self._copy_entry(ent) if ent is not None else None

    def disputed_heights(self) -> List[int]:
        with self._lock:
            return sorted(n for n, e in self._entries.items()
                          if len(e["hashes"]) > 1
                          and e.get("confirmed") is None)

    def stats(self) -> dict:
        with self._lock:
            return {"heights": len(self._entries),
                    "disputed": sum(
                        1 for e in self._entries.values()
                        if len(e["hashes"]) > 1
                        and e.get("confirmed") is None),
                    "confirmed": sum(
                        1 for e in self._entries.values()
                        if e.get("confirmed") is not None)}

    def snapshot(self) -> Dict[int, dict]:
        with self._lock:
            return {n: self._copy_entry(e)
                    for n, e in sorted(self._entries.items())}

    @staticmethod
    def _copy_entry(ent: dict) -> dict:
        return {"hashes": {h: {"sources": list(r["sources"]),
                               "signers": list(r["signers"])}
                           for h, r in ent["hashes"].items()},
                "confirmed": ent.get("confirmed")}

    def _save(self) -> None:
        # caller holds the lock
        self._dirty = 0
        if self.path is None:
            return
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({str(n): e for n, e in self._entries.items()},
                          f, sort_keys=True)
            os.replace(tmp, self.path)
        except Exception:
            logger.exception("witness log not persisted")

    def flush(self) -> None:
        with self._lock:
            self._save()
