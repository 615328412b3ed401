"""Config history: historical channel-config lookups by block height.

Reference parity: core/ledger/confighistory/mgr.go — a height-indexed
store of committed configuration so components can answer "what was the
config (collection/chaincode/channel) as of block N" deterministically
during historical validation and snapshotting.  Here the tracked unit is
the serialized ChannelConfig applied at each config block (the
framework's collection configs ride inside node/chaincode config; the
channel config is the consensus-replicated piece).

Counterpart of `fabric_tpu/ledger/confighistory.py`, whole: the same
`confighistory.bin` byte for byte.
"""

from __future__ import annotations

import bisect
import os
import struct
import threading
from typing import List, Optional, Tuple

_LEN = struct.Struct("<QI")


class ConfigHistory:
    """Append-only (block_num, config_bytes) log with height lookups."""

    def __init__(self, root: Optional[str] = None):
        self.root = root
        self._lock = threading.Lock()
        self._entries: List[Tuple[int, bytes]] = []
        if root is not None:
            os.makedirs(root, exist_ok=True)
            self._path = os.path.join(root, "confighistory.bin")
            self._recover()

    def _recover(self) -> None:
        if not os.path.exists(self._path):
            return
        with open(self._path, "rb") as f:
            data = f.read()
        off = 0
        while off + _LEN.size <= len(data):
            num, n = _LEN.unpack_from(data, off)
            if off + _LEN.size + n > len(data):
                break               # torn tail: drop
            self._entries.append(
                (num, data[off + _LEN.size:off + _LEN.size + n]))
            off += _LEN.size + n

    def record(self, block_num: int, config_bytes: bytes) -> None:
        with self._lock:
            if self._entries and block_num <= self._entries[-1][0]:
                return              # replay during catch-up: idempotent
            self._entries.append((block_num, bytes(config_bytes)))
            if self.root is not None:
                with open(self._path, "ab") as f:
                    f.write(_LEN.pack(block_num, len(config_bytes)))
                    f.write(config_bytes)
                    f.flush()
                    os.fsync(f.fileno())

    def config_at(self, block_num: int) -> Optional[bytes]:
        """The config in force AS OF block_num (most recent entry with
        block <= block_num), or None before the first record."""
        with self._lock:
            nums = [n for n, _ in self._entries]
            i = bisect.bisect_right(nums, block_num)
            return self._entries[i - 1][1] if i else None

    def latest_height(self) -> Optional[int]:
        """Block number of the newest recorded config, or None."""
        with self._lock:
            return self._entries[-1][0] if self._entries else None

    def entries(self) -> List[Tuple[int, bytes]]:
        with self._lock:
            return list(self._entries)
