"""Append-only block store with number/hash/txid index.

Reference parity: common/ledger/blkstorage/{blockfile_mgr,blockindex,
blockstore}.go — append-only block files + a LevelDB index keyed by block
number, block hash, and txid, plus chain info (height, current hash) and
block iterators.

Layout here: numbered segment files `blocks_000000.bin` holding
length-prefixed serialized blocks; the index is rebuilt by scanning on
open (the reference scans only the last partial file because its index is
durable; our scan is cheap at framework scale and doubles as the
crash-recovery pass — a torn trailing write is truncated, mirroring
blockfile_mgr's partial-write recovery).

Snapshot bootstrap: a store created from a shipped state snapshot has no
blocks below the snapshot height.  A `BOOTSTRAP.json` marker records the
base height and the chain hashes at the boundary (bootstrapFromSnapshot
+ bootstrappingSnapshotInfo in the reference's blockfile_mgr), so the
chain check for the first delivered block and commit-hash chaining both
survive the gap; blocks below `base` read as pruned.

Counterpart of `fabric_tpu/ledger/blkstorage.py`, whole: the same
segment files and marker byte for byte, so either package opens the
other's store.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

from fabric_tpu_torch.protocol import Block, Envelope, block_header_hash
from fabric_tpu_torch.protocol import wire
from fabric_tpu_torch.protocol.types import META_TXFLAGS
from fabric_tpu_torch.protocol.txflags import TxFlags, ValidationCode

_LEN = struct.Struct("<Q")
SEGMENT_MAX_BYTES = 64 * 1024 * 1024
BOOTSTRAP_FILE = "BOOTSTRAP.json"


class BlockStoreError(Exception):
    pass


@dataclass
class ChainInfo:
    """common.BlockchainInfo equivalent."""
    height: int
    current_hash: bytes
    previous_hash: bytes


@dataclass
class _Loc:
    segment: int
    offset: int
    length: int


class BlockStore:
    """One channel's block store (blkstorage.BlockStore)."""

    def __init__(self, root: Optional[str] = None,
                 segment_max_bytes: int = SEGMENT_MAX_BYTES):
        self.root = root  # None = pure in-memory (no files, no durability)
        self.segment_max = segment_max_bytes
        self._lock = threading.RLock()
        self._by_number: List[_Loc] = []
        self._mem_blocks: List[bytes] = []  # in-memory mode payloads
        self._by_hash: Dict[bytes, int] = {}
        self._by_txid: Dict[str, Tuple[int, int]] = {}  # txid -> (block, tx idx)
        self._cur_hash = b"\x00" * 32
        self._prev_hash = b"\x00" * 32
        self._open_segment_no = 0
        # snapshot-bootstrap boundary: blocks < base are pruned
        self.base = 0
        self.bootstrap_commit_hash: Optional[bytes] = None
        self._base_cur_hash = b"\x00" * 32
        self._base_prev_hash = b"\x00" * 32
        if root is not None:
            os.makedirs(root, exist_ok=True)
            self._load_bootstrap()
            self._recover()

    # -- recovery / files ---------------------------------------------------

    def _seg_path(self, n: int) -> str:
        return os.path.join(self.root, f"blocks_{n:06d}.bin")

    def _load_bootstrap(self) -> None:
        path = os.path.join(self.root, BOOTSTRAP_FILE)
        if not os.path.exists(path):
            return
        with open(path, "r", encoding="utf-8") as f:
            info = json.load(f)
        self.base = int(info["base"])
        self._base_cur_hash = bytes.fromhex(info["current_hash"])
        self._base_prev_hash = bytes.fromhex(info["previous_hash"])
        self.bootstrap_commit_hash = bytes.fromhex(info["commit_hash"])
        self._cur_hash = self._base_cur_hash
        self._prev_hash = self._base_prev_hash

    @staticmethod
    def write_bootstrap(root: str, base: int, current_hash: bytes,
                        previous_hash: bytes, commit_hash: bytes) -> None:
        """Durably stamp a snapshot-bootstrap boundary.  Written LAST by
        the snapshot installer — its presence is the commit point that
        makes an installed snapshot visible."""
        os.makedirs(root, exist_ok=True)
        path = os.path.join(root, BOOTSTRAP_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"base": int(base),
                       "current_hash": current_hash.hex(),
                       "previous_hash": previous_hash.hex(),
                       "commit_hash": commit_hash.hex()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _segments(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("blocks_") and name.endswith(".bin"):
                out.append(int(name[7:13]))
        return sorted(out)

    def _recover(self) -> None:
        """Scan all segments; truncate a torn trailing record
        (blockfile_mgr partial-write recovery)."""
        for seg in self._segments():
            path = self._seg_path(seg)
            good_end = 0
            with open(path, "rb") as f:
                data = f.read()
            off = 0
            while off + _LEN.size <= len(data):
                (n,) = _LEN.unpack_from(data, off)
                if off + _LEN.size + n > len(data):
                    break  # torn write
                try:
                    block = Block.deserialize(data[off + _LEN.size:off + _LEN.size + n])
                except ValueError:
                    break
                self._index_block(block, _Loc(seg, off, _LEN.size + n))
                off += _LEN.size + n
                good_end = off
            if good_end != len(data):
                with open(path, "r+b") as f:
                    f.truncate(good_end)
        if self._by_number:
            segs = self._segments()
            self._open_segment_no = segs[-1] if segs else 0

    def _index_block(self, block: Block, loc: _Loc) -> None:
        num = block.header.number
        if num != self.base + len(self._by_number):
            raise BlockStoreError(
                f"block {num} out of order "
                f"(height {self.base + len(self._by_number)})")
        self._by_number.append(loc)
        h = block_header_hash(block.header)
        self._by_hash[h] = num
        self._prev_hash = block.header.previous_hash
        self._cur_hash = h
        for i, env_bytes in enumerate(block.data):
            # native header peek; full decode only when it rejects
            summary = wire.envelope_summary(env_bytes)
            if summary is not None:
                txid = summary[2]
            else:
                try:
                    txid = Envelope.deserialize(
                        env_bytes).header().channel_header.txid
                except Exception:
                    continue
            # first writer wins: duplicate txids keep the earliest location
            self._by_txid.setdefault(txid, (num, i))

    # -- writes -------------------------------------------------------------

    def add_block(self, block: Block) -> None:
        with self._lock:
            if block.header.number != self.height:
                raise BlockStoreError(
                    f"expected block {self.height}, got {block.header.number}")
            if self.height > 0 and block.header.previous_hash != self._cur_hash:
                raise BlockStoreError("previous-hash mismatch")
            payload = block.serialize()
            if self.root is None:
                self._mem_blocks.append(payload)
                self._index_block(block, _Loc(-1, len(self._mem_blocks) - 1, 0))
                return
            path = self._seg_path(self._open_segment_no)
            if (os.path.exists(path)
                    and os.path.getsize(path) + len(payload) > self.segment_max):
                self._open_segment_no += 1
                path = self._seg_path(self._open_segment_no)
            offset = os.path.getsize(path) if os.path.exists(path) else 0
            with open(path, "ab") as f:
                f.write(_LEN.pack(len(payload)))
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            self._index_block(
                block, _Loc(self._open_segment_no, offset,
                            _LEN.size + len(payload)))

    def truncate(self, new_height: int) -> None:
        """Drop every block numbered >= new_height (the storage half of
        ledger rollback, blkstorage ResetBlockStore/rollback).  Rewrites
        the retained prefix — an administrative operation, not a hot
        path.  Cannot descend below a snapshot-bootstrap base (those
        blocks were never stored)."""
        with self._lock:
            if new_height < self.base or new_height >= self.height:
                return
            blocks = [self.get_by_number(i)
                      for i in range(self.base, new_height)]
            self._by_number = []
            self._mem_blocks = []
            self._by_hash = {}
            self._by_txid = {}
            self._cur_hash = self._base_cur_hash
            self._prev_hash = self._base_prev_hash
            self._open_segment_no = 0
            if self.root is not None:
                for seg in self._segments():
                    os.unlink(self._seg_path(seg))
            for block in blocks:
                self.add_block(block)

    # -- reads --------------------------------------------------------------

    @property
    def height(self) -> int:
        return self.base + len(self._by_number)

    def chain_info(self) -> ChainInfo:
        with self._lock:
            return ChainInfo(self.height, self._cur_hash, self._prev_hash)

    def _read(self, loc: _Loc) -> Block:
        if loc.segment < 0:
            return Block.deserialize(self._mem_blocks[loc.offset])
        with open(self._seg_path(loc.segment), "rb") as f:
            f.seek(loc.offset)
            raw = f.read(loc.length)
        return Block.deserialize(raw[_LEN.size:])

    def get_by_number(self, number: int) -> Block:
        with self._lock:
            if 0 <= number < self.base:
                raise BlockStoreError(
                    f"block {number} pruned below snapshot base {self.base}")
            if not self.base <= number < self.height:
                raise BlockStoreError(f"no block {number} (height {self.height})")
            return self._read(self._by_number[number - self.base])

    def get_by_hash(self, block_hash: bytes) -> Block:
        with self._lock:
            if block_hash not in self._by_hash:
                raise BlockStoreError("unknown block hash")
            return self.get_by_number(self._by_hash[block_hash])

    def get_by_txid(self, txid: str) -> Block:
        with self._lock:
            if txid not in self._by_txid:
                raise BlockStoreError(f"unknown txid {txid!r}")
            return self.get_by_number(self._by_txid[txid][0])

    def get_tx_validation_code(self, txid: str) -> ValidationCode:
        """blkstorage RetrieveTxValidationCodeByTxID."""
        with self._lock:
            if txid not in self._by_txid:
                raise BlockStoreError(f"unknown txid {txid!r}")
            num, idx = self._by_txid[txid]
            block = self.get_by_number(num)
        flags = TxFlags.from_bytes(block.metadata.items.get(META_TXFLAGS, b""))
        if idx >= len(flags):
            return ValidationCode.NOT_VALIDATED
        return flags.flag(idx)

    def has_txid(self, txid: str) -> bool:
        with self._lock:
            return txid in self._by_txid

    def iter_blocks(self, start: int = 0,
                    end: Optional[int] = None) -> Iterator[Block]:
        """Blocks [start, end) — ledger.ResultsIterator over blocks.
        Starts at the snapshot base when asked for pruned history."""
        n = max(start, self.base)
        while end is None or n < end:
            with self._lock:
                if n >= self.height:
                    return
                loc = self._by_number[n - self.base]
            yield self._read(loc)
            n += 1
