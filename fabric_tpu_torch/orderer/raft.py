"""Raft consensus core: the consenter's signed-entry bytes.

Counterpart of `fabric_tpu/orderer/raft.py`, so far only its
`entry_signed_bytes`, the canonical bytes a consenter signs for one log
entry, which the byzantine monitor needs to re-verify a Raft-entry
equivocation pair (`byzantine/monitor.py` `_verify_entry_equivocation`).
The state machine, its WAL and snapshots come with the port's orderer.
"""

from __future__ import annotations

import struct


def entry_signed_bytes(term: int, index: int, data: bytes,
                       kind: str) -> bytes:
    """Canonical byte string a consenter signs for one entry.  Covers
    (term, index, kind, data) — the full identity of a log slot — so the
    same signer producing two different payloads for one slot yields two
    valid signatures over DIFFERENT canonical bytes: a self-incriminating
    equivocation pair, attributable from the entries alone."""
    return (b"raft-ent\x00" + struct.pack("<QQ", term, index)
            + kind.encode("utf-8") + b"\x00" + data)
