"""Canonical deterministic serialization for framework messages.

Role-equivalent of the reference's protobuf layer + protoutil
(Fabric's protoutil/commonutils.go, txutils.go, blockutils.go): every
on-wire / on-disk structure (identities, transactions, blocks, policies) is
encoded through here, and hashes/signatures are computed over these bytes.

Format ("FTLV"): a tiny canonical TLV scheme —
  None   -> 'N'
  bool   -> 'T'/'F'
  int    -> 'I' + 8-byte signed big-endian (or 'V' + 4-len + magnitude for big)
  bytes  -> 'B' + u32 len + raw
  str    -> 'S' + u32 len + utf-8
  list   -> 'L' + u32 count + items
  dict   -> 'D' + u32 count + sorted (str key, value) pairs
Deterministic by construction (sorted dict keys, fixed-width lengths), so
equal values always produce equal bytes — the property Fabric gets from
deterministic proto marshaling of header bytes.

Decoding is STRICT: exactly the canonical form is accepted — dict keys
must be strictly increasing (which also rejects duplicates), 'V' ints
must be minimal and >= 2^63 (below that the encoder emits 'I'), nesting
is capped at MAX_DEPTH, and trailing bytes are an error.  Strictness
makes decode/encode a bijection on the wire, which the validator's C
pass-1 walker (native/fastcollect.c) depends on: it splices signed byte
spans straight out of the original encoding, and span-splicing equals
re-encoding ONLY when every accepted encoding is canonical.

Counterpart of `fabric_tpu/utils/serde.py`.  The port's codec is the C
extension `native/ftlv.c` (a copy of the reference's); the
reference's pure-Python codec, its no-compiler fallback and differential
oracle, is not copied: the port has no fallback, and a failed build of
the extension raises on import.  The one Python walker kept is the
reference's `decode_views` (the zero-copy decode of the deliver stream,
`comm/rpc.py` `stream_views=True`), whose scalar arms are the
reference's `_dec`.
"""

from __future__ import annotations

import struct
from typing import Any

from fabric_tpu_torch import native as _native_pkg

_U32 = struct.Struct(">I")
_I64 = struct.Struct(">q")

# Uniform nesting cap across every codec implementation (native/ftlv.c
# and native/fastcollect.c's canonical walk, and the reference's Python
# codec).  All MUST agree: a value one implementation accepts and
# another rejects is a validation fork between peers.
MAX_DEPTH = 64

_ftlv = _native_pkg.extension("ftlv")
encode = _ftlv.encode
decode = _ftlv.decode


def decode_views(data) -> Any:
    """Strict decode where 'B' values are READ-ONLY memoryview slices
    into `data` instead of bytes copies.

    Same accept/reject behavior as decode() (the C codec; the tests hold
    the two against each other); only the representation of bytes
    values differs.  Used by the zero-copy
    ingest path (comm/rpc.py stream_views): a deliver frame's
    {"block": <70 KB>} decodes without duplicating the block bytes, and
    the views keep the received frame buffer alive.  Callers must treat
    the result as immutable and not hand views to consumers that expect
    hashable bytes.
    """
    mv = memoryview(data)
    if not mv.readonly:
        mv = mv.toreadonly()
    try:
        v, off = _dec_views(mv, 0)
    except struct.error as e:  # truncated length/int field
        raise ValueError(f"truncated input: {e}") from e
    if off != len(mv):
        raise ValueError("trailing bytes")
    return v


def _dec_views(mv: memoryview, off: int, depth: int = 0):
    # identical to _dec except the 'B' arm, which returns a slice view
    if depth > MAX_DEPTH:
        raise ValueError("nesting too deep")
    tag = _take(mv, off, 1)
    if tag == b"B":
        n = _U32.unpack_from(mv, off + 1)[0]
        off += 5
        if off + n > len(mv):
            raise ValueError(
                f"short buffer: need {n} bytes at {off}, have {len(mv) - off}")
        return mv[off:off + n], off + n
    if tag == b"L":
        n = _U32.unpack_from(mv, off + 1)[0]
        off += 5
        items = []
        for _ in range(n):
            v, off = _dec_views(mv, off, depth + 1)
            items.append(v)
        return items, off
    if tag == b"D":
        n = _U32.unpack_from(mv, off + 1)[0]
        off += 5
        d = {}
        prev = None
        for _ in range(n):
            kn = _U32.unpack_from(mv, off)[0]
            off += 4
            k = _take(mv, off, kn).decode("utf-8")
            off += kn
            if prev is not None and not (k > prev):
                raise ValueError("non-canonical dict key order")
            prev = k
            v, off = _dec_views(mv, off, depth + 1)
            d[k] = v
        return d, off
    return _dec(mv, off, depth)


def _take(mv: memoryview, off: int, n: int) -> bytes:
    if off + n > len(mv):
        raise ValueError(f"short buffer: need {n} bytes at {off}, have {len(mv) - off}")
    return mv[off:off + n].tobytes()


def _dec(mv: memoryview, off: int, depth: int = 0):
    if depth > MAX_DEPTH:
        raise ValueError("nesting too deep")
    tag = _take(mv, off, 1)
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"I":
        return _I64.unpack_from(mv, off)[0], off + 8
    if tag == b"V":
        n = _U32.unpack_from(mv, off)[0]
        off += 4
        mag = _take(mv, off, n)
        # canonical: minimal magnitude, and >= 2^63 (the encoder emits
        # 'I' below that) — a lenient 'V' would give one value two
        # encodings and break splice-equals-reencode (module docstring)
        if n < 8 or mag[0] == 0 or (n == 8 and mag[0] < 0x80):
            raise ValueError("non-canonical V int")
        return int.from_bytes(mag, "big"), off + n
    if tag == b"B":
        n = _U32.unpack_from(mv, off)[0]
        off += 4
        return _take(mv, off, n), off + n
    if tag == b"S":
        n = _U32.unpack_from(mv, off)[0]
        off += 4
        return _take(mv, off, n).decode("utf-8"), off + n
    if tag == b"L":
        n = _U32.unpack_from(mv, off)[0]
        off += 4
        items = []
        for _ in range(n):
            v, off = _dec(mv, off, depth + 1)
            items.append(v)
        return items, off
    if tag == b"D":
        n = _U32.unpack_from(mv, off)[0]
        off += 4
        d = {}
        prev = None
        for _ in range(n):
            kn = _U32.unpack_from(mv, off)[0]
            off += 4
            k = _take(mv, off, kn).decode("utf-8")
            off += kn
            # canonical: strictly increasing keys (also bans duplicates,
            # whose last-wins decode would diverge from span splicing)
            if prev is not None and not (k > prev):
                raise ValueError("non-canonical dict key order")
            prev = k
            v, off = _dec(mv, off, depth + 1)
            d[k] = v
        return d, off
    raise ValueError(f"bad tag {tag!r} at {off - 1}")
