"""K3: ECDSA-P256 batch verification under device-resident keys.

Counterpart of `fabric_tpu/ops/p256_fixed.py` (`_verify_core`,
`verify_words_rows`, `verify_words_fixed`) and of
`fabric_tpu/ops/ecp256.py:comb_accumulate_rows`.  For a key whose comb
table is resident in the device bank (`ops/device_bank.py`), u2*Q is a
second 8-bit fixed-base comb over that table instead of KP2's ladder:
no table of Q, no 256 doublings, no curve check (the key passed it once,
when its table was built).

`verify_words_rows(r, s, e, slot, bank)` takes (8, B) uint32 big-endian
words, a (B,) int32 bank slot per signature and the (K, 8192, 16)
uint32 bank, and returns (B,) bool.  Semantics, shared by the kernel KP3
(`csrc/p256_verify_rows.cu`) and its plain PyTorch version
`verify_words_rows_plain` here, are `p256.verify_core_plain`'s: r and s
in [1, n) (low-S when asked), u1 = e / s and u2 = r / s mod n, u1*G and
u2*Q_slot by combs (digits LSB-first, digit 0 adds nothing), the
complete combine and the projective x check admitting r and r + n.

The reference packs signatures into an (R, C) grid whose rows share a
key, for its one-hot matmul lookup and a bounded set of XLA programs;
the port takes a flat batch (the provider sorts it key-major) with one
slot per signature.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, p256_tables
from .field import IMADS, words_be_to_limbs, words_le_to_limbs
from .p256 import (_ADD, _MIXED, COMB_ENTRIES, INV_N_BATCH_MULS, _as_words,
                   _check, add_mixed, comb_digits, infinity,
                   verify_core_plain)
from ..device import resolve_device

ROWS = p256_tables.ROWS
ROW_WORDS = p256_tables.ROW_WORDS


# ---------------------------------------------------------------------------
# The plain version of KP3
# ---------------------------------------------------------------------------

def comb_accumulate_rows(bank, slot, u):
    """u * Q_slot per signature, each over its own table of the
    (K, 8192, 16) bank (ecp256.comb_accumulate_rows counterpart)."""
    flat = bank.view(torch.int32).reshape(-1, ROW_WORDS)
    base = slot.to(torch.int64) * ROWS
    acc = infinity(u)
    for j, d in enumerate(comb_digits(u)):
        rows = flat[base + j * COMB_ENTRIES + d].to(torch.int64) & 0xFFFFFFFF
        acc = add_mixed(acc, words_le_to_limbs(rows[:, :8]),
                        words_le_to_limbs(rows[:, 8:]), d == 0)
    return acc


def verify_words_rows_plain(r, s, e, slot, bank, table,
                            require_low_s: bool = True) -> torch.Tensor:
    """Plain PyTorch version of KP3: (8, B) uint32 big-endian words, a
    (B,) int32 slot tensor, the (K, 8192, 16) uint32 bank and G's
    (8192, 16) table, all on one device -> (B,) bool."""
    R, S, E = (words_be_to_limbs(v) for v in (r, s, e))
    slot = slot.to(r.device)
    return verify_core_plain(R, S, E, table,
                             lambda u2: comb_accumulate_rows(bank, slot, u2),
                             require_low_s)


# ---------------------------------------------------------------------------
# KP3 wrapper and entry point
# ---------------------------------------------------------------------------

def p256_verify_rows(r, s, e, slot, bank, table,
                     require_low_s: bool = True) -> torch.Tensor:
    """KP3 wrapper.  r, s, e, bank and table lie on one device; slot is a
    (B,) int32 tensor on the CPU, checked to lie in [0, K) here and then
    copied to the device.  CUDA tensors launch the kernel on the current
    stream (one thread per signature, no synchronisation); CPU tensors
    take `verify_words_rows_plain`.  Raises on anything the kernel does
    not take and when the launch fails."""
    if r.dim() != 2 or r.shape[0] != 8:
        raise ValueError("inputs must have shape (8, B)")
    dev = r.device
    n = r.shape[1]
    for name, x in (("r", r), ("s", s), ("e", e)):
        _check(name, x, r.shape, dev)
    if bank.dim() != 3:
        raise ValueError("bank must have shape (K, 8192, 16)")
    _check("bank", bank, (bank.shape[0], ROWS, ROW_WORDS), dev)
    _check("table", table, (ROWS, ROW_WORDS), dev)
    if slot.dtype != torch.int32:
        raise TypeError(f"slot must be int32, got {slot.dtype}")
    if tuple(slot.shape) != (n,) or not slot.is_contiguous():
        raise ValueError(f"slot must be a contiguous ({n},) tensor")
    if slot.device.type != "cpu":
        raise ValueError("slot must lie on the CPU (its range is checked "
                         "there before the upload)")
    if n and (int(slot.min()) < 0 or int(slot.max()) >= bank.shape[0]):
        raise ValueError(f"slot out of range [0, {bank.shape[0]})")
    if dev.type == "cpu":
        return verify_words_rows_plain(r, s, e, slot, bank, table,
                                       require_low_s)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n >= 1 << 31:
        raise ValueError("batch too large for one launch")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    lib = _build.load("p256_verify_rows")
    slot_d = slot.pin_memory().to(dev, non_blocking=True)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [ctypes.c_void_p(t.data_ptr())
                for t in (r, s, e, slot_d, bank, table, out)]
        rc = lib.p256_verify_rows_launch(*ptrs, ctypes.c_int(n),
                                         ctypes.c_int(bool(require_low_s)),
                                         ctypes.c_void_p(stream))
    if rc:
        raise RuntimeError(f"p256_verify_rows launch failed: CUDA error {rc}")
    p256_verify_rows.launches += 1
    return out


p256_verify_rows.launches = 0


def verify_words_rows(r, s, e, slot, bank, require_low_s: bool = True,
                      device=None) -> torch.Tensor:
    """Batched verify over (8, B) uint32 big-endian words (numpy arrays
    or tensors) under the keys of a (K, 8192, 16) uint32 table bank,
    slot[i] naming signature i's key, on `device` (default: CUDA; raises
    without it)."""
    dev = resolve_device(device)
    args = [_as_words(v, dev) for v in (r, s, e)]
    if isinstance(slot, torch.Tensor):
        slot = slot.to("cpu", torch.int32).contiguous()
    else:
        slot = torch.from_numpy(np.ascontiguousarray(slot, np.int32))
    bank = bank if isinstance(bank, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(bank, np.uint32))
    return p256_verify_rows(*args, slot, bank.to(dev).contiguous(),
                            p256_tables.g_table(dev),
                            require_low_s=require_low_s)


# ---------------------------------------------------------------------------
# Work count for the kernel's bound
# ---------------------------------------------------------------------------

def field_ops_per_verify_rows(u1: int, u2: int) -> dict:
    """Montgomery multiplies and squares one KP3 signature with these
    scalars needs at least, keyed like `field.IMADS`, counted from
    csrc/p256_verify_rows.cu: the fixed steps, plus the mixed adds the
    nonzero digits of u1 and u2 call for (the first of each comb is a
    copy) and the complete combine when both combs left infinity.  s^-1
    counts as batched, as in `p256.field_ops_per_verify`
    (`p256.INV_N_CHAIN` is added once per launch)."""
    nm = 1 + INV_N_BATCH_MULS + 2             # to_mont s, s^-1, u1 u2
    ns = 0
    c1, c2 = (sum(1 for j in range(32) if (u >> (8 * j)) & 0xFF)
              for u in (u1, u2))
    pts = [_MIXED] * (max(c1 - 1, 0) + max(c2 - 1, 0))
    if c1 and c2:
        pts.append(_ADD)                      # the complete combine
    pm = 4 + sum(m for m, _ in pts)           # the projective x check: 4
    ps = 1 + sum(s for _, s in pts)           # and 1
    return {("p", "mul"): pm, ("p", "sqr"): ps,
            ("n", "mul"): nm, ("n", "sqr"): ns}


def imads_per_verify_rows(u1: int, u2: int) -> int:
    """32-bit multiply-adds that one KP3 signature's field work needs."""
    return sum(IMADS[k] * c
               for k, c in field_ops_per_verify_rows(u1, u2).items())
