"""K5 and K6: batched Ed25519 (RFC 8032) signature verification.

Counterpart of `fabric_tpu/ops/ed25519.py` (`verify_words`,
`verify_words_rows`, `pack_verify_inputs`).  The host hashes: it packs
each (public key, signature, message) into words and computes
k = SHA-512(R || A || M) mod L (`pack_verify_inputs`).  The device checks
the cofactorless equation [S]B == R + [k]A, as [S]B + [k](-A), and
compares the sum with the encoded R by recompression, so R is never
decompressed.  Two lanes, as for P-256:

* generic, kernel KE5 (`csrc/ed25519_verify.cu`, wrapper
  `ed25519_verify`, plain version `verify_words_plain`): S < L; A
  decompressed (verdict False when it does not); [S]B by the signed
  7-bit comb over B's table; [k](-A) by a 4-bit window ladder; the
  complete add; Z^-1; y and the parity of x against R's encoding.  The
  kernel's ladder takes signed digits over 9 entries, and it compares
  the sum with R decompressed (X == x_R Z, Y == y_R Z) in place of Z^-1:
  the same verdicts.
* fixed-key, kernel KE6 (`csrc/ed25519_verify_rows.cu`, wrapper
  `ed25519_verify_rows`, plain version `verify_words_rows_plain`): as
  KE5, except that [k](-A) is a second signed comb, over the table of
  -A in slot slot[i] of the device bank (`ops/device_bank.py`); A passed
  its decompression when its table was built.

Inputs are (8, B) uint32 big-endian words of the integer values (word 0
most significant) and (B,) int32 sign bits; out comes (B,) bool.  The
reference packs the fixed-key lane into an (R, C) grid whose rows share
a key; the port takes a flat batch (the provider sorts it key-major)
with one int32 slot per signature.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import torch

from . import _build, ed25519_tables
from . import edwards as ed
from .field import IMADS, lt_const, words_be_to_limbs
from .p256 import _as_words, _check
from ..device import resolve_device

L = ed.L
ROWS = ed.ROWS
ROW_WORDS = ed.ROW_WORDS


# ---------------------------------------------------------------------------
# The plain versions of KE5 and KE6
# ---------------------------------------------------------------------------

def verify_words_plain(ay, a_sign, ry, r_sign, s, k,
                       table) -> torch.Tensor:
    """Plain PyTorch version of KE5: (8, B) uint32 words, (B,) int32 sign
    bits and B's (2405, 24) uint32 table, all on one device -> (B,)
    bool."""
    AY, RY, S, K = (words_be_to_limbs(v) for v in (ay, ry, s, k))
    a_sign = a_sign.to(torch.int64)
    r_sign = r_sign.to(torch.int64)
    s_ok = lt_const(S, L)
    (ax, ay_m), a_ok = ed.decompress(AY, a_sign)
    lhs = ed.add(ed.comb_accumulate(table, S),
                 ed.windowed_mul(K, ed.neg(ed.from_affine(ax, ay_m))))
    return s_ok & a_ok & ed.compressed_equals(lhs, RY, r_sign,
                                              ed.zinv(lhs[2]))


def verify_words_rows_plain(ry, r_sign, s, k, slot, bank,
                            table) -> torch.Tensor:
    """Plain PyTorch version of KE6: (8, B) uint32 words, (B,) int32 sign
    bits and slots, the (K, 2405, 24) uint32 bank of -A tables and B's
    table, all on one device -> (B,) bool."""
    RY, S, K = (words_be_to_limbs(v) for v in (ry, s, k))
    r_sign = r_sign.to(torch.int64)
    slot = slot.to(ry.device)
    lhs = ed.add(ed.comb_accumulate(table, S),
                 ed.comb_accumulate_rows(bank, slot, K))
    return lt_const(S, L) & ed.compressed_equals(lhs, RY, r_sign,
                                                 ed.zinv(lhs[2]))


# ---------------------------------------------------------------------------
# KE5 and KE6 wrappers and entry points
# ---------------------------------------------------------------------------

def _check_signs(name, x, n, device):
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if tuple(x.shape) != (n,) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({n},) tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")


def _launch(lib_name, fn_name, tensors, n, dev) -> torch.Tensor:
    """Launch a kernel over tensors (+ out) on the current stream; the
    kernels take four threads a signature, so 4 n must fit an int."""
    if 4 * n >= 1 << 31:
        raise ValueError("batch too large for one launch")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    lib = _build.load(lib_name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*tensors, out)]
        rc = getattr(lib, fn_name)(*ptrs, ctypes.c_int(n),
                                   ctypes.c_void_p(stream))
    if rc:
        raise RuntimeError(f"{lib_name} launch failed: CUDA error {rc}")
    return out


def ed25519_verify(ay, a_sign, ry, r_sign, s, k, table) -> torch.Tensor:
    """KE5 wrapper.  CUDA tensors launch the kernel on the current stream
    (four threads a signature, no synchronisation); CPU tensors take
    `verify_words_plain`.  Raises on anything the kernel does not take and
    when the launch fails."""
    if ay.dim() != 2 or ay.shape[0] != 8:
        raise ValueError("inputs must have shape (8, B)")
    dev, n = ay.device, ay.shape[1]
    for name, x in (("ay", ay), ("ry", ry), ("s", s), ("k", k)):
        _check(name, x, ay.shape, dev)
    _check_signs("a_sign", a_sign, n, dev)
    _check_signs("r_sign", r_sign, n, dev)
    _check("table", table, (ROWS, ROW_WORDS), dev)
    if dev.type == "cpu":
        if n == 0:
            return torch.empty(0, dtype=torch.bool)
        return verify_words_plain(ay, a_sign, ry, r_sign, s, k, table)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _launch("ed25519_verify", "ed25519_verify_launch",
                  (ay, a_sign, ry, r_sign, s, k, table), n, dev)
    if n:
        ed25519_verify.launches += 1
    return out


ed25519_verify.launches = 0


def ed25519_verify_rows(ry, r_sign, s, k, slot, bank,
                        table) -> torch.Tensor:
    """KE6 wrapper.  ry, r_sign, s, k, bank and table lie on one device;
    slot is a (B,) int32 tensor on the CPU, checked to lie in [0, K) here
    and then copied to the device.  CUDA tensors launch the kernel on the
    current stream; CPU tensors take `verify_words_rows_plain`.  Raises
    on anything the kernel does not take and when the launch fails."""
    if ry.dim() != 2 or ry.shape[0] != 8:
        raise ValueError("inputs must have shape (8, B)")
    dev, n = ry.device, ry.shape[1]
    for name, x in (("ry", ry), ("s", s), ("k", k)):
        _check(name, x, ry.shape, dev)
    _check_signs("r_sign", r_sign, n, dev)
    if bank.dim() != 3:
        raise ValueError(f"bank must have shape (K, {ROWS}, {ROW_WORDS})")
    _check("bank", bank, (bank.shape[0], ROWS, ROW_WORDS), dev)
    _check("table", table, (ROWS, ROW_WORDS), dev)
    _check_signs("slot", slot, n, torch.device("cpu"))
    if n and (int(slot.min()) < 0 or int(slot.max()) >= bank.shape[0]):
        raise ValueError(f"slot out of range [0, {bank.shape[0]})")
    if dev.type == "cpu":
        if n == 0:
            return torch.empty(0, dtype=torch.bool)
        return verify_words_rows_plain(ry, r_sign, s, k, slot, bank, table)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    slot_d = slot.pin_memory().to(dev, non_blocking=True)
    out = _launch("ed25519_verify_rows", "ed25519_verify_rows_launch",
                  (ry, r_sign, s, k, slot_d, bank, table), n, dev)
    if n:
        ed25519_verify_rows.launches += 1
    return out


ed25519_verify_rows.launches = 0


def _as_signs(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x.to(torch.int32)
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.int32)))
    return t.to(device).contiguous()


def verify_words(ay, a_sign, ry, r_sign, s, k, device=None) -> torch.Tensor:
    """Generic-lane batched verify over (8, B) uint32 big-endian words
    and (B,) sign bits (numpy arrays or tensors), as `pack_verify_inputs`
    returns them, on `device` (default: CUDA; raises without it)."""
    dev = resolve_device(device)
    return ed25519_verify(
        _as_words(ay, dev), _as_signs(a_sign, dev), _as_words(ry, dev),
        _as_signs(r_sign, dev), _as_words(s, dev), _as_words(k, dev),
        ed25519_tables.b_table(dev))


def verify_words_rows(ry, r_sign, s, k, slot, bank,
                      device=None) -> torch.Tensor:
    """Fixed-key batched verify under the keys of a (K, 2405, 24) uint32
    bank of -A tables, slot[i] naming signature i's key, on `device`
    (default: CUDA; raises without it)."""
    dev = resolve_device(device)
    slot = _as_signs(slot, "cpu")
    bank = bank if isinstance(bank, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(bank, np.uint32))
    return ed25519_verify_rows(
        _as_words(ry, dev), _as_signs(r_sign, dev), _as_words(s, dev),
        _as_words(k, dev), slot, bank.to(dev).contiguous(),
        ed25519_tables.b_table(dev))


# ---------------------------------------------------------------------------
# Host-side packing: RFC 8032 wire format -> kernel inputs
# ---------------------------------------------------------------------------

def pack_verify_inputs(pubkeys: list, sigs: list, msgs: list):
    """(32-byte public key, 64-byte signature, message) triples ->
    (ay, a_sign, ry, r_sign, s, k): (8, B) uint32 big-endian words of A's
    and R's y (top bit cleared), of S and of k = SHA-512(R || A || M)
    mod L, and (B,) int32 sign bits.  A wrong length raises ValueError
    (the provider screens lengths first)."""
    B = len(pubkeys)
    if B == 0:
        z = np.zeros((8, 0), dtype=np.uint32)
        zb = np.zeros((0,), dtype=np.int32)
        return z, zb, z.copy(), zb.copy(), z.copy(), z.copy()
    for pk, sig in zip(pubkeys, sigs):
        if len(pk) != 32 or len(sig) != 64:
            raise ValueError("ed25519: bad pubkey/signature length")
    pkw = np.frombuffer(b"".join(pubkeys), "<u4").reshape(B, 8)
    sgw = np.frombuffer(b"".join(sigs), "<u4").reshape(B, 16)
    rw, sw_le = sgw[:, :8], sgw[:, 8:]
    a_sign = (pkw[:, 7] >> 31).astype(np.int32)
    r_sign = (rw[:, 7] >> 31).astype(np.int32)

    def be_words(lew, mask_top=False):
        w = np.ascontiguousarray(lew[:, ::-1].T).astype(np.uint32)
        if mask_top:
            w[0] &= 0x7FFFFFFF
        return w

    sha512 = hashlib.sha512
    kb = bytearray()
    for pk, sig, msg in zip(pubkeys, sigs, msgs):
        k = int.from_bytes(sha512(sig[:32] + pk + msg).digest(),
                           "little") % L
        kb += k.to_bytes(32, "big")
    kw = np.ascontiguousarray(
        np.frombuffer(bytes(kb), ">u4").reshape(B, 8).T).astype(np.uint32)
    return (be_words(pkw, True), a_sign, be_words(rw, True), r_sign,
            be_words(sw_le), kw)


# ---------------------------------------------------------------------------
# Work count for the kernels' bounds
# ---------------------------------------------------------------------------

# (multiplies, squares) mod p25519 of each point operation in
# csrc/edwards_point.cuh
_ADD = (9, 0)
_DBL = (4, 4)
_NIELS = (7, 0)
_POW22523 = ed.chain_ops(ed.pow22523_chain)
INV_CHAIN = ed.chain_ops(ed.inv_chain)

# Z^-1 over a batch, at least: Montgomery's trick costs 3 multiplies per
# signature and one Fermat chain per launch (`INV_CHAIN`).  KE6 inverts
# once per block of 32 signatures, by the binary extended Euclid; KE5
# inverts nothing (it decompresses R beside A and compares
# projectively), which the least work does not count on.
INV_BATCH_MULS = 3


# The kernels' dependent chains, in multiply latencies: four lanes a
# signature run a point operation as two steps of one multiply a lane
# (csrc/edwards_point.cuh).  KE5's lanes decompress A (lanes 0, 2, 3) and
# R (lane 1) side by side and compare the sum with R projectively; KE6
# inverts Z over its block of 32 signatures (4 warps) by Montgomery's
# trick, the block's product by one thread's binary extended Euclid
# (~750 dependent ALU steps of 8 words, no multiplies, not counted here).
# The ladder's table holds 0Q ... 8Q in cached form.
LADDER_ENTRIES = 9
BLOCK_WARPS = 4


def chain_muls(kernel: str) -> int:
    """Dependent multiply latencies of one signature of `kernel`
    ("ed25519_verify", KE5, or "ed25519_verify_rows", KE6), as the kernel
    runs it: the floor of a launch whose chains overlap fully."""
    comb = 2 * ed.COMB_WINDOWS                # one niels add a window
    if kernel == "ed25519_verify_rows":
        # the warp's prefix and suffix products (3 steps each), one
        # thread's products over the warps, the Euclid's result to
        # Montgomery form, the quad's 4 multiplies; then (X, Y) Z^-1 and
        # from_mont
        block_inv = 2 * 3 + 2 * BLOCK_WARPS + 1 + 4
        return 2 * comb + block_inv + 2
    if kernel != "ed25519_verify":
        raise ValueError(f"unknown kernel {kernel!r}")
    # to_mont y, y^2, d y^2, v^2, v^3, v^6, v^7, u v^7; the power; u v^3,
    # x, x^2, v x^2, the sqrt(-1) fix, from_mont x; then T = x y of -A
    decompress = 8 + sum(_POW22523.values()) + 6 + 1
    table = 1 + 3 * (LADDER_ENTRIES - 2)      # Q cached; 2Q ... 8Q, cached
    ladder = 2 * ed.LADDER_WINDOWS + 2 * ed.LADDER_W * (
        ed.LADDER_WINDOWS - 1)
    return decompress + table + ladder + comb + 1     # x_R Z, y_R Z


def imads_per_launch() -> int:
    """32-bit multiply-adds of the one inversion chain a launch's batched
    Z^-1 needs, on top of the per-signature counts."""
    return sum(IMADS["p25519", k] * c for k, c in INV_CHAIN.items())


def _comb_pts(u: int) -> list:
    """The niels adds of a signed comb over u: one per nonzero digit."""
    pts, carry = [], 0
    for j in range(ed.COMB_WINDOWS):
        v = ((u >> (ed.COMB_W * j)) & 0x7F) + carry
        carry = int(v >= 64)
        if v - 128 * carry:
            pts.append(_NIELS)
    return pts


def _count(pts, mul, sqr) -> dict:
    return {("p25519", "mul"): mul + sum(m for m, _ in pts),
            ("p25519", "sqr"): sqr + sum(s for _, s in pts)}


# the recompression compare: X Z^-1 and Y Z^-1, both out of Montgomery
_COMPARE_MULS = 4


def decompress_ops(root_neg: bool = False) -> dict:
    """Montgomery multiplies and squares of KE5's decompression of A (its
    x * sqrt(-1) fix only when root_neg): all the field work a lane whose
    A does not decompress needs before its verdict is known."""
    # to_mont y, d y^2, v^3, v^7, u v^7, u v^3, x pw, v x^2, from_mont x
    return _count([], 9 + int(root_neg) + _POW22523["mul"],
                  4 + _POW22523["sqr"])       # y^2, v^2, v3^2, x^2


def field_ops_per_verify(s: int, k: int, root_neg: bool = False) -> dict:
    """Montgomery multiplies and squares one KE5 signature with these
    scalars needs at least, keyed like `field.IMADS`, counted from
    csrc/ed25519_verify.cu: the decompression of A (its x * sqrt(-1) fix
    only when root_neg), Q's ladder table, the comb adds the nonzero
    digits of s call for, the ladder's doublings from its first nonzero
    digit on and its adds of nonzero digits, the combine and the
    compare.  Z^-1 counts as batched (`INV_CHAIN` is added once per
    launch)."""
    dec = decompress_ops(root_neg)
    mul = dec["p25519", "mul"] + 1            # and T of -A
    sqr = dec["p25519", "sqr"]
    pts = [_DBL] + [_ADD] * 13                # Q's table
    pts += _comb_pts(s)
    started = False
    for w in range(ed.LADDER_WINDOWS - 1, -1, -1):
        if started:
            pts += [_DBL] * ed.LADDER_W
        if (k >> (4 * w)) & 0xF:
            if started:
                pts.append(_ADD)
            started = True
    pts.append(_ADD)                          # the complete combine
    return _count(pts, mul + INV_BATCH_MULS + _COMPARE_MULS, sqr)


def field_ops_per_verify_rows(s: int, k: int) -> dict:
    """As `field_ops_per_verify`, for one KE6 signature: two signed combs,
    the combine, batched Z^-1 and the compare."""
    pts = _comb_pts(s) + _comb_pts(k) + [_ADD]
    return _count(pts, INV_BATCH_MULS + _COMPARE_MULS, 0)


def imads_per_verify(s: int, k: int, root_neg: bool = False) -> int:
    """32-bit multiply-adds that one KE5 signature's field work needs."""
    return sum(IMADS[key] * c
               for key, c in field_ops_per_verify(s, k, root_neg).items())


def imads_per_verify_rows(s: int, k: int) -> int:
    """32-bit multiply-adds that one KE6 signature's field work needs."""
    return sum(IMADS[key] * c
               for key, c in field_ops_per_verify_rows(s, k).items())
