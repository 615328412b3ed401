"""K7: the fused gate fold and in-order MVCC of one block.

Counterpart of `fabric_tpu/committer/device_validate.py`
`DeviceValidator._program` -> `local`, the reference's jitted gate+MVCC
program.  The lanes are the reference's, without its padding and its
`ent_live`/`sig_live` masks, as int32 numpy arrays in a dict keyed by
`FIELDS` (`blk_num` apart):

  per tx      pre (the post-collect code), status (rw-set lane status),
              has_plan, c_idx, c_live
  per entry   ent_tx, ent_off (offset of its truth table in `tables`)
  per sig     sig_ent, sig_item (verdict position), sig_bit
  per read    r_tx, r_slot, r_has, r_blk, r_txn
  per write   w_tx, w_slot, w_del
  per slot    c_has, c_blk, c_txn (the committed version)
  tables, verdict (0/1)

-> (gate codes, final codes), uint8, one per tx.  `local`'s semantics:
the gate fold gives 4 (creator), 10 (an entry's table says no) or 0 for
a tx with a plan, else its pre code, and 22 where the gate passed and
the lane status is BAD; then, in tx order, a tx whose code is 0 gets 11
when a read misses the version it should see (the in-block last writer
of its slot, else the committed one), and only then applies its writes.

`block_validate(lanes, blk_num, device)` is the entry point: on the CPU
it runs `block_validate_plain`, the plain PyTorch version (the fold in
tensor ops, the walk a Python loop over the txs, with the reference's
wseq state); on CUDA it packs the lanes into one int32 buffer (`pack`),
copies it to the card once, launches KV7 (`csrc/block_validate.cu`,
`block_validate_kernel`: the gate fold as three grid-wide launches, then
the walk in one thread block, which decides up to 32 txs a step) and
copies both outputs back at once.  The wrapper requires the read and
write lanes in tx order (`r_tx`, `w_tx` non-decreasing, as
`rwset_lanes` emits them), keeps only each tx's last write to each slot
(`last_writes`: the earlier ones never decide a later read) and passes
per-tx CSR offsets.  `dep_depth` gives a block's dependency depth, the
walk's least number of dependent steps.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from . import _build
from ..device import resolve_device

FIELDS = ("pre", "status", "has_plan", "c_idx", "c_live",
          "ent_tx", "ent_off", "sig_ent", "sig_item", "sig_bit",
          "r_tx", "r_slot", "r_has", "r_blk", "r_txn",
          "w_tx", "w_slot", "w_del", "tables", "verdict",
          "c_has", "c_blk", "c_txn")
_GROUPS = {"T": ("pre", "status", "has_plan", "c_idx", "c_live"),
           "E": ("ent_tx", "ent_off"),
           "S": ("sig_ent", "sig_item", "sig_bit"),
           "R": ("r_tx", "r_slot", "r_has", "r_blk", "r_txn"),
           "W": ("w_tx", "w_slot", "w_del"),
           "K": ("c_has", "c_blk", "c_txn"),
           "TB": ("tables",), "V": ("verdict",)}
STATUS_BAD = 2
MAX_TXS = 1 << 27       # the kernel's read codes hold (tx + 1) << 3


def dims(lanes) -> dict:
    """{"T", "E", "S", "R", "W", "K", "TB", "V"} of a lane dict; raises
    ValueError unless every lane of a group has the group's length."""
    out = {}
    for g, names in _GROUPS.items():
        sizes = {int(lanes[n].shape[0]) for n in names}
        if len(sizes) != 1:
            raise ValueError(f"lanes {names} differ in length: {sizes}")
        out[g] = sizes.pop()
    return out


def check(lanes) -> dict:
    """Validate a lane dict for the kernel (types, index ranges, tx
    order); -> dims.  The kernel reads no index it has not been given."""
    for n in FIELDS:
        a = lanes[n]
        if not isinstance(a, np.ndarray) or a.dtype != np.int32 \
                or a.ndim != 1:
            raise TypeError(f"lane {n} must be a 1-D int32 numpy array")
    d = dims(lanes)
    T, E, K, V = d["T"], d["E"], d["K"], d["V"]
    if T >= MAX_TXS:
        raise ValueError(f"{T} txs exceed one launch ({MAX_TXS})")

    def in_range(name, hi, where=None):
        a = lanes[name] if where is None else lanes[name][where]
        if a.size and (a.min() < 0 or a.max() >= hi):
            raise ValueError(f"lane {name} out of range [0, {hi})")

    for name in ("r_tx", "w_tx", "ent_tx"):
        in_range(name, T)
    for name in ("r_tx", "w_tx"):
        if lanes[name].size and (np.diff(lanes[name]) < 0).any():
            raise ValueError(f"lane {name} must be non-decreasing (the "
                             f"lanes come in tx order)")
    in_range("r_slot", K)
    in_range("w_slot", K)
    in_range("sig_ent", E)
    in_range("sig_item", V)
    in_range("sig_bit", 31)
    in_range("c_idx", V, lanes["c_live"] != 0)
    if lanes["verdict"].size and not np.isin(lanes["verdict"],
                                             (0, 1)).all():
        raise ValueError("verdict must hold 0 or 1")
    # each entry's table covers every mask its sig lanes can form
    width = np.zeros(E, np.int64)
    np.maximum.at(width, lanes["sig_ent"], lanes["sig_bit"] + 1)
    if E and (lanes["ent_off"].min() < 0 or (
            lanes["ent_off"].astype(np.int64) + (1 << width)
            > d["TB"]).any()):
        raise ValueError("an entry's truth table runs past `tables`")
    return d


# ---------------------------------------------------------------------------
# The plain version of KV7
# ---------------------------------------------------------------------------

def block_validate_plain(lanes, blk_num: int):
    """`local` in PyTorch ops on the CPU: -> (gate, final) uint8 tensors."""
    t = {n: torch.from_numpy(np.ascontiguousarray(lanes[n])).long()
         for n in FIELDS}
    T, E = t["pre"].shape[0], t["ent_tx"].shape[0]
    verdict = t["verdict"]
    # -- the gate fold ------------------------------------------------------
    contrib = verdict[t["sig_item"]] << t["sig_bit"]
    m = torch.zeros(E, dtype=torch.long).index_add_(0, t["sig_ent"],
                                                     contrib)
    ent_ok = t["tables"][t["ent_off"] + m] != 0 if E else \
        torch.zeros(0, dtype=torch.bool)
    ent_fail = torch.zeros(T, dtype=torch.long).index_add_(
        0, t["ent_tx"], (~ent_ok).long())
    c_live = t["c_live"] != 0
    cre_ok = torch.zeros(T, dtype=torch.bool)
    if verdict.numel():
        cre_ok = c_live & (verdict[t["c_idx"].clamp(
            0, verdict.numel() - 1)] != 0)
    gate = torch.where(~cre_ok, 4, torch.where(ent_fail > 0, 10, 0))
    gate_codes = torch.where(t["has_plan"] != 0, gate, t["pre"])
    code0 = torch.where((gate_codes == 0) & (t["status"] == STATUS_BAD),
                        22, gate_codes)
    # -- MVCC in tx order, with the reference's wseq state ---------------
    codes = code0.tolist()
    r_off = np.searchsorted(lanes["r_tx"], np.arange(T + 1)).tolist()
    w_off = np.searchsorted(lanes["w_tx"], np.arange(T + 1)).tolist()
    r_slot, r_has = t["r_slot"].tolist(), t["r_has"].tolist()
    r_blk, r_txn = t["r_blk"].tolist(), t["r_txn"].tolist()
    w_tx, w_slot = t["w_tx"].tolist(), t["w_slot"].tolist()
    w_del = t["w_del"].tolist()
    c_has, c_blk = t["c_has"].tolist(), t["c_blk"].tolist()
    c_txn = t["c_txn"].tolist()
    wseq = [0] * len(c_has)   # 1 + the last applied write lane per slot
    for tx in range(T):
        if codes[tx] != 0:
            continue
        ok = True
        for j in range(r_off[tx], r_off[tx + 1]):
            s = r_slot[j]
            seq = wseq[s]
            if seq:
                has, blk, txn = not w_del[seq - 1], blk_num, w_tx[seq - 1]
            else:
                has, blk, txn = c_has[s] != 0, c_blk[s], c_txn[s]
            if r_has[j]:
                ok = has and blk == r_blk[j] and txn == r_txn[j]
            else:
                ok = not has
            if not ok:
                break
        if not ok:
            codes[tx] = 11
            continue
        for j in range(w_off[tx], w_off[tx + 1]):
            wseq[w_slot[j]] = j + 1
    return (gate_codes.to(torch.uint8),
            torch.tensor(codes, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# KV7
# ---------------------------------------------------------------------------

def last_writes(lanes) -> np.ndarray:
    """Indices, in lane order, of each tx's last write lane to each
    slot.  Only that write can decide a later read: the wseq state keeps
    the largest write index per slot, and a tx's writes land together."""
    w_tx, w_slot = lanes["w_tx"], lanes["w_slot"]
    W = w_tx.shape[0]
    key = w_tx.astype(np.int64) * (int(w_slot.max(initial=0)) + 1) + w_slot
    _, first_rev = np.unique(key[::-1], return_index=True)
    return np.sort(W - 1 - first_rev)


def packed_len(d: dict) -> int:
    """The int32 length of `pack`'s buffer for its dims."""
    return (7 * d["T"] + 2 + 2 * d["E"] + 3 * d["S"] + 4 * d["R"]
            + 2 * d["W"] + 3 * d["K"] + d["TB"] + d["V"])


def pack(lanes) -> tuple:
    """The checked lanes as the kernel's one int32 buffer (the order of
    `Lanes` in csrc/block_validate.cu), with the per-tx CSR offsets of
    the reads and writes in place of r_tx and w_tx and only each tx's
    last write to a slot (`last_writes`, so a tx's writes hit distinct
    slots); -> (buffer, dims), dims["W"] counting the writes kept."""
    d = check(lanes)
    keep = last_writes(lanes)
    w = {n: lanes[n][keep] for n in ("w_tx", "w_slot", "w_del")}
    d["W"] = int(keep.shape[0])
    txs = np.arange(d["T"] + 1)
    parts = [lanes[n] for n in ("pre", "status", "has_plan", "c_idx",
                                "c_live")]
    parts += [np.searchsorted(lanes["r_tx"], txs).astype(np.int32),
              np.searchsorted(w["w_tx"], txs).astype(np.int32)]
    parts += [lanes[n] for n in ("ent_tx", "ent_off", "sig_ent",
                                 "sig_item", "sig_bit", "r_slot", "r_has",
                                 "r_blk", "r_txn")]
    parts += [w["w_slot"], w["w_del"]]
    parts += [lanes[n] for n in ("c_has", "c_blk", "c_txn", "tables",
                                 "verdict")]
    return np.concatenate(parts), d


def smem_slots() -> int:
    """The most key slots whose state KV7 keeps in shared memory on the
    current CUDA device."""
    n = _build.load("block_validate").block_validate_smem_slots()
    if n < 0:
        raise RuntimeError("block_validate_smem_slots: device query failed")
    return n


def _launcher(buf, d: dict, blk_num: int) -> tuple:
    """Check `buf` (`pack`'s buffer as an int32 tensor on a CUDA device)
    and allocate the output and scratch -> (out, launch): `out` the
    (2T,) uint8 output tensor, gate codes then final codes, and
    launch(fn) a call of one of the library's C entry points on the
    current stream, raising when it fails.  The last-writer state lives
    in shared memory when the slots fit (`smem_slots`), else in device
    memory."""
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"KV7 runs on a CUDA device, got {dev}")
    n = packed_len(d)
    if buf.dtype != torch.int32 or tuple(buf.shape) != (n,) \
            or not buf.is_contiguous():
        raise ValueError(f"buf must be a contiguous ({n},) int32 tensor")
    if not -(1 << 31) <= blk_num < (1 << 31):
        raise ValueError("blk_num must fit in int32")
    T = d["T"]
    out = torch.empty(2 * T, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        smem = T > 0 and d["K"] <= smem_slots()
        scratch = torch.empty(d["E"] + 2 * T + d["R"] + d["W"] + d["K"],
                              dtype=torch.int32, device=dev)

    def launch(fn):
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(ctypes.c_void_p(buf.data_ptr()),
                    *[ctypes.c_int(d[k]) for k in
                      ("T", "E", "S", "R", "W", "K", "TB", "V")],
                    ctypes.c_int(blk_num), ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(scratch.data_ptr()),
                    ctypes.c_int(int(smem)), ctypes.c_void_p(stream))
        if rc:
            raise RuntimeError(f"block_validate launch failed: CUDA error "
                               f"{rc}")
    return out, launch


def block_validate_parts(buf, d: dict, blk_num: int) -> tuple:
    """KV7's two phases apart, for timing: -> (out, phase1, walk), each
    of `phase1` (the memset and the three grid-wide gate-fold launches)
    and `walk` (the one-block walk, which needs phase 1's scratch) a
    callable that launches its phase on the current stream, without
    synchronisation.  Counts no launch; arguments as
    `block_validate_kernel`."""
    out, launch = _launcher(buf, d, blk_num)
    lib = _build.load("block_validate")
    return (out, lambda: launch(lib.block_validate_phase1_launch),
            lambda: launch(lib.block_validate_walk_launch))


def block_validate_kernel(buf, d: dict, blk_num: int) -> torch.Tensor:
    """KV7 wrapper: `buf` is `pack`'s buffer as an int32 tensor on a CUDA
    device; launches both phases on the current stream in one call (the
    gate fold across the card, then the walk in one block; no
    synchronisation) and returns the (2T,) uint8 output tensor, gate
    codes then final codes.  Counts one launch a call.  Raises when a
    launch fails."""
    out, launch = _launcher(buf, d, blk_num)
    if d["T"] == 0:
        return out
    launch(_build.load("block_validate").block_validate_launch)
    block_validate_kernel.launches += 1
    return out


block_validate_kernel.launches = 0


def upload(buf: np.ndarray, device) -> torch.Tensor:
    """One host-to-device copy of a packed buffer (pinned, then awaited)."""
    out = torch.from_numpy(buf).pin_memory().to(device, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    return out


def block_validate(lanes, blk_num: int, device=None,
                   timings: dict = None) -> tuple:
    """Gate fold + MVCC of one block -> (gate codes, final codes) as uint8
    numpy arrays.  CUDA (the default): pack, one upload, one KV7 launch,
    one download of both outputs, each step's wall seconds put in
    `timings` when given.  CPU: the plain version."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        check(lanes)
        gate, final = block_validate_plain(lanes, blk_num)
        return gate.numpy(), final.numpy()
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    t0 = time.perf_counter()
    buf, d = pack(lanes)
    t1 = time.perf_counter()
    buf_d = upload(buf, dev)
    t2 = time.perf_counter()
    out = block_validate_kernel(buf_d, d, blk_num)
    torch.cuda.current_stream(dev).synchronize()
    t3 = time.perf_counter()
    out = out.cpu().numpy()
    if timings is not None:
        timings.update(pack_s=t1 - t0, upload_s=t2 - t1, kv7_s=t3 - t2,
                       download_s=time.perf_counter() - t3)
    return out[:d["T"]], out[d["T"]:]


def code0(lanes, blk_num: int) -> np.ndarray:
    """Each tx's code before the MVCC walk (its gate code, or 22 for a
    gate-valid tx whose lane status is BAD): the plain version's final
    codes with no reads or writes."""
    bare = dict(lanes, **{n: lanes[n][:0] for n in _GROUPS["R"]
                          + _GROUPS["W"]})
    return block_validate_plain(bare, blk_num)[1].numpy().astype(np.int32)


def dep_depth(lanes, blk_num: int) -> int:
    """The block's dependency depth: the longest chain of txs t1 < t2 <
    ... in which each t(k+1) reads a slot whose last code-0 writer before
    it (whatever that writer's fate) is t(k).  A walk takes at least one
    dependent step per link; a tx whose code is not 0 is in no chain.
    One pass over the txs with a depth per slot, O(T + R + W)."""
    c0 = code0(lanes, blk_num).tolist()
    T = len(c0)
    r_off = np.searchsorted(lanes["r_tx"], np.arange(T + 1)).tolist()
    w_off = np.searchsorted(lanes["w_tx"], np.arange(T + 1)).tolist()
    r_slot, w_slot = lanes["r_slot"].tolist(), lanes["w_slot"].tolist()
    last = {}                  # slot -> depth of its last code-0 writer
    best = 0
    for t in range(T):
        if c0[t]:
            continue
        dt = 1 + max((last.get(r_slot[j], 0)
                      for j in range(r_off[t], r_off[t + 1])), default=0)
        for j in range(w_off[t], w_off[t + 1]):
            last[w_slot[j]] = dt
        best = max(best, dt)
    return best


def bytes_moved(d: dict) -> int:
    """The bytes KV7 must move: the lanes it reads, `pack`'s buffer for
    dims `d`, read once, and both outputs written once."""
    return 4 * packed_len(d) + 2 * d["T"]
