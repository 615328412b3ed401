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

`block_validate_sharded(lanes, blk_num, mesh)` is the multi-device
branch (the reference's `shard_map` of `local` over a device list,
`fabric_tpu/committer/device_validate.py:499-511`) over a
`parallel.mesh.DeviceMesh`: the sig lanes and the read lanes are split
into the shards' contiguous ranges (`shard_bounds`, no padding), each
shard folds its ranges on its own device and stream
(`block_validate_fold_kernel`: a full-length partial entry mask and its
reads' codes), and the first shard's device sums the partial masks,
gates and walks the gathered codes (`block_validate_finish_kernel`).
Where the reference sums each walk step's read failures across shards
with `psum`, the one walk sees every read lane of a tx in the gathered
codes.  `block_validate_fold_plain` and `block_validate_finish_plain`
are their plain versions; the finish walks the reduced read codes as the
kernel does.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from . import _build
from ..device import resolve_device
from ..parallel.mesh import _on_shard, shard_bounds

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

def _long(lanes, names, lo: int = 0, hi: int = None) -> dict:
    """Lanes [lo, hi) of each of `names` as int64 tensors."""
    return {n: torch.from_numpy(np.ascontiguousarray(lanes[n][lo:hi])).long()
            for n in names}


def _gate(t: dict, m: torch.Tensor) -> tuple:
    """The gate fold from each entry's mask `m` -> (gate codes, code0)
    as long tensors."""
    T, E = t["pre"].shape[0], t["ent_tx"].shape[0]
    verdict = t["verdict"]
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
    return gate_codes, code0


def block_validate_plain(lanes, blk_num: int):
    """`local` in PyTorch ops on the CPU: -> (gate, final) uint8 tensors."""
    t = _long(lanes, FIELDS)
    T, E = t["pre"].shape[0], t["ent_tx"].shape[0]
    # -- the gate fold ------------------------------------------------------
    contrib = t["verdict"][t["sig_item"]] << t["sig_bit"]
    m = torch.zeros(E, dtype=torch.long).index_add_(0, t["sig_ent"],
                                                     contrib)
    gate_codes, code0 = _gate(t, m)
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


def _ranges(d: dict, s_range, r_range) -> tuple:
    (s_lo, s_hi), (r_lo, r_hi) = map(tuple, (s_range, r_range))
    if not (0 <= s_lo <= s_hi <= d["S"] and 0 <= r_lo <= r_hi <= d["R"]):
        raise ValueError(f"lane ranges {s_range}, {r_range} out of the "
                         f"block's {d['S']} sig and {d['R']} read lanes")
    return s_lo, s_hi, r_lo, r_hi


def block_validate_fold_plain(lanes, blk_num: int, s_range, r_range):
    """One shard's fold (`kv7_fold_range_kernel`) in PyTorch ops on the
    CPU: sig lanes [s_lo, s_hi) folded into a full-length partial entry
    mask, read lanes [r_lo, r_hi) reduced to their int32 codes (the state
    word an in-block writer must hold for the read to pass << 2, whether
    it has a version << 1, its verdict against the committed version),
    with the block's T and blk_num -> (mask (E,), rcode (r_hi - r_lo,))
    int32 tensors."""
    d = dims(lanes)
    s_lo, s_hi, r_lo, r_hi = _ranges(d, s_range, r_range)
    sig = _long(lanes, _GROUPS["S"], s_lo, s_hi)
    rd = _long(lanes, _GROUPS["R"], r_lo, r_hi)
    t = _long(lanes, ("verdict", *_GROUPS["K"]))
    mask = torch.zeros(d["E"], dtype=torch.long).index_add_(
        0, sig["sig_ent"], t["verdict"][sig["sig_item"]] << sig["sig_bit"])
    slot, has = rd["r_slot"], rd["r_has"] != 0
    blk, txn = rd["r_blk"], rd["r_txn"]
    c_has = t["c_has"][slot] != 0
    cok = torch.where(has, c_has & (t["c_blk"][slot] == blk)
                      & (t["c_txn"][slot] == txn), ~c_has)
    want = torch.where(has & (blk == blk_num) & (txn >= 0) & (txn < d["T"]),
                       (txn + 1) << 1, 0)
    rcode = (want << 2) | (has.long() << 1) | cok.long()
    return mask.to(torch.int32), rcode.to(torch.int32)


def _read_ok(st: int, rc: int) -> bool:
    """A read's reduced code against its slot's state word (0: no write
    in the block yet; else (writer tx + 1) << 1 | deleted)."""
    if st:
        return st == rc >> 2 if rc & 2 else bool(st & 1)
    return bool(rc & 1)


def block_validate_finish_plain(lanes, blk_num: int, partial_masks,
                                rcodes):
    """The finish (`block_validate_finish_launch`) in PyTorch ops on
    the CPU: the entry masks the sum of the k partial masks
    (`partial_masks`, (k, E)), the gate fold, then the walk in tx order
    over the gathered read codes (`rcodes`, (R,), as
    `block_validate_fold_plain` makes them), the last-writer state of a
    slot one word, (tx + 1) << 1 | deleted -> (gate, final) uint8
    tensors.  The walk needs no blk_num: the read codes carry it."""
    d = dims(lanes)
    masks = torch.as_tensor(partial_masks)
    rcodes = torch.as_tensor(rcodes)
    if masks.dim() != 2 or masks.shape[1] != d["E"]:
        raise ValueError(f"partial_masks must be (k, {d['E']}), got "
                         f"{tuple(masks.shape)}")
    if tuple(rcodes.shape) != (d["R"],):
        raise ValueError(f"rcodes must be ({d['R']},), got "
                         f"{tuple(rcodes.shape)}")
    t = _long(lanes, ("pre", "status", "has_plan", "c_idx", "c_live",
                      "ent_tx", "ent_off", "tables", "verdict"))
    gate_codes, code0 = _gate(t, masks.long().sum(0))
    T = d["T"]
    codes = code0.tolist()
    r_off = np.searchsorted(lanes["r_tx"], np.arange(T + 1)).tolist()
    w_off = np.searchsorted(lanes["w_tx"], np.arange(T + 1)).tolist()
    r_slot, rc = lanes["r_slot"].tolist(), rcodes.tolist()
    w_slot, w_del = lanes["w_slot"].tolist(), lanes["w_del"].tolist()
    state = [0] * d["K"]
    for tx in range(T):
        if codes[tx] != 0:
            continue
        if not all(_read_ok(state[r_slot[j]], rc[j])
                   for j in range(r_off[tx], r_off[tx + 1])):
            codes[tx] = 11
            continue
        # in lane order, so a tx's last write to a slot is the one kept
        for j in range(w_off[tx], w_off[tx + 1]):
            state[w_slot[j]] = (tx + 1) << 1 | (w_del[j] != 0)
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


def _check_buf(buf, d: dict, blk_num: int) -> torch.device:
    """Raise unless `buf` is `pack`'s buffer for dims `d` as an int32
    tensor on a CUDA device and blk_num fits in int32; -> its device."""
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"KV7 runs on a CUDA device, got {dev}")
    n = packed_len(d)
    if buf.dtype != torch.int32 or tuple(buf.shape) != (n,) \
            or not buf.is_contiguous():
        raise ValueError(f"buf must be a contiguous ({n},) int32 tensor")
    if not -(1 << 31) <= blk_num < (1 << 31):
        raise ValueError("blk_num must fit in int32")
    return dev


def _check_int32(x, shape: tuple, dev, name: str) -> None:
    if x.dtype != torch.int32 or tuple(x.shape) != shape \
            or not x.is_contiguous() or x.device != dev:
        raise ValueError(f"{name} must be a contiguous {shape} int32 tensor "
                         f"on {dev}")


def _dims_args(d: dict) -> list:
    return [ctypes.c_int(d[k]) for k in
            ("T", "E", "S", "R", "W", "K", "TB", "V")]


def _launcher(buf, d: dict, blk_num: int) -> tuple:
    """Check `buf` (`pack`'s buffer as an int32 tensor on a CUDA device)
    and allocate the output and scratch -> (out, launch): `out` the
    (2T,) uint8 output tensor, gate codes then final codes, and
    launch(fn, *extra) a call of one of the library's C entry points on
    the current stream, `extra` passed before the stream, raising when it
    fails.  The last-writer state lives in shared memory when the slots
    fit (`smem_slots`), else in device memory."""
    dev = _check_buf(buf, d, blk_num)
    T = d["T"]
    out = torch.empty(2 * T, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        smem = T > 0 and d["K"] <= smem_slots()
        scratch = torch.empty(d["E"] + 2 * T + d["R"] + d["W"] + d["K"],
                              dtype=torch.int32, device=dev)

    def launch(fn, *extra):
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(ctypes.c_void_p(buf.data_ptr()), *_dims_args(d),
                    ctypes.c_int(blk_num), ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(scratch.data_ptr()),
                    ctypes.c_int(int(smem)), *extra,
                    ctypes.c_void_p(stream))
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


def block_validate_fold_kernel(buf, d: dict, blk_num: int, s_range,
                               r_range, mask=None, rcode=None) -> tuple:
    """One shard's fold of the multi-device branch: `buf` is `pack`'s
    buffer as an int32 tensor on the shard's CUDA device; launches
    `block_validate_fold_range_launch` on that device's current stream
    (no synchronisation): sig lanes [s_lo, s_hi) into a full-length
    partial entry mask, read lanes [r_lo, r_hi) into their int32 codes,
    into `mask` ((E,)) and `rcode` ((r_hi - r_lo,)), int32 tensors on the
    device (allocated when not given) -> (mask, rcode).  Counts one
    launch a call.  Raises when the launch fails."""
    dev = _check_buf(buf, d, blk_num)
    s_lo, s_hi, r_lo, r_hi = _ranges(d, s_range, r_range)
    if mask is None:
        mask = torch.empty(d["E"], dtype=torch.int32, device=dev)
    if rcode is None:
        rcode = torch.empty(r_hi - r_lo, dtype=torch.int32, device=dev)
    _check_int32(mask, (d["E"],), dev, "mask")
    _check_int32(rcode, (r_hi - r_lo,), dev, "rcode")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.load("block_validate").block_validate_fold_range_launch(
            ctypes.c_void_p(buf.data_ptr()), *_dims_args(d),
            ctypes.c_int(blk_num),
            *[ctypes.c_int(v) for v in (s_lo, s_hi, r_lo, r_hi)],
            ctypes.c_void_p(mask.data_ptr()),
            ctypes.c_void_p(rcode.data_ptr()), ctypes.c_void_p(stream))
    if rc:
        raise RuntimeError(f"block_validate fold launch failed: CUDA error "
                           f"{rc}")
    block_validate_fold_kernel.launches += 1
    return mask, rcode


block_validate_fold_kernel.launches = 0


def block_validate_finish_kernel(buf, d: dict, blk_num: int, masks,
                                 rcode) -> torch.Tensor:
    """The multi-device branch's finish on the first shard's device:
    `buf` is `pack`'s buffer as an int32 tensor there, `masks` the k
    shards' partial entry masks stacked (k, E) and `rcode` the (R,) read
    codes in global lane order, int32 on the same device; launches
    `block_validate_finish_launch` on the current stream (the entry fold
    over the summed masks, the gate, the walk; no synchronisation) and
    returns the (2T,) uint8 output tensor, gate codes then final codes.
    Counts one KV7 launch (`block_validate_kernel.launches`) a call.
    Raises when a launch fails."""
    out, launch = _launcher(buf, d, blk_num)
    dev = buf.device
    if masks.dim() != 2:
        raise ValueError("masks must be (k, E)")
    _check_int32(masks, (masks.shape[0], d["E"]), dev, "masks")
    _check_int32(rcode, (d["R"],), dev, "rcode")
    if d["T"] == 0:
        return out
    launch(_build.load("block_validate").block_validate_finish_launch,
           ctypes.c_void_p(masks.data_ptr()), ctypes.c_int(masks.shape[0]),
           ctypes.c_void_p(rcode.data_ptr()))
    block_validate_kernel.launches += 1
    return out


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


def block_validate_sharded(lanes, blk_num: int, mesh,
                           timings: dict = None) -> tuple:
    """Gate fold + MVCC of one block over the shards of `mesh` (a
    `parallel.mesh.DeviceMesh`, all CUDA or all CPU) -> (gate codes,
    final codes) as uint8 numpy arrays, equal to `block_validate`'s.
    The sig lanes and the read lanes are split into `shard_bounds`'
    ranges; a shard with neither launches nothing.  CUDA: pack, one
    upload a distinct device, each shard's fold on its device and stream
    (each shard stream first waits on its device's current stream), the
    partial masks and read codes gathered on the first shard's device
    once its current stream has waited on every shard's event (a shard on
    that device writes them in place), the finish there, one download;
    `timings`, when given, gets the steps' wall seconds, `shards`, each
    shard's `fold_launches` and `fold_ms` (CUDA events; None where it
    launched nothing) and the `gather_ms` and `finish_ms` on the first
    device.  CPU: the plain fold of each shard in turn, then the plain
    finish."""
    k = len(mesh)
    kinds = {dev.type for dev in mesh.devices}
    if kinds == {"cpu"}:
        d = check(lanes)
        masks, rcodes = [], []
        for s_r, r_r in zip(shard_bounds(d["S"], k), shard_bounds(d["R"], k)):
            if s_r[1] > s_r[0] or r_r[1] > r_r[0]:
                m, rc = block_validate_fold_plain(lanes, blk_num, s_r, r_r)
                masks.append(m)
                rcodes.append(rc)
        gate, final = block_validate_finish_plain(
            lanes, blk_num,
            torch.stack(masks) if masks else torch.zeros(
                (0, d["E"]), dtype=torch.int32),
            torch.cat(rcodes) if rcodes else torch.zeros(
                0, dtype=torch.int32))
        if timings is not None:
            timings["shards"] = k
        return gate.numpy(), final.numpy()
    if kinds != {"cuda"}:
        raise ValueError(f"a KV7 mesh is all CUDA or all CPU, got "
                         f"{mesh.devices}")
    t0 = time.perf_counter()
    buf, d = pack(lanes)
    t1 = time.perf_counter()
    host = torch.from_numpy(buf).pin_memory()
    bufs = {}
    for dev in mesh.distinct_devices:
        with torch.cuda.device(dev):
            bufs[dev] = host.to(dev, non_blocking=True)
    t2 = time.perf_counter()
    dev0 = mesh.devices[0]
    bounds = list(zip(shard_bounds(d["S"], k), shard_bounds(d["R"], k)))
    live = [i for i, (s_r, r_r) in enumerate(bounds)
            if s_r[1] > s_r[0] or r_r[1] > r_r[0]]
    # the stacked partial masks and the gathered read codes, on dev0's
    # current stream
    masks = torch.empty((len(live), d["E"]), dtype=torch.int32, device=dev0)
    rcode = torch.empty(d["R"], dtype=torch.int32, device=dev0)
    for dev, stream in zip(mesh.devices, mesh.streams):
        stream.wait_stream(torch.cuda.current_stream(dev))
    shards = []
    for row, i in enumerate(live):
        dev, stream = mesh.devices[i], mesh.streams[i]
        s_r, (r_lo, r_hi) = bounds[i]
        with _on_shard(dev, stream):
            bufs[dev].record_stream(stream)
            m_out = r_out = None    # elsewhere the fold allocates them
            if dev == dev0:
                masks.record_stream(stream)
                rcode.record_stream(stream)
                m_out, r_out = masks[row], rcode[r_lo:r_hi]
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            m_out, r_out = block_validate_fold_kernel(
                bufs[dev], d, blk_num, s_r, (r_lo, r_hi), m_out, r_out)
            done = torch.cuda.Event(enable_timing=True)
            done.record(stream)
        shards.append((row, i, m_out, r_out, start, done))
    # the gather: dev0's current stream (and, for a shard on another
    # device, that device's current stream, which runs the copy) waits on
    # each shard's event before it reads the shard's output
    cur0 = torch.cuda.current_stream(dev0)
    for _row, _i, m_out, r_out, _start, done in shards:
        for reader in dict.fromkeys((dev0, m_out.device)):
            s = torch.cuda.current_stream(reader)
            s.wait_event(done)
            m_out.record_stream(s)
            r_out.record_stream(s)
    ev_gather = torch.cuda.Event(enable_timing=True)
    ev_gather.record(cur0)
    for row, i, m_out, r_out, _start, _done in shards:
        if m_out.device != dev0:
            r_lo, r_hi = bounds[i][1]
            masks[row].copy_(m_out)
            rcode[r_lo:r_hi].copy_(r_out)
    ev_finish = torch.cuda.Event(enable_timing=True)
    ev_finish.record(cur0)
    out = block_validate_finish_kernel(bufs[dev0], d, blk_num, masks, rcode)
    ev_done = torch.cuda.Event(enable_timing=True)
    ev_done.record(cur0)
    cur0.synchronize()
    t3 = time.perf_counter()
    out = out.cpu().numpy()
    if timings is not None:
        fold_ms = [None] * k
        for _row, i, _m, _r, start, done in shards:
            fold_ms[i] = start.elapsed_time(done)
        timings.update(pack_s=t1 - t0, upload_s=t2 - t1, kv7_s=t3 - t2,
                       download_s=time.perf_counter() - t3, shards=k,
                       fold_launches=[int(i in live) for i in range(k)],
                       fold_ms=fold_ms,
                       gather_ms=ev_gather.elapsed_time(ev_finish),
                       finish_ms=ev_finish.elapsed_time(ev_done))
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


def sharded_bytes_moved(d: dict, mesh) -> int:
    """The bytes the multi-device branch must move over `mesh`: `pack`'s
    buffer for dims `d` once to each distinct device, the partial masks
    and read codes of the shards on devices other than the first copied
    once to it (the gather), and both outputs written once."""
    k, dev0 = len(mesh), mesh.devices[0]
    gather = sum(4 * (d["E"] + r_hi - r_lo) for dev, s_r, (r_lo, r_hi) in
                 zip(mesh.devices, shard_bounds(d["S"], k),
                     shard_bounds(d["R"], k))
                 if dev != dev0 and (s_r[1] > s_r[0] or r_hi > r_lo))
    return (len(mesh.distinct_devices) * 4 * packed_len(d) + gather
            + 2 * d["T"])
