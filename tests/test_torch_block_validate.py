"""K7's plain version (fabric_tpu_torch.ops.block_validate) against the
reference's jitted `local` (fabric_tpu/committer/device_validate.py:433),
bit for bit, on the CPU.

The reference program is taken single-device, as ROADMAP C1 prescribes:
`DeviceValidator(None, devices=[jax.devices()[0]])._program(key)` for
one fixed bucket key, with the inputs padded as `_dispatch` pads them
(pre with 255, status with SKIP, reads with r_tx = -1, writes with
w_tx = -1, live masks 0), so one compile serves every case.  Inputs are
made from numpy seeds: 200 random lane sets, then the directed cases of
`kv7_cases.py`, one for each place where a rewrite of the walk can drift
from `local`."""
import numpy as np
import pytest
import torch

import jax

from fabric_tpu.committer.device_validate import DeviceValidator as RefDV
from fabric_tpu_torch.ops import block_validate as kv7
from kv7_cases import BLK, DIRECTED, OK, SKIP, BAD, lanes

# the one bucket every case is padded to (powers of two, >= 8)
TB_, EB, SB, RB, WB, KB, TABB, VB = 64, 256, 1024, 256, 256, 64, 8192, 512


@pytest.fixture(scope="module")
def ref_program():
    dv = RefDV(None, "ch", devices=[jax.devices()[0]])
    return dv._program((TB_, EB, SB, RB, WB, KB, TABB, VB))


def _pad(a, size, fill):
    out = np.full(size, fill, dtype=np.int32)
    out[:a.shape[0]] = a
    return out


def ref_local(prog, ln, blk_num=BLK):
    """The reference program's (gate, final) on the lanes, padded as
    DeviceValidator._dispatch pads them."""
    T, E, S = len(ln["pre"]), len(ln["ent_tx"]), len(ln["sig_ent"])
    assert T <= TB_ and E <= EB and S <= SB and len(ln["r_tx"]) <= RB
    assert len(ln["w_tx"]) <= WB and len(ln["c_has"]) <= KB
    assert len(ln["tables"]) <= TABB and len(ln["verdict"]) <= VB
    args = (
        _pad(ln["pre"], TB_, 255), _pad(ln["status"], TB_, SKIP),
        _pad(ln["has_plan"], TB_, 0), _pad(ln["c_idx"], TB_, 0),
        _pad(ln["c_live"], TB_, 0),
        _pad(ln["ent_tx"], EB, 0), _pad(ln["ent_off"], EB, 0),
        _pad(np.ones(E, np.int32), EB, 0),
        _pad(ln["sig_ent"], SB, 0), _pad(ln["sig_item"], SB, 0),
        _pad(ln["sig_bit"], SB, 0), _pad(np.ones(S, np.int32), SB, 0),
        _pad(ln["r_tx"], RB, -1), _pad(ln["r_slot"], RB, 0),
        _pad(ln["r_has"], RB, 0), _pad(ln["r_blk"], RB, 0),
        _pad(ln["r_txn"], RB, 0),
        _pad(ln["w_tx"], WB, -1), _pad(ln["w_slot"], WB, 0),
        _pad(ln["w_del"], WB, 0),
        _pad(ln["tables"], TABB, 0), _pad(ln["verdict"], VB, 0),
        _pad(ln["c_has"], KB, 0), _pad(ln["c_blk"], KB, 0),
        _pad(ln["c_txn"], KB, 0), np.int32(blk_num))
    gate, final = prog(*args)
    return np.asarray(gate)[:T], np.asarray(final)[:T]


def port_local(ln, blk_num=BLK):
    gate, final = kv7.block_validate(ln, blk_num, device="cpu")
    return gate, final


def random_lanes(rng):
    """Random lanes as DeviceValidator builds them: plans of up to 3
    entries of up to 4 live sigs, truth tables, committed versions, and
    tx-ordered reads/writes whose versions hit the committed state, an
    in-block writer, or nothing."""
    T = int(rng.integers(1, TB_ + 1))
    K = int(rng.integers(1, KB + 1))
    V = int(rng.integers(0, 40))
    pre = rng.choice([0, 0, 0, 255, 1, 2, 12], size=T)
    status = rng.choice([OK, OK, OK, OK, SKIP, BAD], size=T)
    has_plan = (rng.random(T) < 0.85).astype(np.int32)
    c_live = ((rng.random(T) < 0.9) & (V > 0)).astype(np.int32)
    c_idx = np.where(c_live == 1, rng.integers(0, max(V, 1), T), 0)
    ent_tx, ent_off, sig_ent, sig_item, sig_bit, tables = [], [], [], [], [], []
    for tx in np.flatnonzero(has_plan):
        for _ in range(int(rng.integers(0, 4))):
            k = int(rng.integers(0, 5)) if V else 0
            e = len(ent_tx)
            ent_tx.append(tx)
            ent_off.append(len(tables))
            for b in range(k):
                sig_ent.append(e)
                sig_item.append(int(rng.integers(0, V)))
                sig_bit.append(b)
            tables.extend(rng.integers(0, 2, 1 << k).tolist())
    verdict = rng.integers(0, 2, V)
    c_has = (rng.random(K) < 0.7).astype(np.int32)
    c_blk = rng.integers(0, 4, K)
    c_txn = rng.integers(0, 8, K)
    r_tx, r_slot, r_has, r_blk, r_txn = [], [], [], [], []
    w_tx, w_slot, w_del = [], [], []
    for tx in range(T):
        if status[tx] != OK:
            continue
        for _ in range(int(rng.integers(0, 4))):
            s = int(rng.integers(0, K))
            mode = rng.random()
            r_tx.append(tx)
            r_slot.append(s)
            if mode < 0.4:          # the committed version (maybe none)
                r_has.append(int(c_has[s]))
                r_blk.append(int(c_blk[s]) if c_has[s] else 0)
                r_txn.append(int(c_txn[s]) if c_has[s] else 0)
            elif mode < 0.75:       # an in-block writer
                r_has.append(1)
                r_blk.append(BLK)
                r_txn.append(int(rng.integers(0, max(tx, 1))))
            elif mode < 0.85:       # absent
                r_has.append(0)
                r_blk.append(0)
                r_txn.append(0)
            else:                   # stale or odd
                r_has.append(1)
                r_blk.append(int(rng.integers(-1, 9)))
                r_txn.append(int(rng.integers(-1, 70)))
        for _ in range(int(rng.integers(0, 3))):
            w_tx.append(tx)
            w_slot.append(int(rng.integers(0, K)))
            w_del.append(int(rng.random() < 0.25))
    return lanes(pre=pre, status=status, has_plan=has_plan, c_idx=c_idx,
                 c_live=c_live, ent_tx=ent_tx, ent_off=ent_off,
                 sig_ent=sig_ent, sig_item=sig_item, sig_bit=sig_bit,
                 r_tx=r_tx, r_slot=r_slot, r_has=r_has, r_blk=r_blk,
                 r_txn=r_txn, w_tx=w_tx, w_slot=w_slot, w_del=w_del,
                 tables=tables, verdict=verdict, c_has=c_has, c_blk=c_blk,
                 c_txn=c_txn)


@pytest.mark.parametrize("chunk", range(4))
def test_plain_matches_reference_on_random_lanes(ref_program, chunk):
    """50 seeded lane sets per case, 200 in all: both outputs equal."""
    n_conflicts = 0
    for seed in range(50 * chunk, 50 * (chunk + 1)):
        ln = random_lanes(np.random.default_rng(seed))
        rg, rf = ref_local(ref_program, ln)
        pg, pf = port_local(ln)
        assert pg.dtype == pf.dtype == np.uint8
        assert np.array_equal(pg, rg), seed
        assert np.array_equal(pf, rf), seed
        n_conflicts += int((pf == 11).sum())
    assert n_conflicts > 0       # the corpus reaches the MVCC branch


@pytest.mark.parametrize("case", sorted(DIRECTED))
def test_plain_matches_reference_on_directed_cases(ref_program, case):
    spec, want = DIRECTED[case]
    ln = lanes(**spec)
    rg, rf = ref_local(ref_program, ln)
    pg, pf = port_local(ln)
    assert np.array_equal(pg, rg) and np.array_equal(pf, rf)
    assert pf.tolist() == want


def test_unsorted_lanes_raise():
    spec, _ = DIRECTED["two_writes_one_slot"]
    for name in ("r_tx", "w_tx"):
        bad = dict(spec)
        bad[name] = list(reversed(spec[name]))
        with pytest.raises(ValueError, match="non-decreasing"):
            kv7.block_validate(lanes(**bad), BLK, device="cpu")
        with pytest.raises(ValueError, match="non-decreasing"):
            kv7.pack(lanes(**bad))


def test_pack_layout_and_bounds():
    """The packed buffer has the kernel's length, holds the CSR offsets
    of the reads and writes and only each tx's last write to a slot, its
    bytes are the bound's, and out-of-range lanes raise."""
    spec, _ = DIRECTED["two_writes_one_slot"]
    ln = lanes(**spec)
    buf, d = kv7.pack(ln)
    T = d["T"]
    assert d["W"] == 2          # tx0's delete of s0, tx3's put of s1
    assert buf.dtype == np.int32
    assert buf.shape[0] == kv7.packed_len(d) == (
        7 * T + 2 + 2 * d["E"] + 3 * d["S"] + 4 * d["R"] + 2 * d["W"]
        + 3 * d["K"] + d["TB"] + d["V"])
    assert buf[5 * T:6 * T + 1].tolist() == [0, 0, 1, 2, 2, 3]
    assert buf[6 * T + 1:7 * T + 2].tolist() == [0, 1, 1, 1, 2, 2]
    w = 7 * T + 2 + 2 * d["E"] + 3 * d["S"] + 4 * d["R"]
    assert buf[w:w + 4].tolist() == [0, 1, 1, 0]    # w_slot, then w_del
    assert kv7.bytes_moved(d) == 4 * buf.shape[0] + 2 * T
    bad = dict(spec, r_slot=[0, 0, 2])
    with pytest.raises(ValueError, match="r_slot"):
        kv7.pack(lanes(**bad))
    bad = dict(DIRECTED["no_plan_keeps_pre"][0], tables=[1])
    with pytest.raises(ValueError, match="truth table"):
        kv7.pack(lanes(**bad))


def test_last_writes_keep_the_result(ref_program):
    """pack keeps only each tx's last write to a slot: on lane sets dense
    in same-slot writes, the plain version on the kept writes equals the
    reference on all of them, and no tx keeps two writes to one slot."""
    n_dropped = 0
    for seed in range(1000, 1050):
        rng = np.random.default_rng(seed)
        ln = random_lanes(rng)
        ln["w_slot"] = rng.integers(0, min(len(ln["c_has"]), 2),
                                    len(ln["w_tx"])).astype(np.int32)
        keep = kv7.last_writes(ln)
        kept = dict(ln, **{n: ln[n][keep]
                           for n in ("w_tx", "w_slot", "w_del")})
        n_dropped += len(ln["w_tx"]) - len(keep)
        pairs = list(zip(kept["w_tx"].tolist(), kept["w_slot"].tolist()))
        assert len(set(pairs)) == len(pairs)
        rg, rf = ref_local(ref_program, ln)
        pg, pf = port_local(kept)
        assert np.array_equal(pg, rg) and np.array_equal(pf, rf), seed
    assert n_dropped > 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the KV7 wrapper raises; the plain version runs
    only through block_validate(..., device="cpu")."""
    spec, _ = DIRECTED["r_has_zero"]
    buf, d = kv7.pack(lanes(**spec))
    with pytest.raises(ValueError, match="CUDA"):
        kv7.block_validate_kernel(torch.from_numpy(buf), d, BLK)
