"""KV7's directed lane sets (fabric_tpu_torch/ops/block_validate.py),
shared by the CPU tests against the reference (test_torch_block_validate,
test_torch_kv7_walk) and the card's (test_torch_cuda).  Imports neither
JAX nor fabric_tpu.  DIRECTED maps a name to (lane spec, final codes):
one case for each place where a walk can drift from the reference's
`local`.  `big_lanes`, `kv7_lanes` and `kv7_heavy_lanes` make seeded
lane sets at a block's size (the card's tests and chip_smoke.py's
kv7_mesh part)."""
import numpy as np

from fabric_tpu_torch.ops import block_validate as kv7

BLK = 7
OK, SKIP, BAD = 0, 1, 2


def lanes(**kw):
    """A lane dict from lists (int32 arrays), empty where not given."""
    out = {n: np.asarray(kw.get(n, []), dtype=np.int32) for n in kv7.FIELDS}
    return out


def one_plan(T, verdict=(1,)):
    """Every tx planned, creator at verdict 0 (live), no entries."""
    return dict(pre=[0] * T, status=[OK] * T, has_plan=[1] * T,
                c_idx=[0] * T, c_live=[1] * T, verdict=list(verdict))


DIRECTED = {
    # tx0 deletes s0 (committed); tx1 reads s0 at its committed version
    # (conflict: the in-block delete is what it sees), tx2 reads it
    # absent (ok)
    "read_after_in_block_delete": (dict(
        one_plan(3), r_tx=[1, 2], r_slot=[0, 0], r_has=[1, 0],
        r_blk=[0, 0], r_txn=[3, 0], w_tx=[0], w_slot=[0], w_del=[1],
        c_has=[1], c_blk=[0], c_txn=[3]), [0, 11, 0]),
    # two writes to one slot in tx0: put then delete, so tx1's absent
    # read passes and tx2's versioned read fails; tx3 deletes then puts,
    # so tx4 sees (BLK, 3)
    "two_writes_one_slot": (dict(
        one_plan(5), r_tx=[1, 2, 4], r_slot=[0, 0, 1], r_has=[0, 1, 1],
        r_blk=[0, BLK, BLK], r_txn=[0, 0, 3],
        w_tx=[0, 0, 3, 3], w_slot=[0, 0, 1, 1], w_del=[0, 1, 1, 0],
        c_has=[0, 0], c_blk=[0, 0], c_txn=[0, 0]), [0, 0, 11, 0, 0]),
    # tx0 fails its creator check (verdict 0): its write never lands, so
    # tx1's read of the committed version passes
    "gate_failed_writer": (dict(
        pre=[0, 0], status=[OK, OK], has_plan=[1, 1], c_idx=[0, 1],
        c_live=[1, 1], verdict=[0, 1], r_tx=[1], r_slot=[0], r_has=[1],
        r_blk=[2], r_txn=[5], w_tx=[0], w_slot=[0], w_del=[0],
        c_has=[1], c_blk=[2], c_txn=[5]), [4, 0]),
    # reads without a version: absent committed key passes, present
    # committed key fails
    "r_has_zero": (dict(
        one_plan(2), r_tx=[0, 1], r_slot=[0, 1], r_has=[0, 0],
        r_blk=[0, 0], r_txn=[0, 0], c_has=[0, 1], c_blk=[0, 1],
        c_txn=[0, 1]), [0, 11]),
    # a gate-valid tx whose lane status is BAD gets 22, SKIP stays 0
    "status_bad_and_skip": (dict(
        pre=[0, 0, 0], status=[BAD, SKIP, OK], has_plan=[1, 1, 1],
        c_idx=[0, 0, 0], c_live=[1, 1, 1], verdict=[1]), [22, 0, 0]),
    # no plan: keeps its pre code (and a failing entry on a planned tx
    # gives 10)
    "no_plan_keeps_pre": (dict(
        pre=[12, 255, 0], status=[OK, OK, OK], has_plan=[0, 0, 1],
        c_idx=[0, 0, 0], c_live=[0, 0, 1], verdict=[1, 0],
        ent_tx=[2], ent_off=[0], sig_ent=[0], sig_item=[1], sig_bit=[0],
        tables=[0, 1]), [12, 255, 10]),
}


def slot_chain(T, period=4, stale_tx=2):
    """tx t reads slot t % period at the version of tx t - period (the
    committed version below period) and writes it; tx stale_tx reads a
    wrong version, so every later tx of its slot fails too."""
    spec = dict(one_plan(T), c_has=[1] * period, c_blk=[1] * period,
                c_txn=list(range(period)), r_tx=[], r_slot=[], r_has=[],
                r_blk=[], r_txn=[], w_tx=[], w_slot=[], w_del=[])
    want = []
    for t in range(T):
        s = t % period
        blk, txn = (1, s) if t < period else (BLK, t - period)
        if t == stale_tx:
            txn += 100
        for k, v in zip(("r_tx", "r_slot", "r_has", "r_blk", "r_txn"),
                        (t, s, 1, blk, txn)):
            spec[k].append(v)
        for k, v in zip(("w_tx", "w_slot", "w_del"), (t, s, 0)):
            spec[k].append(v)
        want.append(11 if s == stale_tx % period and t >= stale_tx else 0)
    return spec, want


def hot_slot(T=40):
    """Every tx reads one hot slot at its current version and writes it:
    tx 10 reads a stale version (11), tx 20 deletes it (tx 21 reads it
    absent), tx 30's creator fails (4)."""
    spec = dict(one_plan(T, verdict=(1, 0)), c_has=[1], c_blk=[1],
                c_txn=[0], r_tx=[], r_slot=[], r_has=[], r_blk=[],
                r_txn=[], w_tx=[], w_slot=[], w_del=[])
    spec["c_idx"] = [1 if t == 30 else 0 for t in range(T)]
    cur, want = (1, 1, 0), []
    for t in range(T):
        has, blk, txn = cur
        if t == 10:
            txn += 7
        for k, v in zip(("r_tx", "r_slot", "r_has", "r_blk", "r_txn"),
                        (t, 0, has, blk, txn)):
            spec[k].append(v)
        spec["w_tx"].append(t)
        spec["w_slot"].append(0)
        spec["w_del"].append(int(t == 20))
        code = 11 if t == 10 else 4 if t == 30 else 0
        want.append(code)
        if code == 0:
            cur = (0, 0, 0) if t == 20 else (1, BLK, t)
    return spec, want


def rw(reads=(), writes=()):
    """Reads (tx, slot, has, blk, txn) and writes (tx, slot, del) as lane
    lists, in tx order."""
    reads, writes = sorted(reads), sorted(writes, key=lambda w: w[0])
    out = {k: [r[i] for r in reads] for i, k in
           enumerate(("r_tx", "r_slot", "r_has", "r_blk", "r_txn"))}
    out.update({k: [w[i] for w in writes] for i, k in
                enumerate(("w_tx", "w_slot", "w_del"))})
    return out


def wide_tx_mid_group():
    """tx 5 reads 13 slots and writes 10 (more than a lane holds), valid;
    tx 10 writes 9 slots and fails a read; the others around them see
    tx 5's writes and not tx 10's."""
    reads = [(5, s, 1, 1, s) for s in range(20, 32)] + [(5, 3, 1, BLK, 3)]
    reads += [(6, 20, 1, BLK, 5), (7, 21, 1, 1, 21), (10, 32, 1, 1, 32),
              (11, 33, 1, 1, 33), (12, 0, 1, BLK, 0)]
    writes = [(t, t, 0) for t in range(20) if t not in (5, 10)]
    writes += [(3, 32, 0)] + [(5, s, 0) for s in range(20, 30)]
    writes += [(10, s, 0) for s in (*range(33, 40), 0, 1)]
    K = 40
    spec = dict(one_plan(20), c_has=[1] * K, c_blk=[1] * K,
                c_txn=list(range(K)), **rw(reads, writes))
    return spec, [11 if t in (7, 10) else 0 for t in range(20)]


DIRECTED.update({
    # tx0 puts s0; tx1 and tx2 read the last put and put again; tx3 reads
    # tx2's, tx4 tx1's (stale: 11); tx5 puts blindly, tx6 reads it, tx7
    # puts then deletes it
    "ww_chain_in_group": (dict(one_plan(8), c_has=[0], c_blk=[0],
                               c_txn=[0], **rw(
        [(1, 0, 1, BLK, 0), (2, 0, 1, BLK, 1), (3, 0, 1, BLK, 2),
         (4, 0, 1, BLK, 1), (6, 0, 1, BLK, 5)],
        [(0, 0, 0), (1, 0, 0), (2, 0, 0), (5, 0, 0), (7, 0, 0),
         (7, 0, 1)])), [0, 0, 0, 0, 11, 0, 0, 0]),
    # tx0 reads committed s0 and deletes it: tx1's absent read passes,
    # tx2's committed read fails; tx3 puts it back, tx4 reads tx3's
    "delete_then_read_in_group": (dict(one_plan(5), c_has=[1], c_blk=[2],
                                       c_txn=[5], **rw(
        [(0, 0, 1, 2, 5), (1, 0, 0, 0, 0), (2, 0, 1, 2, 5),
         (4, 0, 1, BLK, 3)],
        [(0, 0, 1), (3, 0, 0)])), [0, 0, 11, 0, 0]),
    # tx31 puts s0 and tx0 puts s1: tx32 and tx35, in the next group,
    # read them; tx30 reads s0 committed (before tx31: 0), tx33 after
    # (11)
    "dependence_across_group_boundary": (dict(one_plan(40), c_has=[1, 0],
                                              c_blk=[1, 0], c_txn=[0, 0],
                                              **rw(
        [(30, 0, 1, 1, 0), (32, 0, 1, BLK, 31), (33, 0, 1, 1, 0),
         (35, 1, 1, BLK, 0)],
        [(0, 1, 0), (31, 0, 0)])), [11 if t == 33 else 0
                                    for t in range(40)]),
    # tx0's creator fails and tx5's policy entry fails: their writes of
    # s0 never land; tx3 passes its gate, fails MVCC, and its write of
    # s0 does not land either, so tx4, which tx3's write would make
    # depend on it, reads s0 committed and passes
    "gate_failed_writer_in_group": (dict(
        pre=[0] * 6, status=[OK] * 6, has_plan=[1] * 6,
        c_idx=[1, 0, 0, 0, 0, 0], c_live=[1] * 6, verdict=[1, 0],
        ent_tx=[5], ent_off=[0], sig_ent=[0], sig_item=[1], sig_bit=[0],
        tables=[0, 1], c_has=[1, 1], c_blk=[2, 2], c_txn=[5, 6], **rw(
            [(1, 0, 1, 2, 5), (2, 0, 1, BLK, 0), (3, 1, 1, 2, 9),
             (4, 0, 1, 2, 5)],
            [(0, 0, 0), (3, 0, 0), (5, 0, 0)])), [4, 0, 11, 11, 0, 10]),
    "wide_tx_mid_group": wide_tx_mid_group(),
    "t1": slot_chain(1),
    "t31": slot_chain(31),
    "t33": slot_chain(33),
    "hot_slot": hot_slot(),
})


def big_lanes(rng, T, K, slots, wide_every=0):
    """Transfer-like lanes at block scale: tx t reads two slots, each at
    the version its last writer in the block (whatever that writer's
    fate) or the commit left, 1 in 5 at a stale one, and writes both, 1
    in 20 a delete; every wide_every-th tx reads and writes 12.  `slots`
    is the pool the slots come from."""
    spec = dict(pre=[0] * T, status=[0] * T, has_plan=[1] * T,
                c_idx=[0] * T, c_live=[1] * T, verdict=[1],
                c_has=[1] * K, c_blk=[1] * K, c_txn=list(range(K)))
    reads, writes, cur = [], [], {}
    for t in range(T):
        k = 12 if wide_every and t % wide_every == wide_every - 1 else 2
        for s in rng.choice(slots, k, replace=False).tolist():
            has, blk, txn = cur.get(s, (1, 1, s))
            if rng.random() < 0.2:
                txn += 1
            reads.append((t, s, has, blk, txn))
            gone = int(rng.random() < 0.05)
            writes.append((t, s, gone))
            cur[s] = (0, 0, 0) if gone else (1, BLK, t)
    spec.update(rw(reads, writes))
    return lanes(**spec)


def kv7_lanes(rng, T, K, blk_num=3):
    """Seeded lanes in tx order: plans of up to 2 entries of up to 3
    sigs, committed versions, reads that hit the committed version, an
    in-block writer, nothing, or a stale version; writes with deletes."""
    V = 64
    ln = {n: [] for n in kv7.FIELDS}
    ln["pre"] = rng.choice([0, 0, 0, 255, 12], size=T).tolist()
    ln["status"] = rng.choice([0, 0, 0, 0, 1, 2], size=T).tolist()
    ln["has_plan"] = (rng.random(T) < 0.9).astype(int).tolist()
    ln["c_live"] = (rng.random(T) < 0.95).astype(int).tolist()
    ln["c_idx"] = [int(rng.integers(0, V)) if c else 0
                   for c in ln["c_live"]]
    ln["verdict"] = (rng.random(V) < 0.9).astype(int).tolist()
    for tx in range(T):
        if not ln["has_plan"][tx]:
            continue
        for _ in range(int(rng.integers(0, 3))):
            k = int(rng.integers(0, 4))
            e = len(ln["ent_tx"])
            ln["ent_tx"].append(tx)
            ln["ent_off"].append(len(ln["tables"]))
            for b in range(k):
                ln["sig_ent"].append(e)
                ln["sig_item"].append(int(rng.integers(0, V)))
                ln["sig_bit"].append(b)
            ln["tables"] += (rng.random(1 << k) < 0.8).astype(int).tolist()
    ln["c_has"] = (rng.random(K) < 0.8).astype(int).tolist()
    ln["c_blk"] = rng.integers(0, 3, K).tolist()
    ln["c_txn"] = rng.integers(0, 50, K).tolist()
    for tx in range(T):
        if ln["status"][tx] != 0:
            continue
        for _ in range(int(rng.integers(0, 4))):
            s = int(rng.integers(0, K))
            mode = rng.random()
            ln["r_tx"].append(tx)
            ln["r_slot"].append(s)
            if mode < 0.5:
                has = ln["c_has"][s]
                ver = (ln["c_blk"][s], ln["c_txn"][s]) if has else (0, 0)
            elif mode < 0.8:
                has, ver = 1, (blk_num, int(rng.integers(0, max(tx, 1))))
            elif mode < 0.9:
                has, ver = 0, (0, 0)
            else:
                has, ver = 1, (int(rng.integers(0, 5)), -1)
            ln["r_has"].append(has)
            ln["r_blk"].append(ver[0])
            ln["r_txn"].append(ver[1])
        for _ in range(int(rng.integers(0, 3))):
            ln["w_tx"].append(tx)
            ln["w_slot"].append(int(rng.integers(0, K)))
            ln["w_del"].append(int(rng.random() < 0.2))
    return {n: np.asarray(v, dtype=np.int32) for n, v in ln.items()}


def kv7_heavy_lanes(rng, T, K, blk_num=3):
    """`kv7_lanes` behind three heavy txs that push the first window past
    the kernel's staged read and write lanes (2,048 each): tx 0 reads
    3,000 slots at their committed versions, tx 1 writes 5,000 times to
    2,500 slots (about 2,160 distinct ones, most of them several times,
    some deleting), and tx 2 reads each of those 2,500 slots expecting
    tx 1's last write to it, if any."""
    ln = {n: v.tolist() for n, v in kv7_lanes(rng, T, K, blk_num).items()}
    for n in ("ent_tx", "r_tx", "w_tx"):
        ln[n] = [t + 3 for t in ln[n]]
    for n, v in (("pre", 0), ("status", 0), ("has_plan", 0),
                 ("c_idx", 0), ("c_live", 1)):
        ln[n] = [v] * 3 + ln[n]
    reads = []
    for s in rng.choice(K, 3_000, replace=False).tolist():
        has = ln["c_has"][s]
        reads.append((0, s, has, ln["c_blk"][s] if has else 0,
                      ln["c_txn"][s] if has else 0))
    w_slot = rng.integers(0, 2_500, 5_000).tolist()
    w_del = (rng.random(5_000) < 0.3).astype(int).tolist()
    last = dict(zip(w_slot, w_del))
    for s in range(2_500):
        if s not in last:
            has = ln["c_has"][s]
            reads.append((2, s, has, ln["c_blk"][s] if has else 0,
                          ln["c_txn"][s] if has else 0))
        else:
            gone = last[s]
            reads.append((2, s, 0 if gone else 1, 0 if gone else blk_num,
                          0 if gone else 1))
    for i, n in enumerate(("r_tx", "r_slot", "r_has", "r_blk", "r_txn")):
        ln[n] = [r[i] for r in reads] + ln[n]
    ln["w_tx"] = [1] * 5_000 + ln["w_tx"]
    ln["w_slot"] = w_slot + ln["w_slot"]
    ln["w_del"] = w_del + ln["w_del"]
    return {n: np.asarray(v, dtype=np.int32) for n, v in ln.items()}
