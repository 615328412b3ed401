"""A CPU model of KV7 (fabric_tpu_torch/ops/csrc/block_validate.cu),
step for step as the card runs it, against the plain version
(`block_validate_plain`) and the reference's jitted `local`, exactly
(the outputs are integer codes: no tolerance).

The model reads `pack`'s buffer as the kernel does and runs phase 1 (the
gate fold) and the walk: windows of WIN_T txs; groups of up to 32 txs
that end before a tx with more than LANE_MAX reads or writes, which is
walked alone; the hashed stamps, (group id << 5 | 31 - lane) by
atomicMax, never cleared; every code-0 lane checked against the state at
the group's start; the dependent lanes resolved in lane order, each read
seeing the largest word a valid lane below it writes to its slot (the
writes forwarded in registers, `__reduce_max_sync`), else the group's
start; the group's valid writes landed together by atomicMax of (tx + 1)
<< 1 | deleted.  The kernel's constants are read from its
source, so the model follows them.  Also `dep_depth`, the walk's bound,
against a brute-force longest chain."""
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from fabric_tpu_torch.ops import block_validate as kv7
from kv7_cases import BLK, DIRECTED, big_lanes, lanes
from test_torch_block_validate import (random_lanes, ref_local,  # noqa: F401
                                       ref_program)

SRC = (Path(kv7.__file__).parent / "csrc" / "block_validate.cu").read_text()
C = {k: int(re.search(rf"constexpr int {k} = (\d+);", SRC).group(1))
     for k in ("WIN_T", "RCAP", "WCAP", "LANE_MAX", "STAMPS")}
ORDER = ("pre", "status", "has_plan", "c_idx", "c_live", "r_off", "w_off",
         "ent_tx", "ent_off", "sig_ent", "sig_item", "sig_bit", "r_slot",
         "r_has", "r_blk", "r_txn", "w_slot", "w_del", "c_has", "c_blk",
         "c_txn", "tables", "verdict")


def unpack(buf, d):
    """The kernel's Lanes from pack's buffer (lanes_of in the source)."""
    size = {"r_off": d["T"] + 1, "w_off": d["T"] + 1}
    group = {n: g for g, names in kv7._GROUPS.items() for n in names}
    out, p = {}, 0
    for n in ORDER:
        k = size.get(n) or d[group[n]]
        out[n] = buf[p:p + k].tolist()
        p += k
    assert p == buf.shape[0]
    return out


def phase1(L, d, blk_num):
    """kv7_fold_kernel, kv7_entry_kernel, kv7_gate_kernel -> (gate,
    code0, rcode, wcode)."""
    T, E = d["T"], d["E"]
    mask = [0] * E
    for s in range(d["S"]):
        mask[L["sig_ent"][s]] += L["verdict"][L["sig_item"][s]] \
            << L["sig_bit"][s]
    ent_fail = [0] * T
    for e in range(E):
        if L["tables"][L["ent_off"][e] + mask[e]] == 0:
            ent_fail[L["ent_tx"][e]] += 1
    rcode = []
    for j in range(d["R"]):
        s, has = L["r_slot"][j], L["r_has"][j]
        blk, txn = L["r_blk"][j], L["r_txn"][j]
        cok = (L["c_has"][s] != 0 and L["c_blk"][s] == blk
               and L["c_txn"][s] == txn) if has else L["c_has"][s] == 0
        want = (txn + 1) << 1 if has and blk == blk_num and 0 <= txn < T \
            else 0
        rcode.append((want << 2) | (2 if has else 0) | int(cok))
    wcode = [(L["w_slot"][j] << 1) | (L["w_del"][j] != 0)
             for j in range(d["W"])]
    gate, code0 = [], []
    for t in range(T):
        cre_ok = L["c_live"][t] != 0 and L["verdict"][L["c_idx"][t]] != 0
        g = 4 if not cre_ok else 10 if ent_fail[t] > 0 else 0
        gc = g if L["has_plan"][t] else L["pre"][t]
        gate.append(gc)
        code0.append(22 if gc == 0 and L["status"][t] == kv7.STATUS_BAD
                     else gc)
    return gate, code0, rcode, wcode


def read_ok(st, rc):
    return (st == rc >> 2 if rc & 2 else (st & 1) != 0) if st \
        else (rc & 1) != 0


def walk(L, d, code0, rcode, wcode):
    """kv7_walk_kernel's warp 0 -> (final codes, Counter of groups,
    dependent lanes, wide txs walked alone, windows not staged)."""
    T, K = d["T"], d["K"]
    WIN_T, LANE_MAX, STAMPS = C["WIN_T"], C["LANE_MAX"], C["STAMPS"]
    r_off, w_off, r_slot = L["r_off"], L["w_off"], L["r_slot"]
    state, stamps = [0] * K, [0] * STAMPS
    final, stats, gid = [None] * T, Counter(), 0

    def apply(t, lo, hi):
        for j in range(lo, hi):
            v = wcode[j]
            state[v >> 1] = max(state[v >> 1], ((t + 1) << 1) | (v & 1))

    for t0 in range(0, T, WIN_T):
        t1 = min(T, t0 + WIN_T)
        stats["unstaged"] += not (r_off[t1] - r_off[t0] <= C["RCAP"]
                                  and w_off[t1] - w_off[t0] <= C["WCAP"])
        g = t0
        while g < t1:
            ins = range(min(32, t1 - g))
            nr = [r_off[g + i + 1] - r_off[g + i] for i in ins]
            nw = [w_off[g + i + 1] - w_off[g + i] for i in ins]
            wide = [i for i in ins if nr[i] > LANE_MAX or nw[i] > LANE_MAX]
            if wide and wide[0] == 0:              # tx g alone
                out = code0[g]
                if out == 0:
                    if all(read_ok(state[r_slot[j]], rcode[j])
                           for j in range(r_off[g], r_off[g + 1])):
                        apply(g, w_off[g], w_off[g + 1])
                    else:
                        out = 11
                final[g] = out
                stats["wide"] += 1
                g += 1
                continue
            n = min(t1 - g, wide[0] if wide else 32)
            live = [i for i in range(n) if code0[g + i] == 0]
            gid += 1
            for i in live:                          # the stamps
                for j in range(w_off[g + i], w_off[g + i + 1]):
                    b = (wcode[j] >> 1) & (STAMPS - 1)
                    stamps[b] = max(stamps[b], (gid << 5) | (31 - i))
            dep, valid = [], set()
            for i in live:                          # the group's start
                reads = range(r_off[g + i], r_off[g + i + 1])
                st = [stamps[r_slot[j] & (STAMPS - 1)] for j in reads]
                if any(s >> 5 == gid and 31 - (s & 31) < i for s in st):
                    dep.append(i)
                elif all(read_ok(state[r_slot[j]], rcode[j])
                         for j in reads):
                    valid.add(i)
            for dl in dep:                          # in lane order
                ok = True
                for j in range(r_off[g + dl], r_off[g + dl + 1]):
                    # the largest word a valid lane below dl writes to the
                    # slot (__reduce_max_sync), else the group's start
                    top = max((((g + i + 1) << 1) | (wcode[jj] & 1)
                               for i in valid if i < dl
                               for jj in range(w_off[g + i],
                                               w_off[g + i + 1])
                               if wcode[jj] >> 1 == r_slot[j]), default=0)
                    ok &= read_ok(top or state[r_slot[j]], rcode[j])
                if ok:
                    valid.add(dl)
            for i in valid:                         # land together
                apply(g + i, w_off[g + i], w_off[g + i + 1])
            for i in range(n):
                final[g + i] = code0[g + i] or (0 if i in valid else 11)
            stats["groups"] += 1
            stats["dependent"] += len(dep)
            g += n
    return final, stats


def model(ln, blk_num=BLK):
    """The whole kernel on pack's buffer -> (gate, final, stats)."""
    buf, d = kv7.pack(ln)
    L = unpack(buf, d)
    gate, code0, rcode, wcode = phase1(L, d, blk_num)
    final, stats = walk(L, d, code0, rcode, wcode)
    return (np.asarray(gate, np.uint8), np.asarray(final, np.uint8),
            stats)


def check_equal(ln, prog=None):
    gate, final, stats = model(ln)
    pg, pf = kv7.block_validate_plain(ln, BLK)
    assert np.array_equal(gate, pg.numpy())
    assert np.array_equal(final, pf.numpy())
    if prog is not None:
        rg, rf = ref_local(prog, ln)
        assert np.array_equal(gate, rg) and np.array_equal(final, rf)
    return final, stats


@pytest.mark.parametrize("chunk", range(4))
def test_walk_model_matches_plain_and_reference_on_random_lanes(
        ref_program, chunk):  # noqa: F811
    """The 200 seeded lane sets of test_torch_block_validate.py, 50 a
    case."""
    total = Counter()
    for seed in range(50 * chunk, 50 * (chunk + 1)):
        _, stats = check_equal(random_lanes(np.random.default_rng(seed)),
                               ref_program)
        total += stats
    assert total["groups"] > 0 and total["dependent"] > 0


@pytest.mark.parametrize("case", sorted(DIRECTED))
def test_walk_model_matches_plain_and_reference_on_directed_cases(
        ref_program, case):  # noqa: F811
    spec, want = DIRECTED[case]
    final, stats = check_equal(lanes(**spec), ref_program)
    assert final.tolist() == want
    # each new case reaches the part of the walk it was written for
    if case in ("ww_chain_in_group", "delete_then_read_in_group",
                "gate_failed_writer_in_group", "hot_slot", "t31", "t33"):
        assert stats["dependent"] > 0
    if case == "wide_tx_mid_group":
        assert stats["wide"] == 2 and stats["groups"] == 3
    if case == "dependence_across_group_boundary":
        assert stats["groups"] == 2 and stats["dependent"] == 0
    if case == "hot_slot":
        # every live lane but each group's first: tx 30's creator fails
        assert stats["dependent"] == 30 + 7


def test_walk_model_on_colliding_stamps_and_unstaged_windows():
    """At block scale against the plain version: slots 0, STAMPS,
    2 STAMPS, ... share a stamp bucket, so most dependences found are a
    shared bucket's and not a slot's; every 7th tx is walked alone; and
    windows too full to stage."""
    rng = np.random.default_rng(5)
    K = 3 * C["STAMPS"] + 17
    slots = np.asarray([b + k * C["STAMPS"] for b in range(40)
                        for k in range(3)])
    ln = big_lanes(rng, 2_000, K, slots, wide_every=7)
    final, stats = check_equal(ln)
    assert stats["dependent"] > 100 and stats["wide"] > 200
    assert (final == 11).any() and (final == 0).any()
    dense = big_lanes(np.random.default_rng(6), 1_200, 600,
                      np.arange(600), wide_every=3)
    _, stats = check_equal(dense)
    assert stats["unstaged"] > 0


def brute_depth(ln):
    """The longest chain by its definition: txs as nodes, an edge from
    each code-0 tx's read slot's last code-0 writer before it."""
    c0 = kv7.code0(ln, BLK)
    T = len(c0)
    depth = [0] * T
    for t in range(T):
        if c0[t]:
            continue
        best = 0
        for s in ln["r_slot"][ln["r_tx"] == t].tolist():
            writers = [u for u in range(t) if c0[u] == 0 and
                       s in ln["w_slot"][ln["w_tx"] == u].tolist()]
            if writers:
                best = max(best, depth[writers[-1]])
        depth[t] = best + 1
    return max(depth, default=0)


def test_dep_depth():
    assert kv7.dep_depth(lanes(**DIRECTED["hot_slot"][0]), BLK) == 39
    assert kv7.dep_depth(lanes(**DIRECTED["t33"][0]), BLK) == 9
    assert kv7.dep_depth(lanes(**DIRECTED["t1"][0]), BLK) == 1
    assert kv7.dep_depth(lanes(**DIRECTED["status_bad_and_skip"][0]),
                         BLK) == 1
    for seed in range(40):
        ln = random_lanes(np.random.default_rng(seed))
        assert kv7.dep_depth(ln, BLK) == brute_depth(ln), seed
