#!/usr/bin/env python3
"""Same-card A/B timing of KE5 and KE6 built from several source trees of
fabric_tpu_torch/ops/csrc (say the parent commit's and this one's), in
turns within one run.

    python3 tools/ke_ab.py --src parent=.cache/parent/fabric_tpu_torch/ops/csrc \
        --src change=fabric_tpu_torch/ops/csrc --order parent,change,change,parent

It builds `ed25519_verify.cu` and `ed25519_verify_rows.cu` of each tree
as tools/kp2_ab.py builds its sources (nvcc with the flags of
ops/_build.py, every build started at once, into build/ab/<label>/) and
prints ptxas' registers, frame and spills of each kernel.  It then
builds chip_smoke.py's inputs: the block (--txs transactions) for its
64 Ed25519 items, the generic load (--gen items under keys of their
own) and BASELINE config 2 (--ed signatures under 8 keys), whose keys
get their tables through the factory's CUDA provider.
For each label of --order in turn it times, by CUDA events (median of
--trials after one warm-up):

- KE5 on the generic load's batch (chip_smoke.py's `ke5_ms`);
- KE5 on the block's 64 Ed25519 items (one chain a signature: the
  card is nearly empty);
- KE6 on config 2's fixed-key batch (`ke6_ms`);
- KE6 on that batch's first 64 signatures (one chain a signature).

Each output is held against its plain version (computed once) and the
labels.  Then, end to end, it times the warm provider's `batch_verify`
on the block, on config 2 and on config 3 (the block's first 2 x --txs
endorsements and config 2's items), median wall ms of --trials, with
that label's KE5 and KE6 in the provider's place (`_build`'s loaded
libraries), the verdicts checked against the labels.  Prints the card's
name and power limit, one JSON line per label and pass, and last one
JSON line of medians by label.  Needs one CUDA card and nvcc; imports
nothing of JAX."""

from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from kp2_ab import build  # noqa: E402

LIBS = {"ed25519_verify": "ed25519_verify_kernel",
        "ed25519_verify_rows": "ed25519_verify_rows_kernel"}
SMALL = 64


def launcher(torch, fn, args, n):
    """fn(*pointers of args, out, n, stream) on the current stream -> a
    callable that launches once and returns the verdicts."""
    dev = args[0].device

    def run():
        out = torch.empty(n, dtype=torch.bool, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[ctypes.c_void_p(a.data_ptr()) for a in args],
                ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n),
                ctypes.c_void_p(stream))
        if rc:
            raise SystemExit(f"FAILED: launch: CUDA error {rc}")
        return out
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="label=csrc directory (repeat)")
    ap.add_argument("--order", required=True,
                    help="labels in the order they are timed, e.g. "
                    "parent,change,change,parent")
    ap.add_argument("--txs", type=int, default=10_000)
    ap.add_argument("--ed", type=int, default=10_000)
    ap.add_argument("--gen", type=int, default=4096)
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args(argv)
    srcs = dict(s.split("=", 1) for s in args.src)
    order = args.order.split(",")
    if not set(order) <= set(srcs):
        raise SystemExit("FAILED: --order names a label without --src")

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is False")
    from fabric_tpu_torch.bccsp import FactoryOpts, init_factories
    from fabric_tpu_torch.ops import _build, ed25519, ed25519_tables

    print(cs.smi("name,power.limit"), flush=True)
    dlls = build(srcs, LIBS)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, multiprocessing.cpu_count())) as pool:
        items, labels, kinds = cs.build_block(args.txs, pool)
        c2_items, c2_labels, c2_kinds = cs.build_ed25519(
            args.ed, cs.ED_KEYS, cs.ED_CFG2_KINDS, cs.SEED + 3, pool)
        g_items, g_labels, _ = cs.build_ed25519(
            args.gen, 0, cs.ED_GEN_KINDS, cs.SEED + 4, pool)
    n_p256 = 4 * args.txs
    provider = init_factories(FactoryOpts(default="CUDA"))
    want = np.asarray(labels)
    cs.check_verdicts("block", provider.batch_verify(items), want, kinds)
    c2_want = np.asarray(c2_labels)
    cs.check_verdicts("config 2", provider.batch_verify(c2_items), c2_want,
                      c2_kinds)
    c2_pass = provider.pass_ed25519(c2_items, range(args.ed))
    provider.ed_key_tables.unpin(c2_pass.pinned)
    e6_keep, e6_arrays, e6_slot = c2_pass.fast
    g_pass = provider.pass_ed25519(g_items, range(args.gen))
    provider.ed_key_tables.unpin(g_pass.pinned)
    e5_keep, e5_arrays = g_pass.generic
    b_pass = provider.pass_ed25519(items, range(n_p256, len(items)))
    provider.ed_key_tables.unpin(b_pass.pinned)
    b_keep, b_arrays = b_pass.generic
    print(json.dumps({"inputs_s": round(time.perf_counter() - t0, 2),
                      "ke5_lanes": len(e5_keep), "ke5_block_lanes":
                      len(b_keep), "ke6_lanes": len(e6_keep)}), flush=True)

    btab = ed25519_tables.b_table(dev)
    bank = provider.ed_key_tables.array()

    def words(arrays, k=None):
        return [torch.from_numpy(np.ascontiguousarray(
            a if k is None else a[..., :k])).to(dev) for a in arrays]

    g_want, b_want = np.asarray(g_labels), want
    e5, e5b = words(e5_arrays), words(b_arrays)
    e6, e6s = words(e6_arrays), words(e6_arrays, SMALL)
    slot = torch.from_numpy(np.ascontiguousarray(e6_slot)).to(dev)
    slot_s = slot[:SMALL].contiguous()
    cases = {
        "ke5": ("ed25519_verify", [*e5, btab], len(e5_keep),
                ed25519.verify_words_plain(*e5, btab), g_want[e5_keep]),
        "ke5_block": ("ed25519_verify", [*e5b, btab], len(b_keep),
                      ed25519.verify_words_plain(*e5b, btab),
                      b_want[b_keep]),
        "ke6": ("ed25519_verify_rows", [*e6, slot, bank, btab], len(e6_keep),
                ed25519.verify_words_rows_plain(*e6, slot.cpu(), bank, btab),
                c2_want[e6_keep]),
        "ke6_small": ("ed25519_verify_rows", [*e6s, slot_s, bank, btab],
                      SMALL, ed25519.verify_words_rows_plain(
                          *e6s, slot_s.cpu(), bank, btab),
                      c2_want[e6_keep[:SMALL]]),
    }
    torch.cuda.synchronize()
    for name, (_, _, _, plain, expect) in cases.items():
        cs.check((plain.cpu().numpy() == expect).all(),
                 f"{name}: plain version != labels")

    endorse = [i for i in range(n_p256) if i % 4 != cs.N_ORGS][:2 * args.txs]
    c3_items = [items[i] for i in endorse] + c2_items
    c3_want = np.concatenate([want[endorse], c2_want])
    e2e = {"block_e2e": (items, want), "config2_e2e": (c2_items, c2_want),
           "config3_e2e": (c3_items, c3_want)}

    times = {label: {name: [] for name in [*cases, *e2e]} for label in srcs}
    for label in order:
        row = {"label": label}
        for name, (lib, a, n, plain, _) in cases.items():
            run = launcher(torch, getattr(dlls[label][lib],
                                          f"{lib}_launch"), a, n)
            cs.check(torch.equal(run(), plain), f"{label} {name} != plain")
            ms = cs.event_ms(torch, run, args.trials)
            times[label][name].append(ms)
            row[name + "_ms"] = round(ms, 4)
        _build._libs.update(dlls[label])
        for name, (its, w) in e2e.items():
            got = provider.batch_verify(its)
            cs.check((got == w).all(), f"{label} {name} != labels")
            ms = cs.median_ms(lambda: provider.batch_verify(its), args.trials)
            times[label][name].append(ms)
            row[name + "_ms"] = round(ms, 3)
        print(json.dumps(row), flush=True)
    print(cs.smi("name,power.limit"), flush=True)
    print(json.dumps({"medians": {
        label: {name: round(statistics.median(v), 4)
                for name, v in t.items() if v}
        for label, t in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
