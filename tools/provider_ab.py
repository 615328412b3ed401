#!/usr/bin/env python3
"""Same-card A/B timing of the plain provider, `CudaProvider()` (no
mesh), from several source trees of the whole package (say the parent
commit's and this one's), in turns within one run.

    git archive <parent> | tar -x -C .cache/parent
    python3 tools/provider_ab.py --tree parent=.cache/parent --tree change=. \
        --order parent,change,change,parent

It builds chip_smoke.py's inputs once, with this tree's code: the block
(--txs transactions: 4 P-256 items each plus 64 Ed25519 items), BASELINE
config 2 (--ed Ed25519 signatures under 8 keys) and config 3 (the
block's first 2 x --txs endorsements and config 2's items).  For each
label of --order in turn it starts a process in that tree (its own
`fabric_tpu_torch`, its kernels built into its own build/), which runs
each cell once cold through the factory's `CudaProvider()`, then times
its warm `batch_verify` (median wall ms of --trials), the verdicts
checked against the labels every run.  Prints the card's name and power
limit, one JSON line per label and pass, and last one JSON line of
medians by label.  Needs one CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import pickle
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(tree: str, inputs: str, trials: int) -> None:
    """In a process of its own: the plain provider of `tree` on the
    pickled cells -> one JSON line of median warm ms by cell."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from fabric_tpu_torch.bccsp import (FactoryOpts, VerifyItem,
                                        init_factories)
    with open(inputs, "rb") as f:
        cells = pickle.load(f)
    provider = init_factories(FactoryOpts(default="CUDA"))
    out = {}
    for name, (rows, labels) in cells.items():
        items = [VerifyItem(*r) for r in rows]
        want = np.asarray(labels)
        runs = []
        for i in range(trials + 1):             # the first run is cold
            t0 = time.perf_counter()
            got = provider.batch_verify(items)
            ms = (time.perf_counter() - t0) * 1e3
            if not np.array_equal(got, want):
                raise SystemExit(f"FAILED: {tree} {name}: verdicts != labels")
            if i:
                runs.append(ms)
        out[name] = statistics.median(runs)
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="label=path of a checkout of the repository")
    ap.add_argument("--order", required=True,
                    help="comma-separated labels, timed in this order")
    ap.add_argument("--txs", type=int, default=10_000)
    ap.add_argument("--ed", type=int, default=10_000)
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args(argv)
    trees = {label: str(Path(path).resolve()) for label, path in
             (t.split("=", 1) for t in args.tree)}
    order = args.order.split(",")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    print(cs.smi("name,power.limit"), flush=True)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(8) as pool:
        items, labels, _ = cs.build_block(args.txs, pool)
        c2_items, c2_labels, _ = cs.build_ed25519(
            args.ed, cs.ED_KEYS, cs.ED_CFG2_KINDS, cs.SEED + 3, pool)
    n_p256 = 4 * args.txs
    endorse = [i for i in range(n_p256) if i % 4 != cs.N_ORGS][:2 * args.txs]
    c3_items = [items[i] for i in endorse] + c2_items
    c3_labels = [labels[i] for i in endorse] + c2_labels

    def rows(its):
        return [tuple(it) for it in its]

    cells = {"block": (rows(items), labels),
             "config2": (rows(c2_items), c2_labels),
             "config3": (rows(c3_items), c3_labels)}
    path = ROOT / "build" / "ab" / "provider_cells.pkl"
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(cells, f)
    by_label = {}
    for n, label in enumerate(order):
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             trees[label], str(path), str(args.trials)],
            cwd=trees[label], capture_output=True, text=True, timeout=1200)
        if res.returncode:
            print(res.stdout, res.stderr[-4000:], file=sys.stderr)
            return 1
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"label": label, "pass": n, "warm_ms": ms}),
              flush=True)
        for cell, v in ms.items():
            by_label.setdefault(label, {}).setdefault(cell, []).append(v)
    print(json.dumps({"medians_ms": {
        label: {cell: statistics.median(v) for cell, v in cells_.items()}
        for label, cells_ in by_label.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3], int(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())
