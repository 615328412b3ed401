#!/usr/bin/env python3
"""The commit stream of chip_smoke.py, serial and through the cross-block
commit window, under several GIL switch intervals, in turns within one
run on one card.

    python3 tools/window_gil.py [--intervals 0.005,0.0005]
                                [--windows 0,4] [--tails kv7,host]
                                [--trials 3]
                                [--txs 10000] [--last 1000]

It builds the kernels and the stream once (chip_smoke.build_stream,
signed in a spawn pool), commits it once to warm the provider, then for
each trial, for each switch interval (`sys.setswitchinterval`), for
each tail (kv7: the deep tail with KV7, whose prepared batch a serial
commit takes in place of host MVCC and a windowed one never does;
host: the deep host tail, host MVCC either way), for each window W (0:
the serial `store_block`; else `PipelinedCommitter` on
`KVLedger(commit_window=W)`), commits the whole stream on a fresh
in-memory stack (chip_smoke.commit_stack on the factory's CUDA
provider).  Every run's flags are checked against the stream's labels.
Prints the card's name and power limit, one JSON line a run (the
stream's wall ms; pass 1, dispatch wait, gate and ledger commit summed
over the blocks), and last one JSON line of medians by cell.  The
pass-1 walkers release the GIL every 64 or 256 items; a windowed
stream runs the previous block's Python commit on another thread, so
the interval sets how long the walker waits for the GIL each time.
Needs one CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--intervals", default="0.005,0.0005",
                    help="GIL switch intervals in seconds, comma-separated")
    ap.add_argument("--windows", default="0,4",
                    help="commit windows, comma-separated (0: serial)")
    ap.add_argument("--tails", default="kv7,host",
                    help="validator tails, comma-separated: kv7, host")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--txs", type=int, default=10_000)
    ap.add_argument("--last", type=int, default=1_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from fabric_tpu_torch.bccsp import FactoryOpts, init_factories
    if args.device == "cuda":
        from fabric_tpu_torch.ops import _build
        if not torch.cuda.is_available():
            print("FAILED: torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
        _build.build_all(force=True)
        provider = init_factories(FactoryOpts(default="CUDA"))
        card = cs.smi("name,power.limit")
    else:
        from fabric_tpu_torch.bccsp.sw import SoftwareProvider
        init_factories(FactoryOpts(default="SW"))
        provider, card = SoftwareProvider(), "cpu (software provider)"
    dev = torch.device(args.device)
    intervals = [float(v) for v in args.intervals.split(",")]
    windows = [int(v) for v in args.windows.split(",")]
    tails = args.tails.split(",")
    orgs, signers, endorsers, clients = cs.commit_identities()
    with multiprocessing.get_context("spawn").Pool(os.cpu_count()) as pool:
        env_blocks, labels, _ = cs.build_stream(
            args.txs, args.last, signers, endorsers, clients, pool)
    raws = cs.chain_blocks(env_blocks)
    warm, _ = cs.commit_stack(provider, orgs, True, dev)
    cs.serial_stream(warm, raws)
    default = sys.getswitchinterval()
    runs = {}
    print(card, flush=True)
    try:
        for trial in range(args.trials):
            for interval in intervals:
                sys.setswitchinterval(interval)
                for tail in tails:
                    for W in windows:
                        row = one_run(cs, provider, orgs, dev, raws,
                                      labels, tail, W)
                        row = {"trial": trial, "switch_interval_s": interval,
                               **row}
                        runs.setdefault((interval, tail, W), []).append(row)
                        print(json.dumps(row), flush=True)
    finally:
        sys.setswitchinterval(default)
    med = [{"switch_interval_s": i, "tail": tail, "window": W,
            "trials": len(rows),
            **{k: round(statistics.median(r[k] for r in rows), 3)
               for k in rows[0] if k.endswith("_ms")},
            "stream_min_ms": min(r["stream_ms"] for r in rows),
            "stream_max_ms": max(r["stream_ms"] for r in rows)}
           for (i, tail, W), rows in runs.items()]
    print(card, flush=True)
    print(json.dumps({"card": card, "medians": med}), flush=True)
    return 0


def one_run(cs, provider, orgs, dev, raws, labels, tail: str, W: int):
    """The stream on a fresh stack of `tail` at window W -> its row."""
    kw = {"commit_window": W} if W else {}
    c, _ = cs.commit_stack(provider, orgs, tail == "kv7", dev, **kw)
    stream = cs.pipeline_stream if W else cs.serial_stream
    out, secs = stream(c, raws)
    cs.check([r.final_flags.codes() for r, *_x in out] == labels,
             f"{tail} W={W}: flags != labels")
    row = {"tail": tail, "window": W, "stream_ms": round(secs * 1e3, 3)}
    for k, get in (("collect", lambda r: r.validation.collect_s),
                   ("dispatch_wait", lambda r: r.validation.dispatch_s),
                   ("gate", lambda r: r.validation.gate_s),
                   ("commit", lambda r: r.commit_s)):
        row[f"{k}_ms"] = round(sum(get(r) for r, *_x in out) * 1e3, 3)
    return row


if __name__ == "__main__":
    sys.exit(main())
