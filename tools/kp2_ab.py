#!/usr/bin/env python3
"""Same-card A/B timing of KP2, with KP3 as the control, built from
several source trees of fabric_tpu_torch/ops/csrc (say the parent
commit's and this one's), in turns within one run.

    python3 tools/kp2_ab.py --src parent=.cache/parent/fabric_tpu_torch/ops/csrc \
        --src change=fabric_tpu_torch/ops/csrc --order parent,change,change,parent

It builds `p256_verify.cu` and `p256_verify_rows.cu` of each tree with
nvcc (the flags of ops/_build.py, every build started at once) into
build/ab/<label>/ and prints ptxas' registers, frame and spills of each
kernel.  It then builds chip_smoke.py's block (--txs transactions, three
endorsements and one creator signature each, 2% corrupted) and runs it
once through the factory's CUDA provider, which builds the hot keys'
tables.  For each label of --order in turn it times, by CUDA events
(median of --trials after one warm-up):

- KP2 on the block's whole device-bound batch (chip_smoke.py phase 7's
  yardstick);
- KP2 on the path's own KP2 batch, the provider's generic lane for the
  block (the lanes it sends to KP2);
- KP3 on the provider's fixed-key lane for the block.

Each output is held against its plain version (computed once) and the
labels.  Prints the card's name and power limit, one JSON line per label
and pass, and last one JSON line of medians by label.  Needs one CUDA
card and nvcc; imports nothing of JAX."""

from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

LIBS = {"p256_verify": "p256_verify_kernel",
        "p256_verify_rows": "p256_verify_rows_kernel"}


def build(srcs: dict, libs: dict = LIBS) -> dict:
    """{label: csrc dir} -> {label: {lib: ctypes.CDLL}} for the sources
    `libs` names ({lib: kernel}), their C entries typed as ops/_build.py
    types them, printing each kernel's ptxas figures."""
    from fabric_tpu_torch.ops import _build
    procs = {}
    for label, src in srcs.items():
        out = ROOT / "build" / "ab" / label
        out.mkdir(parents=True, exist_ok=True)
        for lib in libs:
            cmd = [_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
                   "-o", str(out / f"lib{lib}.so"), str(Path(src) / f"{lib}.cu")]
            procs[label, lib] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    dlls = {}
    for (label, lib), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"FAILED: nvcc {label}/{lib}.cu:\n{log}")
        res = _build.kernel_resources(log, libs[lib])
        print(json.dumps({"build": label, "kernel": libs[lib], **res}),
              flush=True)
        dll = ctypes.CDLL(str(ROOT / "build" / "ab" / label / f"lib{lib}.so"))
        for fn_name, argtypes in _build.SIGNATURES[lib].items():
            fn = getattr(dll, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        dlls.setdefault(label, {})[lib] = dll
    return dlls


def launcher(torch, fn, args, n):
    """fn(*pointers of args, out, n, low_s=1, stream) on the current
    stream -> a callable that launches once and returns the verdicts."""
    dev = args[0].device

    def run():
        out = torch.empty(n, dtype=torch.bool, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[ctypes.c_void_p(a.data_ptr()) for a in args],
                ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n),
                ctypes.c_int(1), ctypes.c_void_p(stream))
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
    from fabric_tpu_torch.bccsp import cuda as cudaprov
    from fabric_tpu_torch.ops import p256, p256_fixed, p256_tables

    print(cs.smi("name,power.limit"), flush=True)
    libs = build(srcs)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, multiprocessing.cpu_count())) as pool:
        items, labels, kinds = cs.build_block(args.txs, pool)
    want = np.asarray(labels)
    n_p256 = 4 * args.txs
    provider = init_factories(FactoryOpts(default="CUDA"))
    cs.check_verdicts("block", provider.batch_verify(items), want, kinds)
    batch = provider.pass_p256(items, range(n_p256))
    provider.key_tables.unpin(batch.pinned)
    f_keep, f_arrays, f_slot = batch.fast
    g_keep, g_arrays = batch.generic
    recs, _ = cudaprov.parse_p256(items[:n_p256], range(n_p256))
    w_keep, w_arrays = cudaprov.pack_p256_recs(recs)
    print(json.dumps({"block_s": round(time.perf_counter() - t0, 2),
                      "whole_lanes": len(w_keep), "path_lanes": len(g_keep),
                      "kp3_lanes": len(f_keep)}), flush=True)

    table = p256_tables.g_table(dev)
    bank = provider.key_tables.array()

    def words(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    whole, path, fast = words(w_arrays), words(g_arrays), words(f_arrays)
    slot = torch.from_numpy(f_slot).to(dev)
    cases = {
        "kp2_whole": ("p256_verify", [*whole, table], len(w_keep),
                      p256.verify_words_plain(*whole, table), w_keep),
        "kp2_path": ("p256_verify", [*path, table], len(g_keep),
                     p256.verify_words_plain(*path, table), g_keep),
        "kp3": ("p256_verify_rows", [*fast, slot, bank, table], len(f_keep),
                p256_fixed.verify_words_rows_plain(*fast, slot.cpu(), bank,
                                                   table), f_keep),
    }
    torch.cuda.synchronize()
    for name, (_, _, _, plain, keep) in cases.items():
        cs.check((plain.cpu().numpy() == want[keep]).all(),
                 f"{name}: plain version != labels")

    times = {label: {name: [] for name in cases} for label in srcs}
    for label in order:
        row = {"label": label}
        for name, (lib, a, n, plain, _) in cases.items():
            run = launcher(torch, getattr(libs[label][lib], f"{lib}_launch"),
                           a, n)
            cs.check(torch.equal(run(), plain), f"{label} {name} != plain")
            ms = cs.event_ms(torch, run, args.trials)
            times[label][name].append(ms)
            row[name + "_ms"] = round(ms, 4)
        print(json.dumps(row), flush=True)
    print(cs.smi("name,power.limit"), flush=True)
    print(json.dumps({"medians": {
        label: {name: round(statistics.median(v), 4)
                for name, v in t.items() if v}
        for label, t in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
