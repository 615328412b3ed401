#!/usr/bin/env python3
"""Same-card A/B timing of KV7 (the gate fold and MVCC walk of a block)
built from several source trees of fabric_tpu_torch/ops/csrc (say the
parent commit's and this one's), in turns within one run.

    python3 tools/kv7_ab.py --src parent=.cache/parent/fabric_tpu_torch/ops/csrc \
        --src change=fabric_tpu_torch/ops/csrc --order parent,change,change,parent

It builds `block_validate.cu` of each tree with nvcc (the flags of
ops/_build.py, every build started at once) into build/ab/<label>/ and
prints ptxas' registers, frame and spills of each kernel in it.  It then
builds chip_smoke.py's commit stream (a seed block and two blocks of
--txs transfers, signed in a spawn pool), commits its first three blocks
through the port's KV7 stack on the factory's CUDA provider, and keeps
block 2's lanes and chip_smoke.py's two variants of them (every tx on
one hot slot; every seventh tx wider than a lane of the walk).  For each
label of --order in turn it launches that tree's `block_validate_launch`
on each lane set, holds both outputs against `block_validate_plain`
(computed once) and times it by CUDA events (median of --trials after
one warm-up).  Prints the card's name and power limit, one JSON line per
label and pass, and last one JSON line of medians by label.  Needs one
CUDA card and nvcc; imports nothing of JAX."""

from __future__ import annotations

import argparse
import ctypes
import json
import multiprocessing
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

LIB = "block_validate"


def build(srcs: dict) -> dict:
    """{label: csrc dir} -> {label: ctypes.CDLL}, printing each kernel's
    ptxas figures."""
    from fabric_tpu_torch.ops import _build
    procs = {}
    for label, src in srcs.items():
        out = ROOT / "build" / "ab" / label
        out.mkdir(parents=True, exist_ok=True)
        cmd = [_build.find_nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               "-o", str(out / f"lib{LIB}.so"), str(Path(src) / f"{LIB}.cu")]
        procs[label] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    libs = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"FAILED: nvcc {label}/{LIB}.cu:\n{log}")
        for kernel in sorted(set(re.findall(
                r"Compiling entry function '([^']+)'", log))):
            print(json.dumps({"build": label, "kernel": kernel,
                              **_build.kernel_resources(log, kernel)}),
                  flush=True)
        dll = ctypes.CDLL(str(ROOT / "build" / "ab" / label / f"lib{LIB}.so"))
        for fn_name in ("block_validate_launch", "block_validate_smem_slots"):
            fn = getattr(dll, fn_name)
            fn.argtypes = _build.SIGNATURES[LIB][fn_name]
            fn.restype = ctypes.c_int
        libs[label] = dll
    return libs


def launcher(torch, lib, buf, d, blk_num):
    """-> a callable that launches lib's KV7 once on the current stream
    and returns its (2T,) output."""
    dev = buf.device
    smem = int(d["K"] <= lib.block_validate_smem_slots())
    # the change's scratch (E + 2T + R + W + K int32) covers the parent's
    scratch = torch.empty(d["E"] + 2 * d["T"] + d["R"] + d["W"] + d["K"],
                          dtype=torch.int32, device=dev)

    def run():
        out = torch.empty(2 * d["T"], dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.block_validate_launch(
            ctypes.c_void_p(buf.data_ptr()),
            *[ctypes.c_int(d[k]) for k in ("T", "E", "S", "R", "W", "K",
                                           "TB", "V")],
            ctypes.c_int(blk_num), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(scratch.data_ptr()), ctypes.c_int(smem),
            ctypes.c_void_p(stream))
        if rc:
            raise SystemExit(f"FAILED: launch: CUDA error {rc}")
        return out
    return run


def block2_lanes(torch, n_txs: int) -> dict:
    """chip_smoke.py's commit stream, blocks 0-2 committed through the
    KV7 stack -> {name: lanes} of block 2 and its two variants."""
    from fabric_tpu_torch.bccsp import FactoryOpts, init_factories
    from fabric_tpu_torch.ops import block_validate as kv7
    provider = init_factories(FactoryOpts(default="CUDA"))
    orgs, signers, endorsers, clients = cs.commit_identities()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(8, multiprocessing.cpu_count())) as pool:
        blocks, _, _ = cs.build_stream(n_txs, 1, signers, endorsers,
                                       clients, pool)
    raws = cs.chain_blocks(blocks)[:3]
    seen, pack = [], kv7.pack

    def keep(lanes):
        seen.append(lanes)
        return pack(lanes)

    kv7.pack = keep
    try:
        committer, _ = cs.commit_stack(provider, orgs, True,
                                       torch.device("cuda"))
        cs.commit_stream(committer, raws)
    finally:
        kv7.pack = pack
    if len(seen) != 3:
        raise SystemExit(f"FAILED: {len(seen)} device blocks, expected 3")
    return {"block 2": seen[2], **cs.kv7_variants(seen[2], 2)}


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

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is False")
    from fabric_tpu_torch.ops import block_validate as kv7

    print(cs.smi("name,power.limit"), flush=True)
    libs = build(srcs)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cases = {}
    for name, ln in block2_lanes(torch, args.txs).items():
        buf, d = kv7.pack(ln)
        gate, final = kv7.block_validate_plain(ln, 2)
        cases[name] = (kv7.upload(buf, dev), d, torch.cat([gate, final]))
        print(json.dumps({"lanes": name, "dep_depth": kv7.dep_depth(ln, 2),
                          **d}), flush=True)
    print(json.dumps({"stream_s": round(time.perf_counter() - t0, 2)}),
          flush=True)

    times = {label: {name: [] for name in cases} for label in srcs}
    for label in order:
        row = {"label": label}
        for name, (buf_d, d, want) in cases.items():
            run = launcher(torch, libs[label], buf_d, d, 2)
            cs.check(torch.equal(run().cpu(), want),
                     f"{label} {name}: KV7 != block_validate_plain")
            ms = cs.event_ms(torch, run, args.trials)
            times[label][name].append(ms)
            row[name.replace(" ", "_") + "_ms"] = round(ms, 4)
        print(json.dumps(row), flush=True)
    print(cs.smi("name,power.limit"), flush=True)
    print(json.dumps({"medians": {
        label: {name: round(statistics.median(v), 4)
                for name, v in t.items() if v}
        for label, t in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
