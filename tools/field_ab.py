#!/usr/bin/env python3
"""Same-card A/B timing of KP1 and KF2 built from several source trees
of fabric_tpu_torch/ops/csrc (say the parent commit's and this one's),
in turns within one run.

    python3 tools/field_ab.py --src parent=.cache/parent/fabric_tpu_torch/ops/csrc \
        --src change=fabric_tpu_torch/ops/csrc --order parent,change,change,parent

It builds `field_chain.cu` (KP1) and `field_chain_variants.cu` (KF2) of
each tree with nvcc (the flags of ops/_build.py, every build started at
once) into build/ab/<label>/ and prints ptxas' registers, frame and
spills of every kernel.  The cases: KP1 mod p, n, p25519 and BN254's p at
r_log2 = 264 with the reference script's n = 192, and each KF2 preset
(relaxed and stacked at n = 192, min, planes and ilp K = 4 at n = 96; 128
threads a block at most), each at B = 16,384 (the reference's) and at a
card-filling B = SMs x 2,048, on the scripts' data
(`experiments.operands`).  A tree whose library has the group launch
(`field_mul_chain_group_launch`) runs each case at every TPI of --tpis
("auto" is `field.group_plan`'s); an older tree runs its one launch.
Every output is held against the plain version (computed once a case on
the card), then timed by CUDA events (median of --trials after one
warm-up) in the turns of --order.  Prints the card's name and power
limit, one JSON line per label and turn, and last one JSON line of
medians by label, case and TPI, with SM-cycles a multiply (ms x top SM
clock x SMs / (B n)) and a chain's cycles a multiply (ms x clock / n).
Needs one CUDA card and nvcc; imports nothing of JAX."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LIBS = ("field_chain", "field_chain_variants")
# an older tree's C entries (before the group launch)
OLD_SIGNATURES = {
    "field_mul_chain_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "field_chain_variant_launch": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
}
KF2_CASES = (("relaxed", None, 192), ("stacked", None, 192),
             ("min", None, 96), ("planes", None, 96), ("ilp", 4, 96))
KP1_N = 192
MODS = ("p", "n", "p25519", "bn254")


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={fields}",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def build(srcs: dict) -> dict:
    """{label: csrc dir} -> {label: {lib: ctypes.CDLL}}, printing every
    kernel's ptxas figures."""
    from fabric_tpu_torch.ops import _build
    procs = {}
    for label, src in srcs.items():
        out = ROOT / "build" / "ab" / label
        out.mkdir(parents=True, exist_ok=True)
        for lib in LIBS:
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
        names = sorted(set(re.findall(r"Compiling entry function '([^']+)'",
                                      log)))
        figs = {}
        for name in names:
            r = _build.kernel_resources(log, name)
            figs[name] = (f"{r['regs']} / {r['frame_bytes']} / "
                          f"{r['spill_store_bytes']}+{r['spill_load_bytes']}")
        print(json.dumps({"build": label, "lib": lib,
                          "regs / frame / spills": figs}), flush=True)
        dll = ctypes.CDLL(str(ROOT / "build" / "ab" / label / f"lib{lib}.so"))
        sigs = dict(_build.SIGNATURES[lib], **OLD_SIGNATURES)
        for fn_name, argtypes in sigs.items():
            if hasattr(dll, fn_name):
                fn = getattr(dll, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        dlls.setdefault(label, {})[lib] = dll
    return dlls


def launcher(torch, libs, case, a, b, tpi):
    """A callable that launches `case` once from one tree's libraries
    at tpi ("auto": the plan's; an older tree: its one launch) and
    returns the output."""
    from fabric_tpu_torch.ops import field as F
    from fabric_tpu_torch.ops import field_variants as FV
    kind, what, k, n, lanes = case
    dev = a.device
    sms = F.sm_count(dev)
    force = None if tpi == "auto" else tpi
    P = ctypes.c_void_p

    def run():
        out = torch.empty_like(a)
        stream = P(torch.cuda.current_stream(dev).cuda_stream)
        ptrs = (P(a.data_ptr()), P(b.data_ptr()), P(out.data_ptr()))
        if kind == "kp1":
            lib = libs["field_chain"]
            if hasattr(lib, "field_mul_chain_group_launch"):
                t, threads, _ = F.group_plan(lanes, sms, None, force)
                rc = lib.field_mul_chain_group_launch(
                    *ptrs, lanes, n, F.MOD_INDEX[what], 1, t, threads,
                    stream)
            else:
                rc = lib.field_mul_chain_launch(
                    *ptrs, lanes, n, F.MOD_INDEX[what], 1, stream)
        else:
            lib = libs["field_chain_variants"]
            v = FV.variant_of(what, k)
            vid = FV.VARIANT_ID[v.name]
            if hasattr(lib, "field_chain_variant_group_launch"):
                t, threads, _ = F.group_plan(lanes, sms, None, force, v.k)
                rc = lib.field_chain_variant_group_launch(
                    vid, 0, *ptrs, lanes, n, t, threads, P(0), stream)
            else:
                rc = lib.field_chain_variant_launch(
                    vid, 0, *ptrs, lanes, n, 128, P(0), stream)
        if rc:
            raise SystemExit(f"FAILED: {case} launch: CUDA error {rc}")
        return out
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="label=csrc directory (repeat)")
    ap.add_argument("--order", required=True,
                    help="labels in the order they are timed, e.g. "
                    "parent,change,change,parent")
    ap.add_argument("--tpis", default="auto",
                    help="TPIs a group tree runs each case at, e.g. "
                    "auto,1,4")
    ap.add_argument("--lanes", default="16384,fill",
                    help="B of every case; 'fill' is SMs x 2,048")
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args(argv)
    srcs = dict(s.split("=", 1) for s in args.src)
    order = args.order.split(",")
    if not set(order) <= set(srcs):
        raise SystemExit("FAILED: --order names a label without --src")
    tpis = [t if t == "auto" else int(t) for t in args.tpis.split(",")]

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is False")
    from fabric_tpu_torch import experiments as X
    from fabric_tpu_torch.ops import field as F
    from fabric_tpu_torch.ops import field_variants as FV

    print(smi("name,power.limit"), flush=True)
    libs = build(srcs)
    dev = torch.device("cuda")
    sms = F.sm_count(dev)
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    lane_counts = [sms * F.FILL_THREADS_PER_SM if c == "fill" else int(c)
                   for c in args.lanes.split(",")]
    cases, inputs, plains = [], {}, {}
    for lanes in lane_counts:
        a, b = X.operands(lanes, dev)
        inputs[lanes] = (a, b, FV.to_planes(a), FV.to_planes(b))
        for mod in MODS:
            cases.append(("kp1", mod, None, KP1_N, lanes))
        for preset, k, n in KF2_CASES:
            cases.append(("kf2", preset, k, n, lanes))
    for kind, what, k, n, lanes in cases:
        a, b = inputs[lanes][:2]
        mod = what if kind == "kp1" else "p"
        if (mod, n, lanes) not in plains:
            plains[mod, n, lanes] = F.mul_chain_plain(a, b, n, mod,
                                                      r_log2=264)
    torch.cuda.synchronize()

    def operands(case):
        kind, what, k, _, lanes = case
        planes = kind == "kf2" and FV.variant_of(what, k).planes
        a, b, pa, pb = inputs[lanes]
        return (pa, pb) if planes else (a, b)

    def plain(case):
        kind, what, k, n, lanes = case
        out = plains[what if kind == "kp1" else "p", n, lanes]
        if kind == "kf2" and FV.variant_of(what, k).planes:
            return FV.to_planes(out)
        return out

    def label_tpis(label):
        group = hasattr(libs[label]["field_chain"],
                        "field_mul_chain_group_launch")
        return tpis if group else ["one"]

    def key(case, tpi):
        kind, what, k, n, lanes = case
        name = what + (f" K={k}" if k else "")
        return f"{kind} {name} n={n} B={lanes} tpi={tpi}"

    times = {label: {} for label in srcs}
    for turn, label in enumerate(order):
        row = {"label": label, "turn": turn}
        for case in cases:
            x, y = operands(case)
            want = plain(case)
            for tpi in label_tpis(label):
                run = launcher(torch, libs[label], case, x, y, tpi)
                if not torch.equal(run(), want):
                    raise SystemExit(f"FAILED: {label} {key(case, tpi)} != "
                                     "plain")
                ms = X.event_ms(run, args.trials)
                times[label].setdefault(key(case, tpi), []).append(ms)
                row[key(case, tpi)] = round(ms, 4)
        print(json.dumps(row), flush=True)
    print(smi("name,power.limit"), flush=True)
    med = {}
    for label, t in times.items():
        med[label] = {}
        for name, v in t.items():
            ms = statistics.median(v)
            n = int(re.search(r"n=(\d+)", name).group(1))
            lanes = int(re.search(r"B=(\d+)", name).group(1))
            med[label][name] = {
                "ms": round(ms, 4),
                "sm_cycles_per_mul": round(ms * 1e-3 * clock_hz * sms
                                           / (lanes * n), 2),
                "chain_cycles_per_mul": round(ms * 1e-3 * clock_hz / n, 1)}
    print(json.dumps({"medians": med}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
