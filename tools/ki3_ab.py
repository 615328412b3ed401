#!/usr/bin/env python3
"""Same-card A/B timing of KI3 (the instruction-cost probes,
`fabric_tpu_torch/ops/csrc/isa_probe.cu`) built from several source trees
of fabric_tpu_torch/ops/csrc (say the parent commit's and this one's), in
turns within one run.

    python3 tools/ki3_ab.py --src parent=.cache/parent/fabric_tpu_torch/ops/csrc \
        --src change=fabric_tpu_torch/ops/csrc --order parent,change,change,parent

It builds each tree's `isa_probe.cu` with nvcc (the flags of
ops/_build.py, every build started at once) into build/ab/<label>/ and
prints ptxas' registers, frame and spills of every kernel.  Each of the
eight probes runs at B = 16,384 (the reference's) and at a card-filling
B = SMs x 2,048, on the reference script's data
(`experiments.proto_pallas3.probe_inputs`), 4 passes.  A tree with the
layout launch (`isa_probe_layout_launch`) runs each probe in every layout
of --layouts that the probe has ("auto" is `isa_probe.probe_plan`'s,
"all" each of its layouts); an older tree runs its one launch (one thread
a column).  Every output is held against the plain version (computed once
a probe and B on the card), then timed in the turns of --order by
`experiments.launch_ms` (--launches launches captured in a CUDA graph,
median of --trials replays, each over the count), which keeps the host's
enqueue off the card's timeline; `torch.roll` is timed the same way on
rotate's and roll's tile once a turn.  Prints the card's name and power
limit, one JSON line per label and turn, and last one JSON line of
medians by label, probe, B and layout, with each probe's bound and its
share.  Needs one CUDA card and nvcc; imports nothing of JAX."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import struct
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LIB = "isa_probe"
_P, _I = ctypes.c_void_p, ctypes.c_int
# an older tree's C entries (one thread a column, no layout argument)
OLD_SIGNATURES = {
    "isa_probe_launch": [_I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={fields}",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def build(srcs: dict) -> dict:
    """{label: csrc dir} -> {label: ctypes.CDLL}, printing every kernel's
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
    dlls = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"FAILED: nvcc {label}/{LIB}.cu:\n{log}")
        figs = {}
        for name in sorted(set(re.findall(
                r"Compiling entry function '([^']+)'", log))):
            r = _build.kernel_resources(log, name)
            figs[name] = (f"{r['regs']} / {r['frame_bytes']} / "
                          f"{r['spill_store_bytes']}+{r['spill_load_bytes']}")
        print(json.dumps({"build": label, "lib": LIB,
                          "regs / frame / spills": figs}), flush=True)
        dll = ctypes.CDLL(str(ROOT / "build" / "ab" / label / f"lib{LIB}.so"))
        for fn_name, argtypes in dict(_build.SIGNATURES[LIB],
                                      **OLD_SIGNATURES).items():
            if hasattr(dll, fn_name):
                fn = getattr(dll, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        dlls[label] = dll
    return dlls


def launcher(torch, lib, probe, x, layout):
    """A callable that launches `probe` once over x from one tree's
    library in `layout` (an older tree: its one launch) and returns the
    output."""
    from fabric_tpu_torch.ops import isa_probe as IP
    fc_bits = struct.unpack("<i", struct.pack("<f", IP.F_FACTOR))[0]
    consts = (IP.C_MUL, IP.MASK20, IP.MASK12, IP.SHIFT, IP.THRESHOLD,
              fc_bits)
    B = x.shape[1]

    def run():
        out = torch.empty_like(x)
        stream = _P(torch.cuda.current_stream(x.device).cuda_stream)
        if hasattr(lib, "isa_probe_layout_launch"):
            rc = lib.isa_probe_layout_launch(
                IP.PROBE_ID[probe], IP.LAYOUT_ID[layout], x.data_ptr(),
                out.data_ptr(), B, IP.ITERS, *consts, stream)
        else:
            rc = lib.isa_probe_launch(IP.PROBE_ID[probe], x.data_ptr(),
                                      out.data_ptr(), B, IP.ITERS, *consts,
                                      stream)
        if rc:
            raise SystemExit(f"FAILED: {probe} {layout} B={B} launch: "
                             f"CUDA error {rc}")
        return out
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="label=csrc directory (repeat)")
    ap.add_argument("--order", required=True,
                    help="labels in the order they are timed, e.g. "
                    "parent,change,change,parent")
    ap.add_argument("--layouts", default="auto",
                    help="layouts a layout tree runs each probe in, e.g. "
                    "auto,column or all")
    ap.add_argument("--lanes", default="16384,fill",
                    help="B of every probe; 'fill' is SMs x 2,048")
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--launches", type=int, default=100)
    args = ap.parse_args(argv)
    srcs = dict(s.split("=", 1) for s in args.src)
    order = args.order.split(",")
    if not set(order) <= set(srcs):
        raise SystemExit("FAILED: --order names a label without --src")

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is False")
    from fabric_tpu_torch import experiments as X
    from fabric_tpu_torch.experiments import proto_pallas3 as P3
    from fabric_tpu_torch.ops import field as F
    from fabric_tpu_torch.ops import isa_probe as IP

    print(smi("name,power.limit"), flush=True)
    libs = build(srcs)
    dev = torch.device("cuda")
    sms = F.sm_count(dev)
    cd = X.card(dev)
    lane_counts = [sms * F.FILL_THREADS_PER_SM if c == "fill" else int(c)
                   for c in args.lanes.split(",")]
    inputs, plains = {}, {}
    for lanes in lane_counts:
        inputs[lanes] = P3.probe_inputs(lanes, dev)
        for probe in IP.PROBES:
            x = inputs[lanes]["f32" if probe == "f32" else "int32"]
            plains[probe, lanes] = IP.probe_plain(x, probe).view(torch.int32)
    torch.cuda.synchronize()

    def layouts(label, probe, lanes):
        if not hasattr(libs[label], "isa_probe_layout_launch"):
            return ["column"]
        want = args.layouts.split(",")
        if "all" in want:
            return list(IP.PROBE_LAYOUTS[probe])
        out = []
        for lay in want:
            lay = IP.probe_plan(probe, lanes, sms)[0] if lay == "auto" else lay
            if lay in IP.PROBE_LAYOUTS[probe] and lay not in out:
                out.append(lay)
        return out

    def time_it(fn):
        return X.launch_ms(fn, args.launches, args.trials)

    times = {label: {} for label in srcs}
    library = {}
    for turn, label in enumerate(order):
        row = {"label": label, "turn": turn}
        for lanes in lane_counts:
            for probe in IP.PROBES:
                x = inputs[lanes]["f32" if probe == "f32" else "int32"]
                for lay in layouts(label, probe, lanes):
                    run = launcher(torch, libs[label], probe, x, lay)
                    key = f"{probe} B={lanes} {lay}"
                    if not torch.equal(run().view(torch.int32),
                                       plains[probe, lanes]):
                        raise SystemExit(f"FAILED: {label} {key} != plain")
                    ms = time_it(run)
                    times[label].setdefault(key, []).append(ms)
                    row[key] = round(ms, 5)
                lib_call = P3.library_call(x, probe)
                if lib_call is not None:
                    if not torch.equal(lib_call(), plains[probe, lanes]):
                        raise SystemExit(f"FAILED: torch.roll != {probe}")
                    library.setdefault(f"{probe} B={lanes}", []).append(
                        time_it(lib_call))
        print(json.dumps(row), flush=True)
    print(smi("name,power.limit"), flush=True)
    med = {}
    for label, t in times.items():
        med[label] = {}
        for name, v in t.items():
            probe = name.split()[0]
            lanes = int(re.search(r"B=(\d+)", name).group(1))
            bound, by = IP.bound_ms(probe, lanes, IP.ITERS, cd["issue_rate"],
                                    cd["hbm_bytes_per_s"])
            ms = statistics.median(v)
            med[label][name] = {"ms": round(ms, 5),
                                "bound_ms": round(bound, 5), "bound_by": by,
                                "bound_share": round(bound / ms, 3)}
    print(json.dumps({"medians": med, "torch_roll_ms": {
        k: round(statistics.median(v), 5) for k, v in library.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
