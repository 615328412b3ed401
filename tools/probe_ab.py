#!/usr/bin/env python3
"""Same-card A/B timing of KP2's field probe (`p256_field_probe`, in
`fabric_tpu_torch/ops/csrc/p256_verify.cu`) built from several source
trees of fabric_tpu_torch/ops/csrc (say the parent commit's and this
one's), in turns within one run.

    python3 tools/probe_ab.py --src parent=.cache/parent/fabric_tpu_torch/ops/csrc \\
        --src change=fabric_tpu_torch/ops/csrc --order parent,change,change,parent

It builds each tree's `p256_verify.cu` with nvcc (the flags of
ops/_build.py, every build started at once) into build/ab/<label>/ and
prints ptxas' registers, frame and spills of every probe kernel.  Each
op (mul_p, sqr_p, mul_n, mul_25519) runs at 65,536 lanes (the phase-3
size of chip_smoke.py) and at a card-filling SMs x 2,048, on
`field_probe_edges` first and seeded values after.  A tree with the plan
launch (`p256_field_probe_plan_launch`) runs each op in
`p256.field_probe_plan`'s blocks; an older tree runs its one launch
(`p256_field_probe_launch`, one thread a lane).  Every output is held
against the plain version (`field_probe_plain`, computed once an op and
size on the card), then timed in the turns of --order by
`experiments.launch_ms` (--launches launches captured in a CUDA graph,
median of --trials replays, each over the count): "warm" on one copy of
the inputs, which the replays keep in the L2 cache, and with --cold also
"cold", the launches rotating over copies of the inputs that hold at
least twice the L2, so that each launch reads them from device memory.
Prints the card's name and power limit, one JSON line per label and
turn, and last one JSON line of medians by label, op, lanes and warm or
cold, with each op's bound (bytes or 32-bit multiply-adds,
`p256.field_probe_bound_ms`) and its share.  Needs
one CUDA card and nvcc; imports nothing of JAX."""

from __future__ import annotations

import argparse
import ctypes
import json
import random
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LIB = "p256_verify"
_P, _I = ctypes.c_void_p, ctypes.c_int
# an older tree's C entry (one generic kernel, one thread a lane)
OLD_SIGNATURES = {
    "p256_field_probe_launch": [_I, _P, _P, _P, _I, _P],
}


def smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={fields}",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def build(srcs: dict) -> dict:
    """{label: csrc dir} -> {label: ctypes.CDLL}, printing the probe
    kernels' ptxas figures."""
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
                r"Compiling entry function '([^']*field_probe[^']*)'", log))):
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


def launcher(torch, lib, op, copies):
    """A callable that launches `op` once from one tree's library (an
    older tree: its one launch) and returns the output; call k reads
    copy k mod len(copies) of the inputs, [(a, b), ...]."""
    from fabric_tpu_torch.ops import p256
    op_id = p256.FIELD_PROBE_OPS.index(op)
    n = copies[0][0].shape[0]
    turn = [0]

    def run():
        a, b = copies[turn[0] % len(copies)]
        turn[0] += 1
        bb = a if b is None else b
        out = torch.empty_like(a)
        stream = _P(torch.cuda.current_stream(a.device).cuda_stream)
        if hasattr(lib, "p256_field_probe_plan_launch"):
            rc = lib.p256_field_probe_plan_launch(
                op_id, p256.field_probe_plan(n), a.data_ptr(),
                bb.data_ptr(), out.data_ptr(), n, stream)
        else:
            rc = lib.p256_field_probe_launch(op_id, a.data_ptr(),
                                             bb.data_ptr(), out.data_ptr(),
                                             n, stream)
        if rc:
            raise SystemExit(f"FAILED: {op} n={n} launch: CUDA error {rc}")
        return out
    return run


def probe_inputs(torch, op: str, n: int, dev, seed: int) -> tuple:
    """(a, b or None) on dev: the op's edge values, then seeded ones
    within its preconditions."""
    from fabric_tpu_torch.ops import p256
    from fabric_tpu_torch.ops.field import ints_to_words_le
    rng = random.Random(seed)
    m = p256.field_probe_modulus(op)
    ea, eb = p256.field_probe_edges(op)
    k = n - len(ea)
    va = ea + [rng.randrange(m if op == "sqr_p" else 1 << 256)
               for _ in range(k)]
    vb = eb + [rng.randrange(m) for _ in range(k)]
    a = ints_to_words_le(va, dev)
    return a, None if op == "sqr_p" else ints_to_words_le(vb, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="label=csrc directory (repeat)")
    ap.add_argument("--order", required=True,
                    help="labels in the order they are timed, e.g. "
                    "parent,change,change,parent")
    ap.add_argument("--lanes", default="65536,fill",
                    help="lanes of every op; 'fill' is SMs x 2,048")
    ap.add_argument("--cold", action="store_true",
                    help="also time each op with its inputs rotated over "
                    "copies of at least twice the card's L2, "
                    "so that each launch reads them from device memory")
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
    from fabric_tpu_torch.ops import field as F
    from fabric_tpu_torch.ops import p256

    print(smi("name,power.limit"), flush=True)
    libs = build(srcs)
    dev = torch.device("cuda")
    sms = F.sm_count(dev)
    cd = X.card(dev)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    lane_counts = [sms * F.FILL_THREADS_PER_SM if c == "fill" else int(c)
                   for c in args.lanes.split(",")]
    inputs, plains = {}, {}
    for lanes in lane_counts:
        for k, op in enumerate(p256.FIELD_PROBE_OPS):
            a, b = probe_inputs(torch, op, lanes, dev, 40 + k)
            inputs[op, lanes] = [(a, b)]
            plains[op, lanes] = p256.field_probe_plain(op, a, b)
            if args.cold:
                per = a.numel() * 4 * (1 if b is None else 2)
                inputs[op, lanes, "cold"] = [
                    (a.clone(), None if b is None else b.clone())
                    for _ in range(max(2, -(-2 * l2 // per)))]
    torch.cuda.synchronize()

    times = {label: {} for label in srcs}
    for turn, label in enumerate(order):
        row = {"label": label, "turn": turn}
        for lanes in lane_counts:
            for op in p256.FIELD_PROBE_OPS:
                for temp in ("warm", "cold") if args.cold else ("warm",):
                    copies = inputs[(op, lanes) + (() if temp == "warm"
                                                   else ("cold",))]
                    run = launcher(torch, libs[label], op, copies)
                    key = f"{op} n={lanes} {temp}"
                    for _ in copies:
                        if not torch.equal(run(), plains[op, lanes]):
                            raise SystemExit(f"FAILED: {label} {key} "
                                             "!= plain")
                    ms = X.launch_ms(run, args.launches, args.trials)
                    times[label].setdefault(key, []).append(ms)
                    row[key] = round(ms, 5)
        print(json.dumps(row), flush=True)
    print(smi("name,power.limit"), flush=True)
    med = {}
    for label, t in times.items():
        med[label] = {}
        for name, v in t.items():
            op = name.split()[0]
            lanes = int(re.search(r"n=(\d+)", name).group(1))
            bound, by = p256.field_probe_bound_ms(
                op, lanes, cd["int32_rate"], cd["hbm_bytes_per_s"])
            ms = statistics.median(v)
            med[label][name] = {"ms": round(ms, 5),
                                "bound_ms": round(bound, 5), "bound_by": by,
                                "bound_share": round(bound / ms, 3)}
    print(json.dumps({"medians": med}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
