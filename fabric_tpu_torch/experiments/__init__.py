"""Counterparts, on the card, of the JAX package's Pallas microbenchmarks
in `experiments/`: one module per script, each with
`run(device=None, trials=5, B=16384) -> dict`.

Each `run` repeats its script's sweep at the script's own n (NMUL x
NITER), K and tile grid, on the script's data: `np.random.default_rng(0)`,
B values `int.from_bytes(rng.bytes(32), "big") % p`, a = vals and
b = vals[::-1].  A TPU tile of t lanes becomes min(t, 512) threads a block
(a block of the card holds at most 1,024 threads and these kernels keep
everything in registers), and every preset also runs at 128 threads
and, on the card, at the launch plan's block (`field.group_plan`: at
most 128 threads, halved while the grid has fewer blocks than SMs) where
no configuration runs that block already (`threads` None); the row whose
launch is the plan's has `plan` true.  It
holds each kernel's output against the plain version on the first 16,384
lanes and against Python ints on 64 lanes, raising on any difference,
then times each launch with CUDA events and reports, per configuration:
ms, ns per multiply per lane, SM-cycles per multiply (time x the SMs' top
clock x SMs / (B n)), the least-work bound (128 multiply-adds a multiply
at 64 per SM per clock: 2 SM-cycles) and its share of the time, registers
and stack frame, SASS instructions per multiply where the toolkit has
`cuobjdump`, and one warp's cycles per multiply from the kernel's
clock64 build, alone on the card (one warp, 32 K / TPI lanes) and
inside the full launch, with the SM clock that warp ran at (clock64
cycles over globaltimer ns), and the threads a lane (TPI) and block size
each ran at.

Entry points run on CUDA unless given `device="cpu"`; on the CPU the
wrappers take their plain versions, the checks run, and no time is
reported (every time field is None).  Nothing runs at import.
"""

from __future__ import annotations

import collections
import functools
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _build, field
from ..ops import field_variants as FV

REF_B = 16_384
CHECK_LANES = 16_384
INT_LANES = 64
MAX_THREADS = 512
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
INT32_PER_SM_PER_CLOCK = 64
ISSUE_PER_SM_PER_CLOCK = 128
LAUNCHES = 100                     # launch_ms's launches a replay
P = field.P


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def _smi(fields: str, index: int) -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), f"--query-gpu={fields}",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


@functools.lru_cache(maxsize=None)
def card(dev: torch.device) -> dict:
    """The card's name, name and power limit (nvidia-smi), SMs, top SM
    clock and the rates the bounds use; {"device": "cpu"} on the CPU."""
    if dev.type != "cuda":
        return {"device": str(dev)}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    mhz = float(_smi("clocks.max.sm", index).split()[0])
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return {"device": str(dev), "name": torch.cuda.get_device_name(index),
            "name_power": _smi("name,power.limit", index), "sms": sms,
            "max_sm_mhz": mhz,
            "int32_rate": INT32_PER_SM_PER_CLOCK * sms * mhz * 1e6,
            "issue_rate": ISSUE_PER_SM_PER_CLOCK * sms * mhz * 1e6,
            "hbm_bytes_per_s": HBM_BYTES_PER_S}


def event_ms(fn, trials: int) -> float:
    """Median device ms of one fn() by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def _launch_counters() -> list:
    """Every kernel wrapper of the port's loaded ops modules that counts
    its launches (a `launches` attribute)."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if name.startswith("fabric_tpu_torch.ops.") and mod is not None:
            for v in vars(mod).values():
                if callable(v) and isinstance(getattr(v, "launches", None),
                                              int):
                    out[id(v)] = v
    return list(out.values())


def launch_ms(fn, launches: int = LAUNCHES, trials: int = 5) -> float:
    """Median device ms of one fn() as the card runs it, without the
    host's enqueue: after one warm-up, `launches` calls of fn are
    captured in a CUDA graph, and each of `trials` replays is timed by
    CUDA events around it and divided by `launches`.  fn launches on the
    current stream (the capture's inside the capture) and allocates only
    through PyTorch.  Timing launches do not count: every wrapper's launch
    count is left as it was before the call.  Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("launch_ms needs a CUDA card: "
                           "torch.cuda.is_available() is False")
    if launches < 1:
        raise ValueError("launches must be at least 1")
    counts = [(f, f.launches) for f in _launch_counters()]
    try:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
    finally:
        for f, n in counts:
            f.launches = n
    graph.replay()                 # the first replay uploads the graph
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / launches)
    return statistics.median(out)


def timed_once(dev: torch.device, fn):
    """(fn(), its synchronised wall ms on CUDA, None elsewhere)."""
    if dev.type != "cuda":
        return fn(), None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# the scripts' data and the reference values
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def seeded_ints(B: int) -> tuple:
    """The scripts' values: rng = default_rng(0), B draws of 32 bytes,
    big-endian, mod p."""
    rng = np.random.default_rng(0)
    return tuple(int.from_bytes(rng.bytes(32), "big") % P for _ in range(B))


def _words(vals) -> torch.Tensor:
    raw = b"".join(v.to_bytes(32, "little") for v in vals)
    arr = np.frombuffer(raw, dtype="<u4").reshape(len(vals), 8)
    return torch.from_numpy(arr.view(np.int32).copy()).view(torch.uint32)


@functools.lru_cache(maxsize=4)
def operands(B: int, dev: torch.device) -> tuple:
    """(a, b) as (B, 8) uint32 lanes on dev: a = vals, b = vals[::-1]."""
    vals = seeded_ints(B)
    return _words(vals).to(dev), _words(vals[::-1]).to(dev)


@dataclass(frozen=True)
class Reference:
    plain: torch.Tensor      # the plain version on the first CHECK lanes
    ints: tuple              # Python ints on the first INT_LANES lanes
    plain_ms: float | None   # the plain version's one call, on CUDA


def chain_ints(B: int, n: int, lanes: int = INT_LANES) -> tuple:
    """a * (b * 2^-264)^n mod p on the first lanes, in Python ints."""
    vals = seeded_ints(B)
    rinv = pow(1 << 264, -1, P)
    return tuple(x * pow(y * rinv % P, n, P) % P
                 for x, y in zip(vals[:lanes], vals[::-1][:lanes]))


@functools.lru_cache(maxsize=8)
def reference(B: int, n: int, dev: torch.device) -> Reference:
    """The plain version on the first CHECK_LANES lanes (timed once on
    CUDA), held against Python ints on INT_LANES lanes."""
    a, b = operands(B, dev)
    c = min(B, CHECK_LANES)
    plain, ms = timed_once(dev, lambda: field.mul_chain_plain(
        a[:c], b[:c], n, "p", r_log2=264))
    ints = chain_ints(B, n, min(c, INT_LANES))
    if tuple(field.words_le_to_ints(plain[:len(ints)])) != ints:
        raise RuntimeError(f"mul_chain_plain (r_log2=264, n={n}) != "
                           "Python ints")
    return Reference(plain, ints, ms)


def check_chain(out: torch.Tensor, ref: Reference, what: str) -> None:
    """A chain's (B, 8) output against the plain version and the ints."""
    c = ref.plain.shape[0]
    if not torch.equal(out[:c], ref.plain):
        raise RuntimeError(f"{what} != plain version on {c} lanes")
    got = field.words_le_to_ints(out[:len(ref.ints)])
    if tuple(got) != ref.ints:
        raise RuntimeError(f"{what} != Python ints on {len(ref.ints)} lanes")


# ---------------------------------------------------------------------------
# SASS
# ---------------------------------------------------------------------------

def _cuobjdump() -> str | None:
    for cand in (shutil.which("cuobjdump"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "cuobjdump")):
        if cand and os.path.isfile(cand):
            return cand
    return None


_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


@functools.lru_cache(maxsize=None)
def sass_functions(lib: str) -> dict | None:
    """`cuobjdump -sass` of build/kernels/lib<lib>.so -> {function:
    [(address, instruction), ...]}, or None without cuobjdump."""
    tool = _cuobjdump()
    if tool is None or not _build.lib_path(lib).exists():
        return None
    res = subprocess.run([tool, "-sass", str(_build.lib_path(lib))],
                         capture_output=True, text=True, timeout=300)
    if res.returncode:
        return None
    funcs, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def sass_per_mul(counts: dict | None, muls: float) -> dict:
    """A span's counts as SASS figures a multiply (muls in the span: a
    thread's K chains over its TPI threads a lane, K / TPI)."""
    if counts is None:
        return dict.fromkeys(("sass_per_mul", "sass_imads_per_mul",
                              "sass_local_per_mul", "sass_top_ops"))
    return {"sass_per_mul": counts["instructions"] / muls,
            "sass_imads_per_mul": counts["imads"] / muls,
            "sass_local_per_mul": counts["local"] / muls,
            "sass_top_ops": {op: n / muls for op, n in counts["top"]}}


def _opcode(instr: str) -> str:
    parts = instr.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def _is_imad(op: str) -> bool:
    return op.startswith("IMAD") and not op.startswith("IMAD.MOV")


def _span_counts(span: list) -> dict:
    ops = [_opcode(i) for i in span]
    top = collections.Counter(ops).most_common(4)
    return {"instructions": len(ops), "imads": sum(map(_is_imad, ops)),
            "local": sum(o.startswith(("LDL", "STL")) for o in ops),
            "top": top}


def sass_counts(lib: str, fragment: str) -> dict | None:
    """Instruction counts of the largest loop (the instructions from a
    backward branch's target to the branch) of the function whose name
    holds `fragment`: instructions, multiply-adds (IMAD*, not IMAD.MOV),
    local-memory accesses and the four commonest opcodes; None without
    cuobjdump or a match."""
    funcs = sass_functions(lib)
    if not funcs:
        return None
    names = [f for f in funcs if fragment in f]
    if len(names) != 1:
        return None
    code = [(a, i) for a, i in funcs[names[0]] if _opcode(i) != "NOP"]
    loop = []
    for addr, instr in code:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", instr)
        if m and int(m.group(1), 16) < addr:
            span = [i for a, i in code if int(m.group(1), 16) <= a <= addr]
            if len(span) > len(loop):
                loop = span
    return {"loop": _span_counts(loop)}


# ---------------------------------------------------------------------------
# the KF2 sweep every chain script shares
# ---------------------------------------------------------------------------

def plan(grid) -> list:
    """The script's (preset, K, TPU tile) grid -> [(preset, K, threads,
    tiles)]: each tile mapped to threads, every preset also at 128, in
    the grid's order, each (preset, K, threads) once with the tiles it
    stands for."""
    out: dict = {}
    for preset, k, tile in grid:
        out.setdefault((preset, k, min(tile, MAX_THREADS)), []).append(tile)
    for preset, k, _ in grid:
        out.setdefault((preset, k, 128), [])
    return [(p, k, t, tuple(tiles)) for (p, k, t), tiles in out.items()]


def with_plan(configs: list, B: int, dev: torch.device) -> list:
    """plan()'s configurations plus, for each (preset, K), the launch
    plan's block (`field_variants.variant_plan`) at B lanes where no
    configuration runs that block already (threads None)."""
    have = {(p, k, t) for p, k, t, _ in configs}
    out = list(configs)
    for preset, k in dict.fromkeys((p, k) for p, k, _, _ in configs):
        if (preset, k, FV.variant_plan(preset, k, B, dev)[1]) not in have:
            out.append((preset, k, None, ()))
    return out


def chain_times(dev: torch.device, fn, B: int, n: int, trials: int) -> dict:
    """ms and the per-multiply figures of one chain launch fn()."""
    c = card(dev)
    bound, by = FV.bound_ms(B, n, c["int32_rate"], c["hbm_bytes_per_s"])
    ms = event_ms(fn, trials)
    return {"ms": ms, "ns_per_mul": ms * 1e6 / (B * n),
            "sm_cycles_per_mul": ms * 1e-3 * c["max_sm_mhz"] * 1e6
            * c["sms"] / (B * n),
            "bound_ms": bound, "bound_by": by, "bound_share": bound / ms}


def no_times() -> dict:
    return dict.fromkeys(("ms", "ns_per_mul", "sm_cycles_per_mul",
                          "bound_ms", "bound_by", "bound_share"))


def clock_cycles(dev, a, b, n, preset, k, threads, tpi, B) -> dict:
    """One warp's cycles per multiply from the clock64 build at tpi
    threads a lane, alone (one warp: 32 K / TPI lanes, which the plan
    runs as one block of 32 threads) and inside the full launch
    (`threads` a block), and the SM clock it ran at (its cycles over
    globaltimer's nanoseconds for the same chain)."""
    v = FV.variant_of(preset, k)
    clk = torch.zeros(2, dtype=torch.int64, device=dev)
    out = {}
    for what, lanes, block in (("alone", 32 * v.k // tpi, None),
                               ("loaded", B, threads)):
        x, y = a[:lanes], b[:lanes]
        if v.planes:
            x, y = FV.to_planes(x), FV.to_planes(y)
        FV.field_chain_variant(x, y, n, preset, k, block, clock=clk,
                               tpi=tpi)
        cycles, ns = clk.tolist()
        out[f"clock_cycles_per_mul_{what}"] = cycles / (n * v.k)
        out[f"sm_mhz_{what}"] = cycles / ns * 1e3 if ns > 0 else None
    return out


def chain_sweep(script: str, n: int, grid, device=None, trials: int = 5,
                B: int = REF_B) -> dict:
    """Run every configuration of a script's grid through KF2 on the
    script's data, check each, and time it on CUDA."""
    dev = resolve_device(device)
    a, b = operands(B, dev)
    ref = reference(B, n, dev)
    rows = []
    configs = plan(grid)
    if dev.type == "cuda":
        configs = with_plan(configs, B, dev)
    for preset, k, threads, tiles in configs:
        v = FV.variant_of(preset, k)
        x, y = (FV.to_planes(a), FV.to_planes(b)) if v.planes else (a, b)

        def launch(x=x, y=y, preset=preset, k=k, threads=threads):
            return FV.field_chain_variant(x, y, n, preset, k, threads)

        out = launch()
        what = f"{script} {preset} K={v.k} threads={threads} B={B}"
        check_chain(FV.from_planes(out) if v.planes else out, ref, what)
        row = {"preset": preset, "variant": v.name, "k": v.k,
               "threads": threads, "tpu_tiles": tiles, "B": B, "n": n,
               "vs_plain": f"equal on {ref.plain.shape[0]} lanes",
               "vs_ints": f"equal on {len(ref.ints)} lanes",
               "plain_ms": ref.plain_ms}
        if dev.type == "cuda":
            tpi, block, _ = FV.variant_plan(preset, k, B, dev, threads)
            row.update(tpi=tpi, block_threads=block, plan=block == (
                FV.variant_plan(preset, k, B, dev)[1]))
            row.update(chain_times(dev, launch, B, n, trials))
            row.update(clock_cycles(dev, a, b, n, preset, k, threads, tpi,
                                    B))
            row.update(FV.kernel_attrs(preset, k, tpi=tpi))
            # the loop is one thread's share: K multiplies, each of them
            # spread over TPI threads
            counts = sass_counts("field_chain_variants",
                                 FV.kernel_symbol(preset, k, tpi=tpi))
            row.update(sass_per_mul(None if counts is None
                                    else counts["loop"], v.k / tpi))
        else:
            row.update(tpi=None, block_threads=None, plan=None)
            row.update(no_times())
        rows.append(row)
    return {"script": script, "B": B, "n": n, "card": card(dev),
            "configs": rows}
