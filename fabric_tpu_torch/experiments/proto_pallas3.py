"""Counterpart of experiments/proto_pallas3.py: the seven int32 primitive
probes (`bench.run`, :23) and the f32 one (`bench_f32.run`, :115), as
KI3 (`ops.isa_probe`), on the script's data: (22, B) int32
`default_rng(0).integers(0, 4096)` and f32 `default_rng(0).random`.  Each
probe is held bit for bit against its plain version, at the script's 4
passes and at 1 (where the f32 values are still normal numbers), on the
first 16,384 columns, in the plan's layout (`isa_probe.probe_plan`) or a
forced one; then it is timed, and reported as the script prints it: ns
per op (one step of its body over the tile) and lane-ops/s (f32 counts
its two operations a step).  `ms` is the time of one launch as the card
runs it (`launch_ms`: launches captured in a CUDA graph), and
`single_launch_ms` the time of one wrapper call between two events
(`event_ms`, the host's enqueue inside it); rotate and roll also carry
the time of `torch.roll` on the same tile by the same timer
(`library_ms`), which computes the same function."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import field
from ..ops import isa_probe as IP
from . import (CHECK_LANES, LAUNCHES, REF_B, card, event_ms, launch_ms,
               sass_counts, timed_once)

SCRIPT = "experiments/proto_pallas3.py"
# the rows a pass moves rotate and roll by, as one torch.roll
ROLL_SIGN = {"rotate": -1, "roll": 1}


def probe_inputs(B: int, dev: torch.device) -> dict:
    """The script's tiles: each bench draws from a fresh default_rng(0)."""
    ints = np.random.default_rng(0).integers(0, 4096, (IP.L, B))
    reals = np.random.default_rng(0).random((IP.L, B))
    return {"int32": torch.from_numpy(ints.astype(np.int32)).to(dev),
            "f32": torch.from_numpy(reals.astype(np.float32)).to(dev)}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def library_call(x: torch.Tensor, probe: str, iters: int = IP.ITERS):
    """The one PyTorch call that computes a probe's function, or None:
    `torch.roll` for rotate and roll."""
    if probe not in ROLL_SIGN:
        return None
    return lambda: torch.roll(x, ROLL_SIGN[probe] * IP.REP * iters, 0)


def run(device=None, trials: int = 5, B: int = REF_B,
        layout: str | None = None) -> dict:
    """Every probe checked and, on CUDA, timed; `layout` None takes the
    plan's layout for each probe, else the one forced on every probe
    (each must have it: "column" is every probe's)."""
    dev = resolve_device(device)
    xs = probe_inputs(B, dev)
    c = min(B, CHECK_LANES)
    rows = []
    for probe in IP.PROBES:
        x = xs["f32" if probe == "f32" else "int32"]
        head = x[:, :c].contiguous()
        plain_ms = None
        for iters in (1, IP.ITERS):
            got = IP.isa_probe(x, probe, iters, layout)
            want, ms = timed_once(dev, lambda: IP.probe_plain(head, probe,
                                                              iters))
            if iters == IP.ITERS:
                plain_ms = ms
            if not torch.equal(_bits(got[:, :c].contiguous()), _bits(want)):
                raise RuntimeError(f"{SCRIPT} probe {probe} iters={iters} "
                                   f"B={B} layout={layout} != plain version")
        row = {"probe": probe, "replaces": IP.REPLACES[probe], "B": B,
               "iters": IP.ITERS, "steps": IP.STEPS[probe],
               "vs_plain": f"bit-exact on {c} columns, 1 and "
                           f"{IP.ITERS} passes", "plain_ms": plain_ms}
        lib = library_call(x, probe)
        if lib is not None and not torch.equal(lib(), got):
            raise RuntimeError(f"{SCRIPT} probe {probe} B={B} != torch.roll")
        if dev.type == "cuda":
            cd = card(dev)
            lay, threads, blocks = IP.probe_plan(probe, B,
                                                 field.sm_count(dev), layout)
            ms = launch_ms(lambda: IP.isa_probe(x, probe, IP.ITERS, layout),
                           trials=trials)
            single = event_ms(lambda: IP.isa_probe(x, probe, IP.ITERS,
                                                   layout), trials)
            steps = IP.ITERS * IP.STEPS[probe]
            per_step_ops = 2 if probe == "f32" else 1
            bound, by = IP.bound_ms(probe, B, IP.ITERS, cd["issue_rate"],
                                    cd["hbm_bytes_per_s"])
            counts = sass_counts("isa_probe", IP.kernel_symbol(probe, lay))
            row.update({
                "layout": lay, "body": IP.body_form(probe, lay),
                "threads": threads, "blocks": blocks,
                "ms": ms, "single_launch_ms": single,
                "launches_a_replay": LAUNCHES,
                "library_ms": None if lib is None else launch_ms(
                    lib, trials=trials),
                "ns_per_op": ms * 1e6 / steps,
                "lane_ops_per_s": IP.L * B * steps * per_step_ops
                / (ms * 1e-3),
                "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
                # SASS instructions of one pass, per element-step
                "sass_per_element_step": None if counts is None else
                counts["loop"]["instructions"]
                / (IP.STEPS[probe] * IP.values_per_thread(lay)),
                **IP.kernel_attrs(probe, lay)})
        else:
            row.update(dict.fromkeys((
                "layout", "body", "threads", "blocks", "ms",
                "single_launch_ms",
                "launches_a_replay", "library_ms", "ns_per_op",
                "lane_ops_per_s", "bound_ms", "bound_by", "bound_share")))
        rows.append(row)
    return {"script": SCRIPT, "B": B, "layout": layout, "card": card(dev),
            "probes": rows}
