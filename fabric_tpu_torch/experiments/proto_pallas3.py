"""Counterpart of experiments/proto_pallas3.py: the seven int32 primitive
probes (`bench.run`, :23) and the f32 one (`bench_f32.run`, :115), as
KI3 (`ops.isa_probe`), on the script's data: (22, B) int32
`default_rng(0).integers(0, 4096)` and f32 `default_rng(0).random`.  Each
probe is held bit for bit against its plain version, at the script's 4
passes and at 1 (where the f32 values are still normal numbers), on the
first 16,384 columns; then it is timed, and reported as the script prints
it: ns per op (one step of its body over the tile) and lane-ops/s (f32
counts its two operations a step)."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import isa_probe as IP
from . import CHECK_LANES, REF_B, card, event_ms, sass_counts, timed_once

SCRIPT = "experiments/proto_pallas3.py"


def probe_inputs(B: int, dev: torch.device) -> dict:
    """The script's tiles: each bench draws from a fresh default_rng(0)."""
    ints = np.random.default_rng(0).integers(0, 4096, (IP.L, B))
    reals = np.random.default_rng(0).random((IP.L, B))
    return {"int32": torch.from_numpy(ints.astype(np.int32)).to(dev),
            "f32": torch.from_numpy(reals.astype(np.float32)).to(dev)}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def run(device=None, trials: int = 5, B: int = REF_B) -> dict:
    dev = resolve_device(device)
    xs = probe_inputs(B, dev)
    c = min(B, CHECK_LANES)
    rows = []
    for probe in IP.PROBES:
        x = xs["f32" if probe == "f32" else "int32"]
        head = x[:, :c].contiguous()
        plain_ms = None
        for iters in (1, IP.ITERS):
            got = IP.isa_probe(x, probe, iters)
            want, ms = timed_once(dev, lambda: IP.probe_plain(head, probe,
                                                              iters))
            if iters == IP.ITERS:
                plain_ms = ms
            if not torch.equal(_bits(got[:, :c].contiguous()), _bits(want)):
                raise RuntimeError(f"{SCRIPT} probe {probe} iters={iters} "
                                   f"B={B} != plain version")
        row = {"probe": probe, "replaces": IP.REPLACES[probe], "B": B,
               "iters": IP.ITERS, "steps": IP.STEPS[probe],
               "vs_plain": f"bit-exact on {c} columns, 1 and "
                           f"{IP.ITERS} passes", "plain_ms": plain_ms}
        if dev.type == "cuda":
            cd = card(dev)
            ms = event_ms(lambda: IP.isa_probe(x, probe), trials)
            steps = IP.ITERS * IP.STEPS[probe]
            per_step_ops = 2 if probe == "f32" else 1
            bound, by = IP.bound_ms(probe, B, IP.ITERS, cd["issue_rate"],
                                    cd["hbm_bytes_per_s"])
            counts = sass_counts("isa_probe", IP.kernel_symbol(probe))
            row.update({
                "ms": ms, "ns_per_op": ms * 1e6 / steps,
                "lane_ops_per_s": IP.L * B * steps * per_step_ops
                / (ms * 1e-3),
                "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
                # SASS instructions of one pass, per element-step
                "sass_per_element_step": None if counts is None else
                counts["loop"]["instructions"] / (IP.STEPS[probe] * IP.L),
                **IP.kernel_attrs(probe)})
        else:
            row.update(dict.fromkeys(("ms", "ns_per_op", "lane_ops_per_s",
                                      "bound_ms", "bound_by",
                                      "bound_share")))
        rows.append(row)
    return {"script": SCRIPT, "B": B, "card": card(dev), "probes": rows}
