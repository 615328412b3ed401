"""Counterpart of experiments/proto_pallas.py (`run`, :94): its CIOS chain
of n = NMUL x NITER = 192 multiplies on (22, 16384), as KP1 at the
reference's R (`field.field_mul_chain(..., r_log2=264)`, TPI threads a
lane by `field.group_plan`, at most 128 a block), beside KF2's `exact`
control: the same function on KF2's generic reduction."""

from __future__ import annotations

from ..device import resolve_device
from ..ops import field
from . import (REF_B, chain_sweep, chain_times, check_chain, no_times,
               operands, reference, sass_counts, sass_per_mul)

NMUL, NITER = 24, 8
TILE = 512
SCRIPT = "experiments/proto_pallas.py"


def run(device=None, trials: int = 5, B: int = REF_B) -> dict:
    dev = resolve_device(device)
    n = NMUL * NITER
    a, b = operands(B, dev)
    ref = reference(B, n, dev)

    def launch():
        return field.field_mul_chain(a, b, n, "p", r_log2=264)

    check_chain(launch(), ref, f"KP1 (r_log2=264) B={B}")
    row = {"preset": "kp1", "variant": "field_mul_chain", "k": 1,
           "threads": None, "tpu_tiles": (TILE,), "B": B, "n": n,
           "vs_plain": f"equal on {ref.plain.shape[0]} lanes",
           "vs_ints": f"equal on {len(ref.ints)} lanes",
           "plain_ms": ref.plain_ms}
    if dev.type == "cuda":
        tpi, block, _ = field.kp1_plan(B, dev)
        row.update(tpi=tpi, block_threads=block, plan=True)
        row.update(chain_times(dev, launch, B, n, trials))
        # the chain's loop is one multiply, inline, spread over TPI
        # threads
        counts = sass_counts("field_chain", field.kp1_symbol("p", tpi))
        row.update(sass_per_mul(None if counts is None else counts["loop"],
                                1 / tpi))
    else:
        row.update(tpi=None, block_threads=None, plan=None)
        row.update(no_times())
    res = chain_sweep(SCRIPT, n, [("exact", None, TILE)], dev, trials, B)
    res["configs"].insert(0, row)
    return res
