"""Counterpart of experiments/proto_pallas.py (`run`, :94): its CIOS chain
of n = NMUL x NITER = 192 multiplies on (22, 16384), as KP1 at the
reference's R (`field.field_mul_chain(..., r_log2=264)`, one thread a
lane, 128 a block), beside KF2's `exact` control: the same chain with its
multiply inlined in registers."""

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
           "threads": 128, "tpu_tiles": (TILE,), "B": B, "n": n,
           "vs_plain": f"equal on {ref.plain.shape[0]} lanes",
           "vs_ints": f"equal on {len(ref.ints)} lanes",
           "plain_ms": ref.plain_ms}
    if dev.type == "cuda":
        row.update(chain_times(dev, launch, B, n, trials))
        # KP1's loop calls the header's non-inlined mont_mul<M>, one
        # subroutine per modulus (one multiply is one call); mod p (-p^-1
        # = 1 mod 2^32, no multiply for q) it is the smallest of the four
        counts = sass_counts("field_chain", "field_mul_chain_kernel")
        called = counts["called"] if counts else []
        row.update(sass_per_mul(
            min(called, key=lambda c: c["instructions"]) if called
            else None, 1))
    else:
        row.update(no_times())
    res = chain_sweep(SCRIPT, n, [("exact", None, TILE)], dev, trials, B)
    res["configs"].insert(0, row)
    return res
