"""Counterpart of experiments/proto_ilp.py (`bench.run`, :72): K
independent chains interleaved per lane, as KF2's `ilp` preset, over the
script's (tile, K) grid (:115-116).  Chain k of thread j is lane
k * (B / K) + j, the lane order of the script's .reshape(L, K, B // K).
n = NMUL x NITER = 96."""

from __future__ import annotations

from . import REF_B, chain_sweep

NMUL, NITER = 24, 4
GRID = ((128, 1), (128, 4), (128, 8), (256, 4), (256, 2), (512, 4),
        (1024, 4), (2048, 4))
SCRIPT = "experiments/proto_ilp.py"


def run(device=None, trials: int = 5, B: int = REF_B) -> dict:
    grid = [("ilp", k, tile) for tile, k in GRID]
    return chain_sweep(SCRIPT, NMUL * NITER, grid, device, trials, B)
