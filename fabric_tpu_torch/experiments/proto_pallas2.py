"""Counterpart of experiments/proto_pallas2.py: `run` (:71), the chain on
relaxed limbs with an unshifted accumulator, as KF2's `relaxed` preset;
`run_k` (:127), K = 4 independent multiplies stacked per step, as
`stacked`.  n = NMUL x NITER = 192 on B = 16384 lanes, tile 512."""

from __future__ import annotations

from . import REF_B, chain_sweep

NMUL, NITER = 24, 8
B_TILE = 512
SCRIPT = "experiments/proto_pallas2.py"


def run(device=None, trials: int = 5, B: int = REF_B) -> dict:
    grid = [("relaxed", None, B_TILE), ("stacked", None, B_TILE)]
    return chain_sweep(SCRIPT, NMUL * NITER, grid, device, trials, B)
