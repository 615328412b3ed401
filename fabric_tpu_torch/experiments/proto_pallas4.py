"""Counterpart of experiments/proto_pallas4.py (`make_runner(mul_v1).run`,
:70): the hand-minimised CIOS, as KF2's `min` preset (PTX carry chains,
a reduction from p's special form with no multiplies, operands in
registers), over the script's tiles 512 ... 8192 (:164-166).  n = NMUL x
NITER = 96.  The script's mul_v2 is a placeholder and its mul_v3 is
never run, so neither has a counterpart."""

from __future__ import annotations

from . import REF_B, chain_sweep

NMUL, NITER = 24, 4
TILES = (512, 1024, 2048, 4096, 8192)
SCRIPT = "experiments/proto_pallas4.py"


def run(device=None, trials: int = 5, B: int = REF_B) -> dict:
    grid = [("min", None, tile) for tile in TILES]
    return chain_sweep(SCRIPT, NMUL * NITER, grid, device, trials, B)
