"""Counterpart of experiments/proto_planes.py (`run`, :74): the chain
over 22 limb planes of (8, 128), as KF2's `planes` preset, limb-major
(8, B) in device memory with coalesced loads and stores.  n = NMUL x
NITER = 96, tile 8 x 128 = 1024."""

from __future__ import annotations

from . import REF_B, chain_sweep

NMUL, NITER = 24, 4
TILE = 8 * 128
SCRIPT = "experiments/proto_planes.py"


def run(device=None, trials: int = 5, B: int = REF_B) -> dict:
    return chain_sweep(SCRIPT, NMUL * NITER, [("planes", None, TILE)],
                       device, trials, B)
