"""Ops surface for the byzantine plane: `GET /byzantine`.

One route aggregates the node-scoped quarantine registry and every
channel monitor's witness/fraud-proof view.

Counterpart of `fabric_tpu/byzantine/ops.py`, the same code on the
port's imports, mounted on the port's `ops_plane.OperationsServer`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


def byzantine_view(quarantine,
                   monitors: Optional[Dict[str, object]] = None) -> dict:
    """The `/byzantine` response body (also used by tests directly)."""
    body = {
        "quarantined": quarantine.count(),
        "reasons": quarantine.reasons(),
        "identities": quarantine.snapshot(),
        "pardons": quarantine.pardon_count(),
    }
    if monitors:
        channels = {}
        proofs = []
        pardons = []
        for cid, mon in sorted(monitors.items()):
            channels[cid] = mon.snapshot()
            proofs.extend(mon.proofs)
            pardons.extend(getattr(mon, "pardons", []))
        body["channels"] = channels
        body["fraud_proofs"] = proofs
        body["pardon_records"] = pardons
    return body


def register_ops(ops, quarantine,
                 monitors_fn: Optional[Callable[[], Dict[str, object]]]
                 = None) -> None:
    """Mount `GET /byzantine` on an ops server.  `monitors_fn` is called
    per request so channels joined after startup are included."""
    if ops is None:
        return

    def _get(path, body):
        mons = monitors_fn() if monitors_fn is not None else None
        return 200, byzantine_view(quarantine, mons)

    ops.register_route("GET", "/byzantine", _get)
