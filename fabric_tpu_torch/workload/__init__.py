"""Workload plane: open-loop, trace-driven load generation.

The measurement counterpart of the gateway's admission plane.  Closed-
loop drivers (examples/gateway_load.py) self-throttle under saturation
— offered load adapts to what the system sustains, so overload regimes
are unreachable by construction.  This package generates load the way
the world does: seeded arrival processes fire on a wall-clock schedule
regardless of completions (arrivals.py), a Zipf-skewed multi-channel
traffic mix makes MVCC conflict rate a dial (keyspace.py), and a large
client population multiplexes over a small socket pool with reconnect-
storm / cold-start scenarios (clients.py).  The WorkloadRunner
(runner.py) phases them into offered-vs-accepted-vs-committed reports
with sojourn percentiles; `python -m fabric_tpu_torch.workload` boots an
in-process network and runs a named scenario end to end.

Counterpart of `fabric_tpu/workload/__init__.py`, with the same
`__all__`.
"""

from fabric_tpu_torch.workload.arrivals import (
    ArrivalProcess,
    ConstantArrivals,
    DiurnalArrivals,
    OpenLoopScheduler,
    RampArrivals,
    SquareWaveArrivals,
    from_spec,
)
from fabric_tpu_torch.workload.clients import ClientPopulation, ThinkTimeModel
from fabric_tpu_torch.workload.keyspace import (
    Op,
    TrafficMix,
    ZipfSampler,
    expected_collision_p,
)
from fabric_tpu_torch.workload.runner import PhaseStats, WorkloadRunner, pct

__all__ = [
    "ArrivalProcess", "ClientPopulation", "ConstantArrivals",
    "DiurnalArrivals", "Op", "OpenLoopScheduler", "PhaseStats",
    "RampArrivals", "SquareWaveArrivals", "ThinkTimeModel", "TrafficMix",
    "WorkloadRunner", "ZipfSampler", "expected_collision_p", "from_spec",
    "pct",
]
