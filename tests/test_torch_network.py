"""The reference's multi-process network drills on the port's node
binaries, on the CPU.

The two process-level tests of tests/test_network.py (the three-process
Raft cluster that survives a leader kill; the full topology of
orderers and peers that endorses, orders and commits with private data)
run on `python -m fabric_tpu_torch.node.orderer` and
`python -m fabric_tpu_torch.node.peer` (tests/ref_scenarios.py rewrites
the scenario's module names and imports to the port).  The children read
`FABRIC_TPU_ORDERER_BCCSP=SW` and `FABRIC_TPU_PEER_BCCSP=SW` through
`load_node_config`'s environment tier, so they run on the host.  Both
are marked `slow`, exactly as the reference marks its own.
"""
import pytest

from node_world import sw_defaults
from ref_scenarios import run_scenario, scenario_module

DRILLS = ("test_three_process_cluster_survives_leader_kill",
          "test_full_topology_endorse_order_commit_privdata")


@pytest.mark.slow
@pytest.mark.parametrize("name", DRILLS,
                         ids=[f"test_network::{t}" for t in DRILLS])
def test_reference_scenario(name, request, monkeypatch):
    sw_defaults()
    monkeypatch.setenv("FABRIC_TPU_ORDERER_BCCSP", "SW")
    monkeypatch.setenv("FABRIC_TPU_PEER_BCCSP", "SW")
    run_scenario(scenario_module("test_network", "fabric_tpu_torch"), name,
                 request)
