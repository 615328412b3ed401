"""The port's admin and discover command-line clients
(fabric_tpu_torch.node.admin, fabric_tpu_torch.scc.discover) and the
orderer's channel participation (runtime join, the participation REST
routes, onboarding replication) on the port's nodes, on the CPU.

Every test function of tests/test_admin_cli.py and
tests/test_participation.py runs as one case of
`test_reference_scenario`, its source rewritten by tests/ref_scenarios.py
so that the CLIs, `OrdererNode`, `PeerNode` and the provisioning are the
port's (fabric_tpu_torch), every provisioned node on `"bccsp": "SW"`
(`node_world.on_port`).  Left out:
`test_participation.py::test_multichannel_peer_two_channels_one_process`,
which waits on wall-clock deadlines and flakes under xdist on the
reference too (ROADMAP C10).
"""
import pytest

from node_world import on_port, sw_defaults
from ref_scenarios import run_scenario, scenario_module, scenario_names

C10 = ("test_multichannel_peer_two_channels_one_process",)
REF_FILES = ("test_admin_cli", "test_participation")
RUNS = [(f, t) for f in REF_FILES for t in scenario_names(f, skip=C10)]


@pytest.fixture(scope="module", autouse=True)
def _sw():
    sw_defaults()


@pytest.mark.parametrize("case,name", RUNS,
                         ids=[f"{f}::{t}" for f, t in RUNS])
def test_reference_scenario(case, name, request):
    run_scenario(scenario_module(case, "fabric_tpu_torch", edit=on_port),
                 name, request)
