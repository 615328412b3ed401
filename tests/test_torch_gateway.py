"""The reference's gateway, admission and local-config scenarios on the
port's node, on the CPU.

Every test function of tests/test_gateway.py, test_admission.py and
test_localconfig.py runs as one case of `test_reference_scenario`, its
source rewritten by tests/ref_scenarios.py so that the gateway
(service, broadcaster, notifier, admission, client), `PeerNode`,
`provision_network` and `load_node_config` are the port's
(fabric_tpu_torch), while `OrdererNode` stays the reference's: the port
has no orderer process, and both speak the same RPC plane and bytes.
The provisioned peers' configs ask for `"bccsp": "SW"` (the port's peer
takes the card by default; `tests/node_world.py`).  The scenarios'
live topologies (three Raft orderers and a peer an org; one orderer and
one peer) are module-scoped, as in the reference, and torn down after
the last case of their module.  No scenario is left out.
"""
import pytest

from node_world import on_port
from ref_scenarios import close_module, run_scenario, scenario_module, \
    scenario_names

REF_FILES = ("test_gateway", "test_admission", "test_localconfig")
RUNS = [(f, t) for f in REF_FILES for t in scenario_names(f)]


@pytest.fixture(scope="module", autouse=True)
def _topologies():
    yield
    for f in REF_FILES:
        close_module(scenario_module(f, "fabric_tpu_torch", edit=on_port))


@pytest.mark.parametrize("case,name", RUNS,
                         ids=[f"{f}::{t}" for f, t in RUNS])
def test_reference_scenario(case, name, request):
    mod = scenario_module(case, "fabric_tpu_torch", edit=on_port)
    run_scenario(mod, name, request)
