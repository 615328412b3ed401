"""The reference's gateway, admission and local-config scenarios on the
port's node, on the CPU.

Every test function of tests/test_gateway.py, test_admission.py and
test_localconfig.py runs as one case of `test_reference_scenario`, its
source rewritten by tests/ref_scenarios.py so that the gateway
(service, broadcaster, notifier, admission, client), `OrdererNode`,
`PeerNode`, `provision_network` and `load_node_config` are the port's
(fabric_tpu_torch).  test_admission.py's orderers stay the reference's
(`node_world.on_port_ref_orderer`): the port's peers behind the
reference's Raft orderers, both packages speaking the same RPC plane
and bytes.  The provisioned nodes' configs ask for `"bccsp": "SW"` (the
port's nodes take the card by default; `tests/node_world.py`).  The
scenarios' live topologies (three Raft orderers and a peer an org; one
orderer and one peer) are module-scoped, as in the reference, and torn
down after the last case of their module.  No scenario is left out.
"""
import pytest

from node_world import on_port, on_port_ref_orderer
from ref_scenarios import close_module, run_scenario, scenario_module, \
    scenario_names

EDITS = {"test_gateway": on_port, "test_admission": on_port_ref_orderer,
         "test_localconfig": on_port}
RUNS = [(f, t) for f in EDITS for t in scenario_names(f)]


@pytest.fixture(scope="module", autouse=True)
def _topologies():
    yield
    for f, edit in EDITS.items():
        close_module(scenario_module(f, "fabric_tpu_torch", edit=edit))


@pytest.mark.parametrize("case,name", RUNS,
                         ids=[f"{f}::{t}" for f, t in RUNS])
def test_reference_scenario(case, name, request):
    mod = scenario_module(case, "fabric_tpu_torch", edit=EDITS[case])
    run_scenario(mod, name, request)
