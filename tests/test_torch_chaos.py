"""The port's chaos and adversary harness (fabric_tpu_torch.testing:
`ChaosNet`, `adversary.EquivocatingOrderer`, `adversary_factory`) on
the CPU.

* The reference's live-topology drills of tests/test_chaos.py on the
  port's `ChaosNet` (three Raft orderers, a peer an org, every node the
  port's on SW; tests/ref_scenarios.py with `node_world.on_port_chaos`):
  the seeded fault plan with an orderer crash-stopped and restarted
  mid-traffic, exactly once, and the no-false-positive gate after it.
  Left out: `test_orderer_breaker_recovers_after_restart`, which waits
  on wall-clock deadlines and flakes under xdist on the reference too
  (ROADMAP C10).
* An equivocating orderer of either package behind a peer of either
  package: a one-orderer `ChaosNet` of the port whose `node_factory`
  builds the orderer from package A's `adversary_factory` (a forged
  sibling served after the honest block at height 2) and the peer from
  package B's `PeerNode`.  In all four pairings the peer's byzantine
  monitor convicts the orderer's binding of a fork (the `fork`
  reason: two validly signed headers at one height), with one
  fraud proof, and the verdicts are the same as with the reference on
  both sides.

* Teardown (ROADMAP C25): after `stop_all()` on a two-peer port
  `ChaosNet` on SW that has just committed blocks, no thread its nodes
  started is alive (`threading.enumerate()` before `start()` and after
  `stop_all()`, in a process of its own), and no file under its
  directory changes afterwards.

Every wait has its own bound.  Tolerance: exact equality.
"""
import json
import os
import subprocess
import sys

import pytest

from node_world import mod, on_port_chaos, sw_defaults, wait_for
from ref_scenarios import (close_module, run_scenario, scenario_module,
                           scenario_names)

C10 = ("test_orderer_breaker_recovers_after_restart",)
DRILLS = [t for t in scenario_names("test_chaos", skip=C10)
          if t in ("test_chaos_convergence_exactly_once",
                   "test_crash_stop_chaos_yields_zero_quarantines")]
SIDES = ("ref", "port")


def _drills():
    return scenario_module("test_chaos", "fabric_tpu_torch",
                           edit=on_port_chaos)


@pytest.fixture(scope="module", autouse=True)
def _topology():
    sw_defaults()
    yield
    close_module(_drills())


@pytest.mark.parametrize("name", DRILLS,
                         ids=[f"test_chaos::{t}" for t in DRILLS])
def test_reference_scenario(name, request):
    run_scenario(_drills(), name, request)


def _equivocation(base, adv, peer_pkg):
    from fabric_tpu_torch.config import BatchConfig
    from node_world import sw_chaos_net
    adv_factory = mod(adv, "testing.adversary").adversary_factory(
        {"orderer1": {"fork_height": 2}})

    def factory(name, kind, cfg):
        if kind == "orderer":
            return adv_factory(name, kind, cfg)
        return mod(peer_pkg, "node.peer").PeerNode(cfg,
                                                   data_dir=cfg["data_dir"])

    net = sw_chaos_net(str(base), n_orderers=1, peer_orgs=["Org1"],
                       batch=BatchConfig(max_message_count=1, timeout_s=0.1),
                       node_factory=factory)
    net.start()
    try:
        orderer, peer = net.orderers()[0], net.peers()[0]
        gw = net.client("Org1")
        try:
            for i in range(3):
                code, _ = gw.submit_transaction(
                    "assets", "create", [b"k%d" % i, b"alice"],
                    commit_timeout_s=30.0)
                assert code == 0
        finally:
            gw.close()
        mon = peer.channels[net.channel_id].byz_monitor
        wait_for(lambda: mon.proofs, "a fraud proof at the peer", 30.0)
        binding = "%s|%s" % (orderer.signer.mspid, mod(
            "port", "orderer.cluster").cert_fingerprint(orderer.signer.cert))
        committed = orderer.crimes_committed
        return {"crimes": [(c["kind"], c["height"]) for c in committed],
                "proofs": [(p["reason"], p["accused"] == binding)
                           for p in mon.proofs],
                "quarantined": peer.byzantine.is_quarantined(binding)}
    finally:
        net.stop_all()


@pytest.mark.parametrize("adv,peer_pkg", [(a, p) for a in SIDES
                                          for p in SIDES],
                         ids=[f"{a}_orderer-{p}_peer" for a in SIDES
                              for p in SIDES])
def test_equivocating_orderer_convicted(adv, peer_pkg, tmp_path):
    got = _equivocation(tmp_path / "net", adv, peer_pkg)
    assert got["crimes"] and got["crimes"][0] == ("equivocate", 2)
    assert got["proofs"] == [("fork", True)]
    assert got["quarantined"] is True



TEARDOWN = """
import json, os, sys, threading, time
sys.path[:0] = [{tests!r}, {repo!r}]
from fabric_tpu_torch.config import BatchConfig
from node_world import sw_chaos_net, sw_defaults


def tree(root):
    out = {{}}
    for d, _dirs, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = [st.st_size, st.st_mtime_ns]
    return out


sw_defaults()
before = set(threading.enumerate())
net = sw_chaos_net({base!r}, n_orderers=1, peer_orgs=["Org1", "Org2"],
                   batch=BatchConfig(max_message_count=1, timeout_s=0.1))
net.start()
try:
    gw = net.client("Org1")
    try:
        codes = [gw.submit_transaction("assets", "create",
                                       [b"t%d" % i, b"alice"],
                                       commit_timeout_s=30.0)[0]
                 for i in range(3)]
    finally:
        gw.close()
    net.wait_converged(timeout_s=30.0)
    during = len([t for t in threading.enumerate() if t not in before])
finally:
    net.stop_all()
alive = [t.name for t in threading.enumerate()
         if t not in before and t.is_alive()]
files = tree({base!r})
time.sleep(1.0)
print(json.dumps({{"codes": codes, "during": during, "alive": alive,
                  "files_changed": tree({base!r}) != files}}))
"""


def test_stop_all_leaves_no_node_thread_running(tmp_path):
    """In a process of its own, so that no other test's network adds
    threads while this one counts them."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = TEARDOWN.format(tests=here, repo=os.path.dirname(here),
                           base=str(tmp_path / "net"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["codes"] == [0, 0, 0]
    assert got["during"] >= 8
    assert got["alive"] == []
    assert got["files_changed"] is False
