"""The shared world of the node tests (tests/test_torch_gateway.py,
test_torch_node.py, test_torch_provision.py, test_torch_orderer.py,
test_torch_admin.py, test_torch_chaos.py): networks provisioned on disk,
orderers and peers of either package.

- `provision_sw(...)`, `provision_orderers_sw(...)`: the port's
  `provision_network` and `provision_orderers`, with `"bccsp": "SW"`
  written into every orderer's and peer's config.  The
  port's nodes run on the card unless their config asks for the host,
  and these tests run on the CPU; the reference's nodes read the same
  key (the peer's default; the reference's orderer is always SW).
- `on_port(src)`: the `ref_scenarios` edit that runs a reference
  scenario's orderers, peers, gateway and provisioning on the port,
  every provisioned node on SW.
- `on_port_ref_orderer(src)`: `on_port`, but the scenario's
  `OrdererNode` stays the reference's: the port's peers behind the
  reference's orderer.
- `sw_chaos_net(...)`, `on_port_chaos(src)`: the port's `ChaosNet`
  with every node on SW, and the edit that puts it into a reference
  scenario.
- `load_json`, `signer(path, pkg)`: a provisioned file, and the signing
  identity of a provisioned client or admin in either package.
- `mod(pkg, name)`: package `pkg`'s ("ref" or "port") module `name`;
  `sw_defaults()`: both packages' factory default set to SW.
- `wait_for(pred, what, timeout_s)`: a bounded poll.
"""
import importlib
import json
import time

from intake_world import ROOTS


def mod(pkg: str, name: str):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def sw_defaults() -> None:
    """Identities hash and verify through each package's factory
    default: SW in both."""
    for pkg in ROOTS:
        f = mod(pkg, "bccsp.factory")
        f.init_factories(f.FactoryOpts(default="SW"))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def set_sw(paths) -> None:
    """Write `"bccsp": "SW"` into each node config file of `paths`."""
    for path in paths:
        cfg = load_json(path)
        cfg["bccsp"] = "SW"
        with open(path, "w") as f:
            json.dump(cfg, f)


def provision_sw(*args, **kwargs) -> dict:
    from fabric_tpu_torch.node.provision import provision_network
    out = provision_network(*args, **kwargs)
    set_sw(out["orderers"] + out["peers"]
           + out.get("spare_orderers", []))
    return out


def provision_orderers_sw(*args, **kwargs) -> list:
    from fabric_tpu_torch.node.provision import provision_orderers
    out = provision_orderers(*args, **kwargs)
    set_sw(out)
    return out


PROVISION = {
    "from fabric_tpu_torch.node.provision import provision_network":
        "from node_world import provision_sw as provision_network",
    "from fabric_tpu_torch.node.provision import provision_orderers":
        "from node_world import provision_orderers_sw as "
        "provision_orderers"}


def on_port(src: str) -> str:
    assert any(k in src for k in PROVISION)
    for k, v in PROVISION.items():
        src = src.replace(k, v)
    return src


def on_port_ref_orderer(src: str) -> str:
    orderer = ("from fabric_tpu_torch.node.orderer import OrdererNode, "
               "load_signing_identity")
    assert orderer in src
    src = src.replace(orderer, "from fabric_tpu.node.orderer import "
                      "OrdererNode\nfrom fabric_tpu_torch.node.orderer "
                      "import load_signing_identity")
    return on_port(src)


def sw_chaos_net(*args, **kwargs):
    """The port's `ChaosNet` with `"bccsp": "SW"` under every node's
    own overrides."""
    from fabric_tpu_torch.testing import ChaosNet
    for key in ("peer_overrides", "orderer_overrides"):
        kwargs[key] = dict({"bccsp": "SW"}, **(kwargs.get(key) or {}))
    return ChaosNet(*args, **kwargs)


def on_port_chaos(src: str) -> str:
    """A reference scenario's `ChaosNet` on the port, every node on SW."""
    chaos = "from fabric_tpu_torch.testing import ChaosNet"
    assert chaos in src
    return src.replace(chaos, "from node_world import sw_chaos_net as "
                       "ChaosNet")


def signer(path: str, pkg: str):
    cfg = load_json(path)
    return mod(pkg, "node.orderer").load_signing_identity(
        cfg["mspid"], cfg["cert_pem"].encode(), cfg["key_pem"].encode())


def wait_for(pred, what: str, timeout_s: float = 60.0,
             step_s: float = 0.05) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout_s} s: {what}")
        time.sleep(step_s)
