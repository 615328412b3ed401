"""The shared world of the node tests (tests/test_torch_gateway.py,
test_torch_node.py, test_torch_provision.py): networks provisioned on
disk, with the reference's orderer behind either package's peers.

- `provision_sw(...)`: the port's `provision_network`, with
  `"bccsp": "SW"` written into every peer's config.  The port's peer runs
  on the card unless its config asks for the host, and these tests run
  on the CPU; the reference's peer reads the same key (its default).
- `on_port(src)`: the `ref_scenarios` edit that runs a reference
  scenario's peers, gateway and provisioning on the port while its
  `OrdererNode` stays the reference's (the port has no orderer process).
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
    """Write `"bccsp": "SW"` into each peer config file of `paths`."""
    for path in paths:
        cfg = load_json(path)
        cfg["bccsp"] = "SW"
        with open(path, "w") as f:
            json.dump(cfg, f)


def provision_sw(*args, **kwargs) -> dict:
    from fabric_tpu_torch.node.provision import provision_network
    out = provision_network(*args, **kwargs)
    set_sw(out["peers"])
    return out


def on_port(src: str) -> str:
    orderer = ("from fabric_tpu_torch.node.orderer import OrdererNode, "
               "load_signing_identity")
    provision = ("from fabric_tpu_torch.node.provision import "
                 "provision_network")
    assert provision in src
    src = src.replace(orderer, "from fabric_tpu.node.orderer import "
                      "OrdererNode\nfrom fabric_tpu_torch.node.orderer "
                      "import load_signing_identity")
    return src.replace(provision, "from node_world import provision_sw "
                       "as provision_network")


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
