"""The shared world of the block-intake tests (tests/test_torch_comm.py,
test_torch_degrade.py, test_torch_gossip.py, test_torch_privdata.py,
test_torch_intake.py) and of the endorsement side's
(tests/endorse_world.py, test_torch_byzantine.py): the reference and the
port side by side.

- `load(pkg)`: each package's modules of the intake path under one
  namespace, so a scenario is written once and run on both.
- Identities are minted once, by the reference's `DevOrg`; each package
  builds its own MSPs from the same org CA certs (`msps_for`) and holds
  the same certificate and key in its own signing identity
  (`signer_for`).
- `set_mode(monkeypatch, mode)`: the secure channel's crypto in both
  packages at once.  "chacha" is this host's (`cryptography`'s
  ChaCha20-Poly1305 and X25519); "lite" is the GPU hosts', where
  `cryptography` is missing: the hashlib AEAD of `crypto/aead.py` and
  the pure-Python X25519 of `crypto/lite_x25519.py`.  The two AEAD
  modes are not wire-compatible, so every cross-package channel test
  runs in both.
"""
import dataclasses
import importlib
import types

PKGS = ("ref", "port")
ROOTS = {"ref": "fabric_tpu", "port": "fabric_tpu_torch"}
MODES = ("chacha", "lite")

_MODULES = {
    "aead": "crypto.aead", "x25519": "crypto._x25519",
    "lite_x25519": "crypto.lite_x25519", "serde": "utils.serde",
    "rpc": "comm.rpc", "secure": "comm.secure", "faults": "comm.faults",
    "gcomm": "gossip.comm", "gnode": "gossip.node", "mcs": "gossip.mcs",
    "gstate": "gossip.state", "certstore": "gossip.certstore",
    "pull": "gossip.pull", "discovery": "gossip.discovery",
    "privdata": "privdata", "collection": "privdata.collection",
    "blockwriter": "orderer.blockwriter", "deliver": "orderer.deliver",
    "msp": "msp", "identity": "msp.identity", "sw": "bccsp.sw",
    "bccsp": "bccsp", "factory": "bccsp.factory",
    "degrade": "bccsp.degrade",
    "protocol": "protocol", "build": "protocol.build",
    "types": "protocol.types", "wire": "protocol.wire",
    "ledger": "ledger", "blkstorage": "ledger.blkstorage",
    "snapshot": "ledger.snapshot", "committer": "committer",
    "policy": "policy", "peer": "node.peer", "ops": "ops_plane",
    # the endorsement side (tests/endorse_world.py and its users)
    "chaincode": "chaincode", "stub": "chaincode.stub",
    "runtime": "chaincode.runtime", "lifecycle": "chaincode.lifecycle",
    "extcc": "chaincode.extcc", "extbuilder": "chaincode.externalbuilder",
    "endorser": "endorser", "proposal": "endorser.proposal",
    "scc": "scc", "qscc": "scc.qscc", "cscc": "scc.cscc",
    "sdiscovery": "scc.discovery", "byzantine": "byzantine",
    "monitor": "byzantine.monitor", "witness": "byzantine.witness",
    "quarantine": "byzantine.quarantine",
    "proofgossip": "byzantine.proofgossip", "byzops": "byzantine.ops",
    "raft": "orderer.raft", "cluster": "orderer.cluster",
    "config": "config", "acl": "policy.aclmgmt", "sbe": "committer.sbe",
    "statedb": "ledger.statedb", "txflags": "protocol.txflags",
}


def load(pkg: str) -> types.SimpleNamespace:
    root = ROOTS[pkg]
    ns = types.SimpleNamespace(name=pkg, root=root)
    for key, mod in _MODULES.items():
        if pkg == "ref" and key == "peer":
            # the reference's node/peer.py pulls in its whole peer; the
            # intake needs its RemoteDeliver only
            continue
        setattr(ns, key, importlib.import_module(f"{root}.{mod}"))
    if pkg == "ref":
        ns.peer = types.SimpleNamespace(
            RemoteDeliver=importlib.import_module(
                "fabric_tpu.node.peer").RemoteDeliver)
    return ns


def set_mode(monkeypatch, mode: str) -> None:
    """Both packages' secure channel in `mode` ("chacha" or "lite")."""
    assert mode in MODES
    if mode == "chacha":
        return
    for root in ROOTS.values():
        aead = importlib.import_module(f"{root}.crypto.aead")
        monkeypatch.setattr(aead, "_HAVE_CHACHA", False)
        lite = importlib.import_module(f"{root}.crypto.lite_x25519")
        secure = importlib.import_module(f"{root}.comm.secure")
        monkeypatch.setattr(secure, "X25519PrivateKey",
                            lite.X25519PrivateKey)
        monkeypatch.setattr(secure, "X25519PublicKey", lite.X25519PublicKey)


def msps_for(P, orgs) -> dict:
    """{mspid: CachedMSP} of package P from the orgs' CA material."""
    return {o.mspid: P.msp.CachedMSP(P.msp.MSP(P.msp.MSPConfig(
        **dataclasses.asdict(o.msp_config())))) for o in orgs}


def signer_for(P, ident):
    """The reference's signing identity `ident` as package P's: the same
    certificate and key object."""
    if P.name == "ref":
        return ident
    key = ident._key
    return P.identity.SigningIdentity(ident.mspid, ident.cert,
                                      P.sw.SigningKey(key.scheme, key.key))
