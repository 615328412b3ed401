"""The port's ordering service (fabric_tpu_torch.orderer: consensus,
broadcast, registrar; node.orderer `OrdererNode`) against the
reference's, on the CPU.

* The reference's own scenarios on the port: every test function of
  tests/test_orderer.py (tests/ref_scenarios.py), on SW.
* One Raft cluster of both packages: the port's `provision_network`
  (three orderers, one org of two peers, every node `"bccsp": "SW"`);
  orderers 1 and 2 are the reference's `OrdererNode`, orderer 3 the
  port's; peer 0 is the reference's `PeerNode`, peer 1 the port's.
  Transactions go in through both gateways, first under whichever
  orderer the election made leader, then after leadership moved to the
  port's orderer (`transfer_leadership`).  All three orderers hold the
  same blocks (number, previous hash, data hash, header hash, data),
  and the two peers commit them with the same flags and commit hashes.
* Either package's orderer behind the other's peers: the same
  envelopes (endorsed once, on an all-reference network) broadcast in
  the same batches to three networks of one orderer and one peer an
  org, made from the same provisioned files: all reference; the
  reference's orderer behind the port's peers; the port's orderer
  behind the reference's peers.  The flags, commit hashes and state of
  every peer equal the all-reference network's, block for block.
* `OrdererNode(cfg)` with no `bccsp` key asks the factory for the CUDA
  kind (fail-stop), with `"bccsp": "SW"` or `FABRIC_TPU_ORDERER_BCCSP=SW`
  (through `load_node_config`) for SW; `/healthz` carries the
  provider's fields.  The factory is stubbed, so no card is needed.

Every wait has its own bound.  Tolerance: exact equality.
"""
import dataclasses
import json
import os
import urllib.request

import pytest

from node_world import (load_json, mod, set_sw, signer, sw_defaults,
                        wait_for)
from ref_scenarios import run_scenario, scenario_module, scenario_names

RUNS = scenario_names("test_orderer")
COMMIT_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def _sw():
    sw_defaults()


@pytest.mark.parametrize("name", RUNS, ids=[f"test_orderer::{t}"
                                            for t in RUNS])
def test_reference_scenario(name, request):
    run_scenario(scenario_module("test_orderer", "fabric_tpu_torch"), name,
                 request)


def _stop(nodes):
    for n in reversed(nodes):
        try:
            n.stop()
        except Exception:
            pass


def _blocks(store):
    from fabric_tpu.protocol.types import block_header_hash
    out = []
    for n in range(store.height):
        b = store.get_by_number(n)
        h = b.header
        out.append((h.number, bytes(h.previous_hash), bytes(h.data_hash),
                    block_header_hash(h), [bytes(d) for d in b.data]))
    return out


def _chain(peer, channel="ch"):
    from fabric_tpu.protocol.types import META_COMMIT_HASH, META_TXFLAGS
    ledger = peer.channels[channel].ledger
    out = []
    for n in range(ledger.height):
        md = ledger.blockstore.get_by_number(n).metadata.items
        out.append((n, bytes(md.get(META_TXFLAGS) or b""),
                    bytes(md.get(META_COMMIT_HASH) or b"")))
    return out


def _state(peer, channel="ch"):
    ledger = peer.channels[channel].ledger
    return sorted((k, None if vv is None else
                   (vv.value, vv.version.block_num, vv.version.tx_num))
                  for k, vv in ledger.statedb._data.items())


def _settled(peer, height, channel="ch"):
    ledger = peer.channels[channel].ledger
    return (ledger.height == height
            and ledger.statedb.savepoint == height - 1
            and ledger.historydb.savepoint == height - 1)


def _client(paths, pkg, peer):
    return mod(pkg, "gateway").GatewayClient(
        peer.rpc.addr, signer(paths["clients"]["Org1"], pkg), peer.msps,
        channel_id="ch")


def test_mixed_package_raft_cluster_orders_identical_blocks(tmp_path):
    from fabric_tpu_torch.config import BatchConfig
    from fabric_tpu_torch.node.provision import provision_network
    paths = provision_network(
        str(tmp_path), n_orderers=3, peer_orgs=["Org1"], peers_per_org=2,
        batch=BatchConfig(max_message_count=4, timeout_s=0.2))
    set_sw(paths["orderers"] + paths["peers"])
    nodes, orderers, peers = [], [], []
    try:
        for path, pkg in zip(paths["orderers"], ("ref", "ref", "port")):
            cfg = load_json(path)
            orderers.append(mod(pkg, "node.orderer").OrdererNode(
                cfg, data_dir=cfg["data_dir"]).start())
            nodes.append(orderers[-1])
        wait_for(lambda: any(o.support.chain.node.role == "leader"
                             for o in orderers), "a raft leader", 60.0, 0.1)
        for path, pkg in zip(paths["peers"], ("ref", "port")):
            cfg = load_json(path)
            cfg["gateway"] = {"linger_s": 0.002, "max_batch": 8,
                              "broadcast_deadline_s": 20.0}
            peers.append(mod(pkg, "node.peer").PeerNode(
                cfg, data_dir=cfg["data_dir"]).start())
            nodes.append(peers[-1])

        def submit(tag):
            for pkg, peer in zip(("ref", "port"), peers):
                gw = _client(paths, pkg, peer)
                try:
                    for i in range(3):
                        code, _ = gw.submit_transaction(
                            "assets", "create",
                            [f"{tag}-{pkg}-{i}".encode(), b"alice"],
                            commit_timeout_s=COMMIT_S)
                        assert code == 0, (tag, pkg, i)
                finally:
                    gw.close()

        submit("first")
        leader = next(o for o in orderers
                      if o.support.chain.node.role == "leader")
        if leader is not orderers[2]:
            wait_for(lambda: leader.support.chain.transfer_leadership(3),
                     "leadership transfer accepted", 30.0, 0.1)
        wait_for(lambda: orderers[2].support.chain.node.role == "leader",
                 "the port's orderer leads", 60.0, 0.1)
        submit("second")
        stores = [o.registrar.get("ch").ledger for o in orderers]
        wait_for(lambda: len({s.height for s in stores}) == 1,
                 "every orderer at one height", COMMIT_S)
        height = stores[0].height
        wait_for(lambda: all(_settled(p, height) for p in peers),
                 "both peers at the orderers' height", COMMIT_S)
        blocks = [_blocks(s) for s in stores]
        assert blocks[0] == blocks[1] == blocks[2]
        assert [b[0] for b in blocks[0]] == list(range(height))
        for prev, cur in zip(blocks[0], blocks[0][1:]):
            assert cur[1] == prev[3]          # the header chain
        assert sum(len(b[4]) for b in blocks[0]) == 12
        chains = [_chain(p) for p in peers]
        assert chains[0] == chains[1]
        assert all(set(f) == {0} for _n, f, _h in chains[0])
        assert _state(peers[0]) == _state(peers[1])
    finally:
        _stop(nodes)


def _endorse_batches(paths):
    """On an all-reference network of `paths`: two batches of four
    envelopes, endorsed through the reference's gateway.  Batch 1
    creates four assets; batch 2, endorsed after batch 1 committed,
    transfers one asset twice (the second is MVCC_READ_CONFLICT) and
    creates two more."""
    batches = []
    with _network(paths, "ref", "ref", "base") as (orderer, peers):
        gw = _client(paths, "ref", peers[0])
        endorser = mod("ref", "endorser")
        try:
            def env(fn, args):
                sp, responses = gw.endorse("assets", fn, args)
                return endorser.assemble_transaction(sp, responses,
                                                     gw.signer)
            batches.append([env("create", [b"a%d" % i, b"alice"])
                            for i in range(4)])
            _broadcast(orderer, peers, batches[0], paths)
            batches.append([env("transfer", [b"a0", b"bob"]),
                            env("transfer", [b"a0", b"carol"]),
                            env("create", [b"b0", b"dave"]),
                            env("create", [b"b1", b"erin"])])
        finally:
            gw.close()
    return [[e.serialize() for e in b] for b in batches]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _network:
    """One orderer and one peer an org from the files of `paths`, the
    orderer of package `opkg` and the peers of `ppkg`, each node's
    data under its own `tag` directory and every node on a fresh port
    (the provisioned ports remapped in each config's `port`,
    `orderers`, `peers` and `cluster`)."""

    def __init__(self, paths, opkg, ppkg, tag):
        self.paths, self.opkg, self.ppkg, self.tag = paths, opkg, ppkg, tag
        self.nodes = []
        self.ports = {load_json(p)["port"]: _free_port()
                      for p in paths["orderers"] + paths["peers"]}

    def _cfg(self, path):
        cfg = load_json(path)
        cfg["data_dir"] = os.path.join(cfg["data_dir"], self.tag)
        os.makedirs(cfg["data_dir"], exist_ok=True)
        remap = self.ports.get
        cfg["port"] = remap(cfg["port"])
        for key in ("orderers", "peers"):
            if key in cfg:
                cfg[key] = [[h, remap(p, p), *rest]
                            for h, p, *rest in cfg[key]]
        if "cluster" in cfg:
            cfg["cluster"] = [dict(c, port=remap(c["port"], c["port"]))
                              for c in cfg["cluster"]]
        return cfg

    def __enter__(self):
        try:
            ocfg = self._cfg(self.paths["orderers"][0])
            orderer = mod(self.opkg, "node.orderer").OrdererNode(
                ocfg, data_dir=ocfg["data_dir"])
            self.nodes.append(orderer.start())
            wait_for(lambda: orderer.support.chain.node.role == "leader",
                     "raft leader", 60.0, 0.1)
            peers = []
            for path in self.paths["peers"]:
                cfg = self._cfg(path)
                peers.append(mod(self.ppkg, "node.peer").PeerNode(
                    cfg, data_dir=cfg["data_dir"]).start())
                self.nodes.append(peers[-1])
        except BaseException:
            _stop(self.nodes)
            raise
        return orderer, peers

    def __exit__(self, *exc):
        _stop(self.nodes)


def _broadcast(orderer, peers, envs, paths):
    """`envs` as one `broadcast_batch` to the orderer (so it cuts them
    as one block), then wait for every peer to commit that block."""
    pkg = "ref" if orderer.__module__.startswith("fabric_tpu.") else "port"
    store = orderer.registrar.get("ch").ledger
    height = store.height + 1
    conn = mod(pkg, "comm.rpc").connect(
        orderer.rpc.addr, signer(paths["clients"]["Org1"], pkg),
        orderer.bundle_source.current().msps, timeout=5.0)
    try:
        raws = [e if isinstance(e, bytes) else e.serialize() for e in envs]
        out = conn.call("broadcast_batch", {"envelopes": raws},
                        timeout=COMMIT_S)
    finally:
        conn.close()
    assert out["statuses"] == [200] * len(envs), out
    wait_for(lambda: store.height == height, "the batch's block", COMMIT_S)
    wait_for(lambda: all(_settled(p, height) for p in peers),
             "every peer at the orderer's height", COMMIT_S)


@pytest.fixture(scope="module")
def batched(tmp_path_factory):
    from fabric_tpu_torch.config import BatchConfig
    from fabric_tpu_torch.node.provision import provision_network
    base = str(tmp_path_factory.mktemp("crossnet"))
    paths = provision_network(
        base, n_orderers=1, peer_orgs=["Org1", "Org2"], peers_per_org=1,
        batch=BatchConfig(max_message_count=4, timeout_s=2.0))
    set_sw(paths["orderers"] + paths["peers"])
    batches = _endorse_batches(paths)
    return paths, batches, _outcome(paths, batches, "ref", "ref")


def _outcome(paths, batches, opkg, ppkg):
    """Flags and commit hashes a block, state and commit hash of every
    peer, and the orderer's blocks, after `batches` went in."""
    with _network(paths, opkg, ppkg, f"{opkg}-{ppkg}") as (orderer, peers):
        for b in batches:
            _broadcast(orderer, peers, b, paths)
        return ([_chain(p) for p in peers], [_state(p) for p in peers],
                [p.channels["ch"].ledger.commit_hash for p in peers],
                _blocks(orderer.registrar.get("ch").ledger))


@pytest.mark.parametrize("opkg,ppkg", [("ref", "port"), ("port", "ref")],
                         ids=["ref_orderer-port_peers",
                              "port_orderer-ref_peers"])
def test_either_orderer_behind_either_peers(opkg, ppkg, batched):
    paths, batches, want = batched
    got = _outcome(paths, batches, opkg, ppkg)
    assert got == want
    chains = want[0]
    assert chains[0] == chains[1] and len(chains[0]) == 2
    assert [list(f) for _n, f, _h in chains[0]] == [
        [0, 0, 0, 0], [0, 11, 0, 0]]


def test_orderer_defaults_to_the_card(tmp_path, monkeypatch):
    """No `bccsp` key: the port's OrdererNode asks for the CUDA kind,
    fail-stop, where the reference's always takes SW; `"bccsp": "SW"`
    in the file or `FABRIC_TPU_ORDERER_BCCSP=SW` in the environment
    asks for SW.  /healthz carries the provider's fields."""
    from fabric_tpu_torch.config.localconfig import load_node_config
    from fabric_tpu_torch.node.provision import provision_orderers
    orderer_mod = mod("port", "node.orderer")
    sw = mod("port", "bccsp.sw")
    seen = []

    def init_factories(opts):
        seen.append(opts)
        return sw.SoftwareProvider()
    monkeypatch.setattr(orderer_mod, "init_factories", init_factories)
    path = provision_orderers(str(tmp_path / "net"), n=1)[0]
    cfg = load_json(path)
    assert "bccsp" not in cfg
    with open(path, "w") as f:
        json.dump(dict(cfg, ops_port=0), f)
    built = []
    try:
        for label, env in (("none", None), ("file", None), ("env", "SW")):
            if env is not None:
                monkeypatch.setenv("FABRIC_TPU_ORDERER_BCCSP", env)
            ncfg = load_node_config(path, "orderer")
            if label == "file":
                ncfg["bccsp"] = "SW"
            ncfg["data_dir"] = str(tmp_path / label)
            ncfg["port"] = 0
            os.makedirs(ncfg["data_dir"])
            node = orderer_mod.OrdererNode(ncfg, data_dir=ncfg["data_dir"])
            built.append(node.start())
        assert [o.default for o in seen] == ["CUDA", "SW", "SW"]
        assert [o.degrade for o in seen] == [False] * 3
        assert dataclasses.asdict(seen[0])["device"] is None
        assert built[0].warmup == {}          # SW: no kernel to load
        wait_for(lambda: built[0].support.chain.node.leader_id is not None,
                 "raft leader", 60.0, 0.1)
        host, port = built[0].ops.addr[:2]
        with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                    timeout=10) as r:
            health = json.loads(r.read())
        assert health["bccsp"] == {"name": "sw", "backend": "sw",
                                   "degraded": False}
    finally:
        _stop(built)
