"""The port's provisioning, configtxlator and cluster trace collector
(fabric_tpu_torch.node.provision, .config.lator, .node.tracecollect)
against the reference's, on the CPU.

- `provision_network` on both packages with the same arguments: the same
  files, the same JSON keys and non-random values at every level (ports
  and key material aside: keys are random), certificates that parse and
  keys that sign for them, and channel configs equal field by field but
  for certificates and fingerprints.
- Each package's nodes load the other's files: the reference's
  `OrdererNode` and `PeerNode` on the port's, the port's `PeerNode` on
  the reference's (with `"bccsp": "SW"`, the host, as these tests ask
  for), each reading the same channel, orderers, peers and attestors.
- `lator`: `decode_config`, `encode_config`, `compute_update` and the
  command line (`python -m <pkg>.config.lator ...`) byte-equal to the
  reference's on the same config bytes.
- `collect_cluster_trace`: the reference's tests/test_tracecollect.py
  on the port (tests/ref_scenarios.py), and both packages' collectors
  over two live ops servers each on the same span layout give the same
  structure (events by name and node row, nodes, counts, flags).
Tolerance: exact equality.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from node_world import ROOTS, load_json, mod, set_sw, sw_defaults
from ref_scenarios import run_scenario, scenario_module, scenario_names

REPO = Path(__file__).resolve().parent.parent
RANDOM_KEYS = {"port", "cert_pem", "key_pem", "channel_config_hex",
               "cert_fp", "data_dir", "orderers", "peers", "cluster"}



@pytest.fixture(scope="module", autouse=True)
def sw_default():
    sw_defaults()


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    out = {}
    for pkg in ROOTS:
        base = str(tmp_path_factory.mktemp(f"prov_{pkg}"))
        out[pkg] = (base, mod(pkg, "node.provision").provision_network(
            base, n_orderers=2, peer_orgs=["Org1", "Org2"],
            peers_per_org=2, spare_orderers=1, channel_id="chP",
            collections=[{"ns": "assets", "name": "secret",
                          "members": ["Org1"]}]))
    return out


def rel(paths, base):
    if isinstance(paths, dict):
        return {k: rel(v, base) for k, v in paths.items()}
    if isinstance(paths, list):
        return [rel(p, base) for p in paths]
    return os.path.relpath(paths, base)


def shape(v):
    """A JSON value with the random parts replaced by their type."""
    if isinstance(v, dict):
        return {k: (type(x).__name__ if k in RANDOM_KEYS else shape(x))
                for k, x in v.items()}
    if isinstance(v, list):
        return [shape(x) for x in v]
    return v


def files(base):
    return sorted(str(p.relative_to(base)) for p in Path(base).rglob("*"))


def test_provision_writes_the_reference_layout(nets):
    (rb, ref), (pb, port) = nets["ref"], nets["port"]
    assert rel(port, pb) == rel(ref, rb)
    assert files(pb) == files(rb)
    for path in Path(rb).glob("*.json"):
        a, b = load_json(str(path)), load_json(str(Path(pb) / path.name))
        assert shape(b) == shape(a), path.name
        assert sorted(b) == sorted(a)
        for key in ("orderers", "peers", "cluster"):
            if key in a:
                assert len(b[key]) == len(a[key])
        if "verify_once" in a:
            assert [x["mspid"] for x in b["verify_once"].get(
                "attestors", [])] == [x["mspid"] for x in a[
                    "verify_once"].get("attestors", [])]


def test_docstring_names_the_ports_node_processes():
    """The provisioned files are for the port's own peer and orderer
    processes: each `python -m <module> <node.json>` the docstring names
    is a module of the port whose main takes one node file (and prints
    its usage without one)."""
    doc = mod("port", "node.provision").__doc__
    names = re.findall(r"python -m ([\w.]+) <node\.json>", doc)
    assert names == ["fabric_tpu_torch.node.peer",
                     "fabric_tpu_torch.node.orderer"]
    res = subprocess.run([sys.executable, "-m", names[1]], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2
    assert f"usage: python -m {names[1]} <node.json>" in res.stderr


def test_provisioned_material_is_sound(nets):
    """Every file's key signs for its certificate, on both packages' SW;
    every node's port is distinct; the channel config is the
    reference's, certificates and fingerprints aside."""
    cfgs = {}
    for pkg, (base, paths) in nets.items():
        ports = set()
        for path in Path(base).glob("*.json"):
            cfg = load_json(str(path))
            if "port" in cfg:
                ports.add(cfg["port"])
            signer = mod(pkg, "node.orderer").load_signing_identity(
                cfg["mspid"], cfg["cert_pem"].encode(),
                cfg["key_pem"].encode())
            for vpkg in ROOTS:
                ident = mod(vpkg, "msp").identity.Identity(
                    cfg["mspid"], mod(vpkg, "crypto").x509
                    .load_pem_x509_certificate(cfg["cert_pem"].encode()))
                assert ident.verify(b"msg", signer.sign(b"msg")), path
        n_nodes = len(paths["orderers"]) + len(paths["peers"]) + len(
            paths["spare_orderers"])
        assert len(ports) == n_nodes
        cfg = load_json(paths["peers"][0])
        cc = mod("ref", "config").ChannelConfig.deserialize(
            bytes.fromhex(cfg["channel_config_hex"]))
        cfgs[pkg] = (cc.channel_id, cc.sequence,
                     [o.mspid for o in cc.orgs], cc.policies, cc.batch,
                     cc.capabilities,
                     [{k: v for k, v in c.items()
                       if k not in ("port", "cert_fp")}
                      for c in cc.consenters])
    assert cfgs["port"] == cfgs["ref"]


def _stop(node):
    try:
        node.stop()
    except Exception:
        pass


def node_view(node, pkg):
    return {"mspid": node.mspid, "channels": sorted(node.channels),
            "orderers": [tuple(o) for o in node.orderers],
            "peers": [tuple(p) for p in node.peers],
            "attestors": sorted(node._attestors),
            "trust": node._trust_attestations,
            "chaincodes": sorted(node.cc_registry._contracts),
            "collections": sorted(
                (ns, c, cfg.member_orgs) for (ns, c), cfg
                in node.collections._configs.items()),
            "gateway": node.gateway is not None,
            "provider": node.provider.name}


def test_nodes_load_each_others_configs(nets, tmp_path):
    """The reference's OrdererNode and PeerNode built from the port's
    files, the port's PeerNode from the reference's; each sees the
    channel, roster and attestors its file names, as the same node
    built from its own package's file does."""
    from fabric_tpu.node.orderer import OrdererNode
    built = []
    try:
        _, port_paths = nets["port"]
        _, ref_paths = nets["ref"]
        o_cfg = load_json(port_paths["orderers"][0])
        orderer = OrdererNode(o_cfg, data_dir=str(tmp_path / "o1"))
        built.append(orderer)
        assert orderer.channel_id == "chP"
        assert orderer.raft_id == 1
        assert len(orderer._attestors) == 4

        views = {}
        for label, path, pkg in (
                ("ref_on_port_files", port_paths["peers"][0], "ref"),
                ("port_on_ref_files", ref_paths["peers"][0], "port"),
                ("port_on_port_files", port_paths["peers"][1], "port")):
            set_sw([path])
            cfg = load_json(path)
            node = mod(pkg, "node.peer").PeerNode(
                cfg, data_dir=str(tmp_path / label))
            built.append(node)
            views[label] = node_view(node, pkg)
            node.rpc.stop()
            assert views[label]["orderers"] == [tuple(o) for o in
                                                cfg["orderers"]]
            assert views[label]["peers"] == [tuple(p) for p in cfg["peers"]]
            assert views[label]["provider"] == "sw"
        strip = [{k: v for k, v in views[k].items()
                  if k not in ("orderers", "peers", "attestors")}
                 for k in views]
        assert strip[0] == strip[1] == strip[2]
        assert strip[0]["channels"] == ["chP"] and strip[0]["trust"]
        assert strip[0]["chaincodes"] == ["_lifecycle", "assets"]
        assert strip[0]["collections"] == [("assets", "secret", ("Org1",))]
        assert [len(views[k]["attestors"]) for k in views] == [3, 3, 3]
    finally:
        for node in built:
            _stop(node)
            rpc = getattr(node, "rpc", None)
            if rpc is not None:
                _stop(rpc)


# -- lator ------------------------------------------------------------------


def test_lator_output_is_byte_equal(nets, tmp_path):
    ref_lator = mod("ref", "config.lator")
    port_lator = mod("port", "config.lator")
    _, paths = nets["ref"]
    raw = bytes.fromhex(load_json(paths["peers"][0])["channel_config_hex"])
    text = ref_lator.decode_config(raw)
    assert port_lator.decode_config(raw) == text
    assert port_lator.encode_config(text) == ref_lator.encode_config(text)
    assert port_lator.encode_config(text) == raw
    edited = json.loads(text)
    edited["orgs"] = edited["orgs"][:-1]
    edited["batch"]["max_message_count"] = 77
    edited["policies"].pop("Endorsement")
    upd = json.dumps(edited)
    assert port_lator.compute_update(raw, upd) == \
        ref_lator.compute_update(raw, upd)
    for fn in ("jsonify", "dejsonify"):
        v = {"a": [b"\x00\x01", {"b": b"z"}], "c": 3}
        assert getattr(port_lator, fn)(v) == getattr(ref_lator, fn)(v)

    (tmp_path / "cfg.bin").write_bytes(raw)
    (tmp_path / "cfg.json").write_text(text)
    (tmp_path / "upd.json").write_text(upd)
    outs = {}
    for pkg in ROOTS:
        outs[pkg] = [
            subprocess.run([sys.executable, "-m", f"{ROOTS[pkg]}.config.lator",
                            *args], cwd=REPO, capture_output=True,
                           timeout=120, env={**os.environ,
                                             "PYTHONPATH": str(REPO)})
            for args in (["decode", str(tmp_path / "cfg.bin")],
                         ["encode", str(tmp_path / "cfg.json")],
                         ["compute-update", str(tmp_path / "cfg.bin"),
                          str(tmp_path / "upd.json")])]
    for a, b in zip(outs["ref"], outs["port"]):
        assert a.returncode == b.returncode == 0, (a.stderr, b.stderr)
        assert b.stdout == a.stdout
        assert b.stderr == a.stderr
    assert outs["port"][0].stdout.decode() == text
    assert outs["port"][1].stdout == raw


# -- cluster traces -----------------------------------------------------------

TRACE_RUNS = scenario_names("test_tracecollect")


@pytest.mark.parametrize("name", TRACE_RUNS)
def test_tracecollect_scenario_on_port(name, request):
    run_scenario(scenario_module("test_tracecollect", "fabric_tpu_torch"),
                 name, request)


def cluster_structure(pkg):
    """Package `pkg`'s collector over two live ops servers (an orderer's
    and a committer's fragment, the latter reached through a link) and
    a dead endpoint, the gateway's spans served in-process."""
    tracing = mod(pkg, "ops_plane.tracing")
    metrics = mod(pkg, "ops_plane.metrics")
    server = mod(pkg, "ops_plane.server")
    tc = mod(pkg, "node.tracecollect")

    def tracer():
        t = tracing.Tracer(tracing.FlightRecorder())
        t.enabled = True
        return t

    t_gw, t_ord, t_cm = tracer(), tracer(), tracer()
    req, block = "cd" * 16, "ab" * 16
    parent = tracing.SpanContext(req, "11" * 8, True, remote=True)
    with t_gw.start_span("gateway.submit", parent=parent) as root:
        root.add_link(block)
        with t_gw.start_span("gateway.endorse"):
            pass
    for t, tid, name in ((t_ord, req, "orderer.broadcast"),
                         (t_cm, block, "committer.store_block")):
        ctx = tracing.SpanContext(tid, "22" * 8, True, remote=True)
        with t.start_span(name, parent=ctx):
            pass
    servers = []
    try:
        eps = []
        for t in (t_ord, t_cm):
            ops = server.OperationsServer(metrics=metrics.MetricsRegistry())
            tracing.register_routes(ops, t)
            servers.append(ops.start())
            eps.append("127.0.0.1:%d" % ops.addr[1])
        out = tc.collect_cluster_trace(req, eps + ["127.0.0.1:1"],
                                       local_tracer=t_gw,
                                       local_name="peer:Org1")
    finally:
        for ops in servers:
            ops.stop()
    rows = {e["pid"]: e["args"]["name"] for e in out["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    names = {ep: f"node{i}" for i, ep in enumerate(eps)}
    events = sorted((e["ph"], e["name"], names.get(rows.get(e["pid"]),
                                                   rows.get(e["pid"])))
                    for e in out["traceEvents"] if e.get("ph") == "X")
    od = dict(out["otherData"])
    od["nodes"] = {names.get(k, k): v for k, v in od["nodes"].items()}
    for key in ("trace_id", "collected_at", "unreachable", "errors"):
        od.pop(key, None)
    return sorted(out), events, od


def test_cluster_trace_structure_matches_reference():
    ref = cluster_structure("ref")
    assert cluster_structure("port") == ref
    assert len(ref[1]) == 4 and ref[2]["n_nodes"] == 3
