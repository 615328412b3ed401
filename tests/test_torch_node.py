"""The port's peer node (fabric_tpu_torch.node.peer `PeerNode`,
`PeerChannel`, the gateway) beside the reference's in one network, on
the CPU.

The network is the reference's dev network, provisioned by the
reference's `provision_network` (two orgs, two peers an org, one Raft
orderer, small batches): the port's `OrdererNode` orders, and in each
org the first peer is the reference's `PeerNode` and the second the
port's, all five nodes with `"bccsp": "SW"` (the host; every node of both
packages in this process runs on SW, each package's factory default
SW), ops servers on ephemeral ports, the tracer on at the node's
defaults.  The configs are JSON, PEM and hex, so both packages load the
same files.

Held:
- each package's `GatewayClient` submits through the other's gateway
  and every tx commits VALID; a gateway's endorse gathers every peer's
  endorsement, the reference's and the port's, and that tx commits VALID;
- two transfers of one asset in one block: the second is
  MVCC_READ_CONFLICT, and the gateways' commit-status codes equal the
  committed flags;
- at every height the four ledgers give the same tx flags and commit
  hash, and the same state and history at the end;
- attestations: a reference and a port node built from one peer's
  config pull the chain from the orderer through their own
  `RemoteDeliver`, seed their verdict caches from the orderer's
  attestations (`_seed_attestations`) and commit each block: the same
  attestations, seeded entries, commit-time cache hits, flags, commit
  hashes and `attestor_trust.json` bytes;
- the ops routes (`/healthz`, `/verify_plane`, `/gateway`,
  `/byzantine`, `/state`, `/traces`, `/slo`) answer on both packages
  with the same keys, the port's `/healthz` adding its provider fields;
- a second channel whose config the port's `lator` made: the
  `cscc.join` RPC refused alike for one org's admin (the channel's
  Admins need both orgs), then a runtime join on every node, one tx
  committed, the same commit hashes;
- `POST /drain` reaches `drained` on both packages, and a node reopened
  on the drained `data_dir` comes back at the same heights and commit
  hashes on both channels;
- the port's `PeerNode` with no `bccsp` key asks the factory for the
  CUDA kind, fail-stop (no card needed: the factory is stubbed).
Every wait has its own bound.  Tolerance: exact equality.
"""
import dataclasses
import json
import os
import threading
import urllib.request

import pytest

from node_world import (ROOTS, load_json, mod, set_sw, signer,
                        sw_defaults, wait_for)

PKG_OF = ("ref", "port", "ref", "port")      # provisioned peer order:
#                                             Org1_0, Org1_1, Org2_0, Org2_1
COMMIT_S = 60.0



@pytest.fixture(scope="module")
def net(tmp_path_factory):
    from fabric_tpu.config import BatchConfig
    from fabric_tpu.node.provision import provision_network
    from fabric_tpu_torch.node.orderer import OrdererNode
    sw_defaults()
    base = str(tmp_path_factory.mktemp("nodenet"))
    paths = provision_network(
        base, n_orderers=1, peer_orgs=["Org1", "Org2"], peers_per_org=2,
        batch=BatchConfig(max_message_count=8, timeout_s=0.1))
    set_sw(paths["orderers"] + paths["peers"])
    nodes = []
    try:
        ocfg = load_json(paths["orderers"][0])
        orderer = OrdererNode(ocfg, data_dir=ocfg["data_dir"]).start()
        nodes.append(orderer)
        wait_for(lambda: orderer.support.chain.node.role == "leader",
                 "raft leader", 60.0, 0.1)
        peers = []
        for path, pkg in zip(paths["peers"], PKG_OF):
            cfg = load_json(path)
            cfg["ops_port"] = 0
            cfg["gateway"] = {"linger_s": 0.002, "max_batch": 8,
                              "broadcast_deadline_s": 20.0}
            peer = mod(pkg, "node.peer").PeerNode(
                cfg, data_dir=cfg["data_dir"]).start()
            nodes.append(peer)
            peers.append(peer)
        yield {"paths": paths, "orderer": orderer, "peers": peers,
               "cfgs": [load_json(p) for p in paths["peers"]]}
    finally:
        for n in reversed(nodes):
            try:
                n.stop()
            except Exception:
                pass


def msps_of(net, pkg):
    return net["peers"][PKG_OF.index(pkg)].msps


def client(net, pkg, peer, org="Org1"):
    gw = mod(pkg, "gateway")
    return gw.GatewayClient(peer.rpc.addr,
                            signer(net["paths"]["clients"][org], pkg),
                            msps_of(net, pkg), channel_id="ch")


def settled(ledger, height: int) -> bool:
    """The ledger has committed block height-1 whole: its block store
    moves first, then the state and history (their savepoints)."""
    return (ledger.height == height
            and ledger.statedb.savepoint == height - 1
            and ledger.historydb.savepoint == height - 1)


def synced(net, channel="ch"):
    """Wait until every peer has committed up to the orderer's height on
    `channel`."""
    store = net["orderer"].registrar.get(channel).ledger
    wait_for(lambda: all(settled(p.channels[channel].ledger, store.height)
                         for p in net["peers"]),
             f"every peer at the orderer's height on {channel}", COMMIT_S)
    return store.height


def chain(peer, channel="ch"):
    from fabric_tpu.protocol.types import META_COMMIT_HASH, META_TXFLAGS
    ledger = peer.channels[channel].ledger
    out = []
    for n in range(ledger.height):
        md = ledger.blockstore.get_by_number(n).metadata.items
        out.append((n, bytes(md.get(META_TXFLAGS) or b""),
                    bytes(md.get(META_COMMIT_HASH) or b"")))
    return out


def rows(peer, channel="ch"):
    ledger = peer.channels[channel].ledger
    state = sorted((k, None if vv is None else
                    (vv.value, vv.version.block_num, vv.version.tx_num))
                   for k, vv in ledger.statedb._data.items())
    hist = ledger.historydb
    history = {k: [(m.block_num, m.tx_num, m.txid, m.value, m.is_delete)
                   for m in hist.get_history(*k)]
               for k in sorted(hist._index)}
    return state, history, ledger.commit_hash, ledger.height


def test_each_gateway_serves_each_client(net):
    for gi in (0, 1):                      # Org1's reference, port peer
        for cpkg in ROOTS:
            gw = client(net, cpkg, net["peers"][gi])
            try:
                key = f"{cpkg}-via-{PKG_OF[gi]}".encode()
                code, _ = gw.submit_transaction(
                    "assets", "create", [key, b"alice"],
                    commit_timeout_s=COMMIT_S)
                assert code == 0, (cpkg, PKG_OF[gi])
            finally:
                gw.close()


def test_mixed_endorsements_commit_valid(net):
    """The port's gateway gathers all four peers' endorsements (two
    reference, two port), each signature checked on both packages' SW;
    the assembled tx commits VALID everywhere."""
    gw = client(net, "port", net["peers"][1])
    try:
        sp, responses = gw.endorse("assets", "create", [b"mixed", b"bob"])
        ids = {p.signer.serialize(): PKG_OF[i]
               for i, p in enumerate(net["peers"])}
        assert sorted(ids[r.endorsement.endorser] for r in responses) == \
            ["port", "port", "ref", "ref"]
        for r in responses:
            prp = r.payload + r.endorsement.endorser
            for pkg in ROOTS:
                ident = mod(pkg, "msp").deserialize_from_msps(
                    msps_of(net, pkg), r.endorsement.endorser)
                assert ident.verify(prp, r.endorsement.signature)
        env = mod("port", "endorser").assemble_transaction(sp, responses,
                                                           gw.signer)
        out = gw.submit_envelope(env, timeout_s=COMMIT_S)
        code, block = gw.commit_status(out["txid"], timeout_s=COMMIT_S)
        assert code == 0
    finally:
        gw.close()
    synced(net)
    for p in net["peers"]:
        assert p.channels["ch"].ledger.statedb.get("assets", "mixed") \
            .value == b"bob"


def test_conflict_block_and_commit_status(net):
    """Two transfers of one asset, endorsed against the same version and
    submitted together through the reference's gateway: the second is
    MVCC_READ_CONFLICT (11); commit_status from either gateway equals
    the flag committed in its block."""
    gws = [client(net, "ref", net["peers"][0]),
           client(net, "port", net["peers"][1])]
    try:
        gws[0].submit_transaction("assets", "create", [b"hot", b"carol"],
                                  commit_timeout_s=COMMIT_S)
        envs = []
        for owner in (b"dave", b"erin"):
            sp, responses = gws[0].endorse("assets", "transfer",
                                           [b"hot", owner])
            envs.append(mod("ref", "endorser").assemble_transaction(
                sp, responses, gws[0].signer))
        outs = [None, None]

        def submit(i):
            outs[i] = gws[0].submit_envelope(envs[i], timeout_s=COMMIT_S)
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=COMMIT_S + 15)
        assert all(o is not None and o["status"] == 200 for o in outs)
        codes = {}
        for gw in gws:
            for o in outs:
                codes.setdefault(o["txid"], set()).add(
                    gw.commit_status(o["txid"], timeout_s=COMMIT_S))
    finally:
        for gw in gws:
            gw.close()
    assert all(len(v) == 1 for v in codes.values())
    assert sorted(c for (c, _b), in (tuple(v) for v in codes.values())) \
        == [0, 11]
    synced(net)
    ledger = net["peers"][1].channels["ch"].ledger
    for txid, ((code, num),) in ((k, tuple(v)) for k, v in codes.items()):
        block = mod("port", "protocol").wire.parse_block(
            ledger.blockstore.get_by_number(num).serialize())
        from fabric_tpu_torch.protocol.txflags import TxFlags
        from fabric_tpu_torch.protocol.types import META_TXFLAGS
        flags = TxFlags.from_bytes(block.metadata.items[META_TXFLAGS])
        txids = [mod("port", "protocol").Envelope.deserialize(bytes(d))
                 .header().channel_header.txid for d in block.data]
        assert int(flags.flag(txids.index(txid))) == code


def test_ledgers_agree_at_every_height(net):
    synced(net)
    chains = [chain(p) for p in net["peers"]]
    assert len(chains[0]) >= 5
    assert all(c == chains[0] for c in chains[1:])
    assert any(set(f) - {0} for _n, f, _h in chains[0][1:])
    states = [rows(p) for p in net["peers"]]
    assert all(s == states[0] for s in states[1:])


def shadow(net, pkg, root):
    """Package `pkg`'s PeerNode from Org1's first peer config (its RPC
    on an ephemeral port, its own data_dir, not started)."""
    cfg = dict(net["cfgs"][0], port=0)
    cfg.pop("ops_port", None)
    return mod(pkg, "node.peer").PeerNode(cfg, data_dir=root)


def test_attestations_seed_the_same_caches(net, tmp_path):
    height = synced(net)
    out, nodes = {}, []
    try:
        for pkg in ROOTS:
            node = shadow(net, pkg, str(tmp_path / pkg))
            nodes.append(node)
            ch = node.channels["ch"]
            cache = node.verify_cache
            hits = [0]
            inner = cache.lookup

            def lookup(item, _inner=inner, _hits=hits):
                got = _inner(item)
                _hits[0] += got[0] is not None
                return got
            cache.lookup = lookup
            seek = mod(pkg, "orderer.deliver").SeekInfo(
                start=0, stop=height - 1, behavior="block_until_ready")
            rec = []
            for block, attests, sender in ch.deliver_client.deliver(
                    "ch", seek, timeout_s=10):
                items = mod(pkg, "orderer").block_signature_items(
                    block, ch.msps)
                assert bool(node.provider.batch_verify(items).all())
                size0 = len(cache._data)
                ch._seed_attestations(block, attests, sender)
                seeded = len(cache._data) - size0
                hits[0] = 0
                ch.coordinator.store_block(block)
                rec.append((block.header.number, json.dumps(attests),
                            node._attestor_authorized(sender), seeded,
                            hits[0]))
            assert len(rec) == height
            trust = os.path.join(str(tmp_path / pkg), "attestor_trust.json")
            out[pkg] = (rec, open(trust, "rb").read(), chain(node),
                        rows(node)[:3])
    finally:
        for node in nodes:
            node.rpc.stop()
    assert out["port"] == out["ref"]
    rec = out["ref"][0]
    assert all(authorized for _n, _a, authorized, _s, _h in rec)
    assert sum(s for *_x, s, _h in rec) > 0 and sum(h for *_x, h in rec) > 0
    assert out["ref"][2] == chain(net["peers"][0])


ROUTES = ("/healthz", "/verify_plane", "/gateway", "/byzantine", "/state",
          "/traces", "/slo")


def http_get(peer, route):
    host, port = peer.ops.addr[:2]
    with urllib.request.urlopen(f"http://{host}:{port}{route}",
                                timeout=10) as r:
        return json.loads(r.read())


def keys(v):
    if isinstance(v, dict):
        return sorted(v)
    return type(v).__name__


def test_ops_routes_answer_with_the_same_keys(net):
    synced(net)
    ref, port = net["peers"][0], net["peers"][1]
    for route in ROUTES:
        a, b = http_get(ref, route), http_get(port, route)
        if route == "/healthz":
            assert b.pop("bccsp") == {"name": "sw", "backend": "sw",
                                      "degraded": False}
            assert a["status"] == b["status"] == "OK"
            assert a["lifecycle"] == b["lifecycle"] == "serving"
        assert keys(b) == keys(a), route
    assert http_get(port, "/verify_plane")["trust_attestations"] is True


def test_cscc_join_of_a_lator_made_channel(net):
    from fabric_tpu.comm import RpcError as RefRpcError
    from fabric_tpu_torch.comm import RpcError as PortRpcError
    raw = bytes.fromhex(net["cfgs"][0]["channel_config_hex"])
    port_lator = mod("port", "config.lator")
    doc = json.loads(port_lator.decode_config(raw))
    doc["channel_id"] = "ch2"
    raw2 = port_lator.encode_config(json.dumps(doc))
    assert raw2 == mod("ref", "config.lator").encode_config(json.dumps(doc))

    refused = []
    for i in (0, 1):
        pkg = PKG_OF[i]
        admin = signer(net["paths"]["admins"]["Org1"], pkg)
        conn = mod(pkg, "comm.rpc").connect(
            net["peers"][i].rpc.addr, admin, msps_of(net, pkg), timeout=5.0)
        try:
            with pytest.raises((RefRpcError, PortRpcError)) as exc:
                conn.call("cscc.join", {"config": raw2}, timeout=10.0)
            refused.append(str(exc.value))
        finally:
            conn.close()
    assert refused[0] == refused[1] and "cscc/JoinChain" in refused[0]

    net["orderer"].join_channel(
        mod("port", "config").ChannelConfig.deserialize(raw2))
    for i, p in enumerate(net["peers"]):
        p.join_channel(mod(PKG_OF[i], "config").ChannelConfig
                       .deserialize(raw2))
        assert sorted(p.channels) == ["ch", "ch2"]
    gw = client(net, "port", net["peers"][1])
    try:
        code, _ = gw.submit_transaction("assets", "create",
                                        [b"k2", b"frank"], channel="ch2",
                                        commit_timeout_s=COMMIT_S)
        assert code == 0
    finally:
        gw.close()
    synced(net, "ch2")
    chains = [chain(p, "ch2") for p in net["peers"]]
    assert all(c == chains[0] for c in chains[1:])
    assert chains[0][-1][1] == b"\x00"
    for p in net["peers"]:
        assert p.channels["ch2"].ledger.statedb.get("assets", "k2").value \
            == b"frank"
        assert p.channels["ch"].ledger.statedb.get("assets", "k2") is None


def http_post(peer, route):
    host, port = peer.ops.addr[:2]
    req = urllib.request.Request(f"http://{host}:{port}{route}", data=b"",
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_drain_and_reopen(net):
    """Runs last: drains Org1's two peers and reopens each on its
    data_dir."""
    synced(net)
    drained = [http_post(net["peers"][i], "/drain") for i in (0, 1)]
    assert [d["lifecycle"] for d in drained] == ["drained", "drained"]
    assert drained[0]["heights"] == drained[1]["heights"]
    assert keys(drained[0]) == keys(drained[1])
    for i in (0, 1):
        peer = net["peers"][i]
        assert http_get(peer, "/healthz")["lifecycle"] == "drained"
        before = {c: rows(peer, c)[2:] for c in sorted(peer.channels)}
        peer.stop()
        cfg = dict(net["cfgs"][i], port=0)
        again = mod(PKG_OF[i], "node.peer").PeerNode(
            cfg, data_dir=cfg["data_dir"])
        try:
            after = {c: rows(again, c)[2:] for c in sorted(again.channels)}
        finally:
            again.rpc.stop()
        assert after == before, PKG_OF[i]
        assert sorted(after) == ["ch", "ch2"]


def test_port_node_defaults_to_the_card(net, tmp_path, monkeypatch):
    """No `bccsp` key: the port's PeerNode asks for the CUDA kind,
    fail-stop (the reference's default is SW with its auto degrade);
    `bccsp_degrade: true` asks for the wrapper.  The factory is stubbed,
    so no card is needed."""
    peer_mod = mod("port", "node.peer")
    sw = mod("port", "bccsp.sw")
    seen = []

    def init_factories(opts):
        seen.append(opts)
        return sw.SoftwareProvider()
    monkeypatch.setattr(peer_mod, "init_factories", init_factories)
    for extra in ({}, {"bccsp_degrade": True}, {"bccsp": "SW"}):
        cfg = dict(net["cfgs"][1], port=0)
        cfg.pop("bccsp")
        cfg.update(extra)
        node = peer_mod.PeerNode(cfg, data_dir=str(tmp_path / str(len(seen))))
        node.rpc.stop()
    assert [(o.default, o.degrade) for o in seen] == [
        ("CUDA", False), ("CUDA", True), ("SW", False)]
    assert dataclasses.asdict(seen[0])["device"] is None


def test_node_package_import_builds_nothing():
    """Importing `fabric_tpu_torch.node` (as `node.warmup` does) loads
    no part of the config plane, whose serde loads a native extension:
    warmup must be the first to build, and time, every library
    (chip_smoke.py's warmup probe checks each build took time)."""
    import subprocess
    import sys
    code = ("import sys, fabric_tpu_torch.node.warmup\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "('fabric_tpu_torch.utils', 'fabric_tpu_torch.config', "
            "'fabric_tpu_torch.native._'))))\n"
            "from fabric_tpu_torch.node import provision_orderers\n"
            "print(provision_orderers.__module__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    loaded, where = out.stdout.strip().splitlines()
    assert loaded == "[]"
    assert where == "fabric_tpu_torch.node.provision"
