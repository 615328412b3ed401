"""Dev-network provisioning: crypto material + node configs on disk.

The composition of Fabric's cryptogen + configtxgen
(internal/cryptogen, internal/configtxgen): generates an orderer org,
per-node signing identities, the channel's genesis ChannelConfig, and one
JSON config file per orderer process and per peer.

Counterpart of `fabric_tpu/node/provision.py`, the same code on the
port's imports: the files are the reference's layout (JSON, PEM, hex), so
either package's nodes load them.  A peer's file is ready for
`python -m fabric_tpu_torch.node.peer <node.json>`; the orderer's files
are for `python -m fabric_tpu.node.orderer <node.json>` until the port
has its own orderer process.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

from fabric_tpu_torch.crypto import serialization

from fabric_tpu_torch.config import BatchConfig, ChannelConfig, OrgConfig, default_policies
from fabric_tpu_torch.msp.ca import DevOrg


def _key_pem(key) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())


def _cert_pem(cert) -> bytes:
    return cert.public_bytes(serialization.Encoding.PEM)


def provision_orderers(base_dir: str, n: int, channel_id: str = "ch",
                       base_port: int = 0,
                       batch: BatchConfig = None) -> List[str]:
    """Create material for an n-node orderer cluster; returns the list of
    node-config paths.  base_port=0 lets the OS pick ports (they are
    reserved by binding momentarily, then released)."""
    import socket

    org = DevOrg("OrdererOrg")
    mc = org.msp_config()

    ports = []
    socks = []
    for i in range(n):
        if base_port:
            ports.append(base_port + i)
        else:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
            socks.append(s)
    for s in socks:
        s.close()

    # issue every consenter identity first so both the channel config and
    # the shared cluster list can bind raft ids to certificate
    # fingerprints (not forgeable CN strings)
    from fabric_tpu_torch.orderer.cluster import cert_fingerprint

    creds = [org.issuer.issue(f"orderer{i + 1}@OrdererOrg") for i in range(n)]
    cluster = [{"raft_id": i + 1, "host": "127.0.0.1", "port": ports[i],
                "mspid": "OrdererOrg",
                "cert_fp": cert_fingerprint(creds[i][0])}
               for i in range(n)]

    cfg = ChannelConfig(
        channel_id=channel_id,
        sequence=0,
        orgs=(OrgConfig(mspid="OrdererOrg",
                        root_certs=tuple(mc.root_certs_pem),
                        admins=tuple(mc.admin_certs_pem)),),
        policies=default_policies(["OrdererOrg"]),
        batch=batch or BatchConfig(max_message_count=2, timeout_s=0.2),
        consenters=tuple(cluster),
    )
    cfg_hex = cfg.serialize().hex()
    paths = []
    for i in range(n):
        node_dir = os.path.join(base_dir, f"orderer{i + 1}")
        os.makedirs(node_dir, exist_ok=True)
        cert, key = creds[i]
        node_cfg = {
            "mspid": "OrdererOrg",
            "raft_id": i + 1,
            "host": "127.0.0.1",
            "port": ports[i],
            "cert_pem": _cert_pem(cert).decode(),
            "key_pem": _key_pem(key).decode(),
            "channel_config_hex": cfg_hex,
            "cluster": cluster,
            "data_dir": node_dir,
        }
        path = os.path.join(base_dir, f"orderer{i + 1}.json")
        with open(path, "w") as f:
            json.dump(node_cfg, f)
        paths.append(path)

    # client material (for tests/tools): one member + the org admin
    client_cert, client_key = org.issuer.issue("client@OrdererOrg")
    with open(os.path.join(base_dir, "client.json"), "w") as f:
        json.dump({
            "mspid": "OrdererOrg",
            "cert_pem": _cert_pem(client_cert).decode(),
            "key_pem": _key_pem(client_key).decode(),
            "channel_config_hex": cfg_hex,
            "cluster": cluster,
            "channel_id": channel_id,
        }, f)
    with open(os.path.join(base_dir, "admin.json"), "w") as f:
        json.dump({
            "mspid": "OrdererOrg",
            "cert_pem": _cert_pem(org.admin.cert).decode(),
            "key_pem": _key_pem(org.admin._key.key).decode(),
            "channel_config_hex": cfg_hex,
            "cluster": cluster,
            "channel_id": channel_id,
        }, f)
    return paths


def _free_ports(n: int) -> List[int]:
    import socket
    ports, socks = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


def provision_network(base_dir: str, n_orderers: int = 3,
                      peer_orgs: List[str] = ("Org1", "Org2"),
                      peers_per_org: int = 1,
                      channel_id: str = "ch",
                      chaincodes: List[dict] = None,
                      collections: List[dict] = None,
                      batch: BatchConfig = None,
                      spare_orderers: int = 0) -> dict:
    """Full dev network: orderer cluster + peer-org peers on one channel.

    The nwo-style harness (reference: integration/nwo/network.go:173) —
    generates all crypto material and one JSON config per process.
    Returns {"orderers": [cfg paths], "peers": [cfg paths],
             "clients": {org: client cfg path}}.

    `spare_orderers`: additionally issues N orderer identities + node
    configs that are NOT in the genesis consenter set — provisioned but
    unjoined, the raw material for dynamic-membership drills (an
    add-consenter config entry carries the spare's binding to everyone).
    Their cfg paths land under "spare_orderers"; each cfg carries its
    own "cert_fp" so a drill can build the add_consenter request
    without re-deriving it.
    """
    from fabric_tpu_torch.orderer.cluster import cert_fingerprint

    ord_org = DevOrg("OrdererOrg")
    p_orgs = {name: DevOrg(name) for name in peer_orgs}
    all_orgs = {"OrdererOrg": ord_org, **p_orgs}

    n_peers = len(p_orgs) * peers_per_org
    ports = _free_ports(n_orderers + n_peers + spare_orderers)
    ord_ports = ports[:n_orderers]
    peer_ports = ports[n_orderers:n_orderers + n_peers]
    spare_ports = ports[n_orderers + n_peers:]

    org_cfgs = []
    for name, org in all_orgs.items():
        mc = org.msp_config()
        org_cfgs.append(OrgConfig(mspid=name,
                                  root_certs=tuple(mc.root_certs_pem),
                                  admins=tuple(mc.admin_certs_pem)))
    # consenter identities first: the channel config itself carries the
    # rich consenter entries (raft id -> addr + mspid + cert fingerprint)
    creds = [ord_org.issuer.issue(f"orderer{i + 1}@OrdererOrg")
             for i in range(n_orderers)]
    cluster = [{"raft_id": i + 1, "host": "127.0.0.1", "port": ord_ports[i],
                "mspid": "OrdererOrg",
                "cert_fp": cert_fingerprint(creds[i][0])}
               for i in range(n_orderers)]

    cfg = ChannelConfig(
        channel_id=channel_id,
        sequence=0,
        orgs=tuple(org_cfgs),
        policies=default_policies(list(all_orgs)),
        batch=batch or BatchConfig(max_message_count=8, timeout_s=0.2),
        consenters=tuple(cluster),
    )
    cfg_hex = cfg.serialize().hex()

    chaincodes = chaincodes or [
        {"name": "assets", "version": "1.0", "contract": "asset_demo",
         "policy": "AND(%s)" % ", ".join(
             f"'{o}.member'" for o in peer_orgs)}]
    collections = collections or []

    # peer identities first: every peer hosts a gateway whose
    # handshake-verified transport identity the orderers pin as a
    # verdict-attestation attestor — trusting attestations is OFF by
    # node default, so the dev provisioner opts in EXPLICITLY with the
    # exact (mspid, cert sha256) bindings allowed to vouch
    peer_list = []
    idx = 0
    for org_name in peer_orgs:
        for j in range(peers_per_org):
            peer_list.append((org_name, j, peer_ports[idx]))
            idx += 1
    peer_creds = {(o, j): p_orgs[o].issuer.issue(f"peer{j}@{o}")
                  for o, j, _ in peer_list}
    attestors = [{"mspid": o, "cert_fp": cert_fingerprint(c)}
                 for (o, _), (c, _k) in peer_creds.items()]

    # orderers
    orderer_paths = []
    for i in range(n_orderers):
        node_dir = os.path.join(base_dir, f"orderer{i + 1}")
        os.makedirs(node_dir, exist_ok=True)
        cert, key = creds[i]
        path = os.path.join(base_dir, f"orderer{i + 1}.json")
        with open(path, "w") as f:
            json.dump({
                "mspid": "OrdererOrg", "raft_id": i + 1,
                "host": "127.0.0.1", "port": ord_ports[i],
                "cert_pem": _cert_pem(cert).decode(),
                "key_pem": _key_pem(key).decode(),
                "channel_config_hex": cfg_hex,
                "cluster": cluster, "data_dir": node_dir,
                "verify_once": {"trust_attestations": True,
                                "attestors": attestors,
                                "attest_deliver": True},
            }, f)
        orderer_paths.append(path)

    # spare orderers: identity + config on disk, EXCLUDED from the
    # genesis consenter tuple and every bootstrap cluster list.  A
    # spare that starts up is a silent learner (its raft node refuses
    # to campaign while outside the consenter set) until a committed
    # add-consenter config entry teaches the whole channel its binding.
    spare_paths = []
    spare_creds = [ord_org.issuer.issue(
        f"orderer{n_orderers + s + 1}@OrdererOrg")
        for s in range(spare_orderers)]
    for s in range(spare_orderers):
        rid = n_orderers + s + 1
        node_dir = os.path.join(base_dir, f"orderer{rid}")
        os.makedirs(node_dir, exist_ok=True)
        cert, key = spare_creds[s]
        path = os.path.join(base_dir, f"orderer{rid}.json")
        with open(path, "w") as f:
            json.dump({
                "mspid": "OrdererOrg", "raft_id": rid,
                "host": "127.0.0.1", "port": spare_ports[s],
                "cert_pem": _cert_pem(cert).decode(),
                "key_pem": _key_pem(key).decode(),
                "cert_fp": cert_fingerprint(cert),
                "channel_config_hex": cfg_hex,
                "cluster": cluster, "data_dir": node_dir,
                "verify_once": {"trust_attestations": True,
                                "attestors": attestors,
                                "attest_deliver": True},
            }, f)
        spare_paths.append(path)

    # the reverse direction: peers pin the orderer identities so the
    # admission-verdict digests riding deliver frames are honoured —
    # again an explicit dev-provisioner opt-in, off by node default.
    # Spares are pinned too: attestor trust is an identity allowlist,
    # not a membership statement, and a joined spare attests like any
    # other consenter.
    orderer_attestors = [{"mspid": "OrdererOrg",
                          "cert_fp": cert_fingerprint(c)}
                         for c, _k in creds + spare_creds]

    # peers: each knows every OTHER peer's endpoint + org (privdata push,
    # discovery membership)
    peer_paths = []
    for org_name, j, port in peer_list:
        org = p_orgs[org_name]
        node_dir = os.path.join(base_dir, f"peer{org_name}_{j}")
        os.makedirs(node_dir, exist_ok=True)
        cert, key = peer_creds[(org_name, j)]
        others = [["127.0.0.1", p, o] for (o, k, p) in peer_list
                  if (o, k) != (org_name, j)]
        path = os.path.join(base_dir, f"peer{org_name}_{j}.json")
        with open(path, "w") as f:
            json.dump({
                "mspid": org_name, "channel_id": channel_id,
                "host": "127.0.0.1", "port": port,
                "cert_pem": _cert_pem(cert).decode(),
                "key_pem": _key_pem(key).decode(),
                "channel_config_hex": cfg_hex,
                # the full ordering-service roster INCLUDING spares:
                # endpoint knowledge is fleet provisioning, not
                # membership — a spare that later joins (and may even
                # lead) must be dialable, an unstarted one just fails
                # dial and the broadcast/deliver failover walks on
                "orderers": [["127.0.0.1", p]
                             for p in ord_ports + spare_ports],
                "peers": others,
                "chaincodes": chaincodes,
                "collections": collections,
                "data_dir": node_dir,
                "verify_once": {"trust_attestations": True,
                                "attestors": orderer_attestors},
            }, f)
        peer_paths.append(path)

    # per-org clients: one per signature scheme the MSP accepts, so
    # mixed-identity workloads (workload/scenarios.py) can blend P-256
    # and ed25519 creators against the same channel
    from fabric_tpu_torch.bccsp import SCHEME_ED25519
    clients = {}
    clients_ed25519 = {}
    for org_name, org in p_orgs.items():
        for scheme, book in (
                (None, clients), (SCHEME_ED25519, clients_ed25519)):
            ccert, ckey = org.issuer.issue(f"client@{org_name}",
                                           scheme=scheme)
            suffix = f"_{scheme}" if scheme else ""
            path = os.path.join(base_dir,
                                f"client_{org_name}{suffix}.json")
            with open(path, "w") as f:
                json.dump({
                    "mspid": org_name,
                    "cert_pem": _cert_pem(ccert).decode(),
                    "key_pem": _key_pem(ckey).decode(),
                    "channel_config_hex": cfg_hex,
                    "channel_id": channel_id,
                    "orderers": [["127.0.0.1", p]
                                 for p in ord_ports + spare_ports],
                    "peers": [["127.0.0.1", p, o]
                              for (o, k, p) in peer_list],
                }, f)
            book[org_name] = path
    # per-org ADMIN identities (channel-config admin certs): the admin
    # CLI's install/join verbs are Admins-gated
    admins = {}
    for org_name, org in p_orgs.items():
        path = os.path.join(base_dir, f"admin_{org_name}.json")
        with open(path, "w") as f:
            json.dump({
                "mspid": org_name,
                "cert_pem": _cert_pem(org.admin.cert).decode(),
                "key_pem": _key_pem(org.admin._key.key).decode(),
                "channel_config_hex": cfg_hex,
                "channel_id": channel_id,
            }, f)
        admins[org_name] = path
    return {"orderers": orderer_paths, "peers": peer_paths,
            "spare_orderers": spare_paths,
            "clients": clients, "clients_ed25519": clients_ed25519,
            "admins": admins}
