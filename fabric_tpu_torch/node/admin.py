"""Peer admin CLI — channel and chaincode verbs over the RPC plane.

Reference parity: the `peer channel join` / `peer lifecycle chaincode
package|install|approveformyorg|commit|querycommitted` command surface
(internal/peer/{channel,lifecycle}).  Each verb is a
thin client of the running nodes' authenticated RPC plane — nothing
here touches node state directly.

    python -m fabric_tpu_torch.node.admin --client client.json \
        --msp-config <node.json|channel_config.bin> \
        channel join --peer 127.0.0.1:7051 --config chB.bin [--height N]
        channel list --peer ...
        chaincode package --label asset --code-file cc.py --out pkg.bin
        chaincode install --peer ... --package pkg.bin
        chaincode installed --peer ...
        chaincode approve --peer ... --orderer ... --channel ch \
            --name asset --version 1.0 --sequence 1 [--policy EXPR]
        chaincode commit  --peer ... --orderer ... (same flags)
        chaincode querycommitted --peer ... --channel ch --name asset
        gateway evaluate --peer ... --channel ch --name asset \
            --fn read --arg a1
        gateway submit --peer ... --channel ch --name asset \
            --fn create --arg a1 --arg alice --arg 100

The gateway verbs go through the peer's gateway service
(fabric_tpu_torch/gateway): one peer connection drives the whole endorse ->
order -> commit-status lifecycle instead of the client dialing every
peer and orderer itself.

`--msp-config` supplies the verification MSPs for the transport
handshake: a node JSON (its channel_config_hex) or a serialized
ChannelConfig.

Counterpart of `fabric_tpu/node/admin.py`, whole, on the port's imports;
it speaks the reference's RPC verbs, so it drives nodes of either
package.  One addition: `_connect` makes the process's default provider
before it dials (on the card the CUDA provider, whose first making takes
seconds), since the handshake verifies through it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _addr(s: str):
    host, port = s.rsplit(":", 1)
    return host, int(port)


def _load_client(path: str):
    from fabric_tpu_torch.node.orderer import load_signing_identity
    with open(path) as f:
        c = json.load(f)
    return load_signing_identity(c["mspid"], c["cert_pem"].encode(),
                                 c["key_pem"].encode())


def _load_msps(path: str):
    from fabric_tpu_torch.config import Bundle, ChannelConfig
    if path.endswith(".json"):
        with open(path) as f:
            cfg = json.load(f)
        raw = bytes.fromhex(cfg["channel_config_hex"])
    else:
        with open(path, "rb") as f:
            raw = f.read()
    return Bundle(ChannelConfig.deserialize(raw)).msps


def _connect(addr_s: str, signer, msps):
    from fabric_tpu_torch.bccsp import factory
    from fabric_tpu_torch.comm.rpc import connect
    # the handshake verifies the node's transcript signature through the
    # process's default provider: make it first (on the card, the CUDA
    # context), so that its making does not run into the node's 10-s
    # handshake timeout
    factory.get_default()
    return connect(_addr(addr_s), signer, msps, timeout=10.0)


# -- chaincode tx flow (proposal -> endorse -> broadcast -> committed) -------

def _lifecycle_tx(args, signer, msps, fn: str, fnargs) -> str:
    """Drive one `_lifecycle` invoke end-to-end; returns the txid."""
    from fabric_tpu_torch.chaincode import LIFECYCLE_NS
    from fabric_tpu_torch.endorser.proposal import (ProposalResponse,
                                              assemble_transaction,
                                              signed_proposal)
    from fabric_tpu_torch.protocol.types import Endorsement

    sp = signed_proposal(args.channel, LIFECYCLE_NS, fn, fnargs, signer)
    responses = []
    for peer_addr in args.peer:
        conn = _connect(peer_addr, signer, msps)
        try:
            out = conn.call("endorse", {
                "channel": args.channel,
                "proposal": sp.proposal_bytes,
                "signature": sp.signature,
            }, timeout=30.0)
        finally:
            conn.close()
        if out["status"] != 200:
            raise SystemExit(f"endorsement failed on {peer_addr}: "
                             f"{out['message']}")
        responses.append(ProposalResponse(
            out["status"], out["message"], out["payload"],
            Endorsement(out["endorser"], out["endorsement_sig"])))
    env = assemble_transaction(sp, responses, signer)

    oconn = _connect(args.orderer, signer, msps)
    try:
        resp = oconn.call("broadcast", {"envelope": env.serialize()},
                          timeout=30.0)
        if resp["status"] != 200:
            raise SystemExit(f"broadcast rejected: {resp}")
    finally:
        oconn.close()

    txid = env.header().channel_header.txid
    # wait until a peer has the tx committed (qscc.GetTransactionByID)
    deadline = time.time() + float(args.timeout)
    conn = _connect(args.peer[0], signer, msps)
    try:
        while time.time() < deadline:
            try:
                conn.call("qscc.tx_by_id",
                          {"channel": args.channel, "txid": txid},
                          timeout=10.0)
                return txid
            except Exception:
                time.sleep(0.3)
    finally:
        conn.close()
    raise SystemExit(f"tx {txid} not committed within {args.timeout}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fabric-tpu-torch-admin")
    ap.add_argument("--client", required=True,
                    help="client identity json (mspid/cert_pem/key_pem)")
    ap.add_argument("--msp-config", required=True,
                    help="node json or serialized ChannelConfig for "
                         "handshake MSPs")
    sub = ap.add_subparsers(dest="group", required=True)

    chan = sub.add_parser("channel").add_subparsers(dest="verb",
                                                    required=True)
    j = chan.add_parser("join")
    j.add_argument("--peer", required=True)
    j.add_argument("--config", required=True,
                   help="serialized ChannelConfig file")
    j.add_argument("--height", type=int, default=0)
    ls = chan.add_parser("list")
    ls.add_argument("--peer", required=True)

    cc = sub.add_parser("chaincode").add_subparsers(dest="verb",
                                                    required=True)
    pk = cc.add_parser("package")
    pk.add_argument("--label", required=True)
    pk.add_argument("--code-file", required=True)
    pk.add_argument("--out", required=True)
    for name in ("install", "installed"):
        p = cc.add_parser(name)
        p.add_argument("--peer", required=True)
        if name == "install":
            p.add_argument("--package", required=True)
    for name in ("approve", "commit"):
        p = cc.add_parser(name)
        p.add_argument("--peer", action="append", required=True,
                       help="endorsing peer addr (repeatable)")
        p.add_argument("--orderer", required=True)
        p.add_argument("--channel", required=True)
        p.add_argument("--name", required=True)
        p.add_argument("--version", required=True)
        p.add_argument("--sequence", required=True)
        p.add_argument("--policy", default="")
        p.add_argument("--timeout", default="30")
    q = cc.add_parser("querycommitted")
    q.add_argument("--peer", action="append", required=True)
    q.add_argument("--orderer", default="")
    q.add_argument("--channel", required=True)
    q.add_argument("--name", required=True)

    gw = sub.add_parser("gateway").add_subparsers(dest="verb",
                                                  required=True)
    for name in ("evaluate", "submit"):
        p = gw.add_parser(name)
        p.add_argument("--peer", required=True,
                       help="gateway peer addr (host:port)")
        p.add_argument("--channel", required=True)
        p.add_argument("--name", required=True, help="chaincode name")
        p.add_argument("--fn", required=True)
        p.add_argument("--arg", action="append", default=[],
                       help="chaincode argument (repeatable)")
        if name == "submit":
            p.add_argument("--timeout", default="30",
                           help="commit-status wait (seconds)")

    args = ap.parse_args(argv)
    signer = _load_client(args.client)
    msps = _load_msps(args.msp_config)

    if args.group == "channel" and args.verb == "join":
        with open(args.config, "rb") as f:
            cfg_bytes = f.read()
        conn = _connect(args.peer, signer, msps)
        try:
            out = conn.call("cscc.join", {
                "config": cfg_bytes, "config_height": args.height,
            }, timeout=30.0)
        finally:
            conn.close()
        print(json.dumps(out))
    elif args.group == "channel" and args.verb == "list":
        conn = _connect(args.peer, signer, msps)
        try:
            out = conn.call("cscc.channels", {}, timeout=10.0)
        finally:
            conn.close()
        print(json.dumps(out))
    elif args.group == "chaincode" and args.verb == "package":
        from fabric_tpu_torch.chaincode.lifecycle import (package_chaincode,
                                                    package_id)
        with open(args.code_file, "rb") as f:
            code = f.read()
        pkg = package_chaincode(args.label, code)
        with open(args.out, "wb") as f:
            f.write(pkg)
        print(json.dumps({"package_id": package_id(pkg)}))
    elif args.group == "chaincode" and args.verb == "install":
        with open(args.package, "rb") as f:
            pkg = f.read()
        conn = _connect(args.peer, signer, msps)
        try:
            out = conn.call("lifecycle.install", {"package": pkg},
                            timeout=30.0)
        finally:
            conn.close()
        print(json.dumps(out))
    elif args.group == "chaincode" and args.verb == "installed":
        conn = _connect(args.peer, signer, msps)
        try:
            out = conn.call("lifecycle.installed", {}, timeout=10.0)
        finally:
            conn.close()
        print(json.dumps(out))
    elif args.group == "chaincode" and args.verb in ("approve", "commit"):
        fn = "approve_for_org" if args.verb == "approve" else "commit"
        fnargs = [args.name.encode(), args.version.encode(),
                  str(int(args.sequence)).encode(),
                  args.policy.encode()]
        txid = _lifecycle_tx(args, signer, msps, fn, fnargs)
        status = "approved" if args.verb == "approve" else "committed"
        print(json.dumps({"txid": txid, "status": status}))
    elif args.group == "chaincode" and args.verb == "querycommitted":
        from fabric_tpu_torch.chaincode import LIFECYCLE_NS
        from fabric_tpu_torch.endorser.proposal import signed_proposal
        sp = signed_proposal(args.channel, LIFECYCLE_NS,
                             "query_definition", [args.name.encode()],
                             signer)
        conn = _connect(args.peer[0], signer, msps)
        try:
            out = conn.call("endorse", {
                "channel": args.channel,
                "proposal": sp.proposal_bytes,
                "signature": sp.signature,
            }, timeout=30.0)
        finally:
            conn.close()
        if out["status"] != 200:
            raise SystemExit(f"query failed: {out['message']}")
        from fabric_tpu_torch.utils import serde
        payload = serde.decode(out["payload"])
        defn = serde.decode(payload["action"]["response_payload"])
        defn = {k: (v.hex() if isinstance(v, bytes) else v)
                for k, v in defn.items()}
        print(json.dumps({"definition": defn}))
    elif args.group == "gateway":
        from fabric_tpu_torch.gateway import GatewayClient, GatewayError
        from fabric_tpu_torch.utils import serde
        gwc = GatewayClient(_addr(args.peer), signer, msps,
                            channel_id=args.channel)
        fnargs = [a.encode() for a in args.arg]
        try:
            if args.verb == "evaluate":
                payload = gwc.evaluate(args.name, args.fn, fnargs)
                resp = serde.decode(payload)["action"]["response_payload"]
                print(json.dumps({
                    "result": resp.decode("utf-8", "backslashreplace")}))
            else:
                code, block = gwc.submit_transaction(
                    args.name, args.fn, fnargs,
                    commit_timeout_s=float(args.timeout))
                print(json.dumps({"status": "committed", "code": code,
                                  "block": block}))
        except GatewayError as exc:
            raise SystemExit(f"gateway {args.verb} failed: {exc}")
        finally:
            gwc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
