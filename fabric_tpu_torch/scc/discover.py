"""`discover` client CLI — service-discovery queries over the RPC plane.

Reference parity: cmd/discover/main.go + discovery/client
(`discover peers|config|endorsers` against a peer's discovery service).

    python -m fabric_tpu_torch.scc.discover --client client.json \
        --msp-config <node.json|channel_config.bin> \
        --peer 127.0.0.1:7051 [--channel ch] \
        endorsers --chaincode asset
        peers
        config

Output is one JSON document per query, like the reference CLI's
--json mode.

Counterpart of `fabric_tpu/scc/discover.py`, whole, on the port's imports.
"""

from __future__ import annotations

import argparse
import json
import sys

from fabric_tpu_torch.node.admin import _connect, _load_client, _load_msps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fabric-tpu-torch-discover")
    ap.add_argument("--client", required=True)
    ap.add_argument("--msp-config", required=True)
    ap.add_argument("--peer", required=True)
    ap.add_argument("--channel", default=None)
    sub = ap.add_subparsers(dest="verb", required=True)
    e = sub.add_parser("endorsers")
    e.add_argument("--chaincode", required=True)
    sub.add_parser("peers")
    sub.add_parser("config")

    args = ap.parse_args(argv)
    signer = _load_client(args.client)
    msps = _load_msps(args.msp_config)
    body = {}
    if args.channel:
        body["channel"] = args.channel

    conn = _connect(args.peer, signer, msps)
    try:
        if args.verb == "endorsers":
            out = conn.call("discovery.endorsers",
                            {**body, "namespace": args.chaincode},
                            timeout=15.0)
        elif args.verb == "peers":
            out = conn.call("discovery.peers", body, timeout=15.0)
        else:
            out = conn.call("discovery.config", body, timeout=15.0)
    finally:
        conn.close()
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
