"""configtxlator: config <-> JSON translation + update computation.

Reference parity: Fabric's internal/configtxlator — the ops tool
that turns opaque serialized channel config into reviewable JSON
(`proto_decode`), back (`proto_encode`), and computes the delta between
an original and an updated config (`compute_update`).  Here the wire
form is the framework's canonical serde of ChannelConfig; bytes fields
render as {"$base64": ...} so the JSON is lossless.

CLI:
  python -m fabric_tpu_torch.config.lator decode  <config.bin>  > config.json
  python -m fabric_tpu_torch.config.lator encode  <config.json> > config.bin
  python -m fabric_tpu_torch.config.lator compute-update <orig.bin> <new.json>
      > update.bin    (re-sequenced updated config + human diff on stderr)

Counterpart of `fabric_tpu/config/lator.py`, the same code on the port's
imports: on the same config bytes its output is byte-equal to the
reference's.
"""

from __future__ import annotations

import base64
import json
import sys
from typing import Any, List

from .channelconfig import ChannelConfig


def jsonify(v: Any) -> Any:
    if isinstance(v, (bytes, bytearray)):
        return {"$base64": base64.b64encode(bytes(v)).decode()}
    if isinstance(v, dict):
        return {k: jsonify(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [jsonify(x) for x in v]
    return v


def dejsonify(v: Any) -> Any:
    if isinstance(v, dict):
        if set(v) == {"$base64"}:
            return base64.b64decode(v["$base64"])
        return {k: dejsonify(x) for k, x in v.items()}
    if isinstance(v, list):
        return [dejsonify(x) for x in v]
    return v


def decode_config(raw: bytes) -> str:
    cfg = ChannelConfig.deserialize(raw)
    return json.dumps(jsonify(cfg.to_dict()), indent=2, sort_keys=True)


def encode_config(json_text: str) -> bytes:
    d = dejsonify(json.loads(json_text))
    return ChannelConfig.from_dict(d).serialize()


def compute_update(original_raw: bytes, updated_json: str):
    """-> (updated config bytes with sequence = original+1, diff lines).

    The reference emits a ConfigUpdate proto (read/write set delta); this
    framework's config plane replaces whole configs at commit
    (config/configtx.py), so the 'update' is the re-sequenced new config
    plus a reviewable diff of what changed.
    """
    orig = ChannelConfig.deserialize(original_raw)
    new = ChannelConfig.from_dict(dejsonify(json.loads(updated_json)))
    if new.channel_id != orig.channel_id:
        raise ValueError(
            f"channel mismatch: {new.channel_id!r} vs {orig.channel_id!r}")
    import dataclasses
    new = dataclasses.replace(new, sequence=orig.sequence + 1)

    diff: List[str] = []
    o_orgs = {o.mspid: o for o in orig.orgs}
    n_orgs = {o.mspid: o for o in new.orgs}
    for mspid in sorted(set(n_orgs) - set(o_orgs)):
        diff.append(f"+ org {mspid}")
    for mspid in sorted(set(o_orgs) - set(n_orgs)):
        diff.append(f"- org {mspid}")
    for mspid in sorted(set(o_orgs) & set(n_orgs)):
        if o_orgs[mspid] != n_orgs[mspid]:
            diff.append(f"~ org {mspid} (MSP material changed)")
    for name in sorted(set(orig.policies) | set(new.policies)):
        a, b = orig.policies.get(name), new.policies.get(name)
        if a != b:
            tag = "+" if a is None else ("-" if b is None else "~")
            diff.append(f"{tag} policy {name}")
    if tuple(orig.capabilities) != tuple(new.capabilities):
        diff.append(f"~ capabilities {sorted(orig.capabilities)} -> "
                    f"{sorted(new.capabilities)}")
    if orig.batch != new.batch:
        diff.append("~ batch config")
    if tuple(orig.consenters) != tuple(new.consenters):
        diff.append(f"~ consenters {list(orig.consenters)} -> "
                    f"{list(new.consenters)}")
    diff.append(f"sequence {orig.sequence} -> {new.sequence}")
    return new.serialize(), diff


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    cmd = argv[0]
    if cmd == "decode" and len(argv) == 2:
        with open(argv[1], "rb") as f:
            sys.stdout.write(decode_config(f.read()))
        return 0
    if cmd == "encode" and len(argv) == 2:
        with open(argv[1]) as f:
            sys.stdout.buffer.write(encode_config(f.read()))
        return 0
    if cmd == "compute-update" and len(argv) == 3:
        with open(argv[1], "rb") as f:
            orig = f.read()
        with open(argv[2]) as f:
            raw, diff = compute_update(orig, f.read())
        sys.stdout.buffer.write(raw)
        for line in diff:
            print(line, file=sys.stderr)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
