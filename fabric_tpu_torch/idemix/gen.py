"""idemixgen: generate issuer material and signer configs on disk.

The port's own copy of `fabric_tpu/idemix/gen.py`; its files and the
reference's are read by either package.  Fabric's cmd/idemixgen — `ca-keygen`
writes the issuer key pair + revocation authority material, and
`signerconfig` enrolls users and writes their credentials.

Usage:
  python -m fabric_tpu_torch.idemix.gen <outdir> --mspid IdemixOrg \
      --user alice:engineering:member --user boss:hq:admin

Outputs (serde files):
  <outdir>/issuer.key        issuer secret (x + bases)          KEEP SECRET
  <outdir>/ipk.bin           issuer public key
  <outdir>/ra.pem            revocation authority public key
  <outdir>/msp_config.bin    {mspid, ipk, ra_pk, epoch record}
  <outdir>/<user>.signer     {credential, ou, role, rh, handle_sig}
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

from fabric_tpu_torch.utils import serde

from . import credential as cred
from . import revocation as rev
from .msp import (
    ATTR_RH,
    N_ATTRS,
    ROLE_ADMIN,
    ROLE_MEMBER,
    IdemixMSPConfig,
    IdemixSigningIdentity,
    enroll,
    serialize_credential,
    deserialize_credential,
    serialize_ipk,
)


def generate(outdir: str, mspid: str, users: List[str],
             epoch: int = 1, alg: int = rev.ALG_PLAIN_SIGNATURE) -> dict:
    os.makedirs(outdir, exist_ok=True)
    isk = cred.IssuerKey.generate(N_ATTRS)
    ra = rev.RevocationAuthority()
    epk = ra.epoch_pk(epoch, alg=alg)
    ipk_bytes = serialize_ipk(isk.public())
    config = IdemixMSPConfig(mspid, ipk_bytes, ra.public_key_pem(), epk)

    with open(os.path.join(outdir, "issuer.key"), "wb") as f:
        f.write(serde.encode({"x": isk.x, "ipk": ipk_bytes}))
    with open(os.path.join(outdir, "ipk.bin"), "wb") as f:
        f.write(ipk_bytes)
    with open(os.path.join(outdir, "ra.pem"), "wb") as f:
        f.write(ra.public_key_pem())
    with open(os.path.join(outdir, "msp_config.bin"), "wb") as f:
        f.write(serde.encode({
            "mspid": mspid, "ipk": ipk_bytes, "ra": ra.public_key_pem(),
            "epoch": epk.epoch, "alg": epk.alg, "w": epk.w_e,
            "sig": epk.signature}))

    written = {}
    for spec in users:
        name, ou, role_s = (spec.split(":") + ["", "member"])[:3]
        role = ROLE_ADMIN if role_s == "admin" else ROLE_MEMBER
        signer = enroll(isk, config, ou, role, name, ra=ra)
        path = os.path.join(outdir, f"{name}.signer")
        with open(path, "wb") as f:
            f.write(serde.encode({
                "mspid": mspid, "ou": ou, "role": role,
                "credential": serialize_credential(signer._cred),
                "handle_sig": (list(signer._handle_sig)
                               if signer._handle_sig else []),
            }))
        written[name] = path
    return {"config": config, "ra": ra, "isk": isk, "signers": written}


def load_msp_config(path: str) -> IdemixMSPConfig:
    with open(path, "rb") as f:
        d = serde.decode(f.read())
    epk = None
    if d.get("w") or d.get("sig"):
        epk = rev.EpochPK(int(d["epoch"]), int(d["alg"]), d["w"], d["sig"])
    return IdemixMSPConfig(d["mspid"], d["ipk"], d["ra"], epk)


def load_signer(signer_path: str, msp_config_path: str) -> IdemixSigningIdentity:
    config = load_msp_config(msp_config_path)
    with open(signer_path, "rb") as f:
        d = serde.decode(f.read())
    credential = deserialize_credential(d["credential"])
    hs = tuple(int(v) for v in d["handle_sig"]) if d["handle_sig"] else None
    return IdemixSigningIdentity(d["mspid"], config, credential,
                                 str(d["ou"]), int(d["role"]),
                                 handle_sig=hs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="idemixgen")
    ap.add_argument("outdir")
    ap.add_argument("--mspid", default="IdemixOrg")
    ap.add_argument("--user", action="append", default=[],
                    help="name:ou:role (role: member|admin)")
    ap.add_argument("--epoch", type=int, default=1)
    args = ap.parse_args(argv)
    out = generate(args.outdir, args.mspid, args.user, epoch=args.epoch)
    print(f"issuer material + {len(out['signers'])} signer configs "
          f"written to {args.outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
