"""Pure-Python mirror of the C pass-1 walker (native/fastcollect.c).

The validator's pass 1 has exactly one consumer tail
(TxValidator._collect_tx_fast); this module and the C extension are two
interchangeable front walkers that MUST produce identical records for
every input — C-enabled and no-compiler peers would otherwise commit
divergent validity bitmaps for the same block (a state fork).  Every
structural decision below is a line-for-line mirror of collect_env /
do_action / do_ns_rwset in fastcollect.c; tests/test_committer.py runs
the two differentially, including non-canonical and type-fuzzed
envelopes (tests/test_torch_classic.py holds this copy against the
reference's mirror and the port's walker).

Canonicality: serde.decode is strict (utils/serde.py), so decoding here
rejects exactly the inputs the C walker's canon_span rejects, and
re-encoding a decoded subtree reproduces the original span bytes — the
property that makes the C walker's span splicing equal this module's
serde.encode for the endorsed bytes.

Reference analogue: the structural half of ValidateTransaction
(core/common/validation/msgvalidation.go:248) plus the per-action
unpacking of validator.go:298-453.

Counterpart of `fabric_tpu/committer/collect_py.py`, whole.  The port's
C walker always loads or raises, so the validator runs this mirror only
under `force_python_collect`.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple, Union

from fabric_tpu_torch.utils import serde

E_NIL_ENVELOPE = 1
E_BAD_PAYLOAD = 2
E_TARGET_CHAIN = 3
E_BAD_TXID = 4
E_UNKNOWN_TYPE = 5
E_NIL_TXACTION = 6

_MISSING = object()


def _ns_rwset(d, ns_writes: list, meta_writes: list) -> bool:
    """Mirror of do_ns_rwset: False = malformed (whole tx BAD_PAYLOAD)."""
    if not isinstance(d, dict):
        return False
    ns = d.get("namespace")
    if not isinstance(ns, str):
        return False
    writes = d.get("writes", _MISSING)
    if writes is _MISSING:
        return True
    if not isinstance(writes, list):
        return False
    if not writes:
        return True
    # ">= 5" semantics: "#meta" itself is meta with base "" (sbe.py)
    is_meta = ns.endswith("#meta")
    base = ns[:-5] if is_meta else ns
    keys = []
    for w in writes:
        if not isinstance(w, dict):
            return False
        k = w.get("key")
        if not isinstance(k, str):
            return False
        is_delete = w.get("is_delete", False)
        if not isinstance(is_delete, bool):
            return False
        if is_meta:
            # the C walker type-checks a present "value" ('B') even for
            # deletes; a missing value defaults to b""
            val = w.get("value", _MISSING)
            if val is not _MISSING and not isinstance(val, bytes):
                return False
            meta_writes.append(
                (base, k, None if is_delete
                 else (b"" if val is _MISSING else val)))
        else:
            keys.append(k)
    if not is_meta:
        ns_writes.append((ns, tuple(keys)))
    return True


def _action(d) -> Optional[tuple]:
    """Mirror of do_action: None = malformed."""
    if not isinstance(d, dict):
        return None
    act = d.get("action", _MISSING)
    ph = d.get("proposal_hash", _MISSING)
    if act is _MISSING or ph is _MISSING:
        return None
    if not isinstance(act, dict):
        return None
    cc_id = act.get("chaincode_id", _MISSING)
    if cc_id is _MISSING or not isinstance(cc_id, str):
        return None
    ns_writes: list = []
    meta_writes: list = []
    rw = act.get("rwset", _MISSING)
    if rw is not _MISSING:
        if not isinstance(rw, dict):
            return None
        ns_list = rw.get("ns", _MISSING)
        if ns_list is not _MISSING:
            if not isinstance(ns_list, list):
                return None
            for nsd in ns_list:
                if not _ns_rwset(nsd, ns_writes, meta_writes):
                    return None
    # endorsed bytes: with canonical encoding enforced, this re-encode
    # equals the C walker's raw span splice byte-for-byte
    endorsed = serde.encode({"action": act, "proposal_hash": ph})
    ends_out = []
    ends = d.get("endorsements", _MISSING)
    if ends is not _MISSING:
        if not isinstance(ends, list):
            return None
        for e in ends:
            if not isinstance(e, dict):
                return None
            edr = e.get("endorser")
            esig = e.get("signature")
            if not isinstance(edr, bytes) or not isinstance(esig, bytes):
                return None
            ends_out.append(
                (edr, esig, hashlib.sha256(endorsed + edr).digest()))
    return (cc_id, endorsed, ends_out, ns_writes, meta_writes)


def collect_env(env_bytes, channel_id: str) -> Union[int, tuple]:
    """Mirror of collect_env: int code, (code, txid), or the full record
    (txtype, txid, creator, payload, payload_digest, signature, actions)."""
    if not env_bytes:
        return E_NIL_ENVELOPE
    try:
        d = serde.decode(bytes(env_bytes))
    except Exception:
        return E_BAD_PAYLOAD
    if not isinstance(d, dict):
        return E_BAD_PAYLOAD
    payload = d.get("payload")
    signature = d.get("signature")
    if not isinstance(payload, bytes) or not isinstance(signature, bytes):
        return E_BAD_PAYLOAD
    try:
        p = serde.decode(payload)
    except Exception:
        return E_BAD_PAYLOAD
    if not isinstance(p, dict):
        return E_BAD_PAYLOAD
    header = p.get("header")
    if not isinstance(header, dict):
        return E_BAD_PAYLOAD
    ch = header.get("channel_header")
    sh = header.get("signature_header")
    if not isinstance(ch, dict) or not isinstance(sh, dict):
        return E_BAD_PAYLOAD
    typ = ch.get("type")
    chan = ch.get("channel_id")
    txid = ch.get("txid")
    if not (isinstance(typ, str) and isinstance(chan, str)
            and isinstance(txid, str)):
        return E_BAD_PAYLOAD
    creator = sh.get("creator")
    nonce = sh.get("nonce")
    if not (isinstance(creator, bytes) and isinstance(nonce, bytes)):
        return E_BAD_PAYLOAD

    if chan != channel_id:
        return E_TARGET_CHAIN
    if txid != hashlib.sha256(nonce + creator).hexdigest():
        return E_BAD_TXID

    # failures past a known-good txid return (code, txid) so the
    # consumer registers the txid before flagging (duplicate semantics)
    is_config = typ == "config"
    if not is_config and typ != "endorser_transaction":
        return (E_UNKNOWN_TYPE, txid)

    actions = None
    if not is_config:
        data = p.get("data", _MISSING)
        if data is _MISSING or not isinstance(data, dict):
            return (E_BAD_PAYLOAD, txid)
        acts = data.get("actions", _MISSING)
        if acts is _MISSING or not isinstance(acts, list):
            return (E_BAD_PAYLOAD, txid)
        if not acts:
            return (E_NIL_TXACTION, txid)
        actions = []
        for a in acts:
            r = _action(a)
            if r is None:
                return (E_BAD_PAYLOAD, txid)
            actions.append(r)

    pdigest = hashlib.sha256(payload).digest()
    return (0 if is_config else 1, txid, creator, payload, pdigest,
            signature, actions)


def collect(envs, channel_id: str) -> List[Union[int, tuple]]:
    return [collect_env(e, channel_id) for e in envs]
