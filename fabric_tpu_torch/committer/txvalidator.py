"""Block validation orchestrator — the verify-then-gate hot path.

Reference flow being restructured (SURVEY.md §3.2, §7):
  core/committer/txvalidator/v20/validator.go:181-266 Validate(block):
    per-tx goroutines (:194-209) each doing
      ValidateTransaction (core/common/validation/msgvalidation.go:248)
        checkSignatureFromCreator (:26-56)          <- 1 ECDSA verify
      Dispatcher.Dispatch (plugindispatcher/dispatcher.go:102)
        builtin v20 Validate (validation_logic.go:185)
          policy EvaluateSignedData                 <- N ECDSA verifies
    then txflags bitmap assembly (:214-260).

Restructured in three passes over the whole block:
  PASS 1 (host, no crypto):  the C walker (native/fastcollect.c digest +
    assemble) does structural validation, duplicate-txid marking, and
    *collection* of every SignedData the reference would have verified
    — creator sigs and endorsement sets — deduplicated globally by
    (scheme, pubkey, payload, signature) since Verify is a pure function.
  DISPATCH (device):         ONE batched provider.batch_verify_async for
    the entire block.
  PASS 2:                    gate on the verdict bitmap — on the device
    with MVCC when a DeviceValidator is wired (one KV7 launch, see
    committer/device_validate.py), else on the host (fastcollect.gate).

Counterpart of `fabric_tpu/committer/txvalidator.py`, its deep native
path only (`_begin_deep`, `_finish_deep`).  Not ported yet, and not
accepted by the constructor: the classic Python tail and `collect_py`
(so key-level endorsement, SBE, which needs that tail), the verify-once
cache, early abort, per-channel placement, sub-block dispatch chunks,
and the ops-plane spans and gauges.  The config-bundle source is
ported: with `bundle_source` the MSPs come from the current bundle,
pinned once per block.  `ValidationResult` keeps the reference's
timings.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from fabric_tpu_torch import native
from fabric_tpu_torch.bccsp import SCHEME_P256, VerifyItem
from fabric_tpu_torch.msp import Identity
from fabric_tpu_torch.policy import PolicyEvaluator, SignaturePolicy
from fabric_tpu_torch.protocol import Block
from fabric_tpu_torch.protocol.txflags import TxFlags
from fabric_tpu_torch.protocol.types import META_TXFLAGS
from fabric_tpu_torch.protocol.wire import n_txs

logger = logging.getLogger("fabric_tpu_torch.committer")

# C pass-1 walker and host gate (native/fastcollect.c)
_fastcollect = native.extension("fastcollect")

class PolicyRegistry:
    """namespace -> endorsement policy (the _lifecycle/plugindispatcher
    lookup surface, dispatcher.go:102).  Falls back to a default policy,
    like a chaincode with no explicit endorsement policy falls back to
    the channel's majority-endorsement default."""

    def __init__(self, default: Optional[SignaturePolicy] = None):
        self._policies: Dict[str, SignaturePolicy] = {}
        self._default = default

    def set_policy(self, namespace: str, policy: SignaturePolicy) -> None:
        self._policies[namespace] = policy

    def policy_for(self, namespace: str) -> Optional[SignaturePolicy]:
        return self._policies.get(namespace, self._default)


@dataclass
class ValidationResult:
    flags: TxFlags
    collect_s: float
    dispatch_s: float
    gate_s: float
    n_items: int
    n_unique_items: int

    @property
    def total_s(self) -> float:
        return self.collect_s + self.dispatch_s + self.gate_s


class TxValidator:
    """v20 TxValidator equivalent bound to one channel."""

    def __init__(self, channel_id: str, msps: Dict[str, object], provider,
                 policies: PolicyRegistry,
                 ledger_has_txid=None, bundle_source=None,
                 validation_plugin: str = "DefaultValidation",
                 device_validate=None):
        self.channel_id = channel_id
        self._static_msps = msps
        self.provider = provider
        self.policies = policies
        # channel config (config.BundleSource or None): the MSPs of the
        # current bundle, so a committed config block takes effect at the
        # next block
        self.bundle_source = bundle_source
        # pluggable commit-time decision (handlers/library/registry.go;
        # the builtin is the v20 policy gate)
        from fabric_tpu_torch.handlers import default_registry
        self.validation_plugin = default_registry.validation(
            validation_plugin)
        # blkstorage-backed duplicate-txid oracle (validator.go dedup vs
        # ledger).  The module-level sentinel (not a fresh lambda) lets
        # the deep C path detect "unwired" and skip a per-tx Python call.
        self.ledger_has_txid = ledger_has_txid or _false_oracle
        # (block_number, txid-map) of blocks begun whose txids the
        # ledger oracle cannot see yet: a pipelined caller
        # (validate_begin N+1 before block N commits) must still flag a
        # txid duplicated across the in-flight window.  Entries are
        # pruned at the NEXT begin, once the ledger can see them.  Maps
        # for block numbers >= the incoming block are also pruned: a
        # replay of the same or an earlier block is not a duplicate of
        # itself.
        self._inflight_txids: List[Tuple[int, Dict[str, int]]] = []
        # fused device validation (device_validate.DeviceValidator or
        # None): the gate fold AND MVCC run as one KV7 launch; the
        # prepared UpdateBatch is stashed for the ledger.  A demoted
        # block (hash collision, range query, ...) falls back to the
        # host gate below.
        self.device_validate = device_validate
        # wall seconds of pass 1's parts, last block begun
        self.last_timings: Dict[str, float] = {}

    @property
    def msps(self):
        """MSP set for the block being validated.  Snapshotted once per
        validate() call: all txs of one block must be judged under ONE
        config or peers could produce divergent validity bitmaps when a
        bundle swap races a long validation (the reference pins the bundle
        per block too, core/peer/peer.go:332-371)."""
        snap = getattr(self, "_msps_snapshot", None)
        if snap is not None:
            return snap
        if self.bundle_source is not None:
            return self.bundle_source.current().msps
        return self._static_msps

    @property
    def evaluator(self):
        return PolicyEvaluator(self.msps, self.provider)

    # -- identity resolution ------------------------------------------------

    def _deserialize(self, ident_bytes: bytes) -> Optional[Identity]:
        from fabric_tpu_torch.msp import deserialize_from_msps
        return deserialize_from_msps(self.msps, ident_bytes)

    def _resolve_creator(self, ident_bytes: bytes):
        """Creator memo value: (identity, p256_pub_wire|None), or None
        for identities the MSP rejects (deserialize + chain-validate,
        resolved once per unique creator)."""
        creator = self._deserialize(ident_bytes)
        if creator is not None and not _msp_validates(self.msps, creator):
            creator = None
        return None if creator is None else (
            creator, creator._pub_wire
            if getattr(creator, "scheme", None) == SCHEME_P256 else None)

    def _resolve_endorser(self, ident_bytes: bytes):
        """Endorser memo value — deserialize only, NO chain validation
        (an unrecognized endorser merely weakens the policy,
        policy.go:390-393)."""
        ident = self._deserialize(ident_bytes)
        return None if ident is None else (
            ident, ident._pub_wire
            if getattr(ident, "scheme", None) == SCHEME_P256 else None)

    # -- the block entry point (validator.go:181) ---------------------------

    def validate(self, block: Block) -> ValidationResult:
        return self.validate_finish(self.validate_begin(block))

    def validate_begin(self, block: Block) -> dict:
        """Pass 1 + async device enqueue for one block; returns the
        in-flight state for validate_finish.

        Splitting begin/finish lets a block-stream caller overlap host
        collection of block N+1 with device verification of block N."""
        self._msps_snapshot = (self.bundle_source.current().msps
                               if self.bundle_source is not None else None)
        try:
            return self._begin_inner(block)
        finally:
            self._msps_snapshot = None

    def validate_finish(self, state: dict) -> ValidationResult:
        self._msps_snapshot = state["msps"]
        try:
            return self._finish_deep(state)
        finally:
            self._msps_snapshot = None

    def _begin_inner(self, block: Block) -> dict:
        num = block.header.number
        # duplicate-txid oracle widened by the in-flight window: a txid
        # in an earlier block the ledger cannot see yet is a duplicate
        # here.  Prune entries the ledger now covers (committed) and
        # entries at/above this block's number (replay of the window).
        self._inflight_txids = [
            (bn, m) for bn, m in self._inflight_txids
            if m and bn < num
            and not self.ledger_has_txid(next(iter(m)))]
        carry = [m for _, m in self._inflight_txids]
        return self._begin_deep(block, num, carry)

    def _begin_deep(self, block: Block, num: int, carry: list) -> dict:
        """Deep native pass 1: the C walker consumes its own tuples
        (fastcollect digest/assemble) — txid dedup, creator/endorser
        memo slot assignment, and flat dispatch-ordered VerifyItem
        interning all run without per-tx Python bytecode.  Python's
        per-block work shrinks to resolving each UNIQUE identity once
        and launching the async device dispatch."""
        n = n_txs(block)
        t0 = time.perf_counter()
        oracle = self.ledger_has_txid
        if oracle is _false_oracle:
            oracle = None          # unwired: skip the per-tx call in C
        spans = getattr(block, "data_spans", None)
        if spans is not None:
            # zero-copy ingest: the envelopes are consumed as spans of
            # the block's raw wire bytes (protocol/wire.py BlockView) —
            # no per-tx bytes objects ever exist on this path
            codes, seen_txids, works, creators, endorsers = \
                _fastcollect.digest_spans(spans[0], spans[1],
                                          self.channel_id, carry, oracle)
        else:
            codes, seen_txids, works, creators, endorsers = \
                _fastcollect.digest(block.data, self.channel_id, carry,
                                    oracle)
        t1 = time.perf_counter()
        # one MSP resolution per unique identity
        c_ents = [self._resolve_creator(b) for b in creators]
        e_ents = [self._resolve_endorser(b) for b in endorsers]
        t2 = time.perf_counter()

        index: Dict[VerifyItem, int] = {}   # item -> dispatch position
        plans: list = []
        n_refs = _fastcollect.assemble(
            works, c_ents, e_ents, endorsers, codes, index, plans,
            VerifyItem, SCHEME_P256, self.policies.policy_for, {})
        t3 = time.perf_counter()
        resolvers = []
        if index:
            resolve = self.provider.batch_verify_async(list(index))
            # eager background resolution: a thread already blocked on
            # the results keeps the fetch ahead of any later dispatch
            holder: dict = {}

            def run(resolve=resolve, holder=holder):
                try:
                    holder["out"] = resolve()
                except BaseException as exc:   # re-raised at join
                    holder["err"] = exc

            th = threading.Thread(target=run, daemon=True)
            th.start()

            def result(th=th, holder=holder):
                th.join()
                if "err" in holder:
                    raise holder["err"]
                return holder["out"]

            resolvers.append(result)
        self._inflight_txids.append((num, seen_txids))
        t4 = time.perf_counter()
        collect_s = t4 - t0
        self.last_timings = {"digest_s": t1 - t0, "identities_s": t2 - t1,
                             "assemble_s": t3 - t2, "enqueue_s": t4 - t3}
        return {"deep": True, "block": block, "codes": codes,
                "plans": plans, "items": index, "resolvers": resolvers,
                "msps": self._msps_snapshot, "seen_txids": seen_txids,
                "collect_s": collect_s,
                "n_refs": n_refs, "n_txs": n}

    def _finish_deep(self, state: dict) -> ValidationResult:
        block = state["block"]
        codes = state["codes"]
        index = state["items"]
        collect_s = state["collect_s"]

        t0 = time.perf_counter()
        verdict = np.zeros(len(index), dtype=np.uint8)
        for resolve in state["resolvers"]:
            verdict[:] = np.asarray(resolve(), dtype=bool)
        dispatch_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        flags = None
        if self.device_validate is not None:
            # fused device path: gate fold + MVCC in one launch; the
            # prepared batch is stashed for the ledger.  None = demoted
            # (collision / range / ...) — fall through to the host gate.
            flags = self.device_validate.run(
                state, verdict, self.validation_plugin, self.evaluator)
        if flags is None:
            _fastcollect.gate(state["plans"], verdict, codes,
                              self.validation_plugin, self.evaluator, {})
            flags = TxFlags.from_bytes(bytes(codes))
        gate_s = time.perf_counter() - t0

        block.metadata.items[META_TXFLAGS] = flags.to_bytes()
        logger.info(
            "[%s] validated block %d: %d/%d valid | collect=%.1fms "
            "dispatch=%.1fms (%d uniq sigs) gate=%.1fms",
            self.channel_id, block.header.number, flags.valid_count(),
            state["n_txs"], collect_s * 1e3, dispatch_s * 1e3,
            len(index), gate_s * 1e3)
        return ValidationResult(flags, collect_s, dispatch_s, gate_s,
                                state["n_refs"], len(index))


def _false_oracle(_txid: str) -> bool:
    """Default ledger-txid oracle for an unwired validator."""
    return False


def _msp_validates(msps: Dict[str, object], ident: Identity) -> bool:
    msp = msps.get(ident.mspid)
    if msp is None:
        return False
    try:
        return msp.is_valid(ident)
    except Exception:
        return False
