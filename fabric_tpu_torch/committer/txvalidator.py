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
  PASS 1 (host, no crypto):  structural validation, duplicate-txid
    marking, and *collection* of every SignedData the reference would
    have verified — creator sigs and endorsement sets — deduplicated
    globally by (scheme, pubkey, payload, signature) since Verify is a
    pure function.  Two tails: the deep one (native/fastcollect.c digest
    + assemble, no per-tx Python) and the classic one (the C walker's
    `collect`, or its Python mirror collect_py, then `_collect_tx_fast`
    per tx), which key-level endorsement (SBE) needs.
  DISPATCH (device):         provider.batch_verify_async per chunk of
    the block (one flush per block by default), each chunk split first
    against the verify-once cache when one is wired.
  PASS 2:                    gate on the verdict bitmap — on the device
    with MVCC when a DeviceValidator is wired (one KV7 launch, see
    committer/device_validate.py), else on the host (fastcollect.gate,
    or `_gate_tx` with the SBE overlay on the classic tail).

Counterpart of `fabric_tpu/committer/txvalidator.py`: both tails, SBE,
the verify-once cache, per-channel provider resolution
(`provider_source`), early abort, sub-block dispatch chunks, the
config-bundle source and the ops-plane observers (the
`validator.collect`, `dispatch_wait` and `gate` spans with their
speculative links, `validator_stage_seconds`,
`pipeline_collect_under_verify_frac`, `speculative_coverage_frac`,
`validator_midwindow_blocks_total`, `commit_graph_early_aborts_total`).
`ValidationResult` keeps the reference's timings, `last_timings` splits
pass 1.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from fabric_tpu_torch import native
from fabric_tpu_torch.bccsp import SCHEME_P256, VerifyItem
from fabric_tpu_torch.msp import Identity
from fabric_tpu_torch.ops_plane import tracing
from fabric_tpu_torch.policy import PolicyEvaluator, SignaturePolicy
from fabric_tpu_torch.protocol import Block
from fabric_tpu_torch.protocol.txflags import TxFlags, ValidationCode
from fabric_tpu_torch.protocol.types import META_TXFLAGS
from fabric_tpu_torch.protocol.wire import n_txs

logger = logging.getLogger("fabric_tpu_torch.committer")

# C pass-1 walker and host gate (native/fastcollect.c)
_fastcollect = native.extension("fastcollect")

# fastcollect error-code -> ValidationCode (must match fastcollect.c)
_FC_CODES = {
    1: ValidationCode.NIL_ENVELOPE,
    2: ValidationCode.BAD_PAYLOAD,
    3: ValidationCode.TARGET_CHAIN_NOT_FOUND,
    4: ValidationCode.BAD_PROPOSAL_TXID,
    5: ValidationCode.UNKNOWN_TX_TYPE,
    6: ValidationCode.NIL_TXACTION,
}


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


@dataclass(slots=True)
class _TxWork:
    """Collected verification workload for one transaction."""
    tx_num: int
    creator_key: Optional[Tuple] = None          # dedup key of creator item
    creator_identity: Optional[Identity] = None
    # per-namespace: (policy, [(dedup_key, identity), ...])
    namespaces: List[Tuple[str, SignaturePolicy, List[Tuple[Tuple, Identity]]]] = \
        field(default_factory=list)
    # SBE: base_ns -> written keys; and this tx's metadata updates
    written_keys: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    meta_writes: List[Tuple] = field(default_factory=list)


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


def _interval_union(ivals):
    """Merge (start, end) intervals into a sorted disjoint union."""
    out: List[List[float]] = []
    for a, b in sorted(ivals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _intersection_s(u1, u2) -> float:
    i = j = 0
    s = 0.0
    while i < len(u1) and j < len(u2):
        a = max(u1[i][0], u2[j][0])
        b = min(u1[i][1], u2[j][1])
        if b > a:
            s += b - a
        if u1[i][1] < u2[j][1]:
            i += 1
        else:
            j += 1
    return s


class _PipelineEconomics:
    """Live collect-under-verify overlap over a rolling block window, so
    the SLO plane can watch the overlap floor without a bench run.
    Collect intervals come from validate_begin, verify intervals span
    device enqueue -> resolve return (the bccsp.batch_verify window).
    All timestamps share perf_counter."""

    WINDOW = 64            # blocks of history

    def __init__(self):
        self._lock = threading.Lock()
        from collections import deque
        self._collect = deque(maxlen=self.WINDOW)
        self._verify = deque(maxlen=self.WINDOW)

    def note_collect(self, a: float, b: float) -> None:
        if b > a:
            with self._lock:
                self._collect.append((a, b))

    def note_verify(self, a: float, b: float) -> None:
        if b > a:
            with self._lock:
                self._verify.append((a, b))

    def frac(self) -> float:
        with self._lock:
            collect = list(self._collect)
            verify = list(self._verify)
        u_c = _interval_union(collect)
        total = sum(b - a for a, b in u_c)
        if total <= 0.0:
            return 0.0
        return min(1.0, _intersection_s(u_c, _interval_union(verify)) / total)


def _eager(resolve):
    """Start resolving a dispatch on a thread at once -> a callable that
    joins it and returns (or raises) its result.  A thread already
    blocked on the results keeps the fetch ahead of any later
    dispatch."""
    holder: dict = {}

    def run():
        try:
            holder["out"] = resolve()
        except BaseException as exc:   # re-raised at join
            holder["err"] = exc

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def result():
        th.join()
        if "err" in holder:
            raise holder["err"]
        return holder["out"]

    return result


class TxValidator:
    """v20 TxValidator equivalent bound to one channel."""

    def __init__(self, channel_id: str, msps: Dict[str, object], provider,
                 policies: PolicyRegistry,
                 ledger_has_txid=None, bundle_source=None,
                 sbe_lookup=None,
                 validation_plugin: str = "DefaultValidation",
                 provider_source=None, verify_cache=None,
                 early_abort=None, device_validate=None):
        self.channel_id = channel_id
        self._static_msps = msps
        self._provider = provider
        # verify-once plane (verify_plane.VerdictCache) — None keeps the
        # classic always-verify behaviour.  When wired, each flush
        # partitions its dispatch batch against the cache: MAC-verified
        # hits skip the device, misses verify and backfill.  Identity
        # validity and policy evaluation are NEVER cached — the gate
        # always runs live; only the pure signature bit is reused.
        self.verify_cache = verify_cache
        # per-channel device placement hook:
        # provider_source(channel_id, demand) -> Provider | None.  When
        # wired (bccsp.factory.provider_for_channel), each flush
        # re-resolves the provider and reports its batch size so the
        # placement scheduler can resize this channel's device span.
        self.provider_source = provider_source
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
        # key-level endorsement: committed validation-parameter lookup
        # ((ns, key) -> policy bytes), usually sbe.statedb_lookup(statedb)
        self.sbe_lookup = sbe_lookup
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
        # parallel-commit early abort (parallel_commit.EarlyAbortAnalyzer
        # or None): txs provably doomed to MVCC_READ_CONFLICT by a
        # preceding same-block write are flagged during pass 1 and their
        # VerifyItems never reach the device
        self.early_abort = early_abort
        # fused device validation (device_validate.DeviceValidator or
        # None): the gate fold AND MVCC run as one KV7 launch; the
        # prepared UpdateBatch is stashed for the ledger.  A demoted
        # block (hash collision, range query, ...) falls back to the
        # host gate below.  Only the deep tail runs it: a block of the
        # classic tail (sbe_lookup set) leaves no stash, so the ledger
        # runs host MVCC for it.
        self.device_validate = device_validate
        # pass 1 on the Python mirror (collect_py) instead of the C
        # walker's collect; the classic tail either way
        self.force_python_collect = False
        # wall seconds of pass 1's parts, last block begun
        self.last_timings: Dict[str, float] = {}
        # live pipeline-economics window (overlap gauge for the SLO plane)
        self._econ = _PipelineEconomics()

    @property
    def provider(self):
        """The channel's current verify provider: placement-resolved
        when a provider_source is wired, else the static one."""
        return self._resolve_provider()

    @provider.setter
    def provider(self, p):
        self._provider = p

    def _resolve_provider(self, demand=None):
        if self.provider_source is not None:
            try:
                p = self.provider_source(self.channel_id, demand)
            except Exception:
                logger.exception("placement provider_source failed; "
                                 "using static provider")
                p = None
            if p is not None:
                return p
        return self._provider

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

    # -- pass 1: structural + collect ---------------------------------------

    def _doomed_txs(self, block: Block) -> Optional[dict]:
        """tx_num -> MVCC_READ_CONFLICT from the early-abort analyzer,
        or None when unwired / guard-failed / analyzer error.  Never
        lets an analysis failure take the block down — early abort is a
        pure optimization; the MVCC pass remains authoritative."""
        if self.early_abort is None:
            return None
        # fetch the pending-window overlay ONCE here so dooming and the
        # mid-window accounting below judge the same frozen snapshot
        overlay = None
        src = getattr(self.early_abort, "overlay_source", None)
        if src is not None:
            try:
                overlay = src()
            except Exception:
                overlay = None
        if overlay is not None and not overlay.empty:
            try:
                from fabric_tpu_torch.ops_plane import registry
                registry.counter(
                    "validator_midwindow_blocks_total",
                    "blocks validated while commit-window predecessors "
                    "were still in flight").add(1, channel=self.channel_id)
            except Exception:
                pass
        try:
            doomed = self.early_abort.doomed(block, overlay=overlay)
        except Exception:
            logger.exception("early-abort analysis failed; skipping")
            return None
        return doomed or None

    def _note_early_aborts(self, n: int) -> None:
        if not n:
            return
        try:
            from fabric_tpu_torch.ops_plane import registry
            registry.counter(
                "commit_graph_early_aborts_total",
                "txs flagged MVCC_READ_CONFLICT before device dispatch"
            ).add(n, channel=self.channel_id)
        except Exception:
            pass

    def _deserialize(self, ident_bytes: bytes) -> Optional[Identity]:
        from fabric_tpu_torch.msp import deserialize_from_msps
        return deserialize_from_msps(self.msps, ident_bytes)

    def _resolve_creator(self, ident_bytes: bytes):
        """Creator memo value: (identity, p256_pub_wire|None), or None
        for identities the MSP rejects (deserialize + chain-validate —
        the (0, creator) memo of the Python tail, resolved once per
        unique creator on the deep path)."""
        creator = self._deserialize(ident_bytes)
        if creator is not None and not _msp_validates(self.msps, creator):
            creator = None
        return None if creator is None else (
            creator, creator._pub_wire
            if getattr(creator, "scheme", None) == SCHEME_P256 else None)

    def _resolve_endorser(self, ident_bytes: bytes):
        """Endorser memo value — deserialize only, NO chain validation
        (the (1, endorser) memo: an unrecognized endorser merely weakens
        the policy, policy.go:390-393)."""
        ident = self._deserialize(ident_bytes)
        return None if ident is None else (
            ident, ident._pub_wire
            if getattr(ident, "scheme", None) == SCHEME_P256 else None)

    def _collect_tx_fast(self, tx_num: int, rec, flags: TxFlags,
                         seen_txids: Dict[str, int],
                         items: Dict[VerifyItem, None],
                         memo: dict, n_txs: int = 1,
                         has_txid=None, doomed=None) -> Optional[_TxWork]:
        """Pass-1 tail for one tx whose structural walk ran in either
        front walker — C (native/fastcollect.c) or the Python mirror
        (committer/collect_py.py).  One consumer tail for both walkers
        is the invariant that keeps C-enabled and no-compiler peers on
        identical validity bitmaps; the walkers themselves are tested
        differentially.

        This loop runs ~10k times per block on one core (the slot of
        the reference's per-tx goroutine fan-out), so it is written for
        bytecode economy: VerifyItems are their own dedup keys
        (NamedTuple), per-identity facts are memoized as (identity,
        p256_pub_wire) pairs, and attribute lookups are hoisted."""
        if isinstance(rec, int):
            # pre-registration structural failure: the txid never
            # entered seen_txids on the Python path either
            flags.set(tx_num, _FC_CODES[rec])
            return None
        if len(rec) == 2:
            # post-registration failure (unknown type / nil action /
            # malformed body AFTER a valid txid): the Python path
            # registers the txid BEFORE flagging, so later duplicates
            # still read DUPLICATE_TXID — bitmaps must not diverge
            # between the C and no-compiler paths
            code, txid = rec
            if txid in seen_txids or (has_txid or self.ledger_has_txid)(txid):
                flags.set(tx_num, ValidationCode.DUPLICATE_TXID)
                return None
            seen_txids[txid] = tx_num
            flags.set(tx_num, _FC_CODES[code])
            return None
        txtype, txid, creator_bytes, payload, pdigest, signature, actions = rec
        if txid in seen_txids or (has_txid or self.ledger_has_txid)(txid):
            flags.set(tx_num, ValidationCode.DUPLICATE_TXID)
            return None
        seen_txids[txid] = tx_num

        if txtype == 0 and n_txs != 1:
            flags.set(tx_num, ValidationCode.INVALID_CONFIG_TRANSACTION)
            return None

        # early abort: a tx the analyzer proved cannot win MVCC is
        # flagged NOW, after txid registration (later duplicates of its
        # txid must still read DUPLICATE_TXID) and before any identity
        # resolution or VerifyItem interning — its signatures never
        # reach the device
        if doomed is not None and tx_num in doomed:
            flags.set(tx_num, doomed[tx_num])
            return None

        # creator identity: deserialize + chain-validate, memoized per
        # block (the msp/cache role for this hot loop).  memo value:
        # (identity, p256 pub_wire or None), or None for invalid.
        ckey = (0, creator_bytes)
        ent = memo.get(ckey, memo)
        if ent is memo:
            ent = memo[ckey] = self._resolve_creator(creator_bytes)
        if ent is None:
            flags.set(tx_num, ValidationCode.BAD_CREATOR_SIGNATURE)
            return None
        creator, pub_wire = ent
        if pub_wire is not None:
            item = VerifyItem(SCHEME_P256, pub_wire, signature, pdigest)
        else:      # ed25519 (raw message) or idemix (own item shape)
            item = creator.verify_item(payload, signature)
        if item not in items:
            items[item] = None
        work = _TxWork(tx_num)
        work.creator_key = item
        work.creator_identity = creator

        if txtype == 0:
            return work

        policy_for = self.policies.policy_for
        for cc_id, endorsed, endorsements, ns_writes, meta in actions:
            namespaces = {cc_id}
            for ns, keys in ns_writes:
                namespaces.add(ns)
                prev = work.written_keys.get(ns, ())
                work.written_keys[ns] = prev + tuple(keys)
            for base, k, v in meta:
                namespaces.add(base)
                work.meta_writes.append((base, k, v))
            sigset: List[Tuple[VerifyItem, Identity]] = []
            seen_idents = set()
            for endorser, esig, edigest in endorsements:
                if endorser in seen_idents:   # policy.go:385-387 dedup
                    continue
                seen_idents.add(endorser)
                ekey = (1, endorser)
                ent = memo.get(ekey, memo)
                if ent is memo:
                    ent = memo[ekey] = self._resolve_endorser(endorser)
                if ent is None:
                    continue
                ident, e_wire = ent
                if e_wire is not None:
                    it = VerifyItem(SCHEME_P256, e_wire, esig, edigest)
                else:
                    it = ident.verify_item(endorsed + endorser, esig)
                if it not in items:
                    items[it] = None
                sigset.append((it, ident))
            for ns in sorted(namespaces):
                pol = policy_for(ns)
                if pol is None:
                    flags.set(tx_num, ValidationCode.INVALID_CHAINCODE)
                    return None
                work.namespaces.append((ns, pol, sigset))
        return work

    # -- pass 2: gate + evaluate --------------------------------------------

    def _memoized_plugin(self, eval_cache: dict):
        """Per-block memoizing wrapper around the validation plugin.

        Policy evaluation is a pure function of (plugin, policy,
        ordered valid-identity list).  Identities are memoized
        per-block objects and every policy the gate sees is interned
        for the block (PolicyRegistry entries live on the validator;
        SbeOverlay interns decoded key-level policies per block —
        id()-keying a FRESH decode would let a freed policy's reused
        address answer for a different policy), so id() keys are stable
        and the common case — every tx of a chaincode under the same
        endorser set — evaluates ONCE per block instead of ~10k times.
        """
        raw_plugin = self.validation_plugin

        def plugin(pol, idents, ev, _c=eval_cache):
            key = (id(pol), tuple(map(id, idents)))
            r = _c.get(key)
            if r is None:
                r = _c[key] = raw_plugin(pol, idents, ev)
            return r

        return plugin

    def _gate_tx(self, work: _TxWork, flags: TxFlags,
                 verdict: Dict[Tuple, bool], sbe_overlay=None,
                 plugin=None) -> None:
        if not verdict.get(work.creator_key, False):
            flags.set(work.tx_num, ValidationCode.BAD_CREATOR_SIGNATURE)
            return
        evaluator = self.evaluator
        if plugin is None:
            plugin = self.validation_plugin

        for ns, pol, sigset in work.namespaces:
            valid_idents = [ident for key, ident in sigset
                            if verdict.get(key, False)]
            # key-level endorsement (validator_keylevel.go:244): a key's
            # validation parameter REPLACES the chaincode policy for that
            # key; keys without one fall back to the namespace policy.
            # Metadata UPDATES to a key are themselves gated by the key's
            # CURRENT policy (or the cc policy when none is set).
            base_written = work.written_keys.get(ns, ())
            meta_keys = [k for (b, k, _) in work.meta_writes if b == ns]
            if sbe_overlay is None or (not base_written and not meta_keys):
                need_ns_policy = True
            else:
                need_ns_policy = False
                for key in base_written:
                    kpol = sbe_overlay.policy_for(ns, key)
                    if kpol is None:
                        need_ns_policy = True
                        continue
                    if not plugin(kpol, valid_idents, evaluator):
                        flags.set(work.tx_num,
                                  ValidationCode.ENDORSEMENT_POLICY_FAILURE)
                        return
                for key in meta_keys:
                    kpol = sbe_overlay.policy_for(ns, key) or pol
                    if not plugin(kpol, valid_idents, evaluator):
                        flags.set(work.tx_num,
                                  ValidationCode.ENDORSEMENT_POLICY_FAILURE)
                        return
            if need_ns_policy and not plugin(pol, valid_idents, evaluator):
                flags.set(work.tx_num, ValidationCode.ENDORSEMENT_POLICY_FAILURE)
                return
        flags.set(work.tx_num, ValidationCode.VALID)
        if sbe_overlay is not None and work.meta_writes:
            # a VALID tx's metadata updates take effect for later txs in
            # this block (the reference's intra-block dependency ordering)
            sbe_overlay.apply_valid_tx(work.meta_writes)

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
        if self.verify_cache is not None and self.bundle_source is not None:
            # pin THIS channel's cache epoch to its config sequence: a
            # config update (new CRL, rotated CA, policy change)
            # invalidates every verdict minted under the previous
            # sequence of this channel — the cache is shared per node,
            # so other channels' entries must not flap with ours
            try:
                self.verify_cache.set_epoch(
                    self.bundle_source.current().sequence,
                    scope=self.channel_id)
            except Exception:
                pass
        try:
            return self._begin_inner(block)
        finally:
            self._msps_snapshot = None

    def validate_finish(self, state: dict) -> ValidationResult:
        self._msps_snapshot = state["msps"]
        try:
            return self._finish_inner(state)
        finally:
            self._msps_snapshot = None

    @property
    def overlap_chunk(self) -> int:
        """Pass-1 sub-block chunk size: every CHUNK txs the newly-collected
        unique items are dispatched to the device asynchronously, so host
        collection of the NEXT chunk overlaps device verification of the
        previous one.  The default is one flush per block; a deployment
        can lower it via FABRIC_TPU_VALIDATE_CHUNK (read per validate
        call, the reference's variable)."""
        return int(os.environ.get("FABRIC_TPU_VALIDATE_CHUNK",
                                  "1000000000"))

    def _split(self, new: list, links: set):
        """Verify-once partition of a flush's new items: (positions in
        `new` of the misses, hits as (position, verdict)).  Only
        MAC-verified fresh hits skip the device; a miss, a MAC failure
        or a stale epoch goes through the full dispatch.  The hits'
        speculative trace ids join `links`, the validator.collect span's
        links to the speculative spans whose verdicts the block
        consumed."""
        if self.verify_cache is None:
            return range(len(new)), []
        miss_pos, raw_hits = self.verify_cache.filter(new)
        links.update(tr for _i, _v, tr in raw_hits if tr)
        return miss_pos, [(i, v) for i, v, _tr in raw_hits]

    def _dispatch(self, items: list):
        """One async dispatch of `items` on the provider resolved for
        this flush's size -> the eager resolver, which notes the verify
        interval (enqueue -> resolve return) in the economics window."""
        resolve = self._resolve_provider(len(items)).batch_verify_async(
            items)
        t_disp = time.perf_counter()
        econ = self._econ

        def timed():
            out = resolve()
            econ.note_verify(t_disp, time.perf_counter())
            return out

        return _eager(timed)

    def _record_collect(self, t0: float, collect_s: float, num, n: int,
                        n_unique: int, hit_n: int, miss_n: int,
                        links: set) -> None:
        """The validator.collect span of pass 1, and its interval in the
        economics window."""
        self._econ.note_collect(t0, t0 + collect_s)
        attrs = {"block": int(num), "txs": n, "unique_items": n_unique}
        if hit_n or miss_n:
            attrs["cache_hits"] = hit_n
            attrs["cache_misses"] = miss_n
        if links:
            # stitch the block trace to the speculative spans whose
            # verdicts it consumed
            attrs["links"] = sorted(links)[:8]
        tracing.tracer.record_span(
            "validator.collect", t0, t0 + collect_s, attributes=attrs)

    def _begin_inner(self, block: Block) -> dict:
        n = n_txs(block)
        # duplicate-txid oracle widened by the in-flight window: a txid
        # in an earlier block the ledger cannot see yet is a duplicate
        # here.  Prune entries the ledger now covers (committed) and
        # entries at/above this block's number (replay of the window).
        num = block.header.number
        self._inflight_txids = [
            (bn, m) for bn, m in self._inflight_txids
            if m and bn < num
            and not self.ledger_has_txid(next(iter(m)))]
        carry = [m for _, m in self._inflight_txids]

        doomed = self._doomed_txs(block)

        use_fast = not self.force_python_collect
        if use_fast and self.sbe_lookup is None:
            # deep native tail: SBE needs the classic tail's per-tx
            # written-keys bookkeeping, so key-level endorsement keeps
            # the C-walker + Python-tail path
            return self._begin_deep(block, num, carry, doomed)

        flags = TxFlags(n)

        t0 = time.perf_counter()
        seen_txids: Dict[str, int] = {}
        items: Dict[VerifyItem, None] = {}   # insertion-ordered dedup set
        works: List[_TxWork] = []
        # (result-or-None, dispatched keys, [(key, verdict)])
        resolvers: List[Tuple] = []
        flushed = 0
        hit_n = miss_n = 0
        spec_links: set = set()
        chunk = self.overlap_chunk

        def flush():
            nonlocal flushed, hit_n, miss_n
            keys = list(items.keys())
            new = keys[flushed:]
            flushed = len(keys)
            if not new:
                return
            miss_pos, hits = self._split(new, spec_links)
            miss = [new[i] for i in miss_pos]
            hits = [(new[i], v) for i, v in hits]
            if self.verify_cache is not None:
                hit_n += len(hits)
                miss_n += len(miss)
            if miss:
                # items are their OWN dedup keys (VerifyItem NamedTuple)
                resolvers.append((self._dispatch(miss), miss, hits))
            elif hits:
                resolvers.append((None, [], hits))

        if use_fast:
            recs = _fastcollect.collect(block.data, self.channel_id)
        else:
            from fabric_tpu_torch.committer import collect_py
            recs = collect_py.collect(block.data, self.channel_id)
        t1 = time.perf_counter()
        has_txid = (self.ledger_has_txid if not carry else (
            lambda t: any(t in s for s in carry)
            or self.ledger_has_txid(t)))
        memo: dict = {}
        n_aborted = 0
        for tx_num, rec in enumerate(recs):
            work = self._collect_tx_fast(tx_num, rec, flags, seen_txids,
                                         items, memo, n_txs=n,
                                         has_txid=has_txid, doomed=doomed)
            if work is not None:
                works.append(work)
            elif doomed is not None and tx_num in doomed \
                    and flags.flag(tx_num) in (
                        ValidationCode.MVCC_READ_CONFLICT,
                        ValidationCode.PHANTOM_READ_CONFLICT):
                n_aborted += 1
            if (tx_num + 1) % chunk == 0:
                flush()
        flush()
        self._note_early_aborts(n_aborted)
        self._inflight_txids.append((num, seen_txids))
        t2 = time.perf_counter()
        collect_s = t2 - t0
        self._record_collect(t0, collect_s, num, n, len(items), hit_n,
                             miss_n, spec_links)
        self.last_timings = {"walk_s": t1 - t0, "tail_s": t2 - t1}
        return {"block": block, "flags": flags, "items": items,
                "works": works, "resolvers": resolvers,
                "msps": self._msps_snapshot, "seen_txids": seen_txids,
                "collect_s": collect_s, "n_txs": n, "cache_hits": hit_n,
                "cache_misses": miss_n}

    def _begin_deep(self, block: Block, num: int, carry: list,
                    doomed=None) -> dict:
        """Deep native pass 1: the C walker consumes its own tuples
        (fastcollect digest/assemble) — txid dedup, creator/endorser
        memo slot assignment, and flat dispatch-ordered VerifyItem
        interning all run without per-tx Python bytecode.  Python's
        per-block work shrinks to resolving each UNIQUE identity once
        and launching the async device dispatches."""
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
        if doomed:
            # early abort on the deep path: DROP the work tuple (assemble
            # interns every work's items regardless of its code, and gate
            # overwrites the code of any planned tx — filtering is the
            # only insertion point that keeps the tx off the device AND
            # out of the gate) and stamp the code.  Only txs still clean
            # after the structural walk are doomed; a structural code
            # (dup txid etc.) wins, matching the classic tail's ordering.
            not_validated = int(ValidationCode.NOT_VALIDATED)
            kept = []
            n_aborted = 0
            for w in works:
                tx = w[0]
                if tx in doomed and codes[tx] == not_validated:
                    codes[tx] = int(doomed[tx])
                    n_aborted += 1
                else:
                    kept.append(w)
            works = kept
            self._note_early_aborts(n_aborted)
        t1 = time.perf_counter()
        # one MSP resolution per unique identity (the whole-block analogue
        # of the classic tail's (0,creator)/(1,endorser) memo dicts)
        c_ents = [self._resolve_creator(b) for b in creators]
        e_ents = [self._resolve_endorser(b) for b in endorsers]
        t2 = time.perf_counter()

        index: Dict[VerifyItem, int] = {}   # item -> dispatch position
        plans: list = []
        pol_cache: dict = {}
        # (result, verdict positions, dispatched items)
        resolvers: List[Tuple] = []
        flushed = 0
        n_refs = 0
        hit_n = miss_n = 0
        hit_fills: list = []       # (verdict position, cached verdict)
        spec_links: set = set()
        assemble_s = 0.0

        def flush():
            nonlocal flushed, hit_n, miss_n
            keys = list(index.keys())
            new = keys[flushed:]
            base, flushed = flushed, len(keys)
            if not new:
                return
            miss_pos, hits = self._split(new, spec_links)
            miss = [new[i] for i in miss_pos]
            positions = [base + i for i in miss_pos]
            hit_fills.extend((base + i, v) for i, v in hits)
            if self.verify_cache is not None:
                hit_n += len(hits)
                miss_n += len(miss)
            if miss:
                resolvers.append((self._dispatch(miss), positions, miss))

        chunk = self.overlap_chunk
        policy_for = self.policies.policy_for
        for start in range(0, len(works), chunk):
            ta = time.perf_counter()
            n_refs += _fastcollect.assemble(
                works[start:start + chunk], c_ents, e_ents, endorsers,
                codes, index, plans, VerifyItem, SCHEME_P256,
                policy_for, pol_cache)
            assemble_s += time.perf_counter() - ta
            flush()
        self._inflight_txids.append((num, seen_txids))
        t4 = time.perf_counter()
        collect_s = t4 - t0
        self._record_collect(t0, collect_s, num, n, len(index), hit_n,
                             miss_n, spec_links)
        self.last_timings = {"digest_s": t1 - t0, "identities_s": t2 - t1,
                             "assemble_s": assemble_s,
                             "enqueue_s": t4 - t2 - assemble_s}
        return {"deep": True, "block": block, "codes": codes,
                "plans": plans, "items": index, "resolvers": resolvers,
                "msps": self._msps_snapshot, "seen_txids": seen_txids,
                "collect_s": collect_s, "n_refs": n_refs, "n_txs": n,
                "cache_hits": hit_n, "cache_misses": miss_n,
                "hit_fills": hit_fills}

    # per-block stage SLIs + live overlap gauge (the SLO plane's inputs;
    # the "commit" stage lands next door in committer._observe_metrics)
    _STAGE_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                      1.0, 2.5, 5.0, 10.0, float("inf"))

    def _observe_block(self, collect_s: float, dispatch_s: float,
                       gate_s: float) -> None:
        try:
            from fabric_tpu_torch.ops_plane import registry
            h = registry.histogram(
                "validator_stage_seconds",
                "per-block validation stage latency",
                buckets=self._STAGE_BUCKETS)
            ch = self.channel_id
            h.observe(collect_s, stage="collect", channel=ch)
            h.observe(dispatch_s, stage="dispatch", channel=ch)
            h.observe(gate_s, stage="gate", channel=ch)
            registry.gauge(
                "pipeline_collect_under_verify_frac",
                "live collect-under-verify overlap, rolling block window"
            ).set(self._econ.frac(), channel=ch)
        except Exception:
            pass

    def _note_coverage(self, state: dict) -> None:
        """Verify-once economics for one block: feed the rolling
        coverage window and, on a node whose cache is speculatively
        filled (the gateway host), publish speculative_coverage_frac —
        the fraction of this window's unique verify items whose
        verdicts were already cached when the block arrived."""
        cache = self.verify_cache
        if cache is None:
            return
        hits = state.get("cache_hits", 0)
        cache.coverage.note(hits, hits + state.get("cache_misses", 0))
        if not cache.speculative_attached:
            return
        try:
            from fabric_tpu_torch.ops_plane import registry
            registry.gauge(
                "speculative_coverage_frac",
                "fraction of committed unique verify items whose "
                "verdicts were cached before the block arrived "
                "(rolling block window)"
            ).set(cache.coverage.frac(), channel=self.channel_id,
                  # the registry is process-global: multi-node test
                  # topologies share it, so each node's coverage must be
                  # its own series or the last committer wins the sample
                  owner=getattr(cache, "owner", "node"))
        except Exception:
            pass

    def _finish_deep(self, state: dict) -> ValidationResult:
        block = state["block"]
        codes = state["codes"]
        index = state["items"]
        collect_s = state["collect_s"]

        t0 = time.perf_counter()
        verdict = np.zeros(len(index), dtype=np.uint8)
        for pos, v in state["hit_fills"]:
            verdict[pos] = 1 if v else 0
        cache = self.verify_cache
        for resolve, positions, sub in state["resolvers"]:
            out = resolve()
            if cache is not None:
                cache.store(sub, out, site="commit",
                            scope=self.channel_id)
            verdict[np.asarray(positions, dtype=np.intp)] = \
                np.asarray(out, dtype=bool)
        self._note_coverage(state)
        dispatch_s = time.perf_counter() - t0
        tracing.tracer.record_span(
            "validator.dispatch_wait", t0, t0 + dispatch_s,
            attributes={"block": int(block.header.number),
                        "unique_items": len(index)})

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
        tracing.tracer.record_span(
            "validator.gate", t0, t0 + gate_s,
            attributes={"block": int(block.header.number),
                        "txs": len(state["plans"])})
        return self._stamp(block, flags, state, len(index), collect_s,
                           dispatch_s, gate_s, state["n_refs"])

    def _stamp(self, block, flags: TxFlags, state: dict, n_unique: int,
               collect_s: float, dispatch_s: float, gate_s: float,
               n_refs: int) -> ValidationResult:
        """The gate's flags into the block's metadata and the stage
        histograms -> the result."""
        block.metadata.items[META_TXFLAGS] = flags.to_bytes()
        self._observe_block(collect_s, dispatch_s, gate_s)
        logger.info(
            "[%s] validated block %d: %d/%d valid | collect=%.1fms "
            "dispatch=%.1fms (%d uniq sigs) gate=%.1fms",
            self.channel_id, block.header.number, flags.valid_count(),
            state["n_txs"], collect_s * 1e3, dispatch_s * 1e3,
            n_unique, gate_s * 1e3)
        return ValidationResult(flags, collect_s, dispatch_s, gate_s,
                                n_refs, n_unique)

    def _finish_inner(self, state: dict) -> ValidationResult:
        if state.get("deep"):
            return self._finish_deep(state)
        block = state["block"]
        flags = state["flags"]
        works = state["works"]
        collect_s = state["collect_s"]

        t0 = time.perf_counter()
        verdict: Dict[Tuple, bool] = {}
        cache = self.verify_cache
        for resolve, chunk_keys, hits in state["resolvers"]:
            for k, v in hits:
                verdict[k] = bool(v)
            if resolve is None:
                continue
            out = resolve()
            if cache is not None:
                cache.store(chunk_keys, out, site="commit",
                            scope=self.channel_id)
            verdict.update(
                (k, bool(v)) for k, v in zip(chunk_keys, out))
        self._note_coverage(state)
        dispatch_s = time.perf_counter() - t0
        tracing.tracer.record_span(
            "validator.dispatch_wait", t0, t0 + dispatch_s,
            attributes={"block": int(block.header.number),
                        "unique_items": len(state["items"])})

        t0 = time.perf_counter()
        from fabric_tpu_torch.committer.sbe import SbeOverlay
        # key-level endorsement is a CHANNEL CAPABILITY
        # (common/capabilities/application.go KeyLevelEndorsement): on a
        # channel whose config lacks it, validation parameters are inert
        # and every key falls back to the namespace policy — peers that
        # disagreed on this would produce divergent validity bitmaps.
        use_sbe = self.sbe_lookup is not None
        if use_sbe and self.bundle_source is not None:
            from fabric_tpu_torch.config import CAP_KEY_LEVEL_ENDORSEMENT
            use_sbe = self.bundle_source.current().has_capability(
                CAP_KEY_LEVEL_ENDORSEMENT)
        overlay = SbeOverlay(self.sbe_lookup) if use_sbe else None
        plugin = self._memoized_plugin({})
        for work in works:
            self._gate_tx(work, flags, verdict, overlay, plugin=plugin)
        gate_s = time.perf_counter() - t0
        tracing.tracer.record_span(
            "validator.gate", t0, t0 + gate_s,
            attributes={"block": int(block.header.number),
                        "txs": len(works)})

        n_refs = sum(1 + sum(len(s) for _, _, s in w.namespaces)
                     for w in works)
        return self._stamp(block, flags, state, len(state["items"]),
                           collect_s, dispatch_s, gate_s, n_refs)


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
