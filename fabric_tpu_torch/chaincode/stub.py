"""Transaction simulation stub — the chaincode's view of the ledger.

Reference parity: the shim-side ChaincodeStubInterface (GetState/PutState/
DelState/GetStateByRange) plus the peer-side lock-based tx simulator
(core/ledger/kvledger/txmgmt/txmgr/lockbasedtxmgr) that records every read
with its committed version and stages writes, producing the TxRwSet that
endorsers sign and the MVCC validator later checks
(txmgmt/validation/validator.go:83).

Counterpart of `fabric_tpu/chaincode/stub.py`, the same code on the
port's imports.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from fabric_tpu_torch.ledger.statedb import StateDB
from fabric_tpu_torch.protocol.types import (
    KVRead,
    KVWrite,
    NsRwSet,
    RangeQueryInfo,
    TxRwSet,
)


class SimulationError(Exception):
    pass


class _NsBuilder:
    def __init__(self):
        self.reads: Dict[str, KVRead] = {}
        self.writes: Dict[str, KVWrite] = {}
        self.range_queries: List[RangeQueryInfo] = []


class ChaincodeStub:
    """One transaction's simulation context over committed state.

    Reads record the committed version (for MVCC); writes stage in the
    rwset.  get_state sees the simulation's own staged writes;
    get_state_by_range reads COMMITTED state only — same limitation as
    the reference simulator, whose range/rich queries never reflect the
    transaction's own uncommitted writes.
    """

    def __init__(self, db: StateDB, namespace: str,
                 channel_id: str = "", txid: str = "",
                 creator: bytes = b"", registry=None, pvt_store=None):
        self._db = db
        self._ns = namespace
        self.channel_id = channel_id
        self.txid = txid
        self.creator = creator
        self._registry = registry  # for cc2cc invoke
        self._pvt_store = pvt_store  # local PvtDataStore for private reads
        self._pvt_writes: Dict[tuple, Dict[str, object]] = {}
        self._builders: Dict[str, _NsBuilder] = {}
        self._event: bytes = b""
        self._done = False

    def _b(self, ns: Optional[str] = None) -> _NsBuilder:
        ns = self._ns if ns is None else ns
        return self._builders.setdefault(ns, _NsBuilder())

    # -- shim surface -------------------------------------------------------

    def get_state(self, key: str) -> Optional[bytes]:
        self._check_open()
        b = self._b()
        if key in b.writes:  # read-your-writes
            w = b.writes[key]
            return None if w.is_delete else w.value
        vv = self._db.get(self._ns, key)
        if key not in b.reads:  # first read wins (version pinning)
            b.reads[key] = KVRead(key, None if vv is None else vv.version)
        return None if vv is None else vv.value

    def put_state(self, key: str, value: bytes) -> None:
        self._check_open()
        if not key:
            raise SimulationError("empty key")
        self._b().writes[key] = KVWrite(key, value)

    def del_state(self, key: str) -> None:
        self._check_open()
        self._b().writes[key] = KVWrite(key, is_delete=True)

    def get_state_by_range(self, start_key: str, end_key: str,
                           limit: int = 0) -> List[Tuple[str, bytes]]:
        """Records a RangeQueryInfo with raw reads; validation replays the
        same scan at commit time (rangequery_validator.go, phantom reads).
        Committed state only — this simulation's staged writes are NOT
        visible to range scans (reference simulator limitation kept)."""
        self._check_open()
        results = []
        reads = []
        exhausted = True
        for key, vv in self._db.range_scan(self._ns, start_key, end_key):
            if limit and len(results) >= limit:
                exhausted = False
                break
            reads.append(KVRead(key, vv.version))
            results.append((key, vv.value))
        self._b().range_queries.append(RangeQueryInfo(
            start_key, end_key, exhausted, tuple(reads)))
        return results

    def get_query_result(self, selector: dict, limit: int = 0):
        """Rich query over committed JSON-document state (shim
        GetQueryResult; statecouchdb option).  Reads committed state only
        and stages NO read-set entries — rich-query results are not
        MVCC-protected, exactly like the reference."""
        self._check_open()
        return [(k, vv.value)
                for k, vv in self._db.execute_query(self._ns, selector,
                                                    limit)]

    def invoke_chaincode(self, chaincode_id: str, fn: str,
                         args: List[bytes]) -> bytes:
        """cc2cc invocation: the callee simulates into THIS rwset under its
        own namespace (core/chaincode handler cc2cc semantics)."""
        self._check_open()
        if self._registry is None:
            raise SimulationError("no chaincode registry for cc2cc")
        return self._registry.invoke_into(self, chaincode_id, fn, args)

    # -- key-level endorsement (SBE) ----------------------------------------
    # Reference: shim SetStateValidationParameter / GetStateValidationParameter
    # backed by statebased/validator_keylevel.go; parameters are ordinary
    # versioned writes in the companion metadata namespace, so MVCC orders
    # concurrent updates and the policy flips at the block boundary.

    def set_event(self, name: str, payload: bytes) -> None:
        """Chaincode event (shim SetEvent): at most one per invocation,
        carried in the endorsed ChaincodeAction and surfaced to event
        listeners after the tx commits VALID (peer/deliver events)."""
        from fabric_tpu_torch.utils import serde as _serde
        self._check_open()
        self._event = _serde.encode({"name": name, "payload": payload})

    def event_bytes(self) -> bytes:
        return self._event

    def set_state_validation_parameter(self, key: str, policy) -> None:
        self._check_open()
        from fabric_tpu_torch.committer import sbe
        raw = sbe.encode_policy(policy) if policy is not None else None
        mns = sbe.meta_namespace(self._ns)
        if raw is None:
            self._b(mns).writes[key] = KVWrite(key, is_delete=True)
        else:
            self._b(mns).writes[key] = KVWrite(key, raw)

    def get_state_validation_parameter(self, key: str):
        self._check_open()
        from fabric_tpu_torch.committer import sbe
        mns = sbe.meta_namespace(self._ns)
        b = self._b(mns)
        if key in b.writes:
            w = b.writes[key]
            return None if w.is_delete else sbe.decode_policy(w.value)
        vv = self._db.get(mns, key)
        if key not in b.reads:
            b.reads[key] = KVRead(key, None if vv is None else vv.version)
        return None if vv is None else sbe.decode_policy(vv.value)

    # -- private data (collections) -----------------------------------------
    # Reference: the chaincode shim's GetPrivateData/PutPrivateData; the
    # public rwset carries only hash(key)->hash(value) under the hashed
    # namespace ns$collection, the cleartext goes to the transient store
    # (gossip/privdata distribution model).

    def put_private_data(self, collection: str, key: str, value: bytes) -> None:
        self._check_open()
        if not key:
            raise SimulationError("empty key")
        from fabric_tpu_torch.privdata.collection import (hash_key, hash_value,
                                                    pvt_namespace)
        hns = pvt_namespace(self._ns, collection)
        self._b(hns).writes[hash_key(key)] = KVWrite(hash_key(key),
                                                     hash_value(value))
        self._pvt_writes.setdefault((self._ns, collection), {})[key] = value

    def del_private_data(self, collection: str, key: str) -> None:
        self._check_open()
        from fabric_tpu_torch.privdata.collection import hash_key, pvt_namespace
        hns = pvt_namespace(self._ns, collection)
        self._b(hns).writes[hash_key(key)] = KVWrite(hash_key(key),
                                                     is_delete=True)
        self._pvt_writes.setdefault((self._ns, collection), {})[key] = None

    def get_private_data(self, collection: str, key: str) -> Optional[bytes]:
        # Cleartext from the local pvt store; the MVCC-relevant read is
        # recorded against the HASHED namespace so every peer (member or
        # not) validates it identically.
        self._check_open()
        from fabric_tpu_torch.privdata.collection import hash_key, pvt_namespace
        staged = self._pvt_writes.get((self._ns, collection), {})
        if key in staged:
            return staged[key]
        hns = pvt_namespace(self._ns, collection)
        hk = hash_key(key)
        b = self._b(hns)
        vv = self._db.get(hns, hk)
        if hk not in b.reads:
            b.reads[hk] = KVRead(hk, None if vv is None else vv.version)
        if self._pvt_store is None:
            return None
        return self._pvt_store.get(self._ns, collection, key)

    def private_sets(self) -> Dict[tuple, Dict[str, object]]:
        # {(namespace, collection): {key: value|None}}
        return dict(self._pvt_writes)

    # -- result -------------------------------------------------------------

    def rwset(self) -> TxRwSet:
        self._done = True
        ns_sets = []
        for ns in sorted(self._builders):
            b = self._builders[ns]
            ns_sets.append(NsRwSet(
                ns,
                reads=tuple(b.reads[k] for k in sorted(b.reads)),
                writes=tuple(b.writes[k] for k in sorted(b.writes)),
                range_queries=tuple(b.range_queries)))
        return TxRwSet(tuple(ns_sets))

    def _check_open(self) -> None:
        if self._done:
            raise SimulationError("simulation already finalized")

    # -- namespace-scoped view for cc2cc -----------------------------------

    def scoped(self, namespace: str) -> "ChaincodeStub":
        view = ChaincodeStub.__new__(ChaincodeStub)
        view.__dict__.update(self.__dict__)
        view._ns = namespace
        return view
