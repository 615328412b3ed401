"""The endorser service: ProcessProposal.

Reference parity: core/endorser/endorser.go:296 ProcessProposal →
:178 SimulateProposal → ESCC endorse (core/handlers/endorsement/builtin/
default_endorsement.go:36), with the proposal-creator signature check from
core/endorser/msgvalidation.go and the ACL check from core/aclmgmt.

Signing stays host-side (private keys never touch the device); the
single proposal-creator verify here is immediate, not batched —
endorsement is a low-volume interactive path, unlike commit-side block
validation.

Counterpart of `fabric_tpu/endorser/endorser.py`, the same code on the
port's imports.  On the factory's CUDA provider each proposal's creator
check (`Identity.verify`, one item) and its `peer/Propose` ACL check
(`ACLProvider.check_acl` -> `batch_verify`, one item) are each one
launch of the generic lane (KP2 for P-256, KE5 for Ed25519) with its
own host pass and sync.  The three spans (`endorser.validate`,
`endorser.simulate`, `endorser.sign`) are recorded only under a parent
span, such as the RPC server's `rpc.<method>`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Optional

from fabric_tpu_torch.chaincode import ChaincodeRegistry, ChaincodeStub, SimulationError
from fabric_tpu_torch.endorser.proposal import (
    Proposal,
    ProposalResponse,
    SignedProposal,
)
from fabric_tpu_torch.ledger.statedb import StateDB
from fabric_tpu_torch.msp import SigningIdentity, deserialize_from_msps
from fabric_tpu_torch.ops_plane import tracing
from fabric_tpu_torch.policy import PolicyEvaluator, SignaturePolicy, SignedData
from fabric_tpu_torch.protocol.build import compute_txid
from fabric_tpu_torch.protocol.types import (ChaincodeAction, Endorsement,
                                       TransactionAction)

logger = logging.getLogger("fabric_tpu_torch.endorser")


class EndorserError(Exception):
    pass


class Endorser:
    """One peer's endorser service bound to a channel's state."""

    def __init__(self, channel_id: str, db: StateDB,
                 registry: ChaincodeRegistry,
                 msps: Dict[str, object], provider,
                 signer: SigningIdentity,
                 proposal_acl: Optional[SignaturePolicy] = None,
                 transient_store=None, pvt_store=None, distribute=None,
                 ledger_height=None,
                 endorsement_plugin: str = "DefaultEndorsement",
                 auth_filters=("ExpirationCheck",), acl=None):
        self.channel_id = channel_id
        self.db = db
        self.registry = registry
        self.msps = msps
        self.signer = signer
        self.proposal_acl = proposal_acl
        # aclmgmt provider: when set, the proposal gate is the
        # "peer/Propose" resource policy from the channel config
        # (core/endorser ACL check through core/aclmgmt); proposal_acl
        # stays as the static fallback
        self.acl = acl
        self.evaluator = PolicyEvaluator(msps, provider)
        # pluggable handlers (core/handlers/library/registry.go): named
        # auth filters run before simulation; the endorsement plugin
        # signs the response (ESCC slot)
        from fabric_tpu_torch.handlers import default_registry as _handlers
        self.endorsement_plugin = _handlers.endorsement(endorsement_plugin)
        self.auth_filters = [_handlers.auth_filter(n) for n in auth_filters]
        # private-data plane (gossip/privdata distribution at endorsement):
        # cleartext write-sets are staged in the transient store and pushed
        # to collection member peers; only hashes enter the public rwset.
        self.transient_store = transient_store
        self.pvt_store = pvt_store
        self.distribute = distribute      # callable(txid, pvt_sets) -> None
        self.ledger_height = ledger_height or (lambda: 0)

    def process_proposal(self, sp: SignedProposal) -> ProposalResponse:
        """endorser.go:296.  Errors map to a non-200 response, never an
        exception — the reference returns a ProposalResponse with an error
        status to the client in all failure modes."""
        try:
            with tracing.tracer.start_span("endorser.validate",
                                           require_parent=True):
                prop, creator = self._validate(sp)
            with tracing.tracer.start_span(
                    "endorser.simulate", require_parent=True,
                    attributes={"chaincode": prop.chaincode_id}):
                payload, rwset, events = self._simulate(prop, creator)
            action = ChaincodeAction(
                prop.chaincode_id,
                self._version_of(prop.chaincode_id),
                rwset, response_payload=payload, events=events)
            ta = TransactionAction(prop.hash(), action)
            endorsed = ta.endorsed_bytes()
            # ESCC slot: the endorsement plugin signs
            # endorsed-bytes || endorser identity
            with tracing.tracer.start_span("endorser.sign",
                                           require_parent=True):
                endorser_bytes, sig = self.endorsement_plugin(self.signer,
                                                              endorsed)
            return ProposalResponse(200, "", endorsed,
                                    Endorsement(endorser_bytes, sig))
        except (EndorserError, SimulationError) as err:
            logger.info("[%s] proposal rejected: %s", self.channel_id, err)
            return ProposalResponse(500, str(err), b"", None)
        except Exception as err:
            # malformed wire input (e.g. non-bytes header fields) must not
            # crash the request path — the contract is response, not raise
            logger.warning("[%s] proposal processing error: %s",
                           self.channel_id, err)
            return ProposalResponse(500, f"internal error: {err}", b"", None)

    # -- validation (msgvalidation.go) --------------------------------------

    def _validate(self, sp: SignedProposal):
        try:
            prop = sp.proposal()
        except Exception as e:
            raise EndorserError(f"undecodable proposal: {e}") from e
        ch = prop.header.channel_header
        sh = prop.header.signature_header
        if ch.channel_id != self.channel_id:
            raise EndorserError(
                f"proposal for channel {ch.channel_id!r}, serving "
                f"{self.channel_id!r}")
        if ch.txid != compute_txid(sh.nonce, sh.creator):
            raise EndorserError("txid does not bind nonce+creator")
        creator = deserialize_from_msps(self.msps, sh.creator, validate=True)
        if creator is None:
            raise EndorserError("unknown or invalid creator identity")
        if not creator.verify(sp.proposal_bytes, sp.signature):
            raise EndorserError("bad proposal signature")
        for flt in self.auth_filters:       # core/handlers/auth chain
            try:
                flt(prop, creator)
            except Exception as e:
                raise EndorserError(f"auth filter rejected: {e}") from e
        sd = SignedData(sp.proposal_bytes, sh.creator, sp.signature)
        if self.acl is not None:
            try:
                self.acl.check_acl("peer/Propose", sd)
            except PermissionError as e:
                raise EndorserError(str(e)) from e
        elif self.proposal_acl is not None:
            if not self.evaluator.evaluate_signed_data(self.proposal_acl, [sd]):
                raise EndorserError("creator fails proposal ACL policy")
        return prop, sh.creator

    # -- simulation (endorser.go:178) ---------------------------------------

    def _simulate(self, prop: Proposal, creator: bytes):
        txid = prop.header.channel_header.txid
        stub = ChaincodeStub(self.db, prop.chaincode_id,
                             channel_id=self.channel_id,
                             txid=txid,
                             creator=creator, registry=self.registry,
                             pvt_store=self.pvt_store)
        _, payload = self.registry.execute(
            stub, prop.chaincode_id, prop.fn, list(prop.args))
        pvt_sets = stub.private_sets()
        if pvt_sets:
            if self.transient_store is not None:
                self.transient_store.persist(txid, self.ledger_height(),
                                             pvt_sets)
            if self.distribute is not None:
                self.distribute(txid, pvt_sets)
        return payload, stub.rwset(), stub.event_bytes()

    def _version_of(self, chaincode_id: str) -> str:
        d = self.registry.definition(chaincode_id)
        return d.version if d else "0"
