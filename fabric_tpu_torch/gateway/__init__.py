"""Gateway: the batched, fault-tolerant client front door.

Modeled on the Fabric v2.4 Gateway service (gateway/gateway.go in the
reference lineage — which this fork predates): a peer-co-located
service that owns the client-facing transaction lifecycle so clients
stop hand-rolling endorse/broadcast/poll loops.  Four verbs ride the
authenticated RPC plane (comm/rpc.py):

  gateway.evaluate       endorse-only query, result returned, nothing
                         ordered (Evaluate in gateway.proto)
  gateway.endorse        collect endorsements from this peer + the
                         org-peers it knows, for client-side assembly
  gateway.submit         admit an assembled envelope into the bounded
                         batching queue -> coalesced orderer broadcast
  gateway.commit_status  block until the committer records the txid's
                         validation code (CommitStatus in gateway.proto)

Internals: a bounded admission queue with explicit backpressure
(service.py), batch broadcast with exponential-backoff failover across
orderers (broadcaster.py, same pattern as gossip/blocksprovider.py),
a txid dedup window for idempotent submission, a commit notifier
driven by the committer's post-validation txflags (notifier.py) so
commit_status never polls the ledger, and an SLO-driven admission
controller (admission.py) that sheds load with typed retryable
verdicts — NORMAL -> SHED_EVALUATE -> SHED_PROBABILISTIC -> SHED_HARD
with hysteretic recovery — before the queue-full cliff.

Counterpart of `fabric_tpu/gateway`, whole, on the port's imports.
"""

from fabric_tpu_torch.gateway.admission import AdmissionController
from fabric_tpu_torch.gateway.broadcaster import BatchBroadcaster
from fabric_tpu_torch.gateway.client import (
    GatewayClient,
    GatewayError,
    GatewayShedError,
)
from fabric_tpu_torch.gateway.notifier import CommitNotifier
from fabric_tpu_torch.gateway.service import GatewayService

__all__ = ["AdmissionController", "BatchBroadcaster", "CommitNotifier",
           "GatewayClient", "GatewayError", "GatewayShedError",
           "GatewayService"]
