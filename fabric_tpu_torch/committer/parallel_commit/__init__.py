"""Parallel MVCC commit plane.

The serial block-ordered MVCC walk (fabric_tpu_torch/ledger/mvcc.py)
stays the oracle.  Counterpart of `fabric_tpu/committer/parallel_commit`:
so far its conflict graph and the early-abort analyzer the txvalidator
consults to skip device dispatch for transactions already doomed by a
preceding same-block write.  Not ported yet: the dependency-graph
scheduler (`ParallelCommitScheduler`), the commit window
(`CommitWindow`, `WindowEntry`).
"""

from .earlyabort import EarlyAbortAnalyzer
from .graph import ConflictGraph, PendingOverlay, TxFootprint, footprint_of

__all__ = ["ConflictGraph", "PendingOverlay", "TxFootprint",
           "footprint_of", "EarlyAbortAnalyzer"]
