"""Parallel MVCC commit plane.

The serial block-ordered MVCC walk (fabric_tpu_torch/ledger/mvcc.py)
stays the oracle.  Counterpart of `fabric_tpu/committer/parallel_commit`,
whole: a dependency-graph scheduler that validates non-conflicting
transactions concurrently while preserving bit-identical flags, update
batch and history writes (`ParallelCommitScheduler`), the cross-block
commit window (`CommitWindow`, `WindowEntry`), and the early-abort
analyzer the txvalidator consults to skip device dispatch for
transactions already doomed by a preceding same-block write.
"""

from .earlyabort import EarlyAbortAnalyzer
from .graph import ConflictGraph, PendingOverlay, TxFootprint, footprint_of
from .scheduler import CommitWindow, ParallelCommitScheduler, WindowEntry

__all__ = ["ConflictGraph", "PendingOverlay", "TxFootprint",
           "footprint_of", "ParallelCommitScheduler", "CommitWindow",
           "WindowEntry", "EarlyAbortAnalyzer"]
