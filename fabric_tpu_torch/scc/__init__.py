"""System chaincodes + discovery service.

Re-design of Fabric's core/scc/{qscc,cscc} and discovery/:
in-process system contracts for ledger and config queries, and an
endorser-discovery service computing endorsement layouts from policies
+ live membership.

Counterpart of `fabric_tpu/scc`, the same code on the port's imports.
The reference's `discover` command-line client (`scc/discover.py`)
needs the node's admin helpers and comes with the port's node tools.
"""

from .qscc import Qscc
from .cscc import Cscc
from .discovery import DiscoveryService, Layout

__all__ = ["Qscc", "Cscc", "DiscoveryService", "Layout"]
