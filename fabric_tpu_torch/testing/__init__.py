"""Test-support plane: the chaos harness (node lifecycle + fault-plan
drills).  Lives in the package, not tests/, so operators can drive
drills from scripts and the smoke gate.

Counterpart of `fabric_tpu/testing/__init__.py`, on the port's imports;
`testing.adversary` holds the byzantine plane's forgeries.
"""

from .chaos import ChaosNet

__all__ = ["ChaosNet"]
