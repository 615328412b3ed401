from .txvalidator import TxValidator, PolicyRegistry, ValidationResult
from .committer import Committer, PipelinedCommitter

__all__ = ["TxValidator", "PolicyRegistry", "ValidationResult", "Committer",
           "PipelinedCommitter"]
