"""Policy plane: signature policies, compiled evaluators, verify-then-gate.

Re-design of Fabric's common/cauthdsl + common/policies:
- the NOutOf/SignedBy policy tree and its compiled evaluator
  (cauthdsl/cauthdsl.go:24-92),
- the Fabric policy-expression language AND()/OR()/OutOf()
  (cauthdsl/policyparser.go),
- SignedData evaluation (policies/policy.go:282 EvaluateSignedData).

The TPU-native restructure (SURVEY.md §7, north star): signature
verification is SPLIT OUT of evaluation.  `collect()` walks signature sets
and produces dedup'd VerifyItems; the batched provider verifies them all in
one dispatch; `evaluate()` then re-runs the exact reference decision logic
(dedup-by-identity, greedy used-once NOutOf semantics) consuming the
verdict bitmap instead of calling ECDSA per endorsement.
"""

from .policy import SignedData, PolicyError, SignaturePolicy, signed_by, n_out_of
from .dsl import parse_policy
from .evaluator import PolicyEvaluator, CollectResult
from .aclmgmt import ACLError, ACLProvider, DEFAULT_ACLS

__all__ = ["SignedData", "PolicyError", "SignaturePolicy", "signed_by",
           "n_out_of", "parse_policy", "PolicyEvaluator", "CollectResult",
           "ACLError", "ACLProvider", "DEFAULT_ACLS"]
