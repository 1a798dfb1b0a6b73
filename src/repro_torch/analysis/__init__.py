"""Static checks: the plan verifier (``plan_check``, GALV001–082) and the
shared divisibility predicates (``invariants``)."""
