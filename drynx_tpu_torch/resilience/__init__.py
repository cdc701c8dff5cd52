"""Availability: the in-process fault plane (:mod:`.faults`) and the one
place where every retry, backoff and timeout number lives
(:mod:`.policy`). Quorum-degraded surveys, over the DPs and VNs that
answered, run where the survey runs: ``service/service.py``
(``LocalCluster``), parameterized by ``SurveyQuery.min_dp_quorum`` and
``SurveyQuery.vn_quorum``."""
from .faults import FaultPlan, FaultSpec, fault_plan, set_fault_plan
from .policy import DEFAULT_POLICY, RetryPolicy, is_idempotent

__all__ = ["FaultPlan", "FaultSpec", "fault_plan", "set_fault_plan",
           "RetryPolicy", "DEFAULT_POLICY", "is_idempotent"]
