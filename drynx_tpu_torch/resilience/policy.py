"""The waits and the named locks of the port's survey path.

The part of drynx_tpu/resilience/policy.py that the in-process cluster
and the standing server use: how long a verifying-node group waits for
its proofs, how often it polls, the epsilon ledger's default budget, the
streaming engine's pane width, window, epsilon per advance and slide
pacing, the server's worker pool, tenant quota, shedding, refill and
resume constants, the load generator's call timeout and backoff jitter,
and locks that carry a diagnostic name. The values equal the
reference's. The retry table and the fault plane are not ported (ROADMAP
queue A, step 16).
"""
from __future__ import annotations

import threading

# Wait of a verifying-node group for its members' proof counters.
VN_GROUP_WAIT_S = 60.0
# Polling granularity of that wait (VNGroup watches n done-events).
POLL_INTERVAL_S = 0.05
# Wait for a survey's proof threads and its verifying nodes: the first
# proofs-on survey of a process builds the kernels it runs.
COLD_COMPILE_WAIT_S = 2400.0
# Client-side end_verification default (api.py).
END_VERIFICATION_TIMEOUT_S = 600.0
# Tree overlay fan-out bounds (service/topology.py tree_fanout).
TREE_FANOUT_MIN = 2
TREE_FANOUT_MAX = 8
# Per-(DP, cohort) epsilon budget the accountant enforces (pool/epsilon.py)
# when neither the ledger nor the caller names one; DRYNX_EPSILON_BUDGET
# overrides.
EPSILON_BUDGET = 1.0
# Streaming surveys (service/streaming.py). Rows per immutable pane, the
# unit of encode, encrypt and range-prove amortization.
PANE_WIDTH = 4096
# Default sliding-window length in panes.
STREAM_WINDOW_PANES = 8
# Epsilon one window advance charges against each responding DP's budget.
EPSILON_PER_ADVANCE = 0.01
# Minimum seconds between a stream's window advances in the server's
# advance lane (0 disables pacing).
SLIDE_PACING_S = 0.0
# A load-generator querier's wait for its own survey (server/loadgen.py).
CALL_TIMEOUT_S = 900.0
# +/- fraction of a retry wait drawn per attempt (the load generator's
# re-offer after a rejection).
BACKOFF_JITTER = 0.25
# The standing server (server/scheduler.py). Verify worker pool width.
VERIFY_WORKERS = 1
# One tenant's queued surveys across all lanes (QuotaExceeded past it).
TENANT_QUOTA = 8
# Past ceil(SHED_FRACTION * max_depth) queued surveys submit() sheds with
# Overloaded and a retry-after hint; 1.0 disables shedding.
SHED_FRACTION = 0.75
# Bounds on that hint (a server with no observed rate hints the max).
SHED_RETRY_MIN_S = 0.05
SHED_RETRY_MAX_S = 30.0
# Completion events kept for the observed service rate.
RATE_WINDOW_EVENTS = 64
# The refill lane deposits slabs for the waiting need plus the observed
# DRO consumption over this horizon, at most this many slabs a step.
REFILL_HORIZON_S = 2.0
REFILL_MAX_SLABS_STEP = 4
# Survey resume: re-entries of a survey whose dispatch failed; with a
# phase checkpoint, resumes from it, paced by the backoff.
RESUME_MAX_RETRIES = 1
CHECKPOINT_MAX_RESUMES = 3
RESUME_BACKOFF_S = 0.5

def named_lock(name: str, *, reentrant: bool = False):
    """A threading.Lock (or RLock). The name documents the call site; the
    reference registers it for its lock-order analysis, which is not
    ported."""
    return threading.RLock() if reentrant else threading.Lock()


__all__ = ["named_lock", "VN_GROUP_WAIT_S",
           "POLL_INTERVAL_S", "COLD_COMPILE_WAIT_S",
           "END_VERIFICATION_TIMEOUT_S", "TREE_FANOUT_MIN", "TREE_FANOUT_MAX",
           "EPSILON_BUDGET", "PANE_WIDTH", "STREAM_WINDOW_PANES",
           "EPSILON_PER_ADVANCE", "SLIDE_PACING_S", "CALL_TIMEOUT_S",
           "BACKOFF_JITTER", "VERIFY_WORKERS", "TENANT_QUOTA",
           "SHED_FRACTION", "SHED_RETRY_MIN_S", "SHED_RETRY_MAX_S",
           "RATE_WINDOW_EVENTS", "REFILL_HORIZON_S", "REFILL_MAX_SLABS_STEP",
           "RESUME_MAX_RETRIES", "CHECKPOINT_MAX_RESUMES",
           "RESUME_BACKOFF_S"]
