"""The waits and the named locks of the port's survey path.

The part of drynx_tpu/resilience/policy.py that the in-process cluster
uses: how long a verifying-node group waits for its proofs, how often it
polls, the epsilon ledger's default budget, the streaming engine's pane
width, window, epsilon per advance and slide pacing, and locks that carry
a diagnostic name. The retry table and the fault plane are not ported
(ROADMAP queue A, step 16).
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
# Minimum seconds between a stream's window advances in the reference's
# scheduler (0 disables pacing); kept equal to the reference's, read by
# no code of the port until the server is ported.
SLIDE_PACING_S = 0.0

def named_lock(name: str, *, reentrant: bool = False):
    """A threading.Lock (or RLock). The name documents the call site; the
    reference registers it for its lock-order analysis, which is not
    ported."""
    return threading.RLock() if reentrant else threading.Lock()


__all__ = ["named_lock", "VN_GROUP_WAIT_S",
           "POLL_INTERVAL_S", "COLD_COMPILE_WAIT_S",
           "END_VERIFICATION_TIMEOUT_S", "TREE_FANOUT_MIN", "TREE_FANOUT_MAX",
           "EPSILON_BUDGET", "PANE_WIDTH", "STREAM_WINDOW_PANES",
           "EPSILON_PER_ADVANCE", "SLIDE_PACING_S"]
