"""Retry, backoff and timeout numbers, the idempotency table and named
locks: the port's copy of drynx_tpu/resilience/policy.py.

Every wait of the survey path lives here: the retry policy of a call
(connect retries, exponential backoff with seeded jitter), the ping,
straggler and fan-out constants, the liveness probe's verdict lifetime,
how long a verifying-node group waits for its proofs and how often it
polls, the epsilon ledger's default budget, the streaming engine's pane
width, window, epsilon per advance and slide pacing, the server's worker
pool, tenant quota, shedding, refill and resume constants. The values
equal the reference's; none is read from the environment.

Idempotency contract: a message may be re-sent after a transport failure
only when re-executing its handler is harmless. Connection establishment
always retries; a contribution (survey_dp, obf/shuffle/ks_contrib,
proof_request, survey_query, end_verification) mutates per-survey state,
so once any byte of it was sent a failure surfaces and is never re-sent.
"""
from __future__ import annotations

import dataclasses
import random
import threading
from typing import Dict, Optional

# Connection establishment: cheap, always safe to retry.
CONNECT_RETRIES = 2
CONNECT_BACKOFF_S = 0.2          # base of the exponential backoff
BACKOFF_CAP_S = 5.0              # backoff never exceeds this per attempt
# Health probe: a ping does no device work, so a node that cannot answer
# quickly is taken as down.
PING_TIMEOUT_S = 5.0
# A verifying node's wait for its survey's proofs (end_verification), and
# a root's wait for its own proof threads before it replies.
VERIFY_WAIT_S = 300.0
PROOF_DRAIN_S = 300.0
# Extra budget over a remote peer's blocking wait, so the transport's
# timeout always outlives the application timeout it wraps.
STRAGGLER_GRACE_S = 60.0
# Bounded roster fan-out: concurrent calls one fan_out may have in flight
# (service/transport.py).
FAN_OUT_WORKERS = 8
# Idle connections the transport's pool keeps per peer, and in all (the
# least recently pooled one is closed at the cap).
CONN_POOL_MAX_IDLE = 4
CONN_POOL_MAX = 1024
# Finished surveys whose contribution a DP node keeps for replay.
DP_REPLY_CACHE_MAX = 8
# Lifetime of a liveness probe's verdicts (LocalCluster.probe_liveness):
# within it a resume reuses the cached map, past it the probe runs again,
# so a re-entry never dispatches on a view drawn before a healing fault
# window moved.
PROBE_TTL_S = 2.0

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
# One call's timeout (RetryPolicy), and a load-generator querier's wait for
# its own survey (server/loadgen.py).
CALL_TIMEOUT_S = 900.0
# +/- fraction of the base applied to each backoff draw (a retry, the load
# generator's re-offer after a rejection).
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

# Read-only or set-once-overwrite handlers: re-execution is harmless.
IDEMPOTENT_MTYPES = frozenset({
    "ping", "set_roster", "vn_register", "vn_bitmap", "vn_adjust",
    "range_sig", "get_genesis", "get_latest", "get_block", "get_proofs",
    "close_db",
})
# Handlers that mutate survey state, consume entropy or fan out proofs:
# re-sending after a partial write can double-count a contribution.
CONTRIBUTION_MTYPES = frozenset({
    "survey_query", "survey_dp", "obf_contrib", "shuffle_contrib",
    "ks_contrib", "proof_request", "proof_batch", "end_verification",
})


def is_idempotent(mtype: str) -> bool:
    """Unknown message types are not idempotent: the safe failure of a new
    handler is a surfaced error, not a silent re-send."""
    return mtype in IDEMPOTENT_MTYPES


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How one call behaves under failure.

    ``connect_retries`` more attempts follow a failed connect or a failed
    idempotent call; the wait before each is exponential from
    ``backoff_s``, capped at ``backoff_cap_s``, with +/- ``jitter`` of the
    base so a roster's clients do not retry in lockstep. ``seed`` makes the
    jitter draws deterministic; None draws from the OS."""

    connect_retries: int = CONNECT_RETRIES
    backoff_s: float = CONNECT_BACKOFF_S
    backoff_cap_s: float = BACKOFF_CAP_S
    jitter: float = BACKOFF_JITTER
    call_timeout_s: float = CALL_TIMEOUT_S
    seed: Optional[int] = None

    def backoff(self, attempt: int) -> float:
        """Sleep before retry number ``attempt`` (0-based)."""
        base = min(self.backoff_s * (2.0 ** attempt), self.backoff_cap_s)
        if self.jitter <= 0:
            return base
        r = (random.Random(self.seed * 1_000_003 + attempt)
             if self.seed is not None else random.Random())
        return base * (1.0 + self.jitter * (2.0 * r.random() - 1.0))

    def attempts_for(self, mtype: str, sent: bool) -> int:
        """Attempts allowed for a call: before any byte was sent a failure
        is a connect failure (always retried); after, only idempotent
        messages go again."""
        if not sent or is_idempotent(mtype):
            return self.connect_retries + 1
        return 1


DEFAULT_POLICY = RetryPolicy()

# id(lock) -> the diagnostic name it was made under. Named locks are
# module or long-lived instance state, so identity keys are enough.
LOCK_NAMES: Dict[int, str] = {}


def named_lock(name: str, *, reentrant: bool = False):
    """A threading.Lock (or RLock) carrying a stable diagnostic name
    (`lock_name`)."""
    lock = threading.RLock() if reentrant else threading.Lock()
    LOCK_NAMES[id(lock)] = name
    return lock


def lock_name(lock) -> Optional[str]:
    """The name a lock was made under, if any."""
    return LOCK_NAMES.get(id(lock))


__all__ = ["RetryPolicy", "DEFAULT_POLICY", "is_idempotent", "named_lock",
           "lock_name", "LOCK_NAMES", "IDEMPOTENT_MTYPES",
           "CONTRIBUTION_MTYPES", "CONNECT_RETRIES", "CONNECT_BACKOFF_S",
           "BACKOFF_CAP_S", "PING_TIMEOUT_S", "STRAGGLER_GRACE_S",
           "FAN_OUT_WORKERS", "VERIFY_WAIT_S", "PROOF_DRAIN_S",
           "CONN_POOL_MAX_IDLE", "CONN_POOL_MAX", "DP_REPLY_CACHE_MAX",
           "PROBE_TTL_S", "VN_GROUP_WAIT_S",
           "POLL_INTERVAL_S", "COLD_COMPILE_WAIT_S",
           "END_VERIFICATION_TIMEOUT_S", "TREE_FANOUT_MIN", "TREE_FANOUT_MAX",
           "EPSILON_BUDGET", "PANE_WIDTH", "STREAM_WINDOW_PANES",
           "EPSILON_PER_ADVANCE", "SLIDE_PACING_S", "CALL_TIMEOUT_S",
           "BACKOFF_JITTER", "VERIFY_WORKERS", "TENANT_QUOTA",
           "SHED_FRACTION", "SHED_RETRY_MIN_S", "SHED_RETRY_MAX_S",
           "RATE_WINDOW_EVENTS", "REFILL_HORIZON_S", "REFILL_MAX_SLABS_STEP",
           "RESUME_MAX_RETRIES", "CHECKPOINT_MAX_RESUMES",
           "RESUME_BACKOFF_S"]
