"""Admission control keyed on the kernel warm-up registry.

The port's counterpart of drynx_tpu/server/admission.py. A standing
server should not pay a shape's cold work (a library's build or load, a
kernel's first launch, the range proofs' tables) inside a
timed survey, nor on a verify worker. Admission therefore sorts every
submitted survey by SHAPE: the query's shape is folded into a
`compilecache.Profile` and the registry names the entries that shape
reaches. A shape whose entries have all been driven through the warm-up
in this process is *warm* and goes to the fast lane; any other waits for
one cooperative warm-up pass (the scheduler's compile lane) and is then
admitted again.

The warm set is keyed by ENTRY NAME (`kernel:miller`,
`table:range_sigs@u16`, ...), so two shapes that reach the same entries
share warmth: on a warm process only a new range base u is cold.
"""
from __future__ import annotations

import dataclasses

from .. import compilecache as cc
# an exhausted per-(DP, cohort) epsilon budget is an admission-time
# rejection like QueueFull, raised at advance_stream() submit; the
# accountant lives with the other durable ledgers (pool/epsilon.py) and is
# re-exported here, where callers catch it
from ..pool import EpsilonExhausted
from ..resilience.policy import named_lock


class AdmissionError(Exception):
    """Base class for admission rejections."""


class QueueFull(AdmissionError):
    """The server's bounded queue is at max_depth; resubmit later."""


class QuotaExceeded(AdmissionError):
    """One tenant's queued-survey quota is exhausted: that tenant backs off
    while every other tenant keeps admitting (the typed half of fair
    queueing; the deficit round-robin is the other half)."""

    def __init__(self, msg: str, tenant: str = "", quota: int = 0):
        super().__init__(msg)
        self.tenant = tenant
        self.quota = quota


class Overloaded(AdmissionError):
    """Admission-controlled shedding: the queue passed the shed threshold,
    and the server rejects early with a retry-after hint derived from the
    observed completion rate."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass(frozen=True)
class Admission:
    """The verdict for one submitted survey."""

    survey_id: str
    lane: str                     # "fast" | "compile" | "refill"
    profile: object = None        # cc.Profile; None for proofs-off surveys
    missing: tuple = ()           # registry entry names not yet warm
    dro_need: int = 0             # pool elements the DRO phase consumes
                                  # (n_cns * noise_list_size), 0 without
    tenant: str = "default"       # fair-queueing key (DRR and quota)


class AdmissionController:
    """Shape triage and the process-wide warm set. The reference folds the
    cross flush's batch width into the profile (its `n_queue`); the port's
    cross flush launches the survey's kernels at other rows, which name no
    entry of their own, so a fast-lane verdict covers any group."""

    def __init__(self, cluster):
        self.cluster = cluster
        self._warm: set[str] = set()
        self._needed: dict = {}       # Profile -> frozenset of names
        self._lock = named_lock("admission_lock")

    # -- shape -------------------------------------------------------------

    def profile_for(self, sq) -> cc.Profile | None:
        """A survey's shape (None: proofs off, nothing to warm), the same
        key as LocalCluster._warm_kernels'."""
        q = sq.query
        if q.proofs != 1 or self.cluster.vns is None:
            return None
        return cc.query_profile(self.cluster, q)

    def dro_need_for(self, sq) -> int:
        """Pool elements the survey's DRO phase consumes: one noise-list
        precomputation per CN."""
        n = cc.registry.noise_size(sq.query)
        return len(self.cluster.cns) * n if n else 0

    def _pool_digest(self) -> str:
        if not hasattr(self, "_digest"):
            from .. import pool as pool_mod

            self._digest = pool_mod.key_digest(self.cluster.coll_tbl.table)
        return self._digest

    def needed(self, profile: cc.Profile) -> frozenset:
        """Names of the entries this shape reaches that the warm-up drives
        here (libraries and kernels on the card; the tables of this
        cluster).
        Memoized per profile: triage stays a set lookup under load."""
        with self._lock:
            cached = self._needed.get(profile)
        if cached is not None:
            return cached
        names = frozenset(e.name for e in cc.build_registry(
            profile, _cluster_of(self.cluster)) if e.dispatched())
        with self._lock:
            self._needed[profile] = names
        return names

    # -- warm set ----------------------------------------------------------

    def note_warmed(self, profile) -> None:
        """Record that `profile`'s entries have been through the warm-up
        (the scheduler's compile lane, or prewarm)."""
        if profile is None:
            return
        names = self.needed(profile)
        with self._lock:
            self._warm |= names

    def triage(self, sq, tenant: str = "default") -> Admission:
        """Lane order: cold entries -> "compile"; warm, but a pool balance
        short of the survey's noise need -> "refill" (the scheduler
        deposits slabs, then triages again); else "fast". A cluster
        without a pool never sees the refill lane."""
        profile = self.profile_for(sq)
        need = self.dro_need_for(sq)
        missing: tuple = ()
        if profile is None:
            lane = "fast"
        else:
            names = self.needed(profile)
            with self._lock:
                missing = tuple(sorted(names - self._warm))
            lane = "compile" if missing else "fast"
        pool = getattr(self.cluster, "pool", None)
        if (lane == "fast" and need > 0 and pool is not None
                and pool.dro_balance(self._pool_digest()) < need):
            lane = "refill"
        return Admission(survey_id=sq.survey_id, lane=lane,
                         profile=profile, missing=missing, dro_need=need,
                         tenant=tenant)


def _cluster_of(cluster):
    """The cluster as the registry's table entries take it: one with a
    device and `ensure_range_sigs` (a stand-in without them binds none)."""
    ok = hasattr(cluster, "device") and hasattr(cluster, "ensure_range_sigs")
    return cluster if ok else None


__all__ = ["Admission", "AdmissionController", "AdmissionError",
           "QueueFull", "QuotaExceeded", "Overloaded", "EpsilonExhausted"]
