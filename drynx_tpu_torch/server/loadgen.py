"""Open- and closed-loop load generation against a SurveyServer.

The port's counterpart of drynx_tpu/server/loadgen.py: numpy and
threading, no crypto. Synthetic queriers (mixed shapes, mixed proofs-on
ratios, several tenants) arrive on a deterministic seeded Poisson schedule
(with burst episodes) or run closed-loop at a fixed concurrency; every
request carries its latency record (offer -> submit -> admit -> done), and
the accounting is exact: every offered request ends completed, errored or
rejected with a type (shed, quota, queue full), and an admitted survey
that never completes is LOST, which the overload gates hold at zero.

Threading contract: `run_open`/`run_closed` run the server's `serve()`
loop on the CALLING thread (the drain thread, as drain() is) and the
submitters on side threads; submitters only call `submit()`.

`SyntheticCluster` is a calibrated stub service plane for saturation
sweeps: encode costs a wait on the drain thread and verify a wait on a
worker, so offered-load sweeps and worker-scaling curves run in seconds.
Checks with real crypto (equal transcripts across worker counts) run
against a real LocalCluster (chip_smoke.py's phase 13, a `query_fn` that
makes real queries).
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
import types
import zlib

import numpy as np

from ..resilience import policy as rp
from ..utils import log
from . import admission as adm

REJECTED = ("shed", "quota", "queue_full")


@dataclasses.dataclass
class Record:
    """One offered request's life: timestamps are seconds on the run's
    monotonic clock (t=0 at run start)."""

    survey_id: str
    tenant: str
    shape: str
    proofs: int
    t_offer: float          # scheduled arrival
    t_submit: float = 0.0   # submit() entered
    t_admit: float = 0.0    # submit() returned (admission or rejection)
    t_done: float = 0.0     # outcome recorded (server on_done)
    outcome: str = "pending"  # ok|error|shed|quota|queue_full|pending
    lane: str = ""
    retry_after_s: float = 0.0

    @property
    def admitted(self) -> bool:
        return self.outcome not in REJECTED

    def latency(self) -> float:
        """Offer→done: includes queue wait the open-loop schedule imposed
        (coordinated-omission-free — a stalled server cannot shrink it)."""
        return self.t_done - self.t_offer


def poisson_schedule(rate_sps: float, duration_s: float, seed: int,
                     bursts: tuple = ()) -> list[float]:
    """Deterministic seeded Poisson arrivals over [0, duration): same
    seed, same offered trace — reruns and A/B sweeps see identical load.
    ``bursts`` is a tuple of (t0, t1, mult) episodes multiplying the
    instantaneous rate while t is inside [t0, t1)."""
    assert rate_sps > 0 and duration_s > 0
    rng = np.random.default_rng(seed)
    t = 0.0
    out: list[float] = []
    while True:
        r = rate_sps
        for b0, b1, mult in bursts:
            if b0 <= t < b1:
                r = rate_sps * mult
                break
        t += float(rng.exponential(1.0 / r))
        if t >= duration_s:
            return out
        out.append(t)


class SyntheticCluster:
    """Calibrated stub service plane (see module docstring): the full
    LocalCluster surface the server touches, with encode/verify modeled
    as blocking waits. ``jitter`` adds a deterministic per-survey
    perturbation (hash-derived, not wall-clock random) so latency
    distributions have a tail without breaking reproducibility."""

    def __init__(self, encode_s: float = 0.002, verify_s: float = 0.01,
                 jitter: float = 0.2, fail: frozenset = frozenset()):
        self.encode_s = encode_s
        self.verify_s = verify_s
        self.jitter = jitter
        self.fail = set(fail)       # survey_ids that fail dispatch once
        self.cns = ["cn0", "cn1"]
        self.dp_idents = [types.SimpleNamespace(name="dp0"),
                          types.SimpleNamespace(name="dp1")]
        self.vns = types.SimpleNamespace(
            flush_cross_survey=lambda sids: list(sids))
        self.dlog = types.SimpleNamespace(limit=4000)
        self._proof_device_lock = rp.named_lock("proof_device_lock")
        self.executed = 0
        self.finalized = 0
        self._count_lock = rp.named_lock("loadgen_count_lock")

    def _ranges_per_value(self, q):
        return list(getattr(q, "ranges", None) or [(4, 2)])

    def _wait(self, base: float, sid: str) -> None:
        if base <= 0:
            return
        # crc32 keeps the perturbation a pure function of the survey id
        u = (zlib.crc32(sid.encode()) % 1000) / 1000.0
        time.sleep(base * (1.0 + self.jitter * (2.0 * u - 1.0)))

    def probe_liveness(self) -> dict:
        return {d.name: True for d in self.dp_idents}

    def execute_survey(self, sq, seed=0, hold_range=False,
                       tenant="default", responders=None):
        sid = sq.survey_id
        with self._count_lock:
            self.executed += 1
        if sid in self.fail:
            self.fail.discard(sid)
            raise RuntimeError(f"synthetic dispatch failure: {sid}")
        self._wait(self.encode_s, sid)
        return types.SimpleNamespace(
            sq=sq, hold_range=hold_range, tenant=tenant,
            responders=list(responders or ()),
            survey=types.SimpleNamespace(proof_threads=[]))

    def finalize_survey(self, pending):
        sid = pending.sq.survey_id
        self._wait(self.verify_s, sid)
        with self._count_lock:
            self.finalized += 1
        return f"ok-{sid}"


def synthetic_query(sid: str, proofs: int = 1, ranges=None):
    """A minimal survey-query stub carrying exactly the shape surface
    admission reads (proofs flag, ranges; no operation → non-grid, no
    diffp → no noise)."""
    return types.SimpleNamespace(
        survey_id=sid,
        query=types.SimpleNamespace(proofs=proofs,
                                    ranges=list(ranges or [(4, 2)])))


def prewarm_shapes(server, sqs) -> None:
    """Mark each query's profile warm WITHOUT running the warm-up:
    synthetic planes have nothing to warm, and the sweeps measure serving,
    not the one-off warm-up a real deployment runs at boot."""
    for sq in sqs:
        p = server.admission.profile_for(sq)
        if p is not None:
            server.admission.note_warmed(p)


@dataclasses.dataclass
class ShapeMix:
    """One synthetic shape in the offered mix."""

    name: str
    weight: float = 1.0
    proofs: int = 1
    ranges: tuple = ((4, 2),)


class LoadGen:
    """Drives one SurveyServer. Construct, then call ``run_open`` (seeded
    Poisson offered load) or ``run_closed`` (fixed concurrency, each
    querier waits for its survey before offering the next, backing off
    by the server's retry-after hints on rejection). Both return a
    report dict from ``report()``; ``self.records`` keeps the raw
    per-request rows."""

    def __init__(self, server, shapes: list[ShapeMix] | None = None,
                 tenants: dict[str, float] | None = None, seed: int = 0,
                 query_fn=None):
        self.server = server
        self.shapes = list(shapes or [ShapeMix("base")])
        self.tenants = dict(tenants or {"default": 1.0})
        self.seed = seed
        # query_fn(sid, shape) -> SurveyQuery: soak harnesses drive a
        # REAL cluster under the generator by synthesizing full survey
        # queries instead of the admission-surface stubs
        self.query_fn = query_fn
        self.records: list[Record] = []
        self._recs: dict[str, Record] = {}
        self._events: dict[str, threading.Event] = {}
        self._lock = rp.named_lock("loadgen_lock")
        self._t0 = 0.0
        server.on_done = self._on_done

    # -- clock + completion plumbing ---------------------------------------

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _on_done(self, sid: str, ok: bool) -> None:
        with self._lock:
            rec = self._recs.get(sid)
            ev = self._events.get(sid)
        if rec is not None:
            rec.t_done = self._now()
            rec.outcome = "ok" if ok else "error"
        if ev is not None:
            ev.set()

    # -- request synthesis (deterministic per index) -----------------------

    def _draw(self, n: int) -> tuple[str, ShapeMix]:
        rng = np.random.default_rng((self.seed, n))
        tn, tw = zip(*sorted(self.tenants.items()))
        tenant = str(rng.choice(tn, p=np.array(tw) / sum(tw)))
        sw = np.array([s.weight for s in self.shapes])
        shape = self.shapes[int(rng.choice(len(self.shapes),
                                           p=sw / sw.sum()))]
        return tenant, shape

    def _offer(self, n: int, attempt: int, t_offer: float) -> Record:
        tenant, shape = self._draw(n)
        sid = (f"{tenant}-{shape.name}-{n}" if attempt == 0
               else f"{tenant}-{shape.name}-{n}r{attempt}")
        sq = (self.query_fn(sid, shape) if self.query_fn is not None
              else synthetic_query(sid, proofs=shape.proofs,
                                   ranges=shape.ranges))
        rec = Record(survey_id=sid, tenant=tenant, shape=shape.name,
                     proofs=shape.proofs, t_offer=t_offer)
        ev = threading.Event()
        with self._lock:
            self.records.append(rec)
            self._recs[sid] = rec
            self._events[sid] = ev
        rec.t_submit = self._now()
        try:
            a = self.server.submit(sq, tenant=tenant)
            rec.lane = a.lane
        except adm.QuotaExceeded:
            rec.outcome = "quota"
        except adm.Overloaded as exc:
            rec.outcome = "shed"
            rec.retry_after_s = exc.retry_after_s
        except adm.QueueFull:
            rec.outcome = "queue_full"
        rec.t_admit = self._now()
        return rec

    # -- open loop ---------------------------------------------------------

    def run_open(self, rate_sps: float, duration_s: float,
                 bursts: tuple = ()) -> dict:
        """Offered load is the schedule, not the server: arrivals fire on
        time whether or not earlier surveys finished (rejections are
        recorded, never retried — shed really does shed load)."""
        sched = poisson_schedule(rate_sps, duration_s, self.seed, bursts)
        stop = threading.Event()
        self._t0 = time.monotonic()

        def submit_all():
            try:
                for n, t_arr in enumerate(sched):
                    lag = t_arr - self._now()
                    if lag > 0:
                        time.sleep(lag)
                    self._offer(n, 0, t_arr)
            finally:
                stop.set()

        sub = threading.Thread(target=submit_all, name="loadgen-open",
                               daemon=True)
        sub.start()
        self.server.serve(stop)   # the drain thread: this one
        sub.join()
        return self.report(offered_rate=rate_sps)

    # -- closed loop -------------------------------------------------------

    def run_closed(self, concurrency: int, n_total: int,
                   think_s: float = 0.0,
                   max_backoff_s: float = 0.5) -> dict:
        """Each querier offers, waits for ITS survey to finish, then
        offers the next — the classic closed loop whose steady state
        finds the server's saturation throughput. A rejected offer backs
        off (the Overloaded retry-after hint, clamped) and re-offers as
        a fresh attempt, so rejections stay typed and counted. The
        backoff is jittered by a seeded policy RNG (same derivation as
        the reference's resilience.RetryPolicy) so a fleet of shed queriers does not
        re-offer in lockstep at exactly ``retry_after_s`` — while two
        same-seed runs still sleep identical schedules."""
        stop = threading.Event()
        counter = {"n": 0}
        active = {"n": concurrency}
        self._t0 = time.monotonic()

        def querier():
            while True:
                with self._lock:
                    n = counter["n"]
                    if n >= n_total:
                        break
                    counter["n"] = n + 1
                attempt = 0
                while True:
                    rec = self._offer(n, attempt, self._now())
                    if rec.admitted:
                        self._events[rec.survey_id].wait(
                            timeout=rp.CALL_TIMEOUT_S)
                        break
                    attempt += 1
                    wait = (rec.retry_after_s
                            if rec.outcome == "shed" else rp.POLL_INTERVAL_S)
                    # seeded +/- BACKOFF_JITTER fraction, keyed per
                    # (querier slot, attempt), as the reference's RetryPolicy._delay —
                    # de-synchronizes the re-offer herd deterministically
                    r = random.Random((self.seed * 1_000_003 + n)
                                      * 1_000_003 + attempt)
                    wait *= 1.0 + rp.BACKOFF_JITTER * (2.0 * r.random()
                                                       - 1.0)
                    time.sleep(min(max(wait, rp.POLL_INTERVAL_S),
                                   max_backoff_s))
                if think_s > 0:
                    time.sleep(think_s)
            with self._lock:
                active["n"] -= 1
                if active["n"] == 0:
                    stop.set()

        qs = [threading.Thread(target=querier, name=f"loadgen-q{i}",
                               daemon=True)
              for i in range(concurrency)]
        for q in qs:
            q.start()
        self.server.serve(stop)   # the drain thread: this one
        for q in qs:
            q.join()
        return self.report(concurrency=concurrency)

    # -- accounting --------------------------------------------------------

    def report(self, **extra) -> dict:
        """Exact offered-vs-completed accounting plus the latency
        distribution. ``lost`` MUST be zero after any run — an admitted
        survey the server dropped — and is the first overload gate."""
        recs = list(self.records)
        by_outcome: dict[str, int] = {}
        for r in recs:
            by_outcome[r.outcome] = by_outcome.get(r.outcome, 0) + 1
        done = [r for r in recs if r.outcome == "ok"]
        admitted = [r for r in recs if r.admitted]
        lost = [r for r in recs if r.outcome == "pending"]
        t_end = max((r.t_done for r in done), default=self._now())
        span = max(t_end, 1e-9)
        lats = np.array([r.latency() for r in done]) if done else np.array([0.0])
        per_tenant: dict[str, dict] = {}
        for r in recs:
            d = per_tenant.setdefault(r.tenant, {"offered": 0,
                                                 "completed": 0,
                                                 "rejected": 0})
            d["offered"] += 1
            if r.outcome == "ok":
                d["completed"] += 1
            elif r.outcome in REJECTED:
                d["rejected"] += 1
        rep = {
            "offered": len(recs),
            "admitted": len(admitted),
            "completed": len(done),
            "errors": by_outcome.get("error", 0),
            "rejected": {k: by_outcome.get(k, 0) for k in REJECTED},
            "lost": len(lost),
            "duration_s": round(span, 6),
            "throughput_sps": round(len(done) / span, 3),
            "latency_s": {
                "p50": round(float(np.percentile(lats, 50)), 6),
                "p90": round(float(np.percentile(lats, 90)), 6),
                "p99": round(float(np.percentile(lats, 99)), 6),
                "mean": round(float(lats.mean()), 6),
                "max": round(float(lats.max()), 6),
            },
            "per_tenant": per_tenant,
        }
        rep.update(extra)
        if lost:
            log.warn(f"loadgen: {len(lost)} admitted surveys never "
                     f"completed: {[r.survey_id for r in lost[:5]]}...")
        return rep


def fairness_ratio(report: dict, tenants: list[str]) -> float:
    """min/max completed count across the named tenants (1.0 = perfectly
    fair service among them; the adversarial-mix gate bounds this from
    below for the victim tenants while a hot tenant floods)."""
    counts = [report["per_tenant"].get(t, {}).get("completed", 0)
              for t in tenants]
    if not counts or max(counts) == 0:
        return 0.0
    return min(counts) / max(counts)


__all__ = ["LoadGen", "Record", "ShapeMix", "SyntheticCluster",
           "fairness_ratio", "poisson_schedule", "prewarm_shapes",
           "synthetic_query"]
