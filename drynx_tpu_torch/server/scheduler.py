"""Standing survey scheduler: bounded lanes, a cooperative compile lane,
cross-survey batched verification, a two-stage encode/verify pipeline,
per-tenant fair queueing and admission-controlled shedding.

The port's counterpart of drynx_tpu/server/scheduler.py, with the same
lanes, grouping, threading contract and typed rejections. The thread rule,
restated for CUDA:

  * All cold work stays on the thread that calls `drain()`/`serve()`
    (normally the main thread): a library's nvcc build and load, a kernel's
    first launch, the range proofs' tables. The compile lane is
    "background" only in the scheduling sense: promotion runs the warm-up
    registry (`compilecache.precompile`) between surveys on the drain
    thread, under the cluster's proof-device lock.
  * Verify worker threads only re-run warm work: a fast-lane verdict
    certifies every entry of the shape (the cross flush launches the same
    kernels), so a first nvcc build never stalls a verification. The
    warmth is per process, so a pool of N workers is as warm as one.
    `compilecache.COLD_EVENTS` records the thread of every library load
    and table build, which is how the rule is checked.

Pipelining interleaves dispatch: survey N+1's DP encode (drain thread)
overlaps survey N's VN verification (worker threads). PhaseTimers spans
(`Pipeline.encode.<sid>`, `Pipeline.verify.<sid>`) record the overlap;
`pipeline_overlap` integrates it. As in the reference, a verify span
starts at the survey's finalize. A held group's wait for its payloads
(`Pipeline.wait.<sids>`: the proof threads that build the DPs' range
proofs and deliver every envelope) and its cross flush
(`Pipeline.flush.<sids>`) are spans of their own.

Streaming: a registered `StreamEngine` gets an advance lane that bypasses
admission: `open_stream` triages and warms the stream's prototype shape
once; `advance_stream` charges the per-DP epsilon budget at submit (typed
`EpsilonExhausted`, before anything queues) and queues the advance, which
`drain` serves before every other lane, on the drain thread.

Fairness: the fast lane is one deque per tenant, served by deficit
round-robin: each visit credits a tenant `max_batch x weight` and pops at
most that many shape-equal entries. On top of the bounded total depth
(`QueueFull`), each tenant holds at most `tenant_quota` queued surveys
(`QuotaExceeded`), and past `shed_fraction x max_depth` submit() sheds with
`Overloaded` and a retry-after hint from the observed completion rate.

Left out against the reference: its DRYNX_VERIFY_WORKERS,
DRYNX_TENANT_QUOTA, DRYNX_SHED_FRACTION and DRYNX_SLIDE_PACING overrides
(the constructor's arguments and resilience/policy.py's constants remain),
and its lower-only compile mode (its `compile_mode` argument): the compile
lane executes, which on the CPU builds the tables only. The refill lane
seeds a torch.Generator from `secrets` where the reference draws a JAX
key.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue
import secrets
import threading
import time

import torch

from .. import compilecache as cc
from ..resilience import policy as rp
from ..utils import log
from ..utils.timers import PhaseTimers
from . import admission as adm


@dataclasses.dataclass
class _Entry:
    sq: object
    seed: int
    admission: adm.Admission
    tenant: str = "default"
    # survey resume: a dispatch failure re-enters the queue at most
    # RESUME_MAX_RETRIES times, with the post-probe live responder set
    # carried into the retry
    retries: int = 0
    responders: tuple | None = None


@dataclasses.dataclass
class _AdvanceEntry:
    """One queued window advance for a registered stream. Carries the
    engine itself (not a survey query): the advance's survey id is only
    minted when the window slides, so results are recorded under the
    ``ticket`` handed back by advance_stream()."""

    engine: object
    ticket: str
    tenant: str = "default"


class SurveyServer:
    """A standing scheduler over one LocalCluster.

    ``submit()`` triages surveys into the fast or compile lane (bounded
    total depth — ``QueueFull`` past ``max_depth``, ``Overloaded`` past
    the shed threshold, ``QuotaExceeded`` past one tenant's quota);
    ``drain()`` processes all lanes to empty on the calling thread and
    returns per-survey results, ``serve(stop)`` runs the same loop until
    signalled (the load-harness entry point). Fast-lane surveys with
    equal shape are grouped (up to ``max_batch``) and their range
    payloads held at the VNs for ONE cross-survey joint verification; a
    shape miss costs one cooperative precompile pass, after which the
    survey is re-admitted.

    ``pipeline=False`` degrades to strictly serial execute+finalize on
    the drain thread (the reference configuration for transcript
    comparison); batching still applies. ``workers=N`` widens the verify
    pool (default ``policy.VERIFY_WORKERS``); group composition is still
    decided on the drain thread, so transcripts are byte-identical at any
    width.
    """

    def __init__(self, cluster, max_batch: int = 4, max_depth: int = 16,
                 pipeline: bool = True, workers: int | None = None,
                 tenant_quota: int | None = None,
                 tenant_weights: dict | None = None,
                 shed_fraction: float | None = None):
        self.cluster = cluster
        self.max_batch = max(1, max_batch)
        self.max_depth = max(1, max_depth)
        self.pipeline = pipeline
        self.workers = max(1, int(workers) if workers is not None
                           else rp.VERIFY_WORKERS)
        self.tenant_quota = max(1, int(tenant_quota)
                                if tenant_quota is not None
                                else rp.TENANT_QUOTA)
        frac = (float(shed_fraction) if shed_fraction is not None
                else rp.SHED_FRACTION)
        # fraction >= 1 disables shedding: only the hard depth bound
        # applies
        self._shed_depth = (self.max_depth if frac >= 1.0
                            else max(1, math.ceil(frac * self.max_depth)))
        self.admission = adm.AdmissionController(cluster)
        # the one mode (the reference also lowers without executing):
        # execute every entry the shape reaches (on the CPU the kernel
        # entries are skipped and the tables built); this server's passes
        # keep their rows in compile_stats
        self.compile_mode = "execute"
        self.compile_stats = cc.CompileStats()
        self.timers = PhaseTimers()
        # fast lane: one FIFO per tenant under deficit round-robin
        self._fast: dict[str, collections.deque] = {}
        self._rr_order: list[str] = []
        self._rr_idx = 0
        self._deficit: dict[str, float] = {}
        self._weights: dict[str, float] = dict(tenant_weights or {})
        self._compile: collections.deque = collections.deque()
        # refill lane: surveys whose entries are warm but whose DRO
        # noise need exceeds the pool balance (admission lane "refill").
        # The drain thread deposits slabs cooperatively (demand-aware:
        # enough to cover the waiting need plus the observed consumption
        # rate over REFILL_HORIZON_S, capped per step) — fast-lane-
        # preemptible, same pattern as the compile lane — so refill
        # overlaps the verify workers (the pipeline gaps).
        self._refill: collections.deque = collections.deque()
        self.refill_slabs = 0
        # streaming advance lane: registered engines and their
        # queued advances. Advances bypass the admission gates (the
        # stream's shape was triaged once at open_stream; epsilon is
        # charged at submit) and are served before every other lane, so
        # they never count toward the one-shot depth/quota bounds.
        self.streams: dict[str, object] = {}
        self._advance: collections.deque = collections.deque()
        self._advance_seq = 0
        self._stream_last_t: dict[str, float] = {}
        self._results: dict[str, object] = {}
        self._errors: dict[str, Exception] = {}
        self._admissions: dict[str, adm.Admission] = {}
        self._lock = rp.named_lock("scheduler_lock")
        self._results_lock = rp.named_lock("scheduler_results_lock")
        # completion clock: drives the Overloaded retry-after hint and
        # the refill lane's demand forecast
        self._done_t: collections.deque = collections.deque(
            maxlen=rp.RATE_WINDOW_EVENTS)
        self._dro_done: collections.deque = collections.deque(
            maxlen=rp.RATE_WINDOW_EVENTS)
        # optional completion callback: on_done(survey_id, ok) fires
        # exactly once per admitted survey, from whichever thread
        # recorded the outcome (the load generator's latency clock)
        self.on_done = None
        self._verify_q: queue.Queue = queue.Queue()
        self._workers: list[threading.Thread] = []

    # -- intake ------------------------------------------------------------

    def submit(self, sq, seed: int = 0,
               tenant: str = "default") -> adm.Admission:
        """Triage + enqueue under three typed admission gates, checked in
        order: QueueFull at max_depth (the hard bound), QuotaExceeded at
        this tenant's queued-survey quota, Overloaded past the shed
        threshold (with a retry_after_s hint). Nothing admitted is ever
        dropped silently."""
        with self._lock:
            depth = self._depth_locked()
            if depth >= self.max_depth:
                raise adm.QueueFull(
                    f"queue at max_depth={self.max_depth}; survey "
                    f"{sq.survey_id!r} rejected")
            if self._tenant_depth_locked(tenant) >= self.tenant_quota:
                raise adm.QuotaExceeded(
                    f"tenant {tenant!r} at quota={self.tenant_quota}; "
                    f"survey {sq.survey_id!r} rejected",
                    tenant=tenant, quota=self.tenant_quota)
            if depth >= self._shed_depth:
                raise adm.Overloaded(
                    f"queue sheds past depth {self._shed_depth} "
                    f"({depth} queued); survey {sq.survey_id!r} rejected",
                    retry_after_s=self._retry_after(depth))
            a = self.admission.triage(sq, tenant=tenant)
            self._admissions[sq.survey_id] = a
            self._route_locked(_Entry(sq=sq, seed=seed, admission=a,
                                      tenant=tenant))
        return a

    def prewarm(self, sq) -> adm.Admission:
        """Drive the precompile pass for a survey's shape NOW (calling
        thread) without enqueueing it; returns the post-warm verdict."""
        a = self.admission.triage(sq)
        if a.lane == "compile":
            self._compile_profile(a.profile, sq.survey_id)
        return self.admission.triage(sq)

    def admission_of(self, survey_id: str) -> adm.Admission | None:
        return self._admissions.get(survey_id)

    # -- streaming fast lane ---------------------------------------

    def open_stream(self, engine=None, prewarm: bool = True, **kwargs):
        """Register a streaming engine with this scheduler and return it.

        Either pass a built ``StreamEngine`` or kwargs to construct one
        over this server's cluster. Triage happens ONCE here: the
        stream's prototype query is driven through the precompile pass on
        the calling thread (``prewarm=True``), so every later
        ``advance_stream`` bypasses admission re-triage entirely — the
        shape cannot go cold between slides."""
        if engine is None:
            from ..service.streaming import StreamEngine

            engine = StreamEngine(self.cluster, **kwargs)
        if prewarm and engine.proofs_on:
            self.prewarm(engine.sq_proto)
        with self._lock:
            self.streams[engine.stream_id] = engine
        return engine

    def advance_stream(self, stream_id: str, rows_by_dp: dict | None = None,
                       tenant: str = "default") -> str:
        """Feed ``rows_by_dp`` (optional) and queue one window advance on
        the advance fast lane; returns a ticket under which results()
        reports the :class:`~..service.streaming.StreamAdvance`.

        The per-DP epsilon budget is charged HERE, at submit: an
        exhausted (DP, cohort) budget raises the typed
        ``adm.EpsilonExhausted`` before anything queues — the streaming
        admission gate, checked like QueueFull but against a privacy
        ledger instead of a depth bound. The queued advance then runs
        ``precharged`` (the engine never double-charges)."""
        engine = self.streams.get(stream_id)
        if engine is None:
            raise KeyError(f"unknown stream {stream_id!r}; open_stream first")
        if rows_by_dp:
            engine.feed(rows_by_dp)
        engine.charge_epsilon()
        with self._lock:
            self._advance_seq += 1
            ticket = f"{stream_id}#a{self._advance_seq}"
            self._advance.append(_AdvanceEntry(engine=engine, ticket=ticket,
                                               tenant=tenant))
        return ticket

    def _depth_locked(self) -> int:
        return (sum(len(q) for q in self._fast.values())
                + len(self._compile) + len(self._refill))

    def _tenant_depth_locked(self, tenant: str) -> int:
        return (len(self._fast.get(tenant, ()))
                + sum(1 for e in self._compile if e.tenant == tenant)
                + sum(1 for e in self._refill if e.tenant == tenant))

    def _route_locked(self, entry: _Entry) -> None:
        """Append an entry to the deque its admission lane names
        (caller holds self._lock)."""
        if entry.admission.lane == "compile":
            self._compile.append(entry)
        elif entry.admission.lane == "refill":
            self._refill.append(entry)
        else:
            self._requeue_locked(entry)

    def _requeue_locked(self, entry: _Entry) -> None:
        """Fast-lane append for entry.tenant, registering the tenant in
        the round-robin order on first sight. Resume re-entries come
        through here directly — an already-admitted survey bypasses the
        admission gates (it never logically left the queue)."""
        t = entry.tenant
        q = self._fast.get(t)
        if q is None:
            q = self._fast[t] = collections.deque()
            self._rr_order.append(t)
            self._deficit[t] = 0.0
        q.append(entry)

    # -- overload bookkeeping ----------------------------------------------

    def _observed_rate(self) -> float:
        """Completions per second over the recent done-event window
        (0.0 until two completions have landed)."""
        with self._results_lock:
            ts = list(self._done_t)
        if len(ts) < 2 or ts[-1] <= ts[0]:
            return 0.0
        return (len(ts) - 1) / (ts[-1] - ts[0])

    def _retry_after(self, depth: int) -> float:
        """The Overloaded hint: how long until the backlog above the shed
        threshold clears at the observed completion rate, clamped to
        [SHED_RETRY_MIN_S, SHED_RETRY_MAX_S] (a cold server with no rate
        yet hints the max)."""
        rate = self._observed_rate()
        if rate <= 0.0:
            return rp.SHED_RETRY_MAX_S
        backlog = depth - self._shed_depth + 1
        return min(rp.SHED_RETRY_MAX_S,
                   max(rp.SHED_RETRY_MIN_S, backlog / rate))

    def _dro_rate(self) -> float:
        """Observed DRO pool consumption (elements/s) — the refill
        lane's demand forecast input."""
        with self._results_lock:
            evs = list(self._dro_done)
        if len(evs) < 2 or evs[-1][0] <= evs[0][0]:
            return 0.0
        return (sum(n for _, n in evs[1:])
                / (evs[-1][0] - evs[0][0]))

    # -- compile lane (cooperative, drain thread only) ---------------------

    def _compile_profile(self, profile, survey_id: str) -> None:
        t0 = time.perf_counter()
        with self.cluster._proof_device_lock:
            # a stand-in cluster without a device (loadgen's synthetic
            # plane) has nothing on the card: its pass builds the tables
            cc.precompile(profile, mode=self.compile_mode,
                          cluster=adm._cluster_of(self.cluster),
                          device=getattr(self.cluster, "device", "cpu"),
                          stats=self.compile_stats,
                          log=lambda m: log.lvl2(f"server compile: {m}"))
        self.timers.span(f"Compile.{survey_id}", t0, time.perf_counter())
        self.admission.note_warmed(profile)

    def _promote(self, entry: _Entry) -> None:
        """One cooperative compile-lane step: run the warm-up for the
        entry's shape, then re-admit it (now warm) to the fast lane."""
        sid = entry.sq.survey_id
        log.lvl2(f"server: compiling shape for {sid} "
                 f"({len(entry.admission.missing)} cold entries)")
        self._compile_profile(entry.admission.profile, sid)
        entry.admission = self.admission.triage(entry.sq,
                                                tenant=entry.tenant)
        with self._lock:
            self._admissions[sid] = entry.admission
            # now warm — but a short pool still routes it via refill
            self._route_locked(entry)

    # -- refill lane (cooperative, drain thread only) ----------------------

    def _refill_step(self, entry: _Entry) -> None:
        """Deposit pool slabs toward this entry's DRO need, then
        re-triage. Demand-aware: the target is the waiting survey's need
        plus the observed consumption rate integrated over
        REFILL_HORIZON_S (so a busy diffp tenant banks ahead of its next
        survey), capped at REFILL_MAX_SLABS_STEP slabs per cooperative
        step so the fast and compile lanes still preempt promptly. Runs
        on the drain thread under the proof-device lock (the slab
        precompute is a real device dispatch — same threading contract
        as the compile lane), so it fills the encode/verify pipeline
        gaps: while the verify workers grind survey N, the drain thread
        banks randomness for survey N+1."""
        from .. import pool as pool_mod

        sid = entry.sq.survey_id
        pool = self.cluster.pool
        digest = self.admission._pool_digest()
        target = (entry.admission.dro_need
                  + int(self._dro_rate() * rp.REFILL_HORIZON_S))
        t0 = time.perf_counter()
        deposited = 0
        while deposited < rp.REFILL_MAX_SLABS_STEP:
            with self.cluster._proof_device_lock:
                table = self.cluster.coll_tbl.table
                gen = torch.Generator(device=table.device).manual_seed(
                    secrets.randbits(63))
                pool_mod.replenish.refill_slab(pool, gen, table)
            deposited += 1
            self.refill_slabs += 1
            if pool.dro_balance(digest) >= target:
                break
        self.timers.span(f"Refill.{sid}", t0, time.perf_counter())
        entry.admission = self.admission.triage(entry.sq,
                                                tenant=entry.tenant)
        with self._lock:
            self._admissions[sid] = entry.admission
            self._route_locked(entry)

    # -- advance lane (drain thread only) ----------------------------------

    def _advance_step(self, adv: _AdvanceEntry) -> None:
        """Run one queued window advance on the drain thread (the
        engine's delta fold, proof delivery and key switch run under the
        proof-device lock, execute_survey's threading contract). Slide
        pacing, when configured (rp.SLIDE_PACING_S), enforces a minimum
        gap between a stream's advances here rather than at submit, so a
        caller may queue a burst and still release at the paced rate."""
        eng = adv.engine
        pace = rp.SLIDE_PACING_S
        if pace > 0.0:
            last = self._stream_last_t.get(eng.stream_id)
            if last is not None:
                wait = pace - (time.monotonic() - last)
                if wait > 0.0:
                    time.sleep(wait)
        t0 = time.perf_counter()
        try:
            res = eng.advance(precharged=True)
        except Exception as exc:
            log.warn(f"server: stream advance {adv.ticket} failed: {exc}")
            self._record_error(adv.ticket, exc)
        else:
            self._record_result(adv.ticket, res)
        finally:
            self._stream_last_t[eng.stream_id] = time.monotonic()
            self.timers.span(f"Advance.{adv.ticket}",
                             t0, time.perf_counter())

    # -- drain loop --------------------------------------------------------

    def _drain_step(self) -> bool:
        """One scheduling decision on the calling thread; False when all
        lanes are empty. Stream advances first (they pre-paid admission
        at open_stream/advance_stream and their deltas are latency-
        sensitive), then fast work, then compile (it unblocks
        encodes that feed the verify pipeline), then refill — the refill
        lane is pure gap work: slab deposits overlap whatever the verify
        workers are grinding, and nothing downstream waits on them until
        their survey is next."""
        group = None
        entry = None
        rentry = None
        adv = None
        with self._lock:
            if self._advance:
                adv = self._advance.popleft()
            elif any(len(q) for q in self._fast.values()):
                group = self._pop_group_locked()
            elif self._compile:
                entry = self._compile.popleft()
            elif self._refill:
                rentry = self._refill.popleft()
            else:
                return False
        if adv is not None:
            self._advance_step(adv)
        elif group is not None:
            self._run_group(group)
        elif rentry is not None:
            self._refill_step(rentry)
        elif entry is not None:
            self._promote(entry)
        return True

    def drain(self) -> dict:
        """Process all lanes to empty ON THE CALLING THREAD (the drain
        thread), then wait for the verify workers to finish. Returns
        {survey_id: SurveyResult | Exception}."""
        while self._drain_step():
            pass
        self._verify_q.join()
        return self.results()

    def serve(self, stop: threading.Event,
              idle_s: float | None = None) -> dict:
        """Drain continuously until ``stop`` is set, sleeping ``idle_s``
        when all lanes are empty — the standing-load entry point
        (loadgen submits from other threads while this loop runs on the
        drain thread). On stop, finishes whatever is queued and joins
        the verify pool, so every admitted survey still completes."""
        idle = rp.POLL_INTERVAL_S if idle_s is None else idle_s
        while not stop.is_set():
            if not self._drain_step():
                time.sleep(idle)
        return self.drain()

    def results(self) -> dict:
        with self._results_lock:
            out: dict = dict(self._results)
            out.update(self._errors)
        return out

    def _pop_group_locked(self) -> list:
        """Deficit round-robin across tenants, then a maximal run of
        shape-equal entries from the chosen tenant's FIFO (up to the
        tenant's accrued quantum, never more than max_batch; proofs-off
        surveys — profile None — never group). Each visit to a backlogged
        tenant credits ``max_batch × weight``, so relative service rates
        follow the weights while a lone tenant gets whole batches exactly
        like the historical single-FIFO scheduler. A tenant's unused
        deficit is forfeited when its queue empties (classic DRR — idle
        tenants cannot bank credit)."""
        while True:
            t = self._rr_order[self._rr_idx % len(self._rr_order)]
            self._rr_idx = (self._rr_idx + 1) % len(self._rr_order)
            q = self._fast.get(t)
            if not q:
                self._deficit[t] = 0.0
                continue
            self._deficit[t] += self.max_batch * self._weights.get(t, 1.0)
            take = min(int(self._deficit[t]), self.max_batch)
            if take < 1:
                continue
            group = [q.popleft()]
            key = group[0].admission.profile
            while (key is not None and q and len(group) < take
                   and q[0].admission.profile == key):
                group.append(q.popleft())
            self._deficit[t] -= len(group)
            if not q:
                self._deficit[t] = 0.0
            return group

    # -- encode stage (drain thread) ---------------------------------------

    def _run_group(self, group: list) -> None:
        hold = len(group) > 1
        pendings = []
        for e in group:
            sid = e.sq.survey_id
            t0 = time.perf_counter()
            try:
                p = self.cluster.execute_survey(e.sq, e.seed,
                                                hold_range=hold,
                                                tenant=e.tenant,
                                                responders=e.responders)
            except Exception as exc:
                self.timers.span(f"Pipeline.encode.{sid}",
                                 t0, time.perf_counter())
                budget = self._resume_budget(sid)
                if e.retries < budget:
                    # survey resume: re-probe liveness, carry the
                    # responder set, re-enter the queue. The retry
                    # bypasses admission gates — the survey was already
                    # admitted and never logically left. A survey with a
                    # phase checkpoint gets CHECKPOINT_MAX_RESUMES
                    # re-entries (each resumes from the recorded phase,
                    # not from scratch); one without keeps the legacy
                    # single retry.
                    e.retries += 1
                    if budget > rp.RESUME_MAX_RETRIES:
                        # checkpointed lane: pace the passes so the
                        # retry budget spans a healing fault window
                        # instead of burning out in milliseconds —
                        # re-probing only makes sense once the world
                        # has had time to move
                        time.sleep(rp.RESUME_BACKOFF_S)
                    e.responders = self._reprobe()
                    log.warn(f"server: survey {sid} failed in dispatch "
                             f"({exc}); re-queued (retry {e.retries}) "
                             f"with responders={e.responders}")
                    with self._lock:
                        self._requeue_locked(e)
                    continue
                # quorum failure / mid-survey fault after its retry:
                # this survey degrades alone — its batch partners flush
                # without it (a held survey is only included in the
                # cross flush once ALL its expected payloads arrived;
                # see flush_ranges_cross)
                log.warn(f"server: survey {sid} failed in encode: {exc}")
                self._record_error(sid, exc)
                continue
            self.timers.span(f"Pipeline.encode.{sid}",
                             t0, time.perf_counter())
            pendings.append(p)
        if not pendings:
            return
        if self.pipeline:
            self._ensure_workers()
            self._verify_q.put(pendings)
        else:
            self._verify_group(pendings)

    def _resume_budget(self, sid: str) -> int:
        """Retry cap for the resume lane: CHECKPOINT_MAX_RESUMES when the
        cluster holds a phase checkpoint for this survey
        (`LocalCluster.checkpoint_for`: every survey that reached its
        probe phase has one, durable with `attach_checkpoint_store`), as
        a re-entry then counts a resume on that record; else
        RESUME_MAX_RETRIES."""
        ckfor = getattr(self.cluster, "checkpoint_for", None)
        if ckfor is not None:
            try:
                if ckfor(sid) is not None:
                    return rp.CHECKPOINT_MAX_RESUMES
            except Exception:
                pass
        return rp.RESUME_MAX_RETRIES

    def _reprobe(self) -> tuple | None:
        """The resume re-triage: the sorted DPs that the cluster's
        liveness probe (`LocalCluster.probe_liveness`, through the fault
        plane's hooks) finds alive, carried into the retry as its
        responder set; None, no restriction, when the cluster has no
        probe or the probe fails."""
        probe = getattr(self.cluster, "probe_liveness", None)
        if probe is None:
            return None
        try:
            alive = probe()
        except Exception as exc:
            log.warn(f"server: liveness re-probe failed: {exc}")
            return None
        return tuple(sorted(n for n, ok in alive.items() if ok))

    # -- verify stage (worker pool; re-execution only) ---------------------

    def _ensure_workers(self) -> None:
        # called from the drain thread only; workers share one queue, so
        # join() still synchronizes whatever the pool width
        self._workers = [t for t in self._workers if t.is_alive()]
        while len(self._workers) < self.workers:
            i = len(self._workers)
            name = "server-verify" if i == 0 else f"server-verify-{i}"
            t = threading.Thread(target=self._verify_loop, name=name,
                                 daemon=True)
            t.start()
            self._workers.append(t)

    def _verify_loop(self) -> None:
        # a worker re-runs warm work only (the module docstring)
        while True:
            pendings = self._verify_q.get()
            try:
                self._verify_group(pendings)
            except Exception as exc:  # per-survey errors are caught below;
                log.warn(f"server: verify group crashed: {exc}")
            finally:
                self._verify_q.task_done()

    def _verify_group(self, pendings: list) -> None:
        held = [p for p in pendings if p.hold_range]
        if held:
            sids = [p.sq.survey_id for p in held]
            t0 = time.perf_counter()
            deadline = time.monotonic() + rp.COLD_COMPILE_WAIT_S
            for p in held:
                # all held payloads must be AT the VNs before the joint
                # flush (on threaded backends proof delivery is async);
                # joining here is idempotent — finalize joins again
                for t in p.survey.proof_threads:
                    t.join(timeout=max(0.0,
                                       deadline - time.monotonic()))
            self.timers.span("Pipeline.wait." + "+".join(sids),
                             t0, time.perf_counter())
            t0 = time.perf_counter()
            self.cluster.vns.flush_cross_survey(sids)
            self.timers.span("Pipeline.flush." + "+".join(sids),
                             t0, time.perf_counter())
        for p in pendings:
            sid = p.sq.survey_id
            t0 = time.perf_counter()
            try:
                self._record_result(sid, self.cluster.finalize_survey(p))
            except Exception as exc:
                log.warn(f"server: survey {sid} failed in verify: {exc}")
                self._record_error(sid, exc)
            finally:
                self.timers.span(f"Pipeline.verify.{sid}",
                                 t0, time.perf_counter())

    # -- outcome recording (any thread) ------------------------------------

    def _record_result(self, sid: str, res) -> None:
        with self._results_lock:
            self._results[sid] = res
        self._note_done(sid, ok=True)

    def _record_error(self, sid: str, exc: Exception) -> None:
        with self._results_lock:
            self._errors[sid] = exc
        self._note_done(sid, ok=False)

    def _note_done(self, sid: str, ok: bool) -> None:
        now = time.monotonic()
        a = self._admissions.get(sid)
        with self._results_lock:
            self._done_t.append(now)
            if a is not None and a.dro_need:
                self._dro_done.append((now, a.dro_need))
        cb = self.on_done
        if cb is not None:
            try:
                cb(sid, ok)
            except Exception as exc:
                log.warn(f"server: on_done callback failed for "
                         f"{sid}: {exc}")


def refill_overlap(timers: PhaseTimers) -> float:
    """Seconds of wall-clock during which a pool-refill step overlapped
    some survey's verification — the amortization proof the acceptance
    JSON reports (> 0 iff refill ran in a pipeline gap instead of
    serializing in front of its survey)."""
    refills = timers.spans("Refill.")
    verifies = timers.spans("Pipeline.verify.")
    total = 0.0
    for _, r0, r1 in refills:
        for _, v0, v1 in verifies:
            total += max(0.0, min(r1, v1) - max(r0, v0))
    return total


def pipeline_overlap(timers: PhaseTimers) -> float:
    """Seconds of wall-clock during which some survey's encode span
    intersects a DIFFERENT survey's verify span — the pipelining proof
    scripts/serve_surveys.py reports (> 0 iff encode of survey N+1 ran
    concurrently with verification of survey N)."""
    encodes = timers.spans("Pipeline.encode.")
    verifies = timers.spans("Pipeline.verify.")
    total = 0.0
    for en, e0, e1 in encodes:
        e_sid = en.rsplit(".", 1)[-1]
        for vn, v0, v1 in verifies:
            if vn.rsplit(".", 1)[-1] == e_sid:
                continue
            total += max(0.0, min(e1, v1) - max(e0, v0))
    return total


__all__ = ["SurveyServer", "pipeline_overlap", "refill_overlap"]
