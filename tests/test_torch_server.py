"""The port's standing survey server (drynx_tpu_torch/server) against the
reference's, and its own quick tier.

Both packages' `SurveyServer` run the same scenarios over the same fake
cluster: lanes, execution and finalization order, groups and flushes,
typed rejections and their order, retry-after hints given the same
completion times, deficit round-robin over three weighted tenants, the
resume lane and the worker pool's names. Each package's warm-up driver is
replaced by a recorder (the scenarios exercise the lanes, not the
kernels), and each admission's entry set by one name, so warmth means the
same in both. The reference's SurveyServer imports
drynx_tpu/crypto/pallas_ops.py, which does not import under this jax: the
module-scoped `ref` fixture installs the `jax.enable_x64` stand-in of
tests/test_torch_survey.py while this module runs, and at teardown
restores it and forgets every reference module imported under it.

The slow test runs chip_smoke.py's phase-13a surveys through the port's
server on the CPU: batched results equal to a serial run's, and equal
transcripts.
"""
import contextlib
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

from drynx_tpu_torch import compilecache as cc
from drynx_tpu_torch.resilience import policy as TP
from drynx_tpu_torch.server import admission as TADM
from drynx_tpu_torch.server import scheduler as TSCH
from drynx_tpu_torch.server import (AdmissionController, Overloaded,
                                    QueueFull, QuotaExceeded, SurveyServer,
                                    pipeline_overlap, survey_transcript,
                                    transcript_digest)
from drynx_tpu_torch.utils.timers import PhaseTimers

ENTRY = "table:gt_base"


@contextlib.contextmanager
def _x64(flag=True):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", bool(flag))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def ref():
    """The reference's server modules, constructible on this jax while
    this module's tests run (see the module docstring)."""
    saved = jax.enable_x64
    before = set(sys.modules)
    jax.enable_x64 = _x64
    try:
        from drynx_tpu import compilecache
        from drynx_tpu.resilience import policy
        from drynx_tpu.server import admission, scheduler

        yield types.SimpleNamespace(cc=compilecache, policy=policy,
                                    admission=admission,
                                    scheduler=scheduler)
    finally:
        jax.enable_x64 = saved
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name.startswith("drynx_tpu."):
                parent, _, attr = name.rpartition(".")
                sys.modules.pop(name)
                if hasattr(sys.modules.get(parent), attr):
                    delattr(sys.modules[parent], attr)


class _FakeVNs:
    def __init__(self):
        self.flushed: list = []

    def flush_cross_survey(self, sids):
        self.flushed.append(list(sids))
        return list(sids)


class _FakeCluster:
    """The surface AdmissionController and SurveyServer touch."""

    def __init__(self):
        self.cns = ["cn0", "cn1"]
        self.dp_idents = ["dp0", "dp1"]
        self.vns = _FakeVNs()
        self.dlog = types.SimpleNamespace(limit=4000)
        self._proof_device_lock = threading.Lock()
        self.executed: list = []
        self.exec_kwargs: list = []
        self.finalized: list = []
        self.fail_encode: set = set()
        self.fail_encode_once: set = set()

    def _ranges_per_value(self, q):
        return [(4, 2)]

    def execute_survey(self, sq, seed=0, hold_range=False,
                       tenant="default", responders=None):
        self.executed.append((sq.survey_id, hold_range,
                              threading.current_thread().name))
        self.exec_kwargs.append((sq.survey_id, tenant, responders))
        if sq.survey_id in self.fail_encode:
            if sq.survey_id in self.fail_encode_once:
                self.fail_encode.discard(sq.survey_id)
                self.fail_encode_once.discard(sq.survey_id)
            raise RuntimeError(f"boom {sq.survey_id}")
        return types.SimpleNamespace(
            sq=sq, hold_range=hold_range, tenant=tenant,
            survey=types.SimpleNamespace(proof_threads=[]))

    def finalize_survey(self, pending):
        sid = pending.sq.survey_id
        self.finalized.append((sid, threading.current_thread().name))
        return f"result-{sid}"


def _sq(sid, proofs=1):
    return types.SimpleNamespace(survey_id=sid,
                                 query=types.SimpleNamespace(proofs=proofs))


@pytest.fixture
def both(ref, monkeypatch):
    """(module namespace) of each package, their warm-up drivers replaced
    by recorders and their admissions' entry sets by one name."""
    calls = {"port": [], "ref": []}

    def recorder(key):
        def fake(profile, mode="execute", *a, **k):
            calls[key].append((profile, mode))
            return {}
        return fake

    monkeypatch.setattr(cc, "precompile", recorder("port"))
    monkeypatch.setattr(ref.cc, "precompile", recorder("ref"))
    monkeypatch.setattr(ref.cc, "trace_guard", lambda *a, **k: None)
    for A in (TADM.AdmissionController, ref.admission.AdmissionController):
        monkeypatch.setattr(A, "needed", lambda self, p: frozenset({ENTRY}))
    port = types.SimpleNamespace(
        Server=SurveyServer, QueueFull=QueueFull,
        QuotaExceeded=QuotaExceeded, Overloaded=Overloaded, policy=TP,
        calls=calls["port"])
    refs = types.SimpleNamespace(
        Server=ref.scheduler.SurveyServer,
        QueueFull=ref.admission.QueueFull,
        QuotaExceeded=ref.admission.QuotaExceeded,
        Overloaded=ref.admission.Overloaded, policy=ref.policy,
        calls=calls["ref"])
    return port, refs


def _warm(pkg, cl, **kw):
    srv = pkg.Server(cl, **kw)
    srv.admission.note_warmed(srv.admission.profile_for(_sq("_warm")))
    return srv


def _outcome(pkg, srv, sid, tenant="default", proofs=1):
    """A submit's lane, or the name of its typed rejection."""
    try:
        return srv.submit(_sq(sid, proofs), tenant=tenant).lane
    except (pkg.QueueFull, pkg.QuotaExceeded, pkg.Overloaded) as e:
        return type(e).__name__


def _trace(cl, results):
    return {"executed": [(s, h) for s, h, _ in cl.executed],
            "exec_kwargs": cl.exec_kwargs,
            "finalized": [s for s, _ in cl.finalized],
            "flushed": cl.vns.flushed,
            "results": {k: (v if isinstance(v, str) else type(v).__name__)
                        for k, v in sorted(results.items())}}


# ---------------------------------------------------------------------------
# The same scenarios through both servers
# ---------------------------------------------------------------------------

def _lanes(pkg):
    """A cold shape to the compile lane, a prewarm, then the fast lane;
    a proofs-off survey always fast."""
    cl = _FakeCluster()
    srv = pkg.Server(cl, max_batch=2, pipeline=False)
    lanes = [_outcome(pkg, srv, "s0"), _outcome(pkg, srv, "p0", proofs=0)]
    results = srv.drain()
    lanes.append(srv.admission_of("s0").lane)
    lanes.append(srv.prewarm(_sq("s1")).lane)
    lanes.append(_outcome(pkg, srv, "s1"))
    results.update(srv.drain())
    return lanes, _trace(cl, results), [m for _, m in pkg.calls][:1]


def test_lanes_match_the_reference(both):
    port, refs = both
    mine, theirs = _lanes(port), _lanes(refs)
    assert mine[:2] == theirs[:2]
    assert mine[0] == ["compile", "fast", "fast", "fast", "fast"]
    # each ran one warm-up pass for the cold shape ("lower" first there)
    assert mine[2] == ["execute"] and theirs[2] == ["lower"]


def _groups(pkg):
    out = []
    for max_batch, fail, proofs in ((3, (), 1), (2, (), 1), (3, ("s1",), 1),
                                    (3, (), 0)):
        cl = _FakeCluster()
        cl.fail_encode.update(fail)
        srv = _warm(pkg, cl, max_batch=max_batch, pipeline=False)
        for i in range(3):
            srv.submit(_sq(f"s{i}", proofs))
        out.append(_trace(cl, srv.drain()))
    return out


def test_groups_flushes_and_order_match_the_reference(both):
    port, refs = both
    mine = _groups(port)
    assert mine == _groups(refs)
    assert mine[0]["flushed"] == [["s0", "s1", "s2"]]
    assert mine[1]["flushed"] == [["s0", "s1"]]
    assert mine[2]["flushed"] == [["s0", "s2"]]
    assert mine[3]["flushed"] == []


def _pipeline(pkg, workers):
    cl = _FakeCluster()
    srv = _warm(pkg, cl, max_batch=2, pipeline=True, workers=workers,
                tenant_quota=16)
    for i in range(6):
        srv.submit(_sq(f"s{i}"))
    results = srv.drain()
    names = [t.name for t in srv._workers]
    # encodes on the drain thread; which worker takes a group is
    # scheduling, but always one of the pool's
    threads = ({t for _, _, t in cl.executed},
               {t for _, t in cl.finalized} <= set(names))
    return names, threads, sorted(map(sorted, cl.vns.flushed)), results


def test_worker_pool_matches_the_reference(both):
    port, refs = both
    for w in (1, 3):
        mine = _pipeline(port, w)
        assert mine == _pipeline(refs, w)
    assert mine[0] == ["server-verify", "server-verify-1", "server-verify-2"]
    assert mine[1] == ({"MainThread"}, True)


def _spans(pkg):
    cl = _FakeCluster()
    srv = _warm(pkg, cl, max_batch=2, pipeline=False)
    for i in range(3):
        srv.submit(_sq(f"s{i}"))
    srv.drain()
    return srv.timers


def test_verify_spans_start_at_finalize_as_in_the_reference(both):
    """A held survey's Pipeline.verify span starts at its finalize, after
    the cross flush, in both packages; the port adds the payload wait as
    a span of its own, before the flush."""
    port, refs = both
    mine, theirs = _spans(port), _spans(refs)
    for tm in (mine, theirs):
        (_, _, flushed), = tm.spans("Pipeline.flush.s0+s1")
        for sid in ("s0", "s1"):
            (_, v0, _), = tm.spans(f"Pipeline.verify.{sid}")
            assert v0 >= flushed
    (_, _, waited), = mine.spans("Pipeline.wait.s0+s1")
    (_, f0, _), = mine.spans("Pipeline.flush.s0+s1")
    assert waited <= f0
    names = lambda tm: sorted(n for n, _, _ in tm.spans())
    assert names(mine) == sorted(names(theirs) + ["Pipeline.wait.s0+s1"])


def _rejections(pkg):
    """QueueFull before QuotaExceeded before Overloaded."""
    srv = _warm(pkg, _FakeCluster(), max_depth=4, tenant_quota=2,
                shed_fraction=0.5, pipeline=False)
    plan = [("a0", "a"), ("a1", "a"), ("a2", "a"), ("b0", "b"),
            ("b1", "b"), ("c0", "c"), ("b2", "b"), ("c1", "c"),
            ("d0", "d")]
    got = [(sid, _outcome(pkg, srv, sid, t)) for sid, t in plan]
    srv.drain()
    got.append(("a3", _outcome(pkg, srv, "a3", "a")))
    return got


def test_typed_rejections_and_their_order_match_the_reference(both):
    port, refs = both
    mine = _rejections(port)
    assert mine == _rejections(refs)
    kinds = [k for _, k in mine]
    assert kinds[:3] == ["fast", "fast", "QuotaExceeded"]
    assert "Overloaded" in kinds
    tight = [_warm(p, _FakeCluster(), max_depth=2, tenant_quota=1,
                   pipeline=False) for p in (port, refs)]
    for pkg, srv in zip((port, refs), tight):
        srv.submit(_sq("s0"), tenant="a")
        srv.submit(_sq("s1"), tenant="b")
        # at max_depth QueueFull wins over tenant a's quota
        assert _outcome(pkg, srv, "s2", "a") == "QueueFull"


def _retry_hint(pkg, done_times):
    srv = _warm(pkg, _FakeCluster(), max_depth=8, tenant_quota=8,
                shed_fraction=0.5, pipeline=False)
    srv._done_t.extend(done_times)
    for i in range(4):
        srv.submit(_sq(f"s{i}"))
    with pytest.raises(pkg.Overloaded) as ei:
        srv.submit(_sq("s4"))
    return ei.value.retry_after_s


@pytest.mark.parametrize("done_times", [
    [], [5.0], [0.0, 0.5, 1.0, 1.5], [0.0, 100.0], [0.0, 0.001, 0.002]])
def test_retry_after_hint_matches_the_reference(both, done_times):
    port, refs = both
    mine = _retry_hint(port, done_times)
    assert mine == _retry_hint(refs, done_times)
    assert TP.SHED_RETRY_MIN_S <= mine <= TP.SHED_RETRY_MAX_S


def _drr(pkg):
    cl = _FakeCluster()
    srv = _warm(pkg, cl, max_batch=2, max_depth=32, tenant_quota=16,
                pipeline=False, tenant_weights={"a": 1.0, "b": 2.0,
                                                "c": 0.5})
    order = ([(f"a{i}", "a") for i in range(5)]
             + [(f"b{i}", "b") for i in range(6)]
             + [(f"c{i}", "c") for i in range(4)])
    rng = np.random.default_rng(4)
    for j in rng.permutation(len(order)):
        sid, t = order[j]
        srv.submit(_sq(sid), tenant=t)
    results = srv.drain()
    return _trace(cl, results)


def test_weighted_drr_order_matches_the_reference(both):
    port, refs = both
    mine = _drr(port)
    assert mine == _drr(refs)
    assert len(mine["executed"]) == 15


def _resume(pkg):
    out = []
    cl = _FakeCluster()
    cl.fail_encode.add("s1")
    cl.fail_encode_once.add("s1")
    cl.probe_liveness = lambda: {"dp0": True, "dp1": False}
    srv = _warm(pkg, cl, max_batch=3, pipeline=False)
    for i in range(3):
        srv.submit(_sq(f"s{i}"))
    out.append(_trace(cl, srv.drain()))
    cl = _FakeCluster()
    cl.fail_encode.add("s0")
    srv = _warm(pkg, cl, pipeline=False)
    srv.submit(_sq("s0"))
    out.append(_trace(cl, srv.drain()))
    return out


def test_resume_matches_the_reference(both):
    port, refs = both
    mine = _resume(port)
    assert mine == _resume(refs)
    once, twice = mine
    assert [r for s, _, r in once["exec_kwargs"] if s == "s1"] == [
        None, ("dp0",)]
    assert once["flushed"] == [["s0", "s2"]]
    # one retry, then the error
    assert [s for s, _, _ in twice["exec_kwargs"]] == ["s0"] * (
        1 + TP.RESUME_MAX_RETRIES)
    assert twice["results"] == {"s0": "RuntimeError"}


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------

def test_policy_constants_equal_the_reference(ref):
    names = ("VERIFY_WORKERS", "TENANT_QUOTA", "SHED_FRACTION",
             "SHED_RETRY_MIN_S", "SHED_RETRY_MAX_S", "RATE_WINDOW_EVENTS",
             "REFILL_HORIZON_S", "REFILL_MAX_SLABS_STEP",
             "RESUME_MAX_RETRIES", "CHECKPOINT_MAX_RESUMES",
             "RESUME_BACKOFF_S", "CALL_TIMEOUT_S", "BACKOFF_JITTER",
             "POLL_INTERVAL_S", "SLIDE_PACING_S", "COLD_COMPILE_WAIT_S")
    for n in names:
        assert getattr(TP, n) == getattr(ref.policy, n), n


def test_admission_cold_shape_goes_to_compile_then_warms():
    adm = AdmissionController(_FakeCluster())
    a = adm.triage(_sq("s0"))
    assert a.lane == "compile" and a.missing == (ENTRY,)
    assert (a.profile.u, a.profile.l) == (4, 2)
    adm.note_warmed(a.profile)
    b = adm.triage(_sq("s1"))
    assert b.lane == "fast" and not b.missing
    p = adm.triage(_sq("p0", proofs=0))
    assert (p.lane, p.profile, p.missing) == ("fast", None, ())


def test_admission_warmth_is_keyed_by_entry_name():
    """Shapes that name the same entries share warmth: another digit
    count at the same base is warm, another base is cold by its
    signature tables alone."""
    cl = _FakeCluster()
    cl.device, cl.ensure_range_sigs = "cpu", lambda u: None
    cl._ranges_per_value = lambda q: [q.spec]
    adm = AdmissionController(cl)

    def sq(sid, spec):
        return types.SimpleNamespace(
            survey_id=sid, query=types.SimpleNamespace(proofs=1, spec=spec))

    adm.note_warmed(adm.profile_for(sq("s0", (4, 2))))
    warm = adm.triage(sq("s1", (4, 3)))
    assert warm.lane == "fast" and warm.profile != adm.profile_for(
        sq("s0", (4, 2)))
    cold = adm.triage(sq("s2", (8, 2)))
    assert cold.lane == "compile"
    assert cold.missing == ("table:range_sigs@u8",)


def test_compile_lane_runs_the_warm_up_on_the_drain_thread(monkeypatch):
    calls = []

    def fake(profile, mode="execute", cluster=None, log=None, **k):
        calls.append((profile, mode, cluster,
                      threading.current_thread().name))
        return cc.CompileStats()

    monkeypatch.setattr(cc, "precompile", fake)
    cl = _FakeCluster()
    srv = SurveyServer(cl, max_batch=2, pipeline=True)
    assert srv.submit(_sq("s0")).lane == "compile"
    assert srv.drain() == {"s0": "result-s0"}
    # one pass, mode execute, no cluster binding for a stand-in, on the
    # thread that drained
    assert [(m, c, t) for _, m, c, t in calls] == [
        ("execute", None, "MainThread")]
    assert srv.admission_of("s0").lane == "fast"
    assert srv.timers.spans("Compile.s0")
    assert srv.compile_mode == "execute"


def test_queue_full_frees_after_drain_and_quota_is_per_tenant():
    srv = _warm(types.SimpleNamespace(Server=SurveyServer), _FakeCluster(),
                max_depth=3, tenant_quota=2, pipeline=False,
                shed_fraction=1.0)
    srv.submit(_sq("a0"), tenant="a")
    srv.submit(_sq("a1"), tenant="a")
    with pytest.raises(QuotaExceeded) as ei:
        srv.submit(_sq("a2"), tenant="a")
    assert (ei.value.tenant, ei.value.quota) == ("a", 2)
    srv.submit(_sq("b0"), tenant="b")
    with pytest.raises(QueueFull, match="b1"):
        srv.submit(_sq("b1"), tenant="b")
    srv.drain()
    srv.submit(_sq("a2"), tenant="a")


def test_resume_budget_widens_for_checkpointed_surveys():
    cl = _FakeCluster()
    cl.fail_encode.add("s0")
    cl.checkpoint_for = lambda sid: object() if sid == "s0" else None
    srv = _warm(types.SimpleNamespace(Server=SurveyServer), cl,
                pipeline=False)
    assert srv._resume_budget("s0") == TP.CHECKPOINT_MAX_RESUMES
    assert srv._resume_budget("s1") == TP.RESUME_MAX_RETRIES
    srv.submit(_sq("s0"))
    assert isinstance(srv.drain()["s0"], RuntimeError)
    assert len(cl.exec_kwargs) == 1 + TP.CHECKPOINT_MAX_RESUMES


def test_port_cluster_reprobe_returns_the_live_set():
    """The resume lane re-probes the port's LocalCluster: under a plan
    that kills dp1 `_reprobe()` gives the sorted live DPs, and once the
    survey has a checkpoint (its first dispatch refused) the budget is
    CHECKPOINT_MAX_RESUMES."""
    from drynx_tpu_torch.resilience import faults
    from drynx_tpu_torch.service.service import LocalCluster

    cl = LocalCluster(n_cns=1, n_dps=3, n_vns=0, seed=1, dlog_limit=2,
                      device="cpu")
    plan = faults.FaultPlan(seed=0)
    plan.kill("dp1")
    try:
        srv = SurveyServer(cl, pipeline=False)
        assert srv._reprobe() == ("dp0", "dp1", "dp2")
        assert srv._resume_budget("x") == TP.RESUME_MAX_RETRIES
        faults.set_fault_plan(plan)
        assert srv._reprobe() == ("dp0", "dp2")
        sq = cl.generate_survey_query("sum", query_min=0, query_max=3,
                                      survey_id="x")
        with pytest.raises(RuntimeError, match="only 2/3 DPs responded"):
            cl.execute_survey(sq)
        assert srv._resume_budget("x") == TP.CHECKPOINT_MAX_RESUMES
    finally:
        faults.set_fault_plan(None)
        cl.close()


class _FakeEngine:
    """The StreamEngine surface the advance lane touches."""

    def __init__(self, sid, budget=2):
        self.stream_id, self.proofs_on = sid, True
        self.sq_proto = _sq(f"{sid}-proto")
        self.fed, self.charges, self.budget, self.runs = [], 0, budget, []

    def feed(self, rows):
        self.fed.append(rows)

    def charge_epsilon(self):
        if self.charges >= self.budget:
            from drynx_tpu_torch.pool import EpsilonExhausted

            raise EpsilonExhausted("budget spent")
        self.charges += 1

    def advance(self, precharged=False):
        self.runs.append((precharged, threading.current_thread().name))
        return f"advance-{len(self.runs)}"


def test_advance_lane_runs_first_and_charges_at_submit(monkeypatch):
    monkeypatch.setattr(cc, "precompile", lambda *a, **k: None)
    cl = _FakeCluster()
    srv = _warm(types.SimpleNamespace(Server=SurveyServer), cl,
                pipeline=False)
    eng = srv.open_stream(_FakeEngine("st"))
    assert srv.streams == {"st": eng}
    srv.submit(_sq("s0"))
    t1 = srv.advance_stream("st", {"dp0": [1]})
    t2 = srv.advance_stream("st")
    with pytest.raises(TADM.EpsilonExhausted):
        srv.advance_stream("st")
    assert len(srv._advance) == 2     # the rejection queued nothing
    out = srv.drain()
    assert (out[t1], out[t2], out["s0"]) == ("advance-1", "advance-2",
                                             "result-s0")
    # both advances ran precharged on the drain thread, before the survey
    assert eng.runs == [(True, "MainThread")] * 2
    assert srv.timers.spans("Advance.")[-1][2] <= \
        srv.timers.spans("Pipeline.encode.s0")[0][1]
    assert eng.fed == [{"dp0": [1]}]
    with pytest.raises(KeyError):
        srv.advance_stream("no-such-stream")


def test_refill_lane_deposits_slabs_then_admits_fast(monkeypatch):
    """A noised survey whose pool balance is short of its need waits in
    the refill lane; the drain thread deposits slabs (a torch.Generator
    seeded from secrets each) until the need is covered, then the survey
    runs; refill_overlap reads the spans."""
    from drynx_tpu_torch import pool as pool_mod

    monkeypatch.setattr(cc, "precompile", lambda *a, **k: None)
    monkeypatch.setattr(TADM.AdmissionController, "_pool_digest",
                        lambda self: "digest")
    deposits = []

    class Pool:
        def dro_balance(self, digest):
            return 10 * len(deposits)

    def refill_slab(pool, gen, table):
        assert isinstance(gen, torch.Generator) and table is cl.coll_tbl.table
        deposits.append(threading.current_thread().name)

    monkeypatch.setattr(pool_mod.replenish, "refill_slab", refill_slab)
    cl = _FakeCluster()
    cl.pool = Pool()
    cl.coll_tbl = types.SimpleNamespace(table=torch.zeros(1))
    srv = _warm(types.SimpleNamespace(Server=SurveyServer), cl,
                pipeline=False)
    diffp = types.SimpleNamespace(enabled=lambda: True, noise_list_size=12)
    sq = types.SimpleNamespace(survey_id="n0", query=types.SimpleNamespace(
        proofs=1, diffp=diffp))
    a = srv.submit(sq)
    assert (a.lane, a.dro_need) == ("refill", 2 * 12)
    assert srv.drain() == {"n0": "result-n0"}
    assert deposits == ["MainThread"] * 3 and srv.refill_slabs == 3
    assert srv.admission_of("n0").lane == "fast"
    assert srv.timers.spans("Refill.n0")
    assert TSCH.refill_overlap(srv.timers) == 0.0   # serial: no overlap


def test_transcript_is_deterministic_and_key_sorted():
    def vns():
        def vn(name, bitmap):
            return types.SimpleNamespace(
                name=name, bitmap_for=lambda sid: dict(bitmap),
                stored_proofs=lambda sid: {k: k.encode() for k in bitmap})
        return types.SimpleNamespace(vns=[
            vn("vn0", {"range-dp1": 1, "range-dp0": 1}),
            vn("vn1", {"range-dp0": 0})])

    t = survey_transcript(vns(), "s0")
    lines = t.decode().splitlines()
    assert [ln.split()[1] for ln in lines] == [
        "range-dp0", "range-dp1", "range-dp0"]
    assert transcript_digest(vns(), "s0") == transcript_digest(vns(), "s0")


def test_pipeline_overlap_intersects_cross_survey_spans_only():
    tm = PhaseTimers()
    tm.span("Pipeline.encode.s0", 0.0, 2.0)
    tm.span("Pipeline.verify.s0", 2.0, 5.0)   # same survey: excluded
    tm.span("Pipeline.encode.s1", 4.0, 7.0)   # overlaps s0's verify by 1 s
    tm.span("Pipeline.verify.s1", 7.0, 8.0)
    assert pipeline_overlap(tm) == pytest.approx(1.0)
    assert pipeline_overlap(PhaseTimers()) == 0.0
    assert TSCH.refill_overlap(tm) == 0.0


# ---------------------------------------------------------------------------
# chip_smoke.py's phase-13a surveys on the CPU (slow)
# ---------------------------------------------------------------------------

def _phase13_cluster():
    from drynx_tpu_torch.service.service import LocalCluster

    cl = LocalCluster(n_cns=2, n_dps=2, n_vns=2, seed=13, dlog_limit=4000,
                      device="cpu")
    rng = np.random.default_rng(5)
    for dp in cl.dps.values():
        dp.data = rng.integers(0, 4, size=2)
    return cl


def _phase13_queries(cl):
    return [cl.generate_survey_query("sum", 0, 15, proofs=1, ranges=[r],
                                      survey_id=sid)
            for sid, r in (("s0", (4, 2)), ("s1", (4, 2)), ("s2", (4, 3)))]


@pytest.mark.slow
def test_phase13_surveys_batched_equal_serial():
    runs = []
    for kw in ({"max_batch": 4, "pipeline": True},
               {"max_batch": 1, "pipeline": False}):
        cl = _phase13_cluster()
        try:
            srv = SurveyServer(cl, **kw)
            sqs = _phase13_queries(cl)
            srv.prewarm(sqs[0])
            lanes = [srv.submit(sq).lane for sq in sqs]
            with torch.inference_mode():
                res = srv.drain()
            clear = sum(int(d.data.sum()) for d in cl.dps.values())
            assert all(int(r.result) == clear for r in res.values())
            assert all(set(r.block.data.bitmap.values()) == {1}
                       for r in res.values())
            runs.append((lanes, {s: transcript_digest(cl.vns, s)
                                 for s in res}, cl.vns))
        finally:
            cl.close()
    # on the CPU no kernel entry is driven, so the shapes of s0 and s2
    # name the same warm tables (on the card s2's digits make it cold)
    assert runs[0][0] == ["fast", "fast", "fast"]
    assert runs[0][1] == runs[1][1]
