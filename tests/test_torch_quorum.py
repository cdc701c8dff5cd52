"""Quorum-degraded surveys, liveness probes, checkpoints and resumes of the
port's LocalCluster against the reference's, on the CPU.

Both packages run under the same fault plan (`resilience.faults`, process
global in each: an autouse fixture clears both before and after every
test) on clusters of the same seed: a dispatch below `min_dp_quorum`
raises the reference's RuntimeError and leaves the same checkpoint, a
re-entry counts the same resume, `probe_liveness` gives the same map and
caches it per plan object for `PROBE_TTL_S`, the VN group's `vn_quorum`
commits the same bitmap from the VNs a plan leaves reachable (and with
the quorum at 1 names the same straggler), `adjust_expected` fires the
range flush as the reference's does (tests/test_resilience.py:611), and a
held survey flushes over a responder set. The port's proofs-off surveys
run on the CPU at a small size: one over the responders of a killed DP,
whose checkpoint (each phase entered once, no resume:
tests/test_service_vn.py:34) either package's store reads back after a
reopen, and the resume of tests/test_server.py:454 through the port's
server. Under `-m slow` the same surveys run through the reference's
LocalCluster and SurveyServer too (its jitted survey programs take about
a minute to compile on the CPU), and a proofs-on survey with a killed DP
and a killed VN gives the same block in both packages.

The reference's service module imports drynx_tpu/crypto/pallas_ops.py,
which does not import under this jax: the module-scoped `reference`
fixture installs the `jax.enable_x64` stand-in of
tests/test_torch_survey.py while this module runs, and at teardown
restores it and forgets every reference module imported under it.
"""
import contextlib
import dataclasses
import functools
import importlib.util
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from drynx_tpu.proofs import requests as JRQ
from drynx_tpu.resilience import faults as JF
from drynx_tpu.service import proof_collection as JPC
from drynx_tpu.service import store as JSTORE
from drynx_tpu_torch.proofs import requests as TRQ
from drynx_tpu_torch.resilience import faults as TF
from drynx_tpu_torch.resilience import policy as TP
from drynx_tpu_torch.server import SurveyServer
from drynx_tpu_torch.service import proof_collection as TPC
from drynx_tpu_torch.service import service as TSV
from drynx_tpu_torch.service import store as TSTORE

ROOT = Path(__file__).resolve().parents[1]
SEED, N_DPS, DLOG = 23, 3, 200


@contextlib.contextmanager
def _x64(flag=True):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", bool(flag))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions are thousands of small tensor ops: beside JAX's
    CPU threads in this process, torch's thread pool only contends (as in
    tests/test_torch_verify.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    JF.set_fault_plan(None)
    TF.set_fault_plan(None)
    yield
    JF.set_fault_plan(None)
    TF.set_fault_plan(None)


@pytest.fixture(scope="module")
def reference():
    """The reference's service and server modules, importable on this jax
    while this module's tests run (see the module docstring)."""
    saved = jax.enable_x64
    before = set(sys.modules)
    jax.enable_x64 = _x64
    try:
        from drynx_tpu.resilience import policy
        from drynx_tpu.server import scheduler
        from drynx_tpu.service import service

        assert service.faults is JF
        yield types.SimpleNamespace(service=service, scheduler=scheduler,
                                    policy=policy)
    finally:
        jax.enable_x64 = saved
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name.startswith("drynx_tpu."):
                parent, _, attr = name.rpartition(".")
                sys.modules.pop(name)
                if hasattr(sys.modules.get(parent), attr):
                    delattr(sys.modules[parent], attr)


def _data(cluster, rows=3):
    rng = np.random.default_rng(9)
    for dp in cluster.dps.values():
        dp.data = rng.integers(0, 5, size=(rows,)).astype(np.int64)
    return {n: int(dp.data.sum()) for n, dp in cluster.dps.items()}


def _clusters(reference, n_dps=N_DPS):
    """(reference's, port's) proofs-off clusters of one seed and data."""
    ref = reference.service.LocalCluster(n_cns=1, n_dps=n_dps, n_vns=0,
                                         seed=SEED, dlog_limit=DLOG)
    port = TSV.LocalCluster(n_cns=1, n_dps=n_dps, n_vns=0, seed=SEED,
                            dlog_limit=DLOG, device="cpu")
    _data(ref)
    _data(port)
    return ref, port


@pytest.fixture(scope="module")
def clusters(reference):
    ref, port = _clusters(reference)
    yield ref, port
    port.close()


def _plan(mod, kills=(), specs=()):
    plan = mod.FaultPlan(seed=0, specs=[mod.FaultSpec(**s) for s in specs])
    for name in kills:
        plan.kill(name)
    return plan


def _sq(cluster, sid, **kw):
    return cluster.generate_survey_query("sum", query_min=0, query_max=9,
                                         proofs=0, survey_id=sid, **kw)


# ---------------------------------------------------------------------------
# the dispatch: quorum refusals, checkpoints, resumes, probes
# ---------------------------------------------------------------------------

REFUSALS = {
    "two killed": ({"kills": ("dp1", "dp2")}, {"min_dp_quorum": 2}, None),
    "one killed, all needed": ({"kills": ("dp0",)}, {}, None),
    "dropped request": ({"specs": [{"where": "request", "kind": "drop",
                                    "target": "dp1",
                                    "mtype": "survey_query"}]}, {}, None),
    "restricted": ({}, {"min_dp_quorum": 2}, ["dp0"]),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_quorum_refusal_and_checkpoint_equal_the_reference(reference,
                                                           clusters, case):
    plan_kw, q_kw, responders = REFUSALS[case]
    out = []
    for mod, cl in zip((JF, TF), clusters):
        sid = f"refused-{case.replace(' ', '-')}"
        mod.set_fault_plan(_plan(mod, **plan_kw) if plan_kw else None)
        msgs = []
        for _ in range(2):       # the second entry of the same id resumes
            with pytest.raises(RuntimeError) as ei:
                cl.execute_survey(_sq(cl, sid, **q_kw),
                                  responders=responders)
            msgs.append(str(ei.value))
        out.append((msgs, dataclasses.asdict(cl.checkpoint_for(sid))))
    assert out[1] == out[0]
    msgs, ck = out[1]
    assert "DPs responded (quorum" in msgs[0]
    assert (ck["resumes"], ck["phase_entries"]) == (1, {"probe": 2})


def test_generate_survey_query_carries_the_quorums(reference, clusters):
    for kw in ({"min_dp_quorum": 2, "vn_quorum": 0.5}, {}):
        qs = [_sq(cl, "q", **kw) for cl in clusters]
        assert [(q.min_dp_quorum, q.vn_quorum) for q in qs] == \
            [(kw.get("min_dp_quorum", 0), kw.get("vn_quorum", 1.0))] * 2
    for kw in ({"min_dp_quorum": N_DPS + 1}, {"vn_quorum": 0.0}):
        msgs = []
        for cl in clusters:
            with pytest.raises(ValueError) as ei:
                _sq(cl, "q", **kw)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_probe_liveness_equals_the_reference_and_caches_per_plan(
        reference, clusters, monkeypatch):
    ref, port = clusters
    maps = {"ref": [], "port": []}

    def probe(key, cl, mod, plan):
        mod.set_fault_plan(plan)
        maps[key].append(cl.probe_liveness())

    for key, cl, mod in (("ref", ref, JF), ("port", port, TF)):
        cl._probe_cache = None
        probe(key, cl, mod, None)
        plan = _plan(mod, kills=("dp1",))
        probe(key, cl, mod, plan)
        plan.revive("dp1")
        probe(key, cl, mod, plan)                  # cached: the same plan
        probe(key, cl, mod, _plan(mod))            # another plan: probed
        probe(key, cl, mod, _plan(mod, specs=[{
            "where": "request", "kind": "drop", "target": "dp2",
            "mtype": "ping"}]))
    assert maps["port"] == maps["ref"]
    everyone = {f"dp{i}": True for i in range(N_DPS)}
    assert maps["port"][:4] == [everyone, {**everyone, "dp1": False},
                                {**everyone, "dp1": False}, everyone]
    assert maps["port"][4] == {**everyone, "dp2": False}
    # past the verdicts' lifetime the same plan is probed again
    monkeypatch.setenv("DRYNX_PROBE_TTL", "0")
    monkeypatch.setattr(TP, "PROBE_TTL_S", 0.0)
    for cl, mod in ((ref, JF), (port, TF)):
        plan = _plan(mod, kills=("dp0",))
        mod.set_fault_plan(plan)
        assert not cl.probe_liveness()["dp0"]
        plan.revive("dp0")
        assert cl.probe_liveness() == everyone


@pytest.fixture(scope="module")
def degraded(tmp_path_factory):
    """A proofs-off sum on the port's cluster with dp2 killed and
    min_dp_quorum 2, its checkpoints in a durable store."""
    path = str(tmp_path_factory.mktemp("ckpt") / "ckpt.db")
    cl = TSV.LocalCluster(n_cns=1, n_dps=N_DPS, n_vns=0, seed=SEED,
                          dlog_limit=DLOG, device="cpu")
    sums = _data(cl)
    cl.attach_checkpoint_store(path)
    TF.set_fault_plan(_plan(TF, kills=("dp2",)))
    try:
        res = cl.run_survey(_sq(cl, "degraded", min_dp_quorum=2))
    finally:
        TF.set_fault_plan(None)
        cl.close()
    return res, sums, path


def test_degraded_survey_runs_over_the_responders(degraded):
    res, sums, _ = degraded
    assert (res.responders, res.absent) == (["dp0", "dp1"], ["dp2"])
    assert res.result == sums["dp0"] + sums["dp1"]
    assert res.decrypted.found.all()


def test_checkpoint_of_a_run_is_durable(reference, degraded):
    """tests/test_service_vn.py:34 on a survey: a run without a resume
    enters each phase once, and a reopened store (the port's or the
    reference's, one file layout) reads the same record back."""
    res, _, path = degraded
    assert res.resumes == 0 and set(res.phases.values()) == {1}
    assert list(res.phases) == ["probe", "collect", "aggregate",
                                "keyswitch", "decrypt", "done"]
    again = TSV.LocalCluster(n_cns=1, n_dps=N_DPS, n_vns=0, seed=SEED,
                             dlog_limit=DLOG, device="cpu")
    again.attach_checkpoint_store(path)
    ck = again.checkpoint_for("degraded")
    missing = again.checkpoint_for("missing")
    again.close()
    assert ck is not None and missing is None
    assert (ck.done, ck.phase, ck.responders, ck.absent, ck.resumes,
            ck.phase_entries) == (True, "done", ["dp0", "dp1"], ["dp2"], 0,
                                  res.phases)
    ref_ck = reference.service.SurveyCheckpoint.load(JSTORE.ProofDB(path),
                                                     "degraded")
    assert dataclasses.asdict(ref_ck) == dataclasses.asdict(ck)
    # without a store nothing is read back
    assert TSTORE.SurveyCheckpoint.load(None, "degraded") is None


def _resume_cluster(mod_cluster):
    cl = mod_cluster(n_cns=1, n_dps=2, n_vns=0, seed=SEED, dlog_limit=1000)
    rng = np.random.default_rng(9)
    for dp in cl.dps.values():
        dp.data = rng.integers(0, 5, size=(3,)).astype(np.int64)
    return cl


def _resumed(server_cls, cl, faults_mod, sid="r1"):
    """tests/test_server.py:454: a one-shot refused connect to dp1 fails
    the first dispatch's quorum; the resume lane re-probes and re-enters."""
    plan = _plan(faults_mod, specs=[{"where": "connect", "kind": "refuse",
                                     "target": "dp1", "count": 1}])
    faults_mod.set_fault_plan(plan)
    try:
        srv = server_cls(cl, pipeline=False)
        srv.submit(_sq(cl, sid))
        return srv.drain()[sid], plan
    finally:
        faults_mod.set_fault_plan(None)


def test_resume_through_the_server_reprobes_and_reenters():
    cl = _resume_cluster(lambda **kw: TSV.LocalCluster(device="cpu", **kw))
    clear = sum(int(dp.data.sum()) for dp in cl.dps.values())
    res, plan = _resumed(SurveyServer, cl, TF)
    cl.close()
    assert not isinstance(res, Exception), res
    assert res.result == clear and plan.specs[0].fired == 1
    assert (res.responders, res.absent) == (["dp0", "dp1"], [])
    assert res.resumes == 1 and res.phases["probe"] == 2
    assert set(v for k, v in res.phases.items() if k != "probe") == {1}


# ---------------------------------------------------------------------------
# the VN side: vn_quorum, adjust_expected, held flushes over responders
# ---------------------------------------------------------------------------

def _vn_group(mod, tmp_path, tag, verify_fns):
    secrets, pubs = _keys()
    vns = [mod.VerifyingNode(f"vn{i}", str(tmp_path / f"{tag}{i}.db"), pubs,
                             verify_fns=verify_fns, seed=i)
           for i in range(3)]
    return mod.VNGroup(vns), secrets


@functools.lru_cache(maxsize=None)
def _keys():
    """The senders' keys: ({name: secret}, {name: public})."""
    from drynx_tpu_torch.crypto import elgamal as TE

    rng = np.random.default_rng(105)
    secrets, pubs = {}, {}
    for name in ("cn0", "dp0", "dp1", "dp2"):
        secrets[name], pubs[name] = TE.keygen(rng)
    return secrets, pubs


def test_vn_quorum_block_equals_the_reference(tmp_path):
    out = []
    for mod, rq, faults, tag in ((JPC, JRQ, JF, "j"), (TPC, TRQ, TF, "t")):
        group, secrets = _vn_group(mod, tmp_path, tag,
                                   {"aggregation": lambda d, s: d == b"ok"})
        group.register_survey("sv", 2, {"aggregation": 1.0})
        faults.set_fault_plan(_plan(faults, kills=("vn2",)))
        codes = [group.deliver(rq.new_proof_request(
            "aggregation", "sv", "cn0", f"g{i}", 0, data, secrets["cn0"]))
            for i, data in enumerate((b"ok", b"bad"))]
        t0 = time.monotonic()
        with pytest.raises(TimeoutError) as ei:
            group.end_verification("sv", timeout=0.3, quorum=1.0)
        strict_s = time.monotonic() - t0
        block = group.end_verification("sv", timeout=5.0, quorum=2 / 3)
        out.append((codes, str(ei.value), dict(block.data.bitmap),
                    group.root.local_bitmaps["sv"]))
        if mod is TPC:
            # the port knows vn2 missed a delivery: no wait for it
            assert strict_s < 0.25
    assert out[1] == out[0]
    codes, msg, bitmap, _ = out[1]
    assert codes == [[TRQ.BM_TRUE, TRQ.BM_TRUE, None],
                     [TRQ.BM_FALSE, TRQ.BM_FALSE, None]]
    assert msg == "VN vn2: proofs incomplete for 'sv'"
    assert sorted({k.split(":")[0] for k in bitmap}) == ["vn0", "vn1"]


def test_adjust_expected_retriggers_the_range_flush(tmp_path):
    """tests/test_resilience.py:611 through both packages: the buffered
    payloads flush as soon as the counters shrink to the responders."""
    out = []
    for mod, rq, tag in ((JPC, JRQ, "j"), (TPC, TRQ, "t")):
        flushes = []

        def joint(datas, sid, _f=flushes):
            _f.append(len(datas))
            return [True] * len(datas)

        group, secrets = _vn_group(mod, tmp_path, tag,
                                   {"range_joint": joint})
        vn = group.root
        vn.register_survey("sv-adj", 3, {"range": 1.0}, expected_range=3)
        codes = [vn.receive_proof(rq.new_proof_request(
            "range", "sv-adj", f"dp{i}", f"dp{i}", 0, b"payload-%d" % i,
            secrets[f"dp{i}"])) for i in range(2)]
        st = vn.surveys["sv-adj"]
        before = (list(flushes), st.done.is_set())
        vn.adjust_expected("sv-adj", 1, expected_range=2)
        out.append((codes, before, list(flushes), st.done.is_set(),
                    dict(st.bitmap), st.expected, st.expected_range))
        with pytest.raises(KeyError):
            vn.adjust_expected("no-such-survey", 1)
    assert out[1] == out[0]
    assert out[1][:4] == ([TRQ.BM_RECVD] * 2, ([], False), [2], True)


def test_held_flush_over_a_responder_set(tmp_path):
    """A held survey registered for two of three DPs: its two payloads
    make it ready, one cross flush checks them, and the VN is done."""
    out = []
    for mod, rq, tag in ((JPC, JRQ, "j"), (TPC, TRQ, "t")):
        calls = []

        def cross(payloads_by_sid, _c=calls):
            _c.append({s: len(p) for s, p in payloads_by_sid.items()})
            return {s: [True] * len(p) for s, p in payloads_by_sid.items()}

        group, secrets = _vn_group(
            mod, tmp_path, tag,
            {"range_joint": lambda d, s: [True] * len(d),
             "range_cross": cross})
        vn = group.root
        vn.register_survey("held", 2, {"range": 1.0}, expected_range=2,
                           hold_range=True)
        codes = [vn.receive_proof(rq.new_proof_request(
            "range", "held", f"dp{i}", f"dp{i}", 0, b"p%d" % i,
            secrets[f"dp{i}"])) for i in range(2)]
        flushed = vn.flush_ranges_cross(["held"])
        out.append((codes, flushed, calls, vn.surveys["held"].done.is_set(),
                    dict(vn.surveys["held"].bitmap)))
    assert out[1] == out[0]
    assert out[1][1:4] == (["held"], [{"held": 2}], True)


# ---------------------------------------------------------------------------
# chip_smoke.py's helpers
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smokes_plan_helper_clears_the_plan_when_its_body_fails():
    cs = _chip_smoke()
    plan = TF.FaultPlan(seed=0)
    plan.kill("dp9")
    with pytest.raises(ZeroDivisionError):
        with cs.fault_plan_installed(plan) as p:
            assert TF.fault_plan() is p is plan
            _ = 1 / 0
    assert TF.fault_plan() is None and JF.fault_plan() is None


def test_chip_smokes_shared_plain_run_gives_each_call_its_rows():
    from drynx_tpu_torch.crypto import cuda_pairing as TCP
    from drynx_tpu_torch.crypto import field as F
    from drynx_tpu_torch.crypto import params

    cs = _chip_smoke()
    rng = np.random.default_rng(4)
    xs = [F.from_int([int.from_bytes(rng.bytes(40), "little") % params.P
                      for _ in range(n)]) for n in (3, 1, 5)]
    runs = []

    def plain(x):
        runs.append(len(x))
        return TCP.fp_inv_plain(x)

    part = cs.shared_plain(plain, lambda: [(x,) for x in xs])
    for i, x in enumerate(xs):
        assert torch.equal(part(i)().long(), TCP.fp_inv_plain(x).long())
    assert runs == [9]


# ---------------------------------------------------------------------------
# slow: the same surveys through the reference's cluster and server
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_degraded_and_clean_surveys_equal_the_reference(reference):
    ref, port = _clusters(reference)
    out = []
    for mod, cl in ((JF, ref), (TF, port)):
        rows = []
        for sid, kills, kw in (("clean", (), {}),
                               ("degraded", ("dp2",), {"min_dp_quorum": 2})):
            mod.set_fault_plan(_plan(mod, kills=kills) if kills else None)
            res = cl.run_survey(_sq(cl, sid, **kw))
            rows.append((int(res.result), res.responders, res.absent,
                         res.resumes, res.phases,
                         np.asarray(res.decrypted.values).tolist()))
        mod.set_fault_plan(None)
        out.append(rows)
    port.close()
    assert out[1] == out[0]


@pytest.mark.slow
def test_resume_through_both_servers_equals_the_clean_run(reference):
    R = reference.service
    results = []
    for server_cls, cluster_cls, mod in (
            (reference.scheduler.SurveyServer, R.LocalCluster, JF),
            (SurveyServer,
             lambda **kw: TSV.LocalCluster(device="cpu", **kw), TF)):
        clean = _resume_cluster(cluster_cls)
        srv = server_cls(clean, pipeline=False)
        srv.submit(_sq(clean, "r0"))
        baseline = srv.drain()["r0"]
        res, _ = _resumed(server_cls, _resume_cluster(cluster_cls), mod)
        assert not isinstance(res, Exception), res
        results.append((int(baseline.result), int(res.result),
                        res.responders, res.absent, res.resumes,
                        res.phases))
    assert results[1] == results[0]
    assert results[1][0] == results[1][1]


@pytest.mark.slow
def test_proofs_on_degraded_survey_equals_the_reference(reference):
    """1 CN, 3 DPs, 3 VNs, ranges (4, 2): dp2 and vn2 killed, quorums 2
    and 2/3; the same result, responders and block in both packages."""
    out = []
    for mod, mk in ((JF, reference.service.LocalCluster),
                    (TF, lambda **kw: TSV.LocalCluster(device="cpu", **kw))):
        cl = mk(n_cns=1, n_dps=3, n_vns=3, seed=5, dlog_limit=DLOG)
        rng = np.random.default_rng(9)
        for dp in cl.dps.values():
            dp.data = rng.integers(0, 4, size=(4,)).astype(np.int64)
        mod.set_fault_plan(_plan(mod, kills=("dp2", "vn2")))
        sq = cl.generate_survey_query(
            "sum", query_min=0, query_max=3, proofs=1, ranges=[(4, 2)],
            survey_id="pq", min_dp_quorum=2, vn_quorum=2 / 3)
        res = cl.run_survey(sq, seed=1)
        mod.set_fault_plan(None)
        out.append((int(res.result), res.responders, res.absent,
                    sorted(res.block.data.bitmap.items()), res.phases))
        if mk is not reference.service.LocalCluster:
            cl.close()
    assert out[1] == out[0]
    assert {k.split(":")[0] for k, _ in out[1][3]} == {"vn0", "vn1"}
    assert {v for _, v in out[1][3]} == {TRQ.BM_TRUE}
