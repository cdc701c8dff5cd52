"""Held range proofs and the cross-survey flush of the PyTorch port, on the
CPU, against the JAX reference.

`range_proof.verify_cross_survey_payloads_joint` is fed the same payload
bytes as the reference's function (the reference's own payloads of
tests/test_torch_verify.py, two surveys, one with a tampered Zv) and must
give the same verdicts. The verifying node's hold, `range_ready`,
`flush_ranges_cross` and its isolation of a tampered neighbour are the
reference's tests/test_server.py:555-600, run on the port's
`VerifyingNode`; `LocalCluster.finalize_survey` flushes a held survey
that no cross flush took, alone. The two checks on real payloads run the
pairing's plain versions on the CPU (~25 s and ~90 s beside a 16 s
fixture) and are `slow`; chip_smoke.py phase 11 runs the cross flush at
full width on the card.
"""
import inspect

import numpy as np
import pytest
import torch

from drynx_tpu_torch.crypto import elgamal as eg
from drynx_tpu_torch.proofs import range_proof as TRP
from drynx_tpu_torch.proofs import requests as rq
from drynx_tpu_torch.service import service as svc
from drynx_tpu_torch.service.proof_collection import (VerifyCache,
                                                      VerifyingNode)
from test_torch_range_proof import RANGES, U
from test_torch_range_proof import reference  # noqa: F401  (a fixture)
from test_torch_verify import _lean_torch, _tampered  # noqa: F401
from test_torch_verify import payloads  # noqa: F401  (a fixture)


# ---------------------------------------------------------------------------
# The cross-survey check against the reference, on the same bytes
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_cross_survey_verdicts_equal_the_reference(payloads, monkeypatch):
    """Two surveys, the second with one DP's Zv changed: both packages
    accept the first survey whole and reject only the tampered payload; a
    survey whose ranges are unknown is all-False. The port reaches the
    verdicts through one joint check over both surveys, then the
    per-survey joint checks, then each payload of the failing survey."""
    p = payloads
    by_sid = {"s-ok": list(p["bytes"]),
              "s-bad": [p["bytes"][0], _tampered(p["bytes"][1])],
              "s-gone": list(p["bytes"])}
    expected = {"s-ok": RANGES, "s-bad": RANGES, "s-gone": None}
    want = p["JRP"].verify_cross_survey_payloads_joint(
        by_sid, expected, {U: p["pubs"]}, p["ca_tbl"])
    sizes = []
    batch = TRP.verify_range_proofs_batch

    def counted(pb, *a, **k):
        sizes.append(pb.n_values)
        return batch(pb, *a, **k)

    monkeypatch.setattr(TRP, "verify_range_proofs_batch", counted)
    got = TRP.verify_cross_survey_payloads_joint(
        by_sid, expected, {U: p["pubs"]}, p["ca_t"])
    assert got == want == {"s-ok": [True, True], "s-bad": [True, False],
                           "s-gone": [False, False]}
    # 2 surveys x 2 DPs x 2 proved values, then each survey's 4, then the
    # tampered survey's payloads one by one
    assert sizes == [8, 4, 4, 2, 2]


@pytest.mark.slow
def test_cross_survey_accepts_in_one_check_and_rejects_malformed(payloads,
                                                                 monkeypatch):
    """Untampered surveys, as the reference verdicts them: one RLC check
    over every payload; a malformed payload fails alone, before the check;
    a survey whose ranges are unknown is all-False."""
    p = payloads
    by_sid = {"a": list(p["bytes"]),
              "b": [p["bytes"][1], p["bytes"][0][:100]],
              "gone": list(p["bytes"])}
    expected = {"a": RANGES, "b": RANGES, "gone": None}
    want = p["JRP"].verify_cross_survey_payloads_joint(
        by_sid, expected, {U: p["pubs"]}, p["ca_tbl"])
    sizes = []
    batch = TRP.verify_range_proofs_batch
    monkeypatch.setattr(TRP, "verify_range_proofs_batch",
                        lambda pb, *a, **k: sizes.append(pb.n_values)
                        or batch(pb, *a, **k))
    got = TRP.verify_cross_survey_payloads_joint(
        by_sid, expected, {U: p["pubs"]}, p["ca_t"])
    assert got == want == {"a": [True, True], "b": [True, False],
                           "gone": [False, False]}
    assert sizes == [6]


# ---------------------------------------------------------------------------
# The verifying node's hold and cross flush (reference tests/test_server.py)
# ---------------------------------------------------------------------------

def _keys():
    rng = np.random.default_rng(3)
    return eg.keygen(rng), eg.keygen(rng)


def test_cross_flush_isolates_a_tampered_neighbor(tmp_path):
    """Two held surveys flushed in one cross-survey call: the survey with a
    tampered payload gets its BM_FALSE, its batch neighbour stays green; a
    second flush flushes nothing."""
    (sec0, pub0), (sec1, pub1) = _keys()

    def cross(payloads):
        return {sid: [d == b"good" for d in ds]
                for sid, ds in payloads.items()}

    vn = VerifyingNode("vn0", str(tmp_path / "vn0.db"),
                       {"dp0": pub0, "dp1": pub1},
                       verify_fns={"range_cross": cross,
                                   "range_joint":
                                   lambda ds, sid: [d == b"good"
                                                    for d in ds]})
    for sid in ("sv_ok", "sv_bad"):
        vn.register_survey(sid, expected_proofs=2,
                           thresholds={"range": 1.0}, expected_range=2,
                           hold_range=True)
        assert not vn.range_ready(sid)
    deliver = [("sv_ok", "dp0", sec0, b"good"),
               ("sv_ok", "dp1", sec1, b"good"),
               ("sv_bad", "dp0", sec0, b"good"),
               ("sv_bad", "dp1", sec1, b"evil")]
    for sid, dp, sec, data in deliver:
        req = rq.new_proof_request("range", sid, dp, "v0", 0, data, sec)
        # held: buffered, not verified yet
        assert vn.receive_proof(req) == rq.BM_RECVD
    assert vn.range_ready("sv_ok") and vn.range_ready("sv_bad")

    assert sorted(vn.flush_ranges_cross(["sv_ok", "sv_bad"])) == [
        "sv_bad", "sv_ok"]
    assert set(vn.bitmap_for("sv_ok").values()) == {rq.BM_TRUE}
    bad = vn.bitmap_for("sv_bad")
    assert bad["sv_bad/range/dp0/v0"] == rq.BM_TRUE
    assert bad["sv_bad/range/dp1/v0"] == rq.BM_FALSE
    # idempotent: a second flush is a no-op
    assert vn.flush_ranges_cross(["sv_ok", "sv_bad"]) == []
    assert vn.range_ready("sv_ok") and not vn.range_ready("unknown")


def test_cross_flush_failure_and_fallback(tmp_path):
    """A cross check that raises fails every payload of that flush (and is
    not memoized); without a cross function each survey flushes jointly on
    its own; a survey not ready is skipped."""
    (sec0, pub0), (sec1, pub1) = _keys()

    def boom(payloads):
        raise ValueError("a malformed batch")

    calls = []
    vn = VerifyingNode("vn0", str(tmp_path / "vn0.db"),
                       {"dp0": pub0, "dp1": pub1},
                       verify_fns={"range_cross": boom,
                                   "range_joint": lambda ds, sid:
                                   calls.append(sid) or [True] * len(ds)},
                       verify_cache=VerifyCache())
    for sid in ("a", "b", "c"):
        vn.register_survey(sid, 2, {"range": 1.0}, expected_range=2,
                           hold_range=True)
    for sid in ("a", "b"):
        for dp, sec in (("dp0", sec0), ("dp1", sec1)):
            vn.receive_proof(rq.new_proof_request("range", sid, dp, "v0", 0,
                                                  b"x", sec))
    vn.receive_proof(rq.new_proof_request("range", "c", "dp0", "v0", 0,
                                          b"x", sec0))
    assert vn.flush_ranges_cross(["a", "c"]) == ["a"]
    assert set(vn.bitmap_for("a").values()) == {rq.BM_FALSE}
    assert vn.verify_cache.misses == 0
    del vn.verify_fns["range_cross"]
    assert vn.flush_ranges_cross(["b"]) == ["b"]
    assert calls == ["b"] and set(vn.bitmap_for("b").values()) == {
        rq.BM_TRUE}
    assert not vn.range_ready("c") and vn.bitmap_for("c") == {}


def test_finalize_flushes_a_held_survey_alone(tmp_path):
    """A held survey that reaches finalization without a cross flush is
    flushed alone there, through the cross function, and its block
    commits."""
    cluster = svc.LocalCluster(n_cns=1, n_dps=2, n_vns=2, seed=3,
                               device="cpu")
    try:
        flushed = []

        def cross(payloads):
            flushed.append(sorted(payloads))
            return {sid: [True] * len(ds) for sid, ds in payloads.items()}

        for vn in cluster.vns.vns:
            vn.verify_fns = dict(vn.verify_fns, range_cross=cross)
        sq = cluster.generate_survey_query("sum", query_min=0, query_max=9)
        sid = sq.survey_id
        survey = svc.Survey(sq)
        cluster.surveys[sid] = survey
        cluster.vns.register_survey(sid, 2, {"range": 1.0},
                                    expected_range=2, hold_range=True)
        for d in cluster.dp_idents:
            codes = cluster.vns.deliver(rq.new_proof_request(
                "range", sid, d.name, f"range-{d.name}", 0, b"payload",
                d.secret))
            assert codes == [rq.BM_RECVD] * 2
        assert all(vn.range_ready(sid) for vn in cluster.vns.vns)
        pending = svc.PendingSurvey(survey=survey, sq=sq, result=None,
                                    decrypted=None, proofs_on=True,
                                    hold_range=True)
        res = cluster.finalize_survey(pending)
        # both VNs flushed; the second hit the shared cache
        assert flushed == [[sid]]
        assert sorted(set(res.block.data.bitmap.values())) == [rq.BM_TRUE]
        assert len(res.block.data.bitmap) == 4
    finally:
        cluster.close()


def test_held_and_grouped_options_no_longer_refused():
    """No survey option is refused any more: the held, grouped, responder
    and quorum options are the cluster's own arguments."""
    assert not hasattr(svc, "_unported")
    params = inspect.signature(svc.LocalCluster.execute_survey).parameters
    assert {"hold_range", "responders", "tenant"} <= set(params)
    params = inspect.signature(
        svc.LocalCluster.generate_survey_query).parameters
    assert {"group_by", "cutting_factor", "min_dp_quorum",
            "vn_quorum"} <= set(params)
    assert torch.equal(torch.tensor(svc.LocalCluster._ranges_per_value(
        type("Q", (), {"ranges": [(2, 3), (4, 1)], "group_by": [[0, 1]],
                       "n_groups": lambda self: 2})())),
        torch.tensor([(2, 3), (4, 1), (2, 3), (4, 1)]))
