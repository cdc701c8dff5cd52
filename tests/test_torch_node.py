"""The port's TCP nodes (`drynx_tpu_torch/service/node.py`) on the CPU.

In-process `DrynxNode`s on real sockets, `device="cpu"` (the plain kernel
versions), at small sizes, against the reference's tests of the same
paths (tests/test_transport.py, tests/test_topology.py,
tests/test_resilience.py): the tree overlay and the star fan-out fold the
DPs' cached ciphertexts to the same canonical bytes with fewer bytes at
the root; a dead relay at depth costs only its own contribution, the same
way twice; a DP's re-entry replays its first bytes and fires its proof
once; the root refuses a survey short of its DP quorum; missing proofs
keep a block from committing; probe_liveness and broadcast_roster skip a
dead entry; `LocalCluster(share_verify_cache=False)` verifies every
delivery. Whole surveys (a plain ladder takes ~3 s on the CPU, and a
survey runs one a CN and one to decrypt) are under `slow`: the sum, the
group-by and log_reg equal to the clear answers, a survey over the
responders of a killed DP, `LocalCluster(link=...)`'s delay, and a
proofs-on survey whose kernel calls are chip_smoke.py's phase-15a
formula.
"""
import importlib.util
import pathlib
import socket
import threading

import numpy as np
import pytest
import torch

from drynx_tpu_torch.crypto import curve as C
from drynx_tpu_torch.crypto import elgamal as eg
from drynx_tpu_torch.crypto import refimpl
from drynx_tpu_torch.proofs import requests as rq
from drynx_tpu_torch.resilience import faults as TF
from drynx_tpu_torch.resilience import policy as TP
from drynx_tpu_torch.service import topology as topo
from drynx_tpu_torch.service import transport as TT
from drynx_tpu_torch.service.node import (DrynxNode, RemoteClient, Roster,
                                          RosterEntry, call_entry)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FAST = TP.RetryPolicy(connect_retries=1, backoff_s=0.02, backoff_cap_s=0.05,
                      jitter=0.0, call_timeout_s=TP.CALL_TIMEOUT_S, seed=0)


@pytest.fixture(autouse=True)
def _clean_process_globals():
    TF.set_fault_plan(None)
    TT.set_conn_pool(None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    TF.set_fault_plan(None)
    TT.set_conn_pool(None)


def _boot(tmp, roles, rng, data_of=None, policy=FAST):
    """DrynxNodes named <role><i> (per-role counters) on the CPU; DPs hold
    `data_of(rng)` (default: 8 integers in [0, 10))."""
    nodes, entries, datas, secrets_of = [], [], {}, {}
    counts = {}
    for role in roles:
        i = counts.get(role, 0)
        counts[role] = i + 1
        name = f"{role}{i}"
        x, pub = eg.keygen(rng)
        secrets_of[name] = x
        data = None
        if role == "dp":
            data = (data_of(rng) if data_of else
                    rng.integers(0, 10, size=(8,)).astype(np.int64))
            datas[name] = data
        n = DrynxNode(name, x, pub, data=data,
                      db_path=str(tmp / f"{name}.db"), policy=policy,
                      device="cpu")
        n.start()
        entries.append(RosterEntry(name=name, role=role, host=n.address[0],
                                   port=n.address[1], public=pub))
        nodes.append(n)
    return nodes, entries, datas, secrets_of


def _stop(nodes):
    for n in nodes:
        n.stop()


@pytest.fixture(scope="module")
def roster3(tmp_path_factory):
    """One CN and three DPs; the tree's fanout is set to 2 by the tests
    (roots dp0 and dp1; dp0 relays dp2)."""
    rng = np.random.default_rng(41)
    nodes, entries, datas, secrets_of = _boot(
        tmp_path_factory.mktemp("r3"), ["cn"] + ["dp"] * 3, rng)
    client = RemoteClient(Roster(entries), rng, policy=FAST, device="cpu")
    assert client.broadcast_roster() == {e.name: True for e in entries}
    yield nodes, entries, datas, secrets_of["cn0"]
    _stop(nodes)


def _frame(sid):
    return {"type": "survey_dp", "op": "sum", "survey_id": sid,
            "query_min": 0, "query_max": 9, "lr_params": None,
            "group_by": None, "range_offset": 0, "proofs": False,
            "ranges": [], "range_sigs": {}}


def _cached_fold(nodes, sid, names):
    """The canonical fold of the named DPs' cached contributions."""
    cts = [n._dp_replies[sid]["cts"] for n in nodes if n.name in names]
    return topo.fold_cts(torch.stack(cts))


def _decrypts_to(fold, secret, value):
    """The (1, 2, 3, 16) fold of a sum under the lone CN's key decrypts to
    `value`: C - x*K = value*G, on the pure-Python curve (a plain ladder
    on the CPU would cost seconds)."""
    K, Cc = (C.to_ref(fold[0, i]) for i in range(2))
    M = refimpl.g1_add(Cc, refimpl.g1_neg(refimpl.g1_mul(K, secret)))
    return M == refimpl.g1_mul(refimpl.G1, value)


def test_tree_and_star_fold_to_the_same_bytes_fewer_at_the_root(
        roster3, monkeypatch):
    """tests/test_topology.py:201: the tree and the star agree on the
    responders and the aggregate, while the tree root hears less."""
    nodes, entries, datas, secret = roster3
    monkeypatch.setenv(topo.ENV_FANOUT, "2")
    root, dps = nodes[0], [e for e in entries if e.role == "dp"]
    link = TT.LinkModel()
    TT.set_link_model(link)
    TT.set_current_node(root.name)
    try:
        tree = root._dispatch_tree(dps, _frame("tv"), False)
        rx_tree = link.stats()["rx_by_node"][root.name]
        link.reset_stats()
        star = root._dispatch_star(dps, _frame("tv"))
        rx_star = link.stats()["rx_by_node"][root.name]
    finally:
        TT.set_current_node("")
        TT.set_link_model(None)
    names = [e.name for e in dps]
    assert tree[1] == star[1] == names and tree[2] == star[2] == []
    assert len(tree[0]) == 2 and len(star[0]) == 3
    want = _cached_fold(nodes, "tv", names)
    for partials in (tree[0], star[0]):
        assert torch.equal(topo.fold_cts(torch.stack(partials)), want)
    assert _decrypts_to(want, secret,
                        int(sum(d.sum() for d in datas.values())))
    assert 0 < rx_tree < rx_star


def test_a_dead_relay_degrades_only_its_own_contribution(roster3,
                                                         monkeypatch):
    """tests/test_topology.py:233: dp0 relays dp2; killed, it alone is
    absent (its child is dispatched as a subtree root), the same way on a
    second dispatch."""
    nodes, entries, datas, secret = roster3
    monkeypatch.setenv(topo.ENV_FANOUT, "2")
    root, dps = nodes[0], [e for e in entries if e.role == "dp"]
    plan = TF.FaultPlan(seed=5)
    plan.kill("dp0")
    TF.set_fault_plan(plan)
    outcomes = []
    for _ in range(2):
        # the second dispatch of the survey replays the DPs' contributions
        partials, responders, failed, _ = root._dispatch_tree(
            dps, _frame("kill"), False)
        live = [e.name for e in dps if e.name != "dp0"]
        assert failed == ["dp0"] and responders == live
        fold = topo.fold_cts(torch.stack(partials))
        assert torch.equal(fold, _cached_fold(nodes, "kill", live))
        assert _decrypts_to(fold, secret,
                            int(sum(datas[n].sum() for n in live)))
        outcomes.append((responders, failed, len(partials), fold))
    assert outcomes[0][:3] == outcomes[1][:3]
    assert torch.equal(outcomes[0][3], outcomes[1][3])


def test_the_root_refuses_a_survey_short_of_its_quorum(roster3):
    """tests/test_resilience.py:349's strict half: a killed DP and the
    default quorum (every DP) refuse the survey with the reference's text,
    after the healing passes, before any key switch."""
    nodes, entries, _, _ = roster3
    plan = TF.FaultPlan(seed=1)
    plan.kill("dp1")
    TF.set_fault_plan(plan)
    client = RemoteClient(Roster(entries), np.random.default_rng(3),
                          policy=FAST, device="cpu")
    # the survey id of the tree test: its DPs replay, not re-encrypt
    with pytest.raises(TT.RemoteError, match="only 2/3 DPs responded"):
        client.run_survey("sum", query_min=0, query_max=9,
                          survey_id="tv")
    ck = nodes[0]._ckpts["tv"]
    assert ck.responders == ["dp0", "dp2"]
    assert "keyswitch" not in ck.phase_entries and not ck.done


def _dp_node(tmp_path):
    rng = np.random.default_rng(17)
    x, pub = eg.keygen(rng)
    _, cn_pub = eg.keygen(rng)
    node = DrynxNode("dp0", x, pub, data=np.arange(8, dtype=np.int64),
                     db_path=str(tmp_path / "dp0.db"), device="cpu")
    node.roster = Roster([
        RosterEntry(name="cn0", role="cn", host="127.0.0.1", port=0,
                    public=cn_pub),
        RosterEntry(name="dp0", role="dp", host="127.0.0.1", port=0,
                    public=pub)])
    return node


def test_survey_dp_reentry_replays_identical_bytes(tmp_path):
    """tests/test_topology.py:337."""
    node = _dp_node(tmp_path)
    computed, fired = [], []
    real = node._dp_contribution
    node._dp_contribution = lambda m: (computed.append(1), real(m))[1]
    node._fire_proof_request_async = lambda req: fired.append(req)
    msg = {"type": "survey_dp", "op": "sum", "survey_id": "dup-1",
           "query_min": 0, "query_max": 9, "proofs": False}
    r1 = node._h_survey_dp(dict(msg))
    r2 = node._h_survey_dp(dict(msg))
    assert TT.unpack_array(r1["cts"]).tobytes() == \
        TT.unpack_array(r2["cts"]).tobytes()
    assert TT.unpack_array(r1["cts"]).dtype == np.uint32
    assert len(computed) == 1 and not fired
    node.server.server.server_close()


def test_survey_dp_reentry_fires_proof_once_and_prunes(tmp_path):
    """tests/test_topology.py:356."""
    node = _dp_node(tmp_path)
    cts = torch.zeros((1, 2, 3, 16), dtype=torch.int32)
    node._dp_contribution = lambda m: (cts, object())
    fired = []
    node._fire_proof_request_async = lambda req: fired.append(req)
    msg = {"type": "survey_dp", "op": "sum", "survey_id": "dup-2",
           "query_min": 0, "query_max": 9, "proofs": True}
    for _ in range(3):
        node._h_survey_dp(dict(msg))
    assert len(fired) == 1
    node._dp_replies.clear()
    fired.clear()
    ts = [threading.Thread(target=lambda: node._h_survey_dp(
        {**msg, "survey_id": "dup-3"})) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(fired) == 1
    for i in range(2 * TP.DP_REPLY_CACHE_MAX):
        node._h_survey_dp({**msg, "proofs": False, "survey_id": f"m-{i}"})
    assert len(node._dp_replies) <= TP.DP_REPLY_CACHE_MAX
    node.server.server.server_close()


def test_missing_proofs_keep_the_block_from_committing(tmp_path):
    """tests/test_transport.py:166."""
    rng = np.random.default_rng(44)
    nodes, entries, _, _ = _boot(tmp_path, ["vn"], rng)
    try:
        RemoteClient(Roster(entries), rng, device="cpu").broadcast_roster()
        call_entry(entries[0], {"type": "vn_register", "survey_id": "svx",
                                "expected": 3, "proofs": False})
        with pytest.raises(RuntimeError, match="proofs received"):
            call_entry(entries[0], {"type": "end_verification",
                                    "survey_id": "svx", "timeout": 0.3})
        with pytest.raises(TT.RemoteError, match="not a VN"):
            nodes[0].vn = None
            call_entry(entries[0], {"type": "vn_bitmap",
                                    "survey_id": "svx"})
    finally:
        _stop(nodes)


def test_end_verification_vn_quorum(tmp_path):
    """tests/test_resilience.py:600: three VNs expect one proof each and
    two receive it; the strict block is refused, a 2/3 quorum commits and
    names the straggler."""
    rng = np.random.default_rng(105)
    nodes, entries, _, secrets_of = _boot(tmp_path,
                                          ["cn", "vn", "vn", "vn"], rng)
    try:
        RemoteClient(Roster(entries), rng, policy=FAST,
                     device="cpu").broadcast_roster()
        vns = [e for e in entries if e.role == "vn"]
        for e in vns:
            call_entry(e, {"type": "vn_register", "survey_id": "sv-vnq",
                           "expected": 1, "proofs": False}, policy=FAST)
        req = rq.new_proof_request("range", "sv-vnq", "cn0", "dp0", 0,
                                   b"payload", secrets_of["cn0"])
        frame = {"type": "proof_request", **DrynxNode._proof_fields(req)}
        for e in vns[:2]:
            # proofs off: the VN has no verify context, as in the reference
            assert call_entry(e, frame, policy=FAST)["code"] == rq.BM_FALSE
        with pytest.raises(TT.RemoteError, match="complete bitmaps"):
            call_entry(vns[0], {"type": "end_verification",
                                "survey_id": "sv-vnq", "timeout": 0.3,
                                "vn_quorum": 1.0}, timeout=30.0,
                       policy=FAST)
        block = call_entry(vns[0], {"type": "end_verification",
                                    "survey_id": "sv-vnq", "timeout": 0.3,
                                    "vn_quorum": 2 / 3}, timeout=30.0,
                           policy=FAST)
        assert block["vn_reported"] == ["vn0", "vn1"]
        assert block["vn_absent"] == ["vn2"]
        assert {k.split(":")[0] for k in block["bitmap"]} == {"vn0", "vn1"}
        latest = RemoteClient(Roster(entries), rng, device="cpu")
        assert latest.get_latest().hash() == block["block_hash"]
        assert latest.get_block(survey_id="sv-vnq").hash() == \
            block["block_hash"]
        assert latest.get_genesis().index == 0
        assert latest.get_block(index=10 ** 6) is None
        assert list(latest.get_proofs("sv-vnq")) == \
            ["sv-vnq/range/cn0/dp0"]
    finally:
        _stop(nodes)


def test_probe_liveness_and_broadcast_skip_a_dead_entry(tmp_path):
    """tests/test_resilience.py:529, up to its survey (which is slow
    here: test_surveys_over_tcp_equal_the_clear_answers)."""
    rng = np.random.default_rng(104)
    nodes, entries, _, _ = _boot(tmp_path, ["cn", "dp", "dp"], rng)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_port = s.getsockname()[1]
    s.close()
    entries = entries + [RosterEntry(name="dp2", role="dp",
                                     host="127.0.0.1", port=dead_port,
                                     public=entries[0].public)]
    try:
        client = RemoteClient(Roster(entries), rng, policy=FAST,
                              device="cpu")
        assert client.broadcast_roster() == {"cn0": True, "dp0": True,
                                             "dp1": True, "dp2": False}
        want = {"cn0": True, "dp0": True, "dp1": True, "dp2": False}
        assert client.probe_liveness() == want
        # within the verdicts' lifetime the map is reused, unprobed
        pinged = []
        client.ping = lambda e: pinged.append(e.name)
        assert client.probe_liveness() == want and pinged == []
        client._probe_cache = None
        assert client.probe_liveness() == dict.fromkeys(want, False)
        assert sorted(pinged) == sorted(want)
    finally:
        _stop(nodes)


def test_unshared_verify_cache_verifies_every_delivery():
    """LocalCluster(share_verify_cache=False) (reference service.py:193):
    the three CNs' key-switch deliveries to three VNs verify nine times
    (the shared cache verifies one body once: tests/test_torch_cluster.py's
    phase-7 launch counts)."""
    from drynx_tpu_torch.service.service import LocalCluster

    cluster = LocalCluster(n_cns=3, n_dps=1, n_vns=3, seed=2,
                           dlog_limit=10, device="cpu",
                           share_verify_cache=False)
    calls = []
    for vn in cluster.vns.vns:
        vn.verify_fns["keyswitch"] = \
            lambda data, sid: calls.append(sid) is None
    cluster.vns.register_survey("s", 3, {"keyswitch": 1.0})
    for cn in cluster.cns:
        req = rq.new_proof_request("keyswitch", "s", cn.name,
                                   f"keyswitch-{cn.name}", 0, b"body",
                                   cn.secret)
        assert set(cluster.vns.deliver(req)) == {rq.BM_TRUE}
    assert len(calls) == 9
    cluster.close()


# ---------------------------------------------------------------------------
# Whole surveys (slow on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_surveys_over_tcp_equal_the_clear_answers(tmp_path):
    """tests/test_transport.py:131-215 and tests/test_resilience.py
    :348/:529: a sum (tree), a group-by, log_reg (the weights of GD on
    the clear sums), a survey over the responders of a killed DP, and a
    probed survey skipping a dead entry."""
    from drynx_tpu_torch.models import logreg as lr

    rng = np.random.default_rng(66)
    X = rng.normal(size=(24, 2))
    y = (X @ np.asarray([1.0, -0.5]) > 0).astype(np.int64)
    shards = iter([lr.shard_for_dp(X, y, i, 3) for i in range(3)])
    nodes, entries, datas, _ = _boot(tmp_path, ["cn", "dp", "dp", "dp"],
                                     rng, data_of=lambda r: next(shards))
    try:
        client = RemoteClient(Roster(entries), rng, policy=FAST,
                              device="cpu")
        client.broadcast_roster()
        params = lr.LRParams(k=2, precision=1e2, max_iterations=10,
                             step=0.1, lambda_=1.0, n_features=2,
                             n_records=24)
        # one survey id each: a DP replays its reply to a survey id
        w = client.run_survey("log_reg", lr_params=params, survey_id="lr",
                              dlog=eg.DecryptionTable(limit=6000))
        agg = sum(lr.encode_clear(Xi, yi, params) for Xi, yi in
                  datas.values())
        assert np.array_equal(client.last_decrypted.values, agg.numpy())
        want = lr.train(lr.unpack(agg, params), params).numpy()
        np.testing.assert_allclose(w, want, rtol=0, atol=0)
        for n, (Xi, yi) in zip(nodes[1:], datas.values()):
            n.data = (np.rint(Xi[:, 0] * 3 + 5).clip(0, 9).astype(np.int64),
                      yi[:, None])
        res = client.run_survey("sum", query_min=0, query_max=9,
                                group_by=[[0, 1]], survey_id="gb",
                                dlog=eg.DecryptionTable(limit=500))
        for g in (0, 1):
            assert res[(g,)] == int(sum(
                v[gr[:, 0] == g].sum() for v, gr in
                (n.data for n in nodes[1:])))
        for n in nodes[1:]:
            n.data = n.data[0]
        clear = {n.name: int(n.data.sum()) for n in nodes[1:]}
        assert client.run_survey("sum", query_min=0, query_max=9,
                                 survey_id="sum",
                                 dlog=eg.DecryptionTable(limit=500)) == \
            sum(clear.values())
        plan = TF.FaultPlan(seed=1)
        plan.kill("dp1")
        TF.set_fault_plan(plan)
        # a kill reaches a pooled connection only after its next exchange
        # (its handler read the plan before it waited): dial afresh
        TT.set_conn_pool(None)
        res = client.run_survey("sum", query_min=0, query_max=9,
                                survey_id="sv-q", min_dp_quorum=2,
                                dlog=eg.DecryptionTable(limit=500))
        assert res == clear["dp0"] + clear["dp2"]
        assert client.last_responders == ["dp0", "dp2"]
        assert client.last_absent == ["dp1"]
        res = client.run_survey("sum", query_min=0, query_max=9,
                                survey_id="sv-p", min_dp_quorum=2,
                                probe=True,
                                dlog=eg.DecryptionTable(limit=500))
        assert res == clear["dp0"] + clear["dp2"]
        assert client.last_absent == ["dp1"]
    finally:
        _stop(nodes)


@pytest.mark.slow
def test_local_cluster_link_model_pays_its_delay():
    """tests/test_transport.py:236."""
    from drynx_tpu_torch.service.service import LocalCluster

    cluster = LocalCluster(n_cns=2, n_dps=4, n_vns=0, seed=3,
                           dlog_limit=2000, device="cpu",
                           link=TT.LinkModel(delay_ms=50))
    sq = cluster.generate_survey_query("sum", query_min=0, query_max=10)
    res = cluster.run_survey(sq)
    assert dict(res.timers.items())["DataCollectionProtocol"] >= 0.05
    assert cluster.link.stats()["msgs_total"] == 1
    cluster.close()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["tree", "star"])
def test_proofs_on_survey_commits_and_counts_phase_15a(tmp_path, mode,
                                                       monkeypatch):
    """A proofs-on sum over 2 CNs, 3 DPs and 2 VNs (ranges (4, 4),
    tests/test_net_plane.py:594): the clear sum, a clean block of
    2 x expected_proofs entries, the skipchain getters, and every kernel
    wrapper's calls (with their rows) equal to chip_smoke.py's
    tcp_survey_launches for the roster, tree and star."""
    from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
    from drynx_tpu_torch.utils import cuda_build
    import collections

    cs = _chip_smoke()
    monkeypatch.setenv(topo.ENV_TOPOLOGY, mode)
    monkeypatch.setenv(topo.ENV_FANOUT, "2")
    rows = collections.Counter()
    counts = collections.Counter()
    for mod in (cuda_ops, cuda_pairing):
        for name in mod.LAUNCHES:
            def counted(*a, _fn=getattr(mod, f"{name}_flat"), _name=name,
                        **k):
                counts[_name] += 1
                rows[(_name, cuda_build.launch_rows(_name, a))] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, f"{name}_flat", counted)
    rng = np.random.default_rng(33)
    nodes, entries, datas, _ = _boot(
        tmp_path, ["cn", "cn", "dp", "dp", "dp", "vn", "vn"], rng)
    try:
        client = RemoteClient(Roster(entries), rng, policy=FAST,
                              device="cpu")
        client.broadcast_roster()
        dl = eg.DecryptionTable(limit=500)
        for sid in ("cold", "warm"):
            counts.clear()
            rows.clear()
            result, block = client.run_survey(
                "sum", query_min=0, query_max=9, proofs=True,
                ranges=[(4, 4)], survey_id=sid, dlog=dl, timeout=2400.0)
            assert result == int(sum(d.sum() for d in datas.values()))
            assert len(block["bitmap"]) == 2 * client.expected_proofs(
                3, 2, False, False)
            assert set(block["bitmap"].values()) == {rq.BM_TRUE}
        want = cs.tcp_survey_launches(
            n_cns=2, n_dps=3, n_vns=2, V=1, digits=4, topology=mode,
            fanout=2, signed_offset=False)
        assert dict(counts) == {k: v for k, v in want[0].items() if v}
        assert dict(rows) == want[1]
        assert client.get_latest().hash() == block["block_hash"]
        assert len(client.get_proofs("warm")) == 3 + 1 + 2
    finally:
        _stop(nodes)


@pytest.mark.slow
def test_survey_parallel_serial_v1_pooled_all_agree(tmp_path, monkeypatch):
    """tests/test_net_plane.py:507: one roster, the same frequency_count
    dispatched serially (one fan-out worker) and in parallel, over v2 and
    v1 connections, and twice over one pool: the exact counts and
    responders every time; serial and parallel move the same bytes; v1
    costs more than v2; a warm pool reuses its sockets and skips the
    hellos."""
    rng = np.random.default_rng(21)
    nodes, entries, datas, _ = _boot(tmp_path, ["cn", "cn", "dp", "dp",
                                                "dp"], rng)
    client = RemoteClient(Roster(entries), rng, policy=FAST, device="cpu")
    client.broadcast_roster()
    want = {v: int(c) for v, c in enumerate(
        np.bincount(np.concatenate(list(datas.values())), minlength=10))}
    dl = eg.DecryptionTable(limit=500)

    def run(sid, pool):
        TT.set_conn_pool(pool)
        res = client.run_survey("frequency_count", query_min=0,
                                query_max=9, survey_id=sid, dlog=dl)
        assert {int(k): int(v) for k, v in res.items()} == want
        assert client.last_responders == ["dp0", "dp1", "dp2"]
        return dict(client.last_net)

    try:
        monkeypatch.setattr(TP, "FAN_OUT_WORKERS", 1)
        ser = run("sv-ser", TT.ConnPool())
        monkeypatch.undo()
        par = run("sv-par", TT.ConnPool())
        v1 = run("sv-v1", TT.ConnPool(wire=1))
        pool = TT.ConnPool()
        run("sv-pool", pool)
        warm = run("sv-pool2", pool)
    finally:
        TT.set_conn_pool(None)
        _stop(nodes)
    for k in ("bytes_total", "msgs_total", "by_peer"):
        assert ser[k] == par[k]
    assert par["bytes_total"] < 0.8 * v1["bytes_total"]
    assert {"cn0", "dp0", "dp1", "dp2"} <= set(par["by_peer"])
    assert pool.stats()["reuses"] > 0
    assert warm["bytes_total"] < par["bytes_total"]


@pytest.mark.slow
def test_remote_cn_shuffle_consumes_pooled_dro(tmp_path):
    """tests/test_net_plane.py:712: a DrynxNode with a warm CryptoPool
    serves shuffle_contrib from DRO slabs (no fresh precomputation, the
    slab's elements consumed, the noise multiset kept), and precomputes
    once the pool is drained."""
    from drynx_tpu_torch import pool as pool_mod
    from drynx_tpu_torch.parallel import dro
    from drynx_tpu_torch.pool import replenish

    rng = np.random.default_rng(5)
    x, pub = eg.keygen(rng)
    need = 8
    pool = pool_mod.CryptoPool(str(tmp_path / "pool"), slab_elems=need)
    node = DrynxNode("cn0", x, pub, db_path=str(tmp_path / "cn0.db"),
                     pool=pool, device="cpu")
    try:
        node.roster = Roster([RosterEntry(name="cn0", role="cn",
                                          host="127.0.0.1", port=0,
                                          public=pub)])
        tbl = node._table(node.roster.collective_pub())
        gen = torch.Generator().manual_seed(1)
        replenish.refill_to(pool, gen, tbl.table, need)
        noise = np.array([0, 1, -1, 2, -2, 0, 1, -1], dtype=np.int64)
        cts = dro.encrypt_noise(tbl, noise, torch.Generator().manual_seed(2))
        before = dro.PRECOMPUTE_CALLS
        r = node._h_shuffle_contrib({"type": "shuffle_contrib",
                                     "survey_id": "s", "proofs": False,
                                     "cts": TT.pack_array(cts)})
        assert dro.PRECOMPUTE_CALLS == before
        assert pool.counters["elements_consumed"] == need
        out = torch.from_numpy(TT.unpack_array(r["cts"]).astype(np.int32))
        vals, found = eg.decrypt_ints(out, x, eg.DecryptionTable(limit=8))
        assert bool(found.all())
        assert sorted(vals.tolist()) == sorted(noise.tolist())
        node._h_shuffle_contrib({"type": "shuffle_contrib",
                                 "survey_id": "s2", "proofs": False,
                                 "cts": TT.pack_array(cts)})
        assert dro.PRECOMPUTE_CALLS == before + 1
    finally:
        node.server.server.server_close()
        pool_mod.activate(None)


@pytest.fixture(scope="module")
def reference_node():
    """The reference's node module, importable on this jax while the test
    that asks for it runs: drynx_tpu/crypto/pallas_ops.py reads
    `jax.enable_x64` as a bool, so it is a context manager that flips
    `jax_enable_x64` until teardown, which restores it and forgets every
    reference module imported under it (tests/test_torch_survey.py's
    `reference`)."""
    import contextlib
    import sys

    import jax

    @contextlib.contextmanager
    def x64(flag=True):
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", bool(flag))
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", old)

    saved = jax.enable_x64
    before = set(sys.modules)
    jax.enable_x64 = x64
    try:
        from drynx_tpu.resilience import faults as JF
        from drynx_tpu.service import node as JN
        from drynx_tpu.service import transport as JT

        JF.set_fault_plan(None)
        JT.set_conn_pool(None)
        yield JN
        JT.set_conn_pool(None)
    finally:
        jax.enable_x64 = saved
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name.startswith("drynx_tpu."):
                parent, _, attr = name.rpartition(".")
                sys.modules.pop(name)
                if hasattr(sys.modules.get(parent), attr):
                    delattr(sys.modules[parent], attr)


@pytest.mark.slow
def test_a_reference_root_cn_serves_port_dps_and_client(tmp_path,
                                                        reference_node,
                                                        monkeypatch):
    """A mixed roster: the reference's DrynxNode is the root CN, port
    DrynxNodes are the DPs (the tree overlay: a port DP relays a port DP)
    and the port's RemoteClient drives a proofs-off sum. The CN takes the
    port's roster, dispatches to the port's DPs, folds what they send and
    key-switches it; the port's client decrypts the reference's reply to
    the clear sum."""
    monkeypatch.setenv(topo.ENV_FANOUT, "2")     # dp0 relays dp2
    rng = np.random.default_rng(73)
    x, pub = eg.keygen(rng)
    cn = reference_node.DrynxNode("cn0", x, pub,
                                  db_path=str(tmp_path / "cn0.db"))
    cn.start()
    nodes, entries, datas, _ = _boot(tmp_path, ["dp"] * 3, rng)
    entries.insert(0, RosterEntry(name="cn0", role="cn",
                                  host=cn.address[0], port=cn.address[1],
                                  public=pub))
    try:
        client = RemoteClient(Roster(entries), rng, policy=FAST,
                              device="cpu")
        assert client.broadcast_roster() == {e.name: True for e in entries}
        res = client.run_survey("sum", query_min=0, query_max=9,
                                survey_id="mixed",
                                dlog=eg.DecryptionTable(limit=500))
        assert res == int(sum(d.sum() for d in datas.values()))
        assert client.last_responders == ["dp0", "dp1", "dp2"]
    finally:
        _stop(nodes)
        cn.stop()
