"""The port's in-process fault plane against the reference's, on the CPU.

`resilience/faults.py`: the specs' validation, seeded draws, count caps,
node verdicts, fault windows, partitions and episodes, each equal to the
reference's for the same seed and the same calls. `resilience/policy.py`:
the retry policy's backoff and idempotency gate and every constant the
port shares with the reference. `service/transport.py`: `local_call`
raises the reference's error class and message for each (hook, kind) the
in-process path meets (tests/test_resilience.py's cases that need no
socket), and `fan_out` keeps roster order. The fault plan is process
global in both packages: an autouse fixture clears both before and after
each test.
"""
import threading
import time

import pytest

from drynx_tpu.resilience import faults as JF
from drynx_tpu.resilience import policy as JP
from drynx_tpu.service import transport as JT
from drynx_tpu_torch.resilience import faults as TF
from drynx_tpu_torch.resilience import policy as TP
from drynx_tpu_torch.service import transport as TT


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    JF.set_fault_plan(None)
    TF.set_fault_plan(None)
    yield
    JF.set_fault_plan(None)
    TF.set_fault_plan(None)


def _both(seed=0, specs=(), clock=None):
    """The same plan in both packages: (reference's, port's)."""
    kw = {} if clock is None else {"clock": clock}
    return tuple(mod.FaultPlan(seed=seed, specs=[mod.FaultSpec(**s)
                                                 for s in specs], **kw)
                 for mod in (JF, TF))


# ---------------------------------------------------------------------------
# FaultSpec / FaultPlan
# ---------------------------------------------------------------------------

def test_tables_equal_the_reference():
    assert (TF.KINDS, TF.WHERES, TF.NODE_KINDS) == (JF.KINDS, JF.WHERES,
                                                    JF.NODE_KINDS)


@pytest.mark.parametrize("spec", [
    {"where": "bogus", "kind": "drop"},
    {"where": "request", "kind": "bogus"},
    {"where": "request", "kind": "kill"},
    {"where": "request", "kind": "partition"},
    {"where": "node", "kind": "kill", "heal_after_s": 0.0},
    {"where": "request", "kind": "drop", "heal_after_s": 1.0},
    {"where": "connect", "kind": "refuse", "after_s": 2.0},
])
def test_spec_validation_equals_the_reference(spec):
    msgs = []
    for mod in (JF, TF):
        with pytest.raises(ValueError) as ei:
            mod.FaultSpec(**spec)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("seed", [0, 9, 12345])
def test_link_draws_equal_the_reference(seed):
    specs = [{"where": "request", "kind": "drop", "prob": 0.5},
             {"where": "request", "kind": "delay", "target": "dp*",
              "mtype": "survey_dp", "prob": 0.3, "delay_s": 0.0},
             {"where": "connect", "kind": "refuse", "target": "vn*",
              "prob": 0.4, "count": 3},
             {"where": "reply", "kind": "corrupt", "prob": 0.25}]
    plans = _both(seed, specs)
    calls = [(w, t, m) for _ in range(12)
             for w in ("connect", "request", "reply")
             for t in ("dp0", "dp3", "vn1", "cn0")
             for m in ("survey_dp", "ping")]
    seqs = []
    for plan in plans:
        seq = []
        for w, t, m in calls:
            s = plan.pick(w, t, m)
            seq.append(None if s is None else plan.specs.index(s))
        seqs.append((seq, [s.fired for s in plan.specs], plan.describe()))
    assert seqs[0] == seqs[1]
    fired = seqs[1][0]
    assert any(f is None for f in fired) and any(f == 0 for f in fired)
    assert seqs[1][1][2] <= 3 * 4      # the cap is per (spec, target)


def test_count_cap_equals_the_reference():
    out = []
    for mod in (JF, TF):
        plan = mod.FaultPlan(seed=0)
        spec = plan.add(mod.FaultSpec(where="connect", kind="refuse",
                                      target="dp0", count=2))
        hits = [plan.pick("connect", "dp0") is not None for _ in range(4)]
        out.append((hits, spec.fired,
                    plan.pick("connect", "dp1") is None))
    assert out[0] == out[1] == ([True, True, False, False], 2, True)


@pytest.mark.parametrize("seed", [4, 7])
def test_node_verdicts_equal_the_reference(seed):
    specs = [{"where": "node", "kind": "kill", "target": "dp*",
              "prob": 0.5},
             {"where": "node", "kind": "pause", "target": "vn*",
              "prob": 0.5, "delay_s": 0.25}]
    out = []
    for plan in _both(seed, specs):
        names = [f"dp{i}" for i in range(8)] + [f"vn{i}" for i in range(4)]
        v = {n: plan.killed(n) for n in names}
        # memoized: a node never flaps between dead and alive
        assert all(plan.killed(n) == dead for n, dead in v.items())
        faults = {n: (None if (f := plan.node_fault(n)) is None
                      else (f.kind, f.delay_s)) for n in names}
        out.append((v, faults))
    assert out[0] == out[1]
    assert True in out[1][0].values() and False in out[1][0].values()


def test_windows_and_explicit_kills_equal_the_reference():
    t = {"now": 0.0}
    clock = lambda: t["now"]  # noqa: E731
    out = []
    for plan in _both(0, [{"where": "node", "kind": "kill", "target": "dp0",
                           "after_s": 1.0, "heal_after_s": 2.0}], clock):
        rows = []
        plan.kill("dp1", heal_after_s=1.5)
        plan.kill("dp2")
        for now in (0.0, 0.5, 1.0, 1.49, 1.5, 2.9, 3.0, 5.0, 1e9):
            t["now"] = now
            rows.append((plan.killed("dp0"), plan.killed("dp1"),
                         plan.killed("dp2"), plan.elapsed()))
        plan.revive("dp2")
        rows.append(plan.killed("dp2"))
        t["now"] = 0.0
        out.append(rows)
    assert out[0] == out[1]
    assert [r[0] for r in out[1][:8]] == [False, False, True, True, True,
                                          True, False, False]


def test_partitions_equal_the_reference():
    t = {"now": 0.0}
    clock = lambda: t["now"]  # noqa: E731
    out = []
    for plan in _both(7, [{"where": "node", "kind": "partition",
                           "target": "cn*", "peer": "dp*", "prob": 0.5,
                           "heal_after_s": 4.0}], clock):
        t["now"] = 1.0
        v = {(a, b): plan.partitioned(a, b)
             for a in ("cn0", "cn1", "client") for b in ("dp0", "dp1", "dp2")}
        assert all(plan.partitioned(b, a) == cut for (a, b), cut in v.items())
        assert not plan.partitioned("cn0", "cn0")
        t["now"] = 4.0
        healed = [plan.partitioned(a, b) for (a, b) in v]
        t["now"] = 0.0
        out.append((v, healed))
    assert out[0] == out[1]
    assert True in out[1][0].values() and not any(out[1][1])


def test_episodes_and_epoch_equal_the_reference():
    t = {"now": 10.0}
    clock = lambda: t["now"]  # noqa: E731
    out = []
    for mod, plan in zip((JF, TF), _both(3, [
            {"where": "node", "kind": "kill", "target": "dp1",
             "after_s": 0.5, "heal_after_s": 1.0},
            {"where": "node", "kind": "partition", "target": "cn*",
             "peer": "dp*", "after_s": 2.0, "heal_after_s": 3.0},
            {"where": "request", "kind": "drop", "target": "vn0"}], clock)):
        plan.kill("vn0", heal_after_s=4.0)
        t["now"] = 12.0
        e0 = plan.elapsed()
        plan.reset_epoch()
        out.append((plan.episodes(), e0, plan.elapsed(), plan.describe()))
        t["now"] = 10.0
    assert out[0] == out[1]
    assert out[1][0][0] == {"spec": 0, "kind": "kill", "target": "dp1",
                            "peer": None, "down_s": 0.5, "heal_s": 1.5}


def test_process_global_plan_is_the_ports_own():
    plan = TF.FaultPlan(seed=1)
    TF.set_fault_plan(plan)
    assert TF.fault_plan() is plan and JF.fault_plan() is None


# ---------------------------------------------------------------------------
# RetryPolicy, the idempotency table, the constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"backoff_s": 0.2, "backoff_cap_s": 1.0, "jitter": 0.0},
    {"backoff_s": 0.2, "backoff_cap_s": 1.0, "jitter": 0.25, "seed": 3},
    {"seed": 0},
    {"backoff_s": 0.02, "backoff_cap_s": 0.05, "jitter": 0.1, "seed": 11},
])
def test_backoff_equals_the_reference(kw):
    ref, port = JP.RetryPolicy(**kw), TP.RetryPolicy(**kw)
    assert [port.backoff(a) for a in range(8)] == \
        [ref.backoff(a) for a in range(8)]
    for a, d in enumerate(port.backoff(a) for a in range(8)):
        base = min(port.backoff_s * 2.0 ** a, port.backoff_cap_s)
        assert base * (1 - port.jitter) <= d <= base * (1 + port.jitter)


def test_idempotency_gate_equals_the_reference():
    assert TP.IDEMPOTENT_MTYPES == JP.IDEMPOTENT_MTYPES
    assert TP.CONTRIBUTION_MTYPES == JP.CONTRIBUTION_MTYPES
    mtypes = sorted(JP.IDEMPOTENT_MTYPES | JP.CONTRIBUTION_MTYPES) + [
        "made_up"]
    for m in mtypes:
        assert TP.is_idempotent(m) == JP.is_idempotent(m)
        for retries in (0, 2):
            for sent in (False, True):
                assert (TP.RetryPolicy(connect_retries=retries)
                        .attempts_for(m, sent)
                        == JP.RetryPolicy(connect_retries=retries)
                        .attempts_for(m, sent))
    assert TP.DEFAULT_POLICY == TP.RetryPolicy()
    assert TP.RetryPolicy().attempts_for("survey_dp", sent=True) == 1


def test_constants_equal_the_reference():
    names = [n for n in TP.__all__
             if n.isupper() and isinstance(getattr(TP, n), (int, float))]
    assert {"PROBE_TTL_S", "PING_TIMEOUT_S", "STRAGGLER_GRACE_S",
            "FAN_OUT_WORKERS", "CONNECT_RETRIES"} <= set(names)
    assert {n: getattr(TP, n) for n in names} == \
        {n: getattr(JP, n) for n in names}


def test_named_locks_carry_their_names():
    lock = TP.named_lock("a_lock")
    rlock = TP.named_lock("r_lock", reentrant=True)
    assert (TP.lock_name(lock), TP.lock_name(rlock)) == ("a_lock", "r_lock")
    assert TP.lock_name(threading.Lock()) is None
    with rlock, rlock:
        pass


# ---------------------------------------------------------------------------
# local_call and fan_out
# ---------------------------------------------------------------------------

LOCAL_CASES = {
    "no plan": (None, []),
    "killed": ("kill", []),
    "kill spec": (None, [{"where": "node", "kind": "kill",
                          "target": "dp1"}]),
    "partition": (None, [{"where": "node", "kind": "partition",
                          "target": "client", "peer": "dp*"}]),
    "refuse": (None, [{"where": "connect", "kind": "refuse"}]),
    "connect delay": (None, [{"where": "connect", "kind": "delay",
                              "delay_s": 0.01}]),
    "drop": (None, [{"where": "request", "kind": "drop",
                     "mtype": "survey_query"}]),
    "drop other mtype": (None, [{"where": "request", "kind": "drop",
                                 "mtype": "ping"}]),
    "corrupt": (None, [{"where": "request", "kind": "corrupt"}]),
    "close_mid_frame": (None, [{"where": "request",
                                "kind": "close_mid_frame"}]),
    "request delay": (None, [{"where": "request", "kind": "delay",
                              "delay_s": 0.01}]),
    "pause": (None, [{"where": "node", "kind": "pause", "target": "dp1",
                      "delay_s": 0.01}]),
    "reply drop": (None, [{"where": "reply", "kind": "drop"}]),
    "reply corrupt": (None, [{"where": "reply", "kind": "corrupt"}]),
    "reply close": (None, [{"where": "reply", "kind": "close_mid_frame"}]),
    "reply delay": (None, [{"where": "reply", "kind": "delay",
                            "delay_s": 0.01}]),
    "kill before refuse": ("kill", [{"where": "connect", "kind": "refuse"}]),
    "refuse before drop": (None, [{"where": "request", "kind": "drop"},
                                  {"where": "connect", "kind": "refuse"}]),
    "other target": (None, [{"where": "connect", "kind": "refuse",
                             "target": "dp0"}]),
}


def _outcome(mod, tr, case):
    kill, specs = LOCAL_CASES[case]
    plan = None
    if kill or specs:
        plan = mod.FaultPlan(seed=0, specs=[mod.FaultSpec(**s)
                                            for s in specs])
        if kill:
            plan.kill("dp1")
    mod.set_fault_plan(plan)
    ran = []
    try:
        out = tr.local_call("dp1", "survey_query",
                            lambda x, y=0: ran.append(x + y) or "ok", 1, y=2)
        return ("ok", out, ran)
    except tr.TransportError as e:
        return (type(e).__name__, str(e), ran,
                [isinstance(e, c) for c in (ConnectionError, TimeoutError,
                                            RuntimeError)])
    finally:
        mod.set_fault_plan(None)


@pytest.mark.parametrize("case", sorted(LOCAL_CASES))
def test_local_call_raises_as_the_reference(case):
    want = _outcome(JF, JT, case)
    assert _outcome(TF, TT, case) == want


def test_local_call_hooks_follow_the_reference_order():
    """A reply fault comes after the call ran; a connect fault before;
    the partition is read from this thread's node."""
    for mod, tr in ((JF, JT), (TF, TT)):
        plan = mod.FaultPlan(seed=0)
        plan.add(mod.FaultSpec(where="node", kind="partition",
                               target="cn0", peer="dp1"))
        mod.set_fault_plan(plan)
        try:
            assert tr.local_call("dp1", "ping", lambda: 5) == 5
            tr.set_current_node("cn0")
            with pytest.raises(tr.ConnectError, match="cn0 -> dp1"):
                tr.local_call("dp1", "ping", lambda: 5)
        finally:
            tr.set_current_node("")
            mod.set_fault_plan(None)
    t0 = time.monotonic()
    TF.set_fault_plan(TF.FaultPlan(seed=0, specs=[TF.FaultSpec(
        where="node", kind="pause", target="dp1", delay_s=0.05)]))
    assert TT.local_call("dp1", "ping", lambda: 1) == 1
    assert time.monotonic() - t0 >= 0.05


def test_error_classes_match_the_reference():
    for name in ("TransportError", "ConnectError", "ConnectionClosed",
                 "CallTimeout", "FrameTooLarge", "CorruptFrame",
                 "RemoteError"):
        port, ref = getattr(TT, name), getattr(JT, name)
        assert [b.__name__ for b in port.__mro__] == \
            [b.__name__ for b in ref.__mro__]


@pytest.mark.parametrize("workers", [1, 2, TP.FAN_OUT_WORKERS])
def test_fan_out_keeps_roster_order_and_bounds_its_pool(workers,
                                                        monkeypatch):
    monkeypatch.setattr(TP, "FAN_OUT_WORKERS", workers)
    names = [f"dp{i}" for i in range(12)]
    live, peak, lock = [0], [0], threading.Lock()
    TT.set_current_node("cn0")
    seen = []

    def call(name):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.002 * (12 - int(name[2:])))
        seen.append(TT.current_node())
        with lock:
            live[0] -= 1
        if name == "dp5":
            raise TT.ConnectError("down")
        return name.upper()

    try:
        out = TT.fan_out(names, call)
    finally:
        TT.set_current_node("")
    assert [r for r, _ in out] == [None if n == "dp5" else n.upper()
                                   for n in names]
    assert isinstance(out[5][1], TT.ConnectError)
    assert 1 <= peak[0] <= workers
    assert set(seen) == {"cn0"}
