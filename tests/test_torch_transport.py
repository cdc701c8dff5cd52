"""The port's control-plane transport against the reference's.

`drynx_tpu_torch/service/transport.py` (frames, negotiation, the device
decode, the link model, connections and their pool) and `utils/timers.py`'s
split held against `drynx_tpu/service/transport.py` and
`drynx_tpu/utils/timers.py`, whose modules import no JAX of their own:

  - every handler payload of tests/test_net_plane.py:_handler_payloads (the
    reference's file imports its node module, which fails to import under
    jax 0.9's `enable_x64` (ROADMAP fact 4), so the payloads are rebuilt
    here from the same seed)
    gives byte-identical v1 and v2 frames in both packages, and each
    package decodes the other's frames; garbage is refused with the same
    error types;
  - a port Conn negotiates v2 with a reference NodeServer and a reference
    Conn with a port NodeServer; a v1-pinned side and a server without the
    hello stay on v1;
  - the device decode equals the host decode for every widen pair, below
    and above the floor; LazySeg's host surfaces and relay re-encode;
  - the pool, fan-out and link cases of tests/test_net_plane.py:248-578
    and the transport cases of tests/test_resilience.py:236-345, on the
    port.
"""
import socket
import threading
import time

import numpy as np
import pytest
import torch

from drynx_tpu.resilience import faults as JF
from drynx_tpu.service import transport as JT
from drynx_tpu.utils import timers as JTM
from drynx_tpu_torch.resilience import faults as TF
from drynx_tpu_torch.resilience import policy as TP
from drynx_tpu_torch.service import node as TN
from drynx_tpu_torch.service import transport as TT
from drynx_tpu_torch.utils import timers as TTM


@pytest.fixture(autouse=True)
def _clean_process_globals():
    """Fault plans, pools and link models are process-wide in both
    packages."""
    for F, T in ((JF, JT), (TF, TT)):
        F.set_fault_plan(None)
        T.set_conn_pool(None)
    yield
    for F, T in ((JF, JT), (TF, TT)):
        F.set_fault_plan(None)
        T.set_conn_pool(None)


def _pack_bytes(b: bytes) -> dict:
    return TT.pack_array(np.frombuffer(b, dtype=np.uint8))


def _handler_payloads() -> dict:
    """One message per handler payload family, as
    tests/test_net_plane.py:_handler_payloads builds them."""
    rng = np.random.default_rng(7)
    cts = rng.integers(0, 2 ** 16, size=(4, 2, 3, 16)).astype(np.uint32)
    pts = rng.integers(0, 2 ** 16, size=(4, 3, 16)).astype(np.uint32)
    A = rng.integers(0, 2 ** 16, size=(2, 16, 3, 2, 16)).astype(np.uint32)
    roster = TN.Roster([TN.RosterEntry(name="cn0", role="cn",
                                       host="127.0.0.1", port=7000,
                                       public=(12345, 67890))])
    return {
        "set_roster": {"type": "set_roster", "roster": roster.to_dict()},
        "survey_query": {
            "type": "survey_query", "op": "sum", "survey_id": "s1",
            "query_min": 0, "query_max": 9, "proofs": True,
            "ranges": [[16, 4], [16, 4]], "obfuscation": False,
            "diffp": {"noise_list_size": 8, "lap_mean": 0.0,
                      "lap_scale": 2.0, "quanta": 1.0, "scale": 1.0,
                      "limit": 4.0},
            "lr_params": None, "group_by": None, "range_offset": 0,
            "min_dp_quorum": 0, "dp_exclude": [],
            "client_pub": [12345, 67890]},
        "survey_dp": {
            "type": "survey_dp", "op": "sum", "survey_id": "s1",
            "query_min": 0, "query_max": 9, "range_offset": 0,
            "proofs": True, "ranges": [[16, 4]],
            "range_sigs": {"16": {"pubs": [[1, 2], [3, 4]],
                                  "A": TT.pack_array(A)}}},
        "survey_dp_reply": {"type": "survey_dp_reply",
                            "cts": TT.pack_array(cts)},
        "range_sig_reply": {"type": "range_sig_reply", "pub": [111, 222],
                            "A": TT.pack_array(A[0])},
        "contrib": {"type": "shuffle_contrib", "survey_id": "s1",
                    "proofs": False, "cts": TT.pack_array(cts)},
        "ks_contrib": {"type": "ks_contrib", "survey_id": "s1",
                       "proofs": False, "client_pub": [12345, 67890],
                       "k_component": TT.pack_array(pts)},
        "ks_reply": {"type": "ks_contrib_reply", "u": TT.pack_array(pts),
                     "w": TT.pack_array(pts)},
        "proof_request": {
            "type": "proof_request", "proof_type": "range",
            "survey_id": "s1", "sender_id": "dp0",
            "differ_info": "range-dp0", "round_id": 0,
            "data": _pack_bytes(b"\x00\x01\xfe\xff" * 64),
            "signature": _pack_bytes(b"\x80" * 96)},
        "end_verification_reply": {
            "type": "end_verification_reply", "block_index": 1,
            "block_hash": "ab" * 32,
            "bitmap": {"vn0:range-dp0": "BM_TRUE", "vn1:ks-cn0": "BM_TRUE"},
            "vn_reported": ["vn0", "vn1"], "vn_absent": []},
        "get_proofs_reply": {
            "type": "get_proofs_reply",
            "proofs": {"range-dp0": _pack_bytes(b"\x01\x02" * 100)}},
    }


def _arrays(tree, out):
    if isinstance(tree, dict):
        if set(tree) >= {"dtype", "shape", "data"}:
            out.append(tree)
        else:
            for v in tree.values():
                _arrays(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _arrays(v, out)
    return out


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", [1, 2])
@pytest.mark.parametrize("name", sorted(_handler_payloads()))
def test_frames_equal_the_references_and_cross_decode(name, wire):
    msg = _handler_payloads()[name]
    for a in _arrays(msg, []):
        assert JT.pack_array(TT.unpack_array(a)) == a
    f_port = TT.encode_frame(msg, wire)
    f_ref = JT.encode_frame(msg, wire)
    assert f_port == f_ref
    port_of_ref = TT.decode_frame(f_ref[4:], wire)
    ref_of_port = JT.decode_frame(f_port[4:], wire)
    assert TT.jsonable(port_of_ref) == JT.jsonable(ref_of_port) \
        == JT.jsonable(msg)
    # a decoded tree re-encodes to the same frame in either package (the
    # relay path: narrowed segments forwarded as they came)
    assert TT.encode_frame(port_of_ref, wire) == f_ref
    assert JT.encode_frame(ref_of_port, wire) == f_port
    for a_port, a_ref, a0 in zip(_arrays(port_of_ref, []),
                                 _arrays(ref_of_port, []),
                                 _arrays(msg, [])):
        want = TT.unpack_array(a0)
        assert np.array_equal(TT.unpack_array(a_port), want)
        assert np.array_equal(JT.unpack_array(a_ref), want)
        assert TT.unpack_array(a_port).dtype == want.dtype


def test_v2_frames_beat_v1_on_tensor_payloads():
    msg = _handler_payloads()["survey_dp_reply"]
    v1, v2 = len(TT.encode_frame(msg, 1)), len(TT.encode_frame(msg, 2))
    assert v2 < 0.8 * v1
    ping = {"type": "ping"}
    assert len(TT.encode_frame(ping, 2)) <= len(TT.encode_frame(ping, 1)) + 16


def test_garbage_is_refused_with_the_references_error_types():
    good2 = TT.encode_frame({"a": b"xy"}, 2)[4:]
    good1 = TT.encode_frame({"a": b"xy"}, 1)[4:]
    cases = [(2, b""), (2, b"\x00" * 6), (2, b"\xff" + good2[1:]),
             (2, good2[:-1]), (1, b"\xff{not json"), (1, good1[:-1]),
             (2, (2).to_bytes(4, "big") + b'{}' + (5).to_bytes(4, "big"))]
    for wire, bad in cases:
        with pytest.raises(TT.CorruptFrame):
            TT.decode_frame(bad, wire)
        with pytest.raises(JT.CorruptFrame):
            JT.decode_frame(bad, wire)
    assert TT.unb64(b"raw") == b"raw" and TT.unb64("cmF3") == b"raw"
    for name in ("TransportError", "ConnectError", "ConnectionClosed",
                 "CallTimeout", "FrameTooLarge", "CorruptFrame",
                 "RemoteError"):
        assert ([b.__name__ for b in getattr(TT, name).__mro__]
                == [b.__name__ for b in getattr(JT, name).__mro__])


# ---------------------------------------------------------------------------
# Negotiation, between the packages too
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("server_pkg,client_pkg",
                         [(TT, TT), (JT, TT), (TT, JT)])
def test_conn_negotiates_v2_across_packages(server_pkg, client_pkg):
    srv = server_pkg.NodeServer()
    srv.register("echo", lambda m: {"blob": m["blob"],
                                    "arr": m["arr"]})
    srv.start()
    arr = np.arange(300, dtype=np.uint32).reshape(3, 100)
    try:
        c = client_pkg.Conn(srv.host, srv.port)
        assert c.wire == 2
        r = c.call({"type": "echo", "blob": b"\x00\xff" * 8,
                    "arr": client_pkg.pack_array(arr)})
        assert client_pkg.unb64(r["blob"]) == b"\x00\xff" * 8
        assert np.array_equal(client_pkg.unpack_array(r["arr"]), arr)
        with pytest.raises(RuntimeError):
            c.call({"type": "nope"})
        c.close()
    finally:
        srv.stop()


def test_v1_pins_and_a_server_without_the_hello():
    srv = TT.NodeServer()
    srv.register("echo", lambda m: {"blob": m["blob"]})
    srv.start()
    try:
        c1 = TT.Conn(srv.host, srv.port, wire=1)
        assert c1.wire == 1
        assert TT.unb64(c1.call({"type": "echo", "blob": b"\x01"})["blob"]) \
            == b"\x01"
        c1.close()
    finally:
        srv.stop()
    pinned = TT.NodeServer(wire=1)
    pinned.start()
    try:
        c = TT.Conn(pinned.host, pinned.port)
        assert c.wire == 1
        c.close()
    finally:
        pinned.stop()
    # a server that errors the hello (tests/test_net_plane.py:214)
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def serve():
        conn, _ = lsock.accept()
        with conn:
            while True:
                msg = TT.recv_msg(conn)
                if msg is None:
                    return
                if msg.get("type") == "wire_hello":
                    TT.send_msg(conn, {"type": "error",
                                       "error": "no handler"})
                else:
                    TT.send_msg(conn, {"type": "echo_reply", "v": msg["v"]})

    threading.Thread(target=serve, daemon=True).start()
    try:
        c = TT.Conn(*lsock.getsockname())
        assert c.wire == 1
        assert c.call({"type": "echo", "v": 42})["v"] == 42
        c.close()
    finally:
        lsock.close()


# ---------------------------------------------------------------------------
# The device-direct decode
# ---------------------------------------------------------------------------

def _narrowed_field(narrow: str, wide: str, n: int):
    """A packed `wide` array whose values fit `narrow`, through a v2 frame:
    its data arrives as a LazySeg."""
    info = np.iinfo(np.dtype(narrow))
    rng = np.random.default_rng(n)
    a = rng.integers(info.min, int(info.max) + 1, size=n).astype(wide)
    a[:2] = [info.min, info.max]
    msg = TT.decode_frame(TT.encode_frame({"a": TT.pack_array(a)}, 2)[4:],
                          2)
    return msg["a"], a


@pytest.mark.parametrize("narrow,wide", TT.widen_pairs())
def test_device_decode_equals_the_host_decode(narrow, wide):
    assert sorted(TT.widen_pairs()) == sorted(JT.widen_pairs())
    floor = TT.DEVICE_DECODE_MIN_BYTES
    isz = np.dtype(narrow).itemsize
    for n in (5, floor // isz - 1, floor // isz + 3):
        d, a = _narrowed_field(narrow, wide, n)
        assert isinstance(d["data"], TT.LazySeg)
        assert d["data"].wire_dt == narrow and d["data"].orig_dt == wide
        want = torch.from_numpy(TT.unpack_array(d).copy())
        assert np.array_equal(TT.unpack_array(d), a)
        got = TT.unpack_array_device(d, "cpu")
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


def test_device_decode_needs_the_card_unless_the_cpu_is_named(monkeypatch):
    d, a = _narrowed_field("uint16", "uint32", 40)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.unpack_array_device(d)
    assert np.array_equal(TT.unpack_array_device(d, "cpu").numpy(), a)


def test_lazyseg_host_surfaces_and_relay_reencode():
    d, a = _narrowed_field("uint16", "uint32", 40)
    seg = d["data"]
    assert seg.to_bytes() == a.tobytes() and len(seg) == a.nbytes
    assert seg == a.tobytes() and hash(seg) == hash(a.tobytes())
    assert repr(seg) == "LazySeg(80B uint16->uint32)"
    assert np.array_equal(seg.narrow_view(), a.astype(np.uint16))
    # forwarded untouched: the same frame as the original message, and the
    # v1 form of the widened bytes
    relay = {"a": d}
    assert TT.encode_frame(relay, 2) == \
        TT.encode_frame({"a": TT.pack_array(a)}, 2)
    assert TT.encode_frame(relay, 1) == \
        JT.encode_frame({"a": JT.pack_array(a)}, 1)
    assert TT.unb64(seg) == a.tobytes()


def test_phase_timers_split_summary_equals_the_references():
    """tests/test_device_path.py:330's cases, in both packages."""
    out = []
    for T in (TTM.PhaseTimers(), JTM.PhaseTimers()):
        T.add_split("Decode", "host_glue", 0.25)
        T.add_split("Verify.block", "device_compute", 0.75)
        T.add("PlainPhase", 1.0)
        out.append(T.split_summary())
    assert out[0] == out[1]
    s = out[0]
    assert s["host_glue_s"] == 0.25 and s["device_compute_s"] == 0.75
    assert s["device_share"] == 0.75
    assert "PlainPhase" not in s["phases"]
    assert TTM.PhaseTimers().split_summary() == \
        JTM.PhaseTimers().split_summary()
    assert TTM.PhaseTimers().split_summary()["device_share"] is None
    # the transport's decode spans land in WIRE_TIMERS as host glue
    before = TT.WIRE_TIMERS.split_summary()["host_glue_s"]
    _narrowed_field("uint8", "uint64", 100)
    assert TT.WIRE_TIMERS.split_summary()["phases"]["WireDecode"]
    assert TT.WIRE_TIMERS.split_summary()["host_glue_s"] >= before


# ---------------------------------------------------------------------------
# The connection pool (tests/test_net_plane.py:248-427)
# ---------------------------------------------------------------------------

def _echo_server():
    srv = TT.NodeServer()
    srv.register("echo", lambda m: {"v": m["v"]})
    srv.register("slow", lambda m: (time.sleep(0.3), {"ok": True})[1])
    srv.start()
    return srv


def test_conn_pool_reuses_and_bounds_idle():
    srv = _echo_server()
    pool = TT.ConnPool(max_idle=2)
    try:
        c1 = pool.get(srv.host, srv.port, peer="s")
        assert c1.call({"type": "echo", "v": 1})["v"] == 1
        pool.put(c1)
        c2 = pool.get(srv.host, srv.port, peer="s")
        assert c2 is c1
        st = pool.stats()
        assert st["connects"] == 1 and st["reuses"] == 1
        extra = [pool.get(srv.host, srv.port, peer="s") for _ in range(3)]
        for c in [c2] + extra:
            pool.put(c)
        assert pool.idle_count() == 2
        pool.close_all()
        assert pool.idle_count() == 0
    finally:
        srv.stop()


def test_conn_pool_global_cap_evicts_lru():
    s1, s2 = _echo_server(), _echo_server()
    pool = TT.ConnPool(max_idle=4, max_total=2)
    try:
        a1 = pool.get(s1.host, s1.port, peer="a")
        a2 = pool.get(s1.host, s1.port, peer="a")
        b1 = pool.get(s2.host, s2.port, peer="b")
        pool.put(a1)
        pool.put(b1)
        assert pool.idle_count() == 2 and pool.stats()["evictions"] == 0
        pool.put(a2)
        st = pool.stats()
        assert st["evictions"] == 1 and st["idle"] == 2
        assert a1.closed and not b1.closed
        assert pool.get(s1.host, s1.port, peer="a") is a2
        assert pool.get(s2.host, s2.port, peer="b") is b1
        pool.close_all()
    finally:
        s1.stop()
        s2.stop()
    assert TT.ConnPool(max_total=3).max_total == 3
    assert TT.ConnPool().max_total == TP.CONN_POOL_MAX == JT.rp.CONN_POOL_MAX


def test_conn_pool_never_reuses_timed_out_conn():
    srv = _echo_server()
    pool = TT.ConnPool()
    try:
        c = pool.get(srv.host, srv.port, timeout=0.1, peer="s")
        with pytest.raises(TT.CallTimeout):
            c.call({"type": "slow"})
        assert c.broken
        pool.put(c)
        assert pool.idle_count() == 0
        c2 = pool.get(srv.host, srv.port, timeout=5.0, peer="s")
        assert c2 is not c
        assert c2.call({"type": "echo", "v": 7})["v"] == 7
        pool.put(c2)
    finally:
        srv.stop()


def test_conn_pool_health_check_discards_desynced_socket():
    srv = _echo_server()
    pool = TT.ConnPool()
    try:
        c = pool.get(srv.host, srv.port, peer="s")
        assert c.call({"type": "echo", "v": 0})["v"] == 0
        TT.send_frame(c.sock, {"type": "echo", "v": 1}, c.wire)
        deadline = time.time() + 5.0
        while time.time() < deadline:
            try:
                c.sock.setblocking(False)
                c.sock.recv(1, socket.MSG_PEEK)
                break
            except BlockingIOError:
                time.sleep(0.01)
            finally:
                c.sock.settimeout(5.0)
        pool.put(c)
        assert pool.idle_count() == 1
        c2 = pool.get(srv.host, srv.port, peer="s")
        assert c2 is not c
        assert pool.stats()["discards"] >= 1
        assert c2.call({"type": "echo", "v": 9})["v"] == 9
        pool.put(c2)
    finally:
        srv.stop()


def test_conn_pool_purges_suspect_peer_stack_on_redial():
    srv = _echo_server()
    pool = TT.ConnPool(max_idle=4)
    try:
        a = pool.get(srv.host, srv.port, peer="s")
        b = pool.get(srv.host, srv.port, peer="s")
        c = pool.get(srv.host, srv.port, peer="s")
        for x in (a, b):
            assert x.call({"type": "echo", "v": 0})["v"] == 0
            pool.put(x)
        c._timeout = 0.1
        c.sock.settimeout(0.1)
        with pytest.raises(TT.CallTimeout):
            c.call({"type": "slow"})
        pool.discard(c)
        d = pool.get(srv.host, srv.port, peer="s")
        assert d is not a and d is not b
        st = pool.stats()
        assert st["purges"] == 2 and pool.idle_count() == 0
        assert a.closed and b.closed
        assert d.call({"type": "echo", "v": 5})["v"] == 5
        pool.put(d)
        assert pool.get(srv.host, srv.port, peer="s") is d
        pool.close_all()
    finally:
        srv.stop()


def test_conn_pool_overflow_close_does_not_condemn_peer():
    srv = _echo_server()
    pool = TT.ConnPool(max_idle=1)
    try:
        a = pool.get(srv.host, srv.port, peer="s")
        b = pool.get(srv.host, srv.port, peer="s")
        pool.put(a)
        pool.put(b)
        assert pool.idle_count() == 1
        c = pool.get(srv.host, srv.port, peer="s")
        assert c is a
        assert pool.stats()["purges"] == 0
        pool.put(c)
        pool.close_all()
    finally:
        srv.stop()


def test_call_entry_checks_out_of_the_process_pool_and_pool_wire():
    srv = _echo_server()
    try:
        pool = TT.ConnPool()
        TT.set_conn_pool(pool)
        e = TN.RosterEntry(name="s", role="cn", host=srv.host,
                           port=srv.port, public=(0, 0))
        for v in range(3):
            assert TN.call_entry(e, {"type": "echo", "v": v})["v"] == v
        st = pool.stats()
        assert st["connects"] == 1 and st["reuses"] == 2
        v1 = TT.ConnPool(wire=1)
        TT.set_conn_pool(v1)
        assert TN.call_entry(e, {"type": "echo", "v": 4})["v"] == 4
        assert [c.wire for s in v1._idle.values() for _, c in s] == [1]
    finally:
        TT.set_conn_pool(None)
        srv.stop()


# ---------------------------------------------------------------------------
# Fan-out, fault-plan draws and the link model (tests/test_net_plane.py
# :429-578, tests/test_transport.py:224)
# ---------------------------------------------------------------------------

def test_node_fan_out_builds_messages_first_and_keeps_roster_order():
    entries = [TN.RosterEntry(name=f"n{i}", role="dp", host="x", port=i,
                              public=(0, 0)) for i in range(6)]
    built = []

    def mk(e):
        built.append(threading.current_thread().name)
        return {"k": e.port * 10}

    def call(e, m):
        time.sleep((len(entries) - e.port) * 0.02)
        if e.port == 3:
            raise OSError("down")
        return {"who": e.name, "echo": m["k"]}

    outs = TN._fan(entries, mk, call)
    assert set(built) == {threading.current_thread().name}
    for i, (r, err) in enumerate(outs):
        if i == 3:
            assert r is None and isinstance(err, OSError)
        else:
            assert err is None and r == {"who": f"n{i}", "echo": i * 10}


def test_fan_out_overlaps_link_latency(monkeypatch):
    entries = list(range(6))

    def call(e):
        time.sleep(0.1)
        return e

    monkeypatch.setattr(TP, "FAN_OUT_WORKERS", 6)
    t0 = time.perf_counter()
    outs = TT.fan_out(entries, call)
    par = time.perf_counter() - t0
    assert [r for r, _ in outs] == entries
    monkeypatch.setattr(TP, "FAN_OUT_WORKERS", 1)
    t0 = time.perf_counter()
    assert TT.fan_out(entries, call) == outs
    ser = time.perf_counter() - t0
    assert par < ser / 2


def test_fault_plan_draws_are_arrival_order_independent():
    targets = [f"dp{i}" for i in range(5)]

    def specs(F):
        return [F.FaultSpec(where="connect", kind="refuse", target="dp*",
                            prob=0.5),
                F.FaultSpec(where="request", kind="drop", target="dp*",
                            mtype="survey_dp", prob=0.4)]

    ref = JF.FaultPlan(seed=11, specs=specs(JF))
    want = {}
    for t in targets:
        for k in range(8):
            want[("c", t, k)] = ref.pick("connect", t) is not None
            want[("r", t, k)] = ref.pick("request", t, "survey_dp") is not None
    plan = TF.FaultPlan(seed=11, specs=specs(TF))
    got, lock = {}, threading.Lock()

    def worker(t):
        for k in range(8):
            a = plan.pick("connect", t) is not None
            b = plan.pick("request", t, "survey_dp") is not None
            with lock:
                got[("c", t, k)] = a
                got[("r", t, k)] = b

    threads = [threading.Thread(target=worker, args=(t,))
               for t in reversed(targets)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert got == want


def test_link_model_accounts_and_charges_wall_clock():
    m = TT.LinkModel()
    threads = [threading.Thread(
        target=lambda i=i: [m.charge(3, peer=f"p{i % 2}")
                            for _ in range(200)]) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = m.stats()
    assert st == {"bytes_total": 4800, "msgs_total": 1600,
                  "by_peer": {"p0": 2400, "p1": 2400}}
    m.count_rx(10, "cn0")
    assert m.stats()["rx_by_node"] == {"cn0": 10}
    m.reset_stats()
    assert m.stats() == {"bytes_total": 0, "msgs_total": 0, "by_peer": {}}
    slow = TT.LinkModel(delay_ms=5, bandwidth_mbps=8)   # 1 byte a us
    t0 = time.perf_counter()
    slow.charge(10_000)                                 # 5 ms + 10 ms
    assert 0.014 <= time.perf_counter() - t0 <= 0.5
    assert not TT.LinkModel().active
    assert TT.LinkModel(delay_ms=1).active and \
        TT.LinkModel(bandwidth_mbps=1).active


def test_frames_charge_the_process_link_model_by_length():
    m = TT.LinkModel()
    TT.set_link_model(m)
    try:
        srv = _echo_server()
        try:
            c = TT.Conn(srv.host, srv.port, peer="s")
            c.call({"type": "echo", "v": 1})
            c.close()
        finally:
            srv.stop()
        hello = len(TT.encode_frame({"type": "wire_hello", "max": 2}, 1))
        req = len(TT.encode_frame({"type": "echo", "v": 1}, 2))
        assert m.stats()["by_peer"] == {"s": hello + req}
    finally:
        TT.set_link_model(None)


# ---------------------------------------------------------------------------
# Framing bounds and the retry contract (tests/test_resilience.py:236-345)
# ---------------------------------------------------------------------------

FAST = TP.RetryPolicy(connect_retries=1, backoff_s=0.02, backoff_cap_s=0.05,
                      jitter=0.0, call_timeout_s=TP.CALL_TIMEOUT_S, seed=0)


def _frame(body: bytes) -> bytes:
    return len(body).to_bytes(4, "big") + body


def test_recv_bounds_frame_length_and_rejects_corrupt_frames():
    a, b = socket.socketpair()
    try:
        a.sendall((2048).to_bytes(4, "big"))
        with pytest.raises(TT.FrameTooLarge, match="2048"):
            TT.recv_msg(b, max_bytes=1024)
    finally:
        a.close()
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall(_frame(b"\xff{not json"))
        with pytest.raises(TT.CorruptFrame):
            TT.recv_msg(b)
        a.sendall(_frame(b'{"type": "ok"}'))
        assert TT.recv_msg(b) == {"type": "ok"}
    finally:
        a.close()
        b.close()
    saved = TT.MAX_FRAME_BYTES
    TT.set_max_frame_bytes(16)
    a, b = socket.socketpair()
    try:
        a.sendall(_frame(b"x" * 17))
        with pytest.raises(TT.FrameTooLarge):
            TT.recv_msg(b)
    finally:
        TT.set_max_frame_bytes(saved)
        a.close()
        b.close()


def test_call_timeout_marks_connection_broken():
    srv = TT.NodeServer()
    srv.register("nap", lambda m: time.sleep(m["s"]) or {"ok": True})
    srv.start()
    c = TT.Conn(srv.host, srv.port, timeout=0.3)
    try:
        with pytest.raises(TT.CallTimeout):
            c.call({"type": "nap", "s": 5.0})
        with pytest.raises(TT.ConnectionClosed):
            c.call({"type": "nap", "s": 0.0})
        assert isinstance(TT.CallTimeout("x"), TimeoutError)
        assert issubclass(TT.CallTimeout, TT.TransportError)
    finally:
        c.close()
        srv.stop()


def _plan_server(mtype: str, name: str):
    srv = TT.NodeServer()
    calls = []
    srv.register(mtype, lambda m: calls.append(1) or {"ok": True})
    srv.start()
    entry = TN.RosterEntry(name=name, role="dp", host=srv.host,
                           port=srv.port, public=(0, 0))
    return srv, calls, entry


def test_call_entry_retries_refused_connect():
    srv, calls, entry = _plan_server("ping", "p0")
    plan = TF.FaultPlan(seed=0)
    plan.add(TF.FaultSpec(where="connect", kind="refuse", target="p0",
                          count=2))
    TF.set_fault_plan(plan)
    try:
        with pytest.raises(TT.ConnectError):
            TN.call_entry(entry, {"type": "ping"}, retries=0, policy=FAST)
        assert TN.call_entry(entry, {"type": "ping"}, retries=1,
                             policy=FAST)["ok"]
        assert calls == [1]
    finally:
        srv.stop()


def test_idempotent_call_retried_after_dropped_request():
    srv, calls, entry = _plan_server("ping", "p1")
    plan = TF.FaultPlan(seed=0)
    plan.add(TF.FaultSpec(where="request", kind="drop", target="p1",
                          mtype="ping", count=1))
    TF.set_fault_plan(plan)
    pol = TP.RetryPolicy(connect_retries=2, backoff_s=0.01,
                         backoff_cap_s=0.02, jitter=0.0, call_timeout_s=0.4,
                         seed=0)
    try:
        assert TN.call_entry(entry, {"type": "ping"}, policy=pol)["ok"]
        assert calls == [1]
    finally:
        srv.stop()


def test_contribution_never_resent_after_partial_write():
    srv, calls, entry = _plan_server("survey_dp", "p2")
    plan = TF.FaultPlan(seed=0)
    plan.add(TF.FaultSpec(where="request", kind="close_mid_frame",
                          target="p2", mtype="survey_dp"))
    TF.set_fault_plan(plan)
    pol = TP.RetryPolicy(connect_retries=5, backoff_s=0.01,
                         backoff_cap_s=0.02, jitter=0.0, call_timeout_s=0.4,
                         seed=0)
    try:
        with pytest.raises(TT.ConnectionClosed, match="partial write"):
            TN.call_entry(entry, {"type": "survey_dp"}, policy=pol)
        assert calls == []
    finally:
        srv.stop()


def test_reply_faults_and_a_killed_node_over_sockets():
    """The server's hooks: a corrupted reply breaks the connection (the
    handler ran), a killed node closes without a word."""
    srv, calls, entry = _plan_server("survey_dp", "p3")
    try:
        plan = TF.FaultPlan(seed=0)
        plan.add(TF.FaultSpec(where="reply", kind="corrupt", target="p3",
                              mtype="survey_dp", count=1))
        srv.node_name = "p3"
        TF.set_fault_plan(plan)
        with pytest.raises(TT.CorruptFrame):
            TN.call_entry(entry, {"type": "survey_dp"}, policy=FAST)
        assert calls == [1]
        plan.kill("p3")
        with pytest.raises(TT.ConnectError):
            TN.call_entry(entry, {"type": "ping"}, policy=FAST)
    finally:
        srv.stop()
