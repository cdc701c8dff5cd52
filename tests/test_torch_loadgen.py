"""The port's load generator (drynx_tpu_torch/server/loadgen.py) against
the reference's, and its quick tier over `SyntheticCluster`.

The seeded Poisson schedule (with a burst episode), `LoadGen._draw`'s
(tenant, shape) sequence and `fairness_ratio` equal the reference's; the
open and closed loops account for every offer exactly. The reference's
loadgen imports its server package, whose scheduler reaches
drynx_tpu/crypto/pallas_ops.py only when a server is built; the
module-scoped `ref` fixture installs the `jax.enable_x64` stand-in of
tests/test_torch_survey.py all the same while this module runs, and at
teardown restores it and forgets every reference module imported under
it.
"""
import contextlib
import sys
import types

import jax
import pytest

from drynx_tpu_torch.server.loadgen import (LoadGen, ShapeMix,
                                            SyntheticCluster,
                                            fairness_ratio,
                                            poisson_schedule,
                                            prewarm_shapes, synthetic_query)
from drynx_tpu_torch.server.scheduler import SurveyServer

SHAPES = [ShapeMix("r42", weight=2.0, ranges=((4, 2),)),
          ShapeMix("off", weight=1.0, proofs=0)]


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
    saved = jax.enable_x64
    before = set(sys.modules)
    jax.enable_x64 = _x64
    try:
        from drynx_tpu.server import loadgen

        yield loadgen
    finally:
        jax.enable_x64 = saved
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name.startswith("drynx_tpu."):
                parent, _, attr = name.rpartition(".")
                sys.modules.pop(name)
                if hasattr(sys.modules.get(parent), attr):
                    delattr(sys.modules[parent], attr)


def _server(**kw):
    cl = SyntheticCluster(encode_s=0.0005, verify_s=0.002)
    kw.setdefault("max_batch", 4)
    kw.setdefault("tenant_quota", 64)
    srv = SurveyServer(cl, **kw)
    prewarm_shapes(srv, [synthetic_query(f"w-{s.name}", proofs=s.proofs,
                                         ranges=s.ranges)
                         for s in SHAPES])
    return cl, srv


# -- against the reference ----------------------------------------------------

@pytest.mark.parametrize("rate,duration,seed,bursts", [
    (50.0, 2.0, 7, ()), (40.0, 3.0, 1, ((1.0, 2.0, 5.0),)),
    (400.0, 0.8, 3, ((0.1, 0.2, 3.0), (0.5, 0.6, 0.5)))])
def test_poisson_schedule_equals_the_reference(ref, rate, duration, seed,
                                               bursts):
    mine = poisson_schedule(rate, duration, seed, bursts)
    assert mine == ref.poisson_schedule(rate, duration, seed, bursts)
    assert mine and all(0.0 < t < duration for t in mine)


def test_draw_sequence_equals_the_reference(ref):
    tenants = {"a": 1.0, "b": 3.0, "hot": 0.5}
    shapes = [(3.0, 1, ((4, 2),)), (1.0, 0, ((4, 2),)), (0.5, 1, ((4, 3),))]
    mine = LoadGen(types.SimpleNamespace(), tenants=tenants, seed=9,
                   shapes=[ShapeMix(f"s{i}", w, p, r)
                           for i, (w, p, r) in enumerate(shapes)])
    theirs = ref.LoadGen(types.SimpleNamespace(), tenants=tenants, seed=9,
                         shapes=[ref.ShapeMix(f"s{i}", w, p, r)
                                 for i, (w, p, r) in enumerate(shapes)])
    got = [(t, s.name) for t, s in map(mine._draw, range(200))]
    want = [(t, s.name) for t, s in map(theirs._draw, range(200))]
    assert got == want
    assert {t for t, _ in got} == set(tenants)


def test_fairness_ratio_equals_the_reference(ref):
    reps = [{"per_tenant": {"a": {"completed": 10}, "b": {"completed": 5},
                            "hot": {"completed": 400}}},
            {"per_tenant": {}},
            {"per_tenant": {"a": {"completed": 0}, "b": {"completed": 0}}}]
    for rep in reps:
        for names in (["a", "b"], ["a", "missing"], ["a", "b", "hot"],
                      []):
            assert fairness_ratio(rep, names) == ref.fairness_ratio(rep,
                                                                    names)
    assert fairness_ratio(reps[0], ["a", "b"]) == pytest.approx(0.5)


# -- the port's quick tier ---------------------------------------------------

def test_poisson_burst_episode_densifies_the_window():
    base = poisson_schedule(40.0, 3.0, seed=1)
    burst = poisson_schedule(40.0, 3.0, seed=1, bursts=((1.0, 2.0, 5.0),))
    in_win = len([t for t in burst if 1.0 <= t < 2.0])
    base_win = len([t for t in base if 1.0 <= t < 2.0])
    assert in_win > 2 * max(base_win, 1)
    pre = [t for t in burst if t < 1.0]
    assert pre == [t for t in base if t < 1.0][:len(pre)]


def test_open_loop_accounting_is_exact():
    cl, srv = _server(max_depth=64, workers=2)
    lg = LoadGen(srv, shapes=SHAPES, seed=5)
    rep = lg.run_open(150.0, 1.0)
    assert rep["offered"] == len(lg.records) > 0
    r = rep["rejected"]
    assert rep["offered"] == (rep["completed"] + rep["errors"]
                              + r["shed"] + r["quota"] + r["queue_full"]
                              + rep["lost"])
    assert rep["lost"] == 0
    assert rep["completed"] == cl.finalized
    assert rep["latency_s"]["p50"] <= rep["latency_s"]["p99"]
    assert sum(d["offered"] for d in rep["per_tenant"].values()) \
        == rep["offered"]


def test_open_loop_overload_sheds_typed_and_loses_nothing():
    cl, srv = _server(max_depth=8, workers=1)
    lg = LoadGen(srv, shapes=SHAPES, seed=3)
    rep = lg.run_open(400.0, 0.8)
    assert rep["rejected"]["shed"] > 0
    assert rep["lost"] == 0 and rep["errors"] == 0
    assert rep["admitted"] == rep["completed"]
    sheds = [r for r in lg.records if r.outcome == "shed"]
    assert all(r.retry_after_s > 0 and not r.admitted for r in sheds)


def test_closed_loop_completes_the_requested_total():
    cl, srv = _server(max_depth=32, workers=2)
    lg = LoadGen(srv, shapes=SHAPES, seed=11)
    rep = lg.run_closed(concurrency=8, n_total=60)
    assert rep["completed"] == 60 and rep["lost"] == 0
    assert rep["throughput_sps"] > 0
    assert cl.finalized == 60


def test_closed_loop_retries_rejections_as_fresh_attempts():
    cl, srv = _server(max_depth=2, workers=1)
    lg = LoadGen(srv, shapes=SHAPES, seed=2)
    rep = lg.run_closed(concurrency=8, n_total=24, max_backoff_s=0.02)
    assert rep["completed"] == 24 and rep["lost"] == 0
    rejected = sum(rep["rejected"].values())
    assert rejected > 0
    assert rep["offered"] == 24 + rejected
    assert len({r.survey_id for r in lg.records}) == rep["offered"]


def test_synthetic_cluster_transient_failure_is_resumed():
    cl = SyntheticCluster(encode_s=0.0, verify_s=0.0,
                          fail=frozenset({"f-0"}))
    srv = SurveyServer(cl, pipeline=False, tenant_quota=8)
    prewarm_shapes(srv, [synthetic_query("w")])
    srv.submit(synthetic_query("f-0"))
    res = srv.drain()
    assert res["f-0"] == "ok-f-0"
    assert cl.executed == 2 and cl.finalized == 1


def test_cold_shape_warms_in_the_compile_lane_under_load():
    """Without prewarm_shapes the first proofs-on shape goes through the
    compile lane (the registry's CPU entries: the tables), and the load
    still completes with nothing lost."""
    cl = SyntheticCluster(encode_s=0.0005, verify_s=0.001)
    srv = SurveyServer(cl, max_batch=4, tenant_quota=64, max_depth=32)
    lg = LoadGen(srv, shapes=SHAPES, seed=4)
    rep = lg.run_closed(concurrency=4, n_total=16)
    assert rep["completed"] == 16 and rep["lost"] == 0
    assert any(r.lane == "compile" for r in lg.records)
    assert srv.timers.spans("Compile.")
