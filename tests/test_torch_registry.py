"""The port's kernel warm-up registry (drynx_tpu_torch/compilecache) and
its CLI, on the CPU.

The intent of tests/test_precompile.py, restated for the port: entry names
are unique and well formed; a kernel entry for each kernel the cluster
survey launches (chip_smoke.py's phase-7 constant), each on distinct valid
operands; only the range base u names an entry of its own; `--list`
exits 0. (The reference's worker-op set went with its lower-only mode,
which the port does not have.) A CPU cluster's survey runs no warm-up.
The warm-up on a tiny CPU cluster builds its signature
tables once, on the calling thread, skips every kernel entry and leaves
the launch counters as they were. tests/test_torch_cluster.py holds the
registry against every launch of a real survey.
"""
import collections
import dataclasses
import importlib.util
import threading
from pathlib import Path

import pytest
import torch

from drynx_tpu_torch import compilecache as cc
from drynx_tpu_torch import precompile as cli
from drynx_tpu_torch.compilecache import registry as R
from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
from drynx_tpu_torch.proofs import range_proof as rp
from drynx_tpu_torch.service.service import LocalCluster
from drynx_tpu_torch.utils import cuda_build
from drynx_tpu_torch.utils.timers import PhaseTimers

ROOT = Path(__file__).resolve().parent.parent
KERNELS = set(cuda_ops.LAUNCHES) | set(cuda_pairing.LAUNCHES)
# the Pima cluster survey of chip_smoke.py's phase 7 (3 CNs, 10 DPs, 90
# values a DP, ranges (16, 5))
PIMA = cc.Profile(n_cns=3, n_dps=10, n_values=90, u=16, l=5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _names(p):
    return {e.name for e in cc.build_registry(p)}


@pytest.mark.parametrize("profile", [cc.BENCH, PIMA,
                                     cc.Profile(n_cns=2, n_dps=2, n_values=1,
                                                u=4, l=2)])
def test_names_unique_and_entries_well_formed(profile):
    entries = cc.build_registry(profile)
    names = [e.name for e in entries]
    assert len(names) == len(set(names))
    kinds = collections.Counter(e.kind for e in entries)
    assert kinds["library"] == len(R.LIBRARIES) == len(
        cuda_build.ENTRY_POINTS)
    assert kinds["table"] == 2
    assert kinds["kernel"] == len(R.KERNELS) == len(KERNELS) - 1
    for e in entries:
        assert e.name.startswith(f"{e.kind}:") and e.phase
        assert callable(e.call) and callable(e.dispatched)
        if e.kind == "kernel":
            assert e.kernel in KERNELS and e.kernel != "f12_pow"
            assert e.name == f"kernel:{e.kernel}"
    # cheap first: the libraries, then the tables, then the kernels
    order = [e.kind for e in entries]
    assert order == sorted(order, key=["library", "table",
                                       "kernel"].index)


def test_kernel_entries_are_the_kernels_the_cluster_survey_launches():
    """One entry a kernel that phase 7's proofs-on cluster survey launches
    (EXPECTED_LAUNCHES_CLUSTER): every kernel but the Fp12 power."""
    cs = _chip_smoke()
    launched = {k for k, v in cs.EXPECTED_LAUNCHES_CLUSTER.items() if v}
    assert {e.kernel for e in cc.build_registry(PIMA)
            if e.kind == "kernel"} == launched == set(R.KERNELS)


@pytest.mark.parametrize("field,value", [("n_cns", 5), ("n_dps", 3),
                                         ("n_values", 90), ("l", 3),
                                         ("u", 4)])
def test_only_the_range_base_names_an_entry_of_its_own(field, value):
    """A survey's kernels and libraries do not depend on its shape; the
    signature tables depend on its base u only."""
    grown = _names(dataclasses.replace(cc.BENCH, **{field: value}))
    base = _names(cc.BENCH)
    if field == "u":
        assert base - grown == {"table:range_sigs@u16"}
        assert grown - base == {"table:range_sigs@u4"}
    else:
        assert grown == base


@pytest.mark.parametrize("kernel", sorted(KERNELS - {"f12_pow"}))
def test_kernel_entries_launch_on_distinct_valid_operands(kernel):
    """Each kernel entry's operands are valid group elements, distinct
    from row to row and between a launch's operands (a point added to
    itself takes the doubling branch only)."""
    from drynx_tpu_torch.crypto import curve as C
    from drynx_tpu_torch.crypto import g2 as G2
    from drynx_tpu_torch.crypto import refimpl

    args, _ = R._kernel_inputs(kernel, torch.device("cpu"), 4)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if kernel == "fixed_base_mul":
        tensors = tensors[1:]                  # the shared table
    for t in tensors:
        flat = t.reshape(t.shape[0], -1)
        assert len({tuple(r.tolist()) for r in flat}) == flat.shape[0]
    if len(tensors) == 2 and tensors[0].shape == tensors[1].shape:
        assert not torch.equal(tensors[0], tensors[1])
    pools = R._operand_pools()
    assert all(refimpl.g1_is_on_curve(p) for p in C.to_ref(pools["g1"]))
    assert all(refimpl.g2_is_on_curve(p) for p in G2.to_ref(pools["g2"]))
    if kernel == "point_add":
        got = C.to_ref(cuda_ops.point_add_flat(*args))
        want = [refimpl.g1_add(p, q) for p, q in zip(C.to_ref(args[0]),
                                                     C.to_ref(args[1]))]
        assert got == want


def test_list_exits_zero(capsys):
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "library:g1_ops" in out and "table:range_sigs@u16" in out
    assert "kernel:miller" in out
    assert out.strip().splitlines()[-1].startswith("-- ")


def test_cli_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--quiet"]) == 2
    assert cli.main(["--cpu", "--quiet"]) == 0


@pytest.mark.parametrize("flag", ["--dlog-limit", "--buckets", "--queue",
                                  "--noise", "--panes", "--n-cns",
                                  "--values", "--range-u", "--range-l"])
def test_cli_has_no_profile_flag(flag):
    # without a cluster the CLI drives the same entries for every shape;
    # of the reference's fields, the decryption table is the cluster's, a
    # grid's tiles are host work, and the cross flush, the DRO phase and a
    # stream launch the survey's kernels: none names an entry
    with pytest.raises(SystemExit) as exc:
        cli.main(["--list", flag, "8"])
    assert exc.value.code == 2


def test_cluster_warm_up_runs_on_the_card_only():
    """A CPU cluster's survey does not run the registry (a CPU cluster is
    warmed by calling precompile with it)."""
    cl = LocalCluster(n_cns=1, n_dps=1, n_vns=1, seed=2, dlog_limit=4,
                      device="cpu")
    try:
        sq = cl.generate_survey_query("sum", 0, 3, proofs=1,
                                      ranges=[(4, 1)])
        tm = PhaseTimers()
        mark = cc.COLD_EVENTS.mark()
        cl._warm_kernels(tm, sq.query)
        assert "PrecompileTraceExec" not in dict(tm.items())
        assert cc.COLD_EVENTS.since(mark) == [] and cl.range_sigs == {}
    finally:
        cl.close()


def test_warm_up_on_a_cpu_cluster_builds_its_tables_once():
    cl = LocalCluster(n_cns=1, n_dps=1, n_vns=1, seed=2, dlog_limit=4,
                      device="cpu")
    try:
        sq = cl.generate_survey_query("sum", 0, 3, proofs=1,
                                      ranges=[(4, 1)])
        p = cc.query_profile(cl, sq.query)
        assert (p.n_cns, p.n_dps, p.n_values, p.u, p.l) == (1, 1, 1, 4, 1)
        before = ({**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES},
                  dict(cuda_build.LAUNCH_ROWS))
        builds = dict(rp.SIG_BUILD_COUNTS)
        runs = []
        for _ in range(2):
            mark = cc.COLD_EVENTS.mark()
            st = cc.precompile(p, cluster=cl, stats=cc.CompileStats(),
                               log=lambda m: None)
            runs.append((st, cc.COLD_EVENTS.since(mark)))
        (first, ev1), (second, ev2) = runs
        for st in (first, second):
            assert st.rows["table:range_sigs@u4"]["status"] == "executed"
            assert st.count("error") == 0
            assert all(r["status"] == "skipped"
                       for n, r in st.rows.items()
                       if n.startswith(("kernel:", "library:")))
        # built once: the second pass finds the tables
        assert rp.SIG_BUILD_COUNTS["pow_table"] == builds["pow_table"] + 1
        assert ("table", "sig_gt_pow_tables",
                threading.current_thread().name) in ev1
        assert {t for _, _, t in ev1} == {threading.current_thread().name}
        assert ev2 == []
        assert ({**cuda_ops.LAUNCHES, **cuda_pairing.LAUNCHES},
                dict(cuda_build.LAUNCH_ROWS)) == before
    finally:
        cl.close()


def test_uncounted_launches_go_to_their_sink_only():
    launches = {"k": 0}
    cuda_build.reset_launch_rows()
    sink = collections.Counter()
    with cuda_build.uncounted(sink):
        assert not cuda_build.counting()
        cuda_build.count(launches, "k", 5)
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            cuda_build.counting()))
        t.start()
        t.join()
    assert seen == [True]          # other threads count as before
    assert cuda_build.counting()
    cuda_build.count(launches, "k", 7)
    assert sink == {("k", 5): 1}
    assert launches == {"k": 1}
    assert dict(cuda_build.LAUNCH_ROWS) == {"k": {7: 1}}
    cuda_build.reset_launch_rows()


def test_stats_table_and_totals():
    st = cc.CompileStats()
    st.record("library:g1_ops", "loaded", 0.5, cached=True)
    st.record("kernel:miller@8", "executed", 0.25)
    st.record("kernel:f12_mul@8", "error", 0.0, detail="KernelError: x")
    st.add_launches({("miller", 8): 1})
    t = st.totals()
    assert (t["entries"], t["loaded"], t["executed"], t["errors"],
            t["cached_libraries"], t["launches"]) == (3, 1, 1, 1, 1, 1)
    table = st.table()
    assert "KernelError: x" in table and table.splitlines()[-1].startswith(
        "-- 3 entries")
