"""The port's static analyzer (drynx_tpu_torch/analysis) against the
reference's (drynx_tpu/analysis), on the CPU.

* Rule parity: every source string of the reference analyzer's own tests
  goes through both analyzers, under ``drynx_tpu/...`` for the reference
  and ``drynx_tpu_torch/...`` for the port, and every rule the port keeps
  gives the same findings (rule, line, message modulo the package prefix).
* Goldens: on tests/fixtures/lintpkg the port's engines reproduce the
  reference's goldens; the graph's and the SARIF log's differences are the
  launch entries and the adapted and replaced rules, stated below.
* The adapted and new rules fire on a violation, stay silent on the fixed
  form and honour ``noqa``; every scoped rule fires on a drynx_tpu_torch/
  path and on no path outside the package.
* The tree: one CLI pass over drynx_tpu_torch/ in a fresh interpreter
  exits 0, with torch, jax and drynx_tpu never imported.

No wall-clock budget is asserted: the pass's time is printed.
"""
import ast
import io
import json
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import pytest

from drynx_tpu import analysis as ref
from drynx_tpu_torch import analysis as port
from drynx_tpu_torch.analysis import cli as port_cli
from drynx_tpu_torch.analysis import rules as port_rules

REPO_ROOT = port.REPO_ROOT
TESTS = REPO_ROOT / "tests"
FIXTURE = TESTS / "fixtures" / "lintpkg"
REFERENCE_TESTS = ("test_analysis_rules.py", "test_dataflow.py",
                   "test_concurrency_analysis.py",
                   "test_determinism_analysis.py",
                   "test_typestate_analysis.py", "test_static_analysis.py")
# where a case is placed inside each package: every scope a rule knows
PLACES = ("crypto/synthetic.py", "proofs/synthetic.py",
          "parallel/synthetic.py", "service/synthetic.py",
          "resilience/synthetic.py", "network/synthetic.py",
          "proofs/safe_pickle.py", "server/transcript.py")

KEPT = sorted(r for r, rule in port.RULES.items() if rule.group == "kept")


def _cases():
    """(id, source) for every multi-line string constant of the reference
    analyzer's tests that parses as Python and calls something."""
    out = []
    for name in REFERENCE_TESTS:
        for node in ast.walk(ast.parse((TESTS / name).read_text())):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str) and "\n" in node.value):
                continue
            src = textwrap.dedent(node.value)
            try:
                tree = ast.parse(src)
            except SyntaxError:
                continue
            if any(isinstance(n, ast.Call) for n in ast.walk(tree)):
                out.append((f"{name[:-3]}:{node.lineno}", src))
    return out


CASES = _cases()


def _findings(pkg, relpath, src):
    """What analyze_project reports for a one-file project, from a
    source string: the per-module and project rules of the KEPT set,
    suppressions and absorption applied."""
    project = pkg.ProjectInfo.from_sources([(relpath, src)])
    mod = project.modules[relpath]
    found = []
    for rid in KEPT:
        rule = pkg.RULES[rid]
        found.extend(rule.run(mod))
        if rule.project:
            found.extend(rule.run_project(project))
    found = [f for f in found
             if not pkg.core.suppressed_at(f, project.modules)]
    winners = {(f.file, f.line) for f in found
               if f.rule == "secret-flow-to-sink"}
    found = [f for f in found if not (f.rule == "secret-logging"
                                      and (f.file, f.line) in winners)]
    return sorted((f.rule, f.line, f.message.replace(
        "drynx_tpu_torch/", "drynx_tpu/").replace("drynx_tpu_torch.",
                                                  "drynx_tpu."))
                  for f in found)


def test_the_reference_tests_give_the_parity_cases():
    assert len(CASES) >= 100, len(CASES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kept_rules_give_the_reference_findings(case):
    _, src = case
    for place in PLACES:
        want = _findings(ref, f"drynx_tpu/{place}", src)
        got = _findings(port, f"drynx_tpu_torch/{place}", src)
        assert got == want, place
    # a case outside both packages is the scoped rules' negative
    assert _findings(port, f"elsewhere/{PLACES[0]}", src) == \
        _findings(ref, f"elsewhere/{PLACES[0]}", src)


def test_every_reference_rule_has_one_group():
    groups = {}
    for rid, rule in port.RULES.items():
        key = rule.replaces or rid
        groups.setdefault(key, []).append(rule.group)
    for rid in port_rules.NOT_APPLICABLE:
        groups.setdefault(rid, []).append("n/a")
    assert set(groups) == set(ref.RULES), set(groups) ^ set(ref.RULES)
    assert all(len(g) == 1 for g in groups.values()), groups
    assert port.RULES["cuda-launch-operand"].replaces == \
        "pallas-operand-dtype"
    assert port.RULES["thread-build"].replaces == "thread-trace"
    assert sorted(port_rules.NOT_APPLICABLE) == [
        "cross-module-flag-capture", "env-read-into-trace",
        "jit-global-capture"]


def test_list_rules_prints_every_group_and_reason():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert port_cli.main(["--list-rules"]) == 0
    text = buf.getvalue()
    for rid, rule in port.RULES.items():
        line = next(x for x in text.splitlines() if f"  {rid} " in x)
        assert f"({rule.group}" in line, line
    for rid, why in port_rules.NOT_APPLICABLE.items():
        assert f"  {rid} (n/a): {why}" in text
    assert "(replaced: pallas-operand-dtype)" in text


# -- goldens over the fixture package ------------------------------------------

@pytest.fixture(scope="module")
def fixture_pass():
    findings = port.analyze_project([FIXTURE])
    project, errors = port.ProjectInfo.from_paths([FIXTURE])
    assert errors == []
    return findings, project


def _golden(name):
    return json.loads((TESTS / "fixtures" / name).read_text())


RULE_SETS = {
    "lintpkg_concurrency.json": {"unguarded-shared-mutation",
                                 "lock-order-inversion",
                                 "blocking-call-under-lock"},
    "lintpkg_determinism.json": {"nondet-flow-to-transcript",
                                 "unordered-iteration-at-sink"},
    "lintpkg_typestate.json": {"atomic-durable-write",
                               "slab-consumption-order",
                               "conn-checkout-discipline",
                               "seal-commit-once"},
}


@pytest.mark.parametrize("golden", sorted(RULE_SETS))
def test_fixture_findings_equal_the_reference_golden(fixture_pass, golden):
    findings, _ = fixture_pass
    got = [f.to_json() for f in findings if f.rule in RULE_SETS[golden]]
    got.sort(key=lambda f: (f["file"], f["line"], f["rule"]))
    assert got == _golden(golden)


@pytest.mark.parametrize("golden, rule, line", [
    ("lintpkg_cycle_codeflow.json", "lock-order-inversion", None),
    ("lintpkg_det_codeflow.json", "nondet-flow-to-transcript", 34),
    ("lintpkg_proto_codeflow.json", "seal-commit-once", None)])
def test_fixture_codeflows_equal_the_reference_golden(fixture_pass, golden,
                                                       rule, line):
    findings, _ = fixture_pass
    results = [r for r in port.to_sarif(findings)["runs"][0]["results"]
               if r["ruleId"] == rule and (line is None or r["locations"][0][
                   "physicalLocation"]["region"]["startLine"] == line)]
    assert len(results) == 1
    assert results[0]["codeFlows"] == _golden(golden)


def test_fixture_summaries_equal_the_reference_golden(fixture_pass):
    _, project = fixture_pass
    assert port.dataflow_for(project).summaries_json(
        "tests.fixtures.lintpkg.dataflow") == _golden("lintpkg_dataflow.json")


def test_fixture_graph_differs_from_the_golden_by_its_entries(fixture_pass):
    """The imports and the callgraph are the reference's; the reference's
    traced entries (jit functions, functions that build a pallas_call) have no
    counterpart, and the fixture reaches no cuda_build.launch, so the
    port's launch entries are empty."""
    _, project = fixture_pass
    got, want = project.to_json(), _golden("lintpkg_graph.json")
    assert got["imports"] == want["imports"]
    assert got["callgraph"] == want["callgraph"]
    assert want["traced_entries"] and got["launch_entries"] == []


def test_fixture_sarif_differs_from_the_golden_by_the_jax_rules(
        fixture_pass):
    """The SARIF log is the reference's without the results of the rules
    whose subject is JAX: the n/a cross-module-flag-capture, the replaced
    pallas-operand-dtype, and the adapted host-sync-in-hot-path and
    ciphertext-dtype-launder, whose fixture sinks are a jit entry and a
    jit kernel. Rule indices shift with the rule list."""
    findings, _ = fixture_pass
    jax_rules = {"cross-module-flag-capture", "pallas-operand-dtype",
                 "host-sync-in-hot-path", "ciphertext-dtype-launder"}
    want = _golden("lintpkg_sarif.json")["runs"][0]["results"]

    def strip(rs):
        return [{k: v for k, v in r.items() if k != "ruleIndex"} for r in rs]

    got = port.to_sarif(findings)["runs"][0]["results"]
    assert strip(got) == strip([r for r in want
                                if r["ruleId"] not in jax_rules])
    assert {r["ruleId"] for r in want} - {r["ruleId"] for r in got} \
        == jax_rules


# -- the adapted and new rules ---------------------------------------------------

CRYPTO = "drynx_tpu_torch/crypto/synthetic.py"
SERVICE = "drynx_tpu_torch/service/synthetic.py"


def run(src, relpath=CRYPTO, rule=None):
    return port.analyze_source(textwrap.dedent(src), relpath,
                               rules=[rule] if rule else None)


def run_project(files, rule):
    project = port.ProjectInfo.from_sources(
        [(rel, textwrap.dedent(src)) for rel, src in files])
    found = port.RULES[rule].run_project(project)
    return [f for f in found
            if not port.core.suppressed_at(f, project.modules)]


def test_implicit_dtype_flags_torch_ctors_without_dtype():
    src = """
        import torch
        a = torch.zeros((4, 16))
        b = torch.tensor([1, 2])
        c = torch.as_tensor(x)
        ok = torch.zeros((4, 16), dtype=torch.int32)
        like = torch.zeros_like(ok)
        quiet = torch.empty(3)  # drynx: noqa[implicit-dtype]
    """
    found = run(src, rule="implicit-dtype")
    assert [f.line for f in found] == [3, 4, 5]
    assert run(src, "drynx_tpu_torch/service/x.py", "implicit-dtype") == []


ROUNDTRIP = """
    import numpy as np
    import torch
    def nested(x, dev):
        return torch.as_tensor(np.asarray(x), device=dev)
    def staged(x, dev):
        return torch.from_numpy(np.asarray(x)).to(dev)
    def two_steps(x, dev):
        v = torch.from_numpy(x)
        return v.cuda()
    def cast_on_host(x):
        return torch.from_numpy(x).to(torch.int32)
    def direct(d, dev):
        return unpack_array_device(d, dev)
    def marked(x, dev):
        return torch.from_numpy(x).to(dev)  # drynx: noqa[host-roundtrip-in-decode]
"""


def test_host_roundtrip_flags_the_torch_forms_in_service():
    found = run(ROUNDTRIP, SERVICE, "host-roundtrip-in-decode")
    assert [f.line for f in found] == [5, 7, 10]
    assert run(ROUNDTRIP, CRYPTO, "host-roundtrip-in-decode") == []


HOST_SYNC = """
    import torch
    from drynx_tpu_torch.utils import cuda_build

    def _launch(out, inputs):
        cuda_build.launch("g1_ops", "g1_point_add", out, inputs, (1,))
        return out

    def wrapper(p, q, n: int = 4, cyc: bool = False):
        out = torch.empty((len(p), 3, 16), dtype=torch.int32, device=p.device)
        k = int(p.shape[0]) + int(n) + int(cyc)
        return _launch(out, (p, q))

    def readback(p, q):
        r = wrapper(p, q)
        return _total(r)

    def _total(r):
        return r.sum().item()

    def marked(p, q):  # drynx: noqa[host-sync-in-hot-path]
        return bool(wrapper(p, q).all())

    def barrier(p, q):
        wrapper(p, q)
        torch.cuda.synchronize()
"""


def test_host_sync_follows_the_callgraph_out_of_launch_entries():
    found = run_project([(CRYPTO, HOST_SYNC)], "host-sync-in-hot-path")
    assert sorted((f.line, f.call_chain[-1].rsplit(":", 1)[-1])
                  for f in found) == [(19, ".item()"),
                                      (26, "torch.cuda.synchronize()")]
    item = next(f for f in found if f.line == 19)
    assert item.call_chain[0].endswith(":readback")
    assert run_project([(SERVICE, HOST_SYNC)], "host-sync-in-hot-path") == []


LAUNDER = """
    import torch
    from drynx_tpu_torch.utils import cuda_build

    def _launch(out, inputs):
        cuda_build.launch("g1_ops", "g1_point_add", out, inputs, (1,))
        return out

    def wrapper(p, q):
        cuda_build.check_operands(("p", p), ("q", q))
        return _launch(torch.empty_like(p), (p, q))

    def laundered(p, q):
        a = p.to(torch.int32)
        b = a.float() / 2
        return wrapper(b, q)

    def repinned(p, q):
        a = p.to(torch.int32)
        b = (a.float() / 2).to(torch.int32)
        return wrapper(b, q)

    def serialized(p):
        a = torch.as_tensor(p, dtype=torch.int32)
        return a.double().numpy().tobytes()

    def marked(p, q):
        b = p.int().float()  # drynx: noqa[ciphertext-dtype-launder]
        return wrapper(b, q)  # drynx: noqa[ciphertext-dtype-launder]
"""


def test_ciphertext_launder_reaches_the_wrapper_or_serialization():
    found = run_project([(CRYPTO, LAUNDER)], "ciphertext-dtype-launder")
    assert [f.line for f in found] == [16, 25]
    assert "kernel wrapper 'wrapper'" in found[0].message
    assert any(".float()" in hop for hop in found[0].call_chain)


LAUNCH_OK = """
    import torch
    from drynx_tpu_torch.utils import cuda_build

    ENTRY_POINTS = {}

    def _launch(entry, out, inputs, ints):
        cuda_build.launch("g1_ops", entry, out, inputs, ints)
        return out

    def _empty(n, device):
        return torch.empty((n, 3, 16), dtype=torch.int32, device=device)

    def _checked(name, a):
        cuda_build.check_operands((name, a))

    def add(p, q):
        device = cuda_build.check_operands(("p", p), ("q", q))
        return _launch("g1_point_add", _empty(len(p), device),
                       (p, q.contiguous()), (len(p),))

    def reduce(pts):
        _checked("pts", pts)
        return _launch("g1_point_reduce", _empty(pts.shape[1], pts.device),
                       (torch.stack([pts[0], pts[1]]),),
                       (pts.shape[0], pts.shape[1]))
"""
TABLE = """
    ENTRY_POINTS = {
        "g1_ops": {"g1_point_add": (3, 1), "g1_point_reduce": (2, 2)},
    }
    def launch(name, entry, out, inputs, ints):
        pass
"""
BUILD = "drynx_tpu_torch/utils/cuda_build.py"


def test_cuda_launch_operand_proves_checked_and_pinned_operands():
    assert run_project([(CRYPTO, LAUNCH_OK), (BUILD, TABLE)],
                       "cuda-launch-operand") == []


@pytest.mark.parametrize("edit, what", [
    ('_empty(len(p), device),', "float out"),
    ('(p, q.contiguous()), (len(p),))', "unchecked input"),
    ('(pts.shape[0], pts.shape[1]))', "int count"),
    ('"g1_point_add", _empty', "unknown entry"),
])
def test_cuda_launch_operand_fires(edit, what):
    bad = {
        "float out": ('_empty(len(p), device),',
                      'torch.empty((len(p), 3, 16), device=device),'),
        "unchecked input": ('(p, q.contiguous()), (len(p),))',
                            '(p, r.contiguous()), (len(p),))'),
        "int count": ('(pts.shape[0], pts.shape[1]))', '(pts.shape[0],))'),
        "unknown entry": ('"g1_point_add", _empty', '"g1_point_sub", _empty'),
    }[what]
    src = LAUNCH_OK.replace(*bad)
    if what == "unchecked input":
        src = src.replace("def add(p, q):", "def add(p, q, r):")
    found = run_project([(CRYPTO, src), (BUILD, TABLE)],
                        "cuda-launch-operand")
    assert len(found) == 1, [f.render() for f in found]
    message = found[0].message
    expect = {"float out": "out of a launch of 'g1_point_add'",
              "unchecked input": "input 1 of a launch of 'g1_point_add'",
              "int count": "passes 2 pointers and 1 ints",
              "unknown entry": "'g1_ops.g1_point_sub' is not an entry point"}
    assert expect[what] in message, message
    # suppressible at the launch site (the finding's anchor)
    quiet = src.replace('cuda_build.launch("g1_ops", entry, out, inputs, ints)',
                        'cuda_build.launch("g1_ops", entry, out, inputs, '
                        'ints)  # drynx: noqa[cuda-launch-operand]')
    assert run_project([(CRYPTO, quiet), (BUILD, TABLE)],
                       "cuda-launch-operand") == []


THREAD = """
    import threading
    from drynx_tpu_torch.utils import cuda_build

    def survey():
        return cuda_build.load("g1_ops")

    def worker():
        survey()

    def locked_worker(lock):
        with lock:
            survey()

    def start():
        threading.Thread(target=worker).start()
        threading.Thread(target=locked_worker).start()
        threading.Thread(target=lambda: survey()).start()
"""
BUILDER = """
    def load(name):
        return build(name)

    def build(name):
        pass
"""


def test_thread_build_fires_on_a_thread_that_reaches_a_build():
    found = run_project([(SERVICE, THREAD), (BUILD, BUILDER)], "thread-build")
    assert [f.line for f in found] == [16, 18]
    assert found[0].call_chain[-1].endswith(":load")
    # the warm-up registry's threads are exempt
    assert run_project([("drynx_tpu_torch/compilecache/x.py", THREAD),
                        (BUILD, BUILDER)], "thread-build") == []
    quiet = THREAD.replace("def worker():",
                           "def worker():  # drynx: noqa[thread-build]")
    assert [f.line for f in run_project(
        [(SERVICE, quiet), (BUILD, BUILDER)], "thread-build")] == [18]


# -- every scoped rule fires on a drynx_tpu_torch/ path --------------------------

SCOPED = {
    "implicit-dtype": ("crypto", "import torch\nx = torch.zeros(3)\n"),
    "host-roundtrip-in-decode": (
        "service", "import numpy as np\nimport torch\n"
        "x = torch.as_tensor(np.asarray(y))\n"),
    "hardcoded-timeout": ("service", "f(timeout=5)\n"),
    "host-sync-in-hot-path": ("crypto", HOST_SYNC),
    "ciphertext-dtype-launder": ("crypto", LAUNDER),
    "secret-flow-to-sink": (
        "service", "import secrets\nimport logging\nlog = logging.getLogger()"
        "\ndef f():\n    k = secrets.randbelow(7)\n    log.info('%d', k)\n"),
    "thread-build": ("service", THREAD),
    "cuda-launch-operand": ("crypto", LAUNCH_OK.replace(
        "(p, q.contiguous())", "(p, p.float())")),
}
# the engines' rules: the lintpkg fixture's module of each engine holds a
# violation of every one of its rules
for _name, _rules in (("concurrency.py", ("unguarded-shared-mutation",
                                          "lock-order-inversion",
                                          "blocking-call-under-lock")),
                      ("determinism.py", ("nondet-flow-to-transcript",
                                          "unordered-iteration-at-sink")),
                      ("typestate.py", ("atomic-durable-write",
                                        "slab-consumption-order",
                                        "conn-checkout-discipline",
                                        "seal-commit-once"))):
    for _rule in _rules:
        SCOPED[_rule] = ("service", (FIXTURE / _name).read_text())


# ciphertext-dtype-launder's scope is crypto/ and parallel/ wherever they
# lie, as the reference's is: its negative is the same file in service/
OUTSIDE = {"ciphertext-dtype-launder": "drynx_tpu_torch/service"}


@pytest.mark.parametrize("rule", sorted(SCOPED))
def test_scoped_rule_fires_on_the_port_path_only(rule):
    scope, src = SCOPED[rule]
    helper = TABLE if rule == "cuda-launch-operand" else BUILDER

    def found(where):
        files = [(f"{where}/synthetic.py", src),
                 (f"{where.split('/')[0]}/utils/cuda_build.py", helper)]
        project = port.ProjectInfo.from_sources(
            [(rel, textwrap.dedent(s)) for rel, s in files])
        r = port.RULES[rule]
        out = list(r.run_project(project)) if r.project else \
            list(r.run(project.modules[files[0][0]]))
        return [f for f in out if f.file == files[0][0]]

    assert found(f"drynx_tpu_torch/{scope}"), rule
    assert found(OUTSIDE.get(rule, f"elsewhere/{scope}")) == [], rule


# -- the tree ----------------------------------------------------------------------

_TREE_CHILD = """\
import json, sys, time
import drynx_tpu_torch.analysis
loaded = sorted({m.split(".")[0] for m in sys.modules} &
                {"torch", "jax", "drynx_tpu"})
from drynx_tpu_torch.analysis.cli import main
t0 = time.perf_counter()
rc = main(sys.argv[1:])
seconds = time.perf_counter() - t0
loaded_after = sorted({m.split(".")[0] for m in sys.modules} &
                      {"torch", "jax", "drynx_tpu"})
# the same pass's concurrency engine (memoized on the tree's content)
from drynx_tpu_torch.analysis import (REPO_ROOT, ProjectInfo,
                                      concurrency_for, crosscheck)
project, _ = ProjectInfo.from_paths([REPO_ROOT / "drynx_tpu_torch"])
cc = concurrency_for(project)
print(json.dumps({"rc": rc, "seconds": seconds, "loaded_at_import": loaded,
                  "loaded": loaded_after,
                  "locks": sorted({d.lock_id for d in cc.lock_defs.values()}),
                  "edges": sorted(cc.named_lock_edges()),
                  "crosscheck_edges": sorted(crosscheck.static_lock_edges())}))
"""


@pytest.fixture(scope="module")
def tree_pass():
    proc = subprocess.run(
        [sys.executable, "-c", _TREE_CHILD, "--format", "json"],
        cwd=str(REPO_ROOT), capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    # the CLI prints its report, then the child its line
    report = json.loads("\n".join(lines[:-1]))
    return proc, report, json.loads(lines[-1])


def test_the_port_tree_is_clean(tree_pass):
    proc, report, meta = tree_pass
    print(f"whole-tree pass over drynx_tpu_torch/: {meta['seconds']:.2f} s")
    assert proc.returncode == 0, proc.stderr
    assert meta["rc"] == 0
    assert report["findings"] == [], report["findings"]
    assert report["stale_baseline_entries"] == []


def test_the_analyzer_imports_no_framework(tree_pass):
    _, _, meta = tree_pass
    assert meta["loaded_at_import"] == []
    assert meta["loaded"] == []


def test_the_port_baseline_is_its_own_file():
    assert port_cli.DEFAULT_BASELINE == \
        REPO_ROOT / "drynx_tpu_torch" / "analysis" / "lint_baseline.json"
    entries = port.load_baseline(port_cli.DEFAULT_BASELINE)
    assert all(e.why for e in entries)


def test_the_static_lock_graph_is_the_ports(tree_pass):
    _, _, meta = tree_pass
    names = set(meta["locks"])
    for absent in ("compile_lock", "pairing_build_lock",
                   "proofdb_build_lock", "sig_count_lock"):
        assert absent not in names, absent
    for new in ("cold_events_lock", "node_sigs_lock", "node_tables_lock",
                "vn_missed_lock"):
        assert new in names, new
    edges = [tuple(e) for e in meta["edges"]]
    assert ("scheduler_lock", "scheduler_results_lock") in edges
    assert meta["crosscheck_edges"] == meta["edges"]
