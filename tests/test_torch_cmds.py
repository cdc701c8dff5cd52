"""The port's CLIs (`drynx_tpu_torch/cmd/`) against the reference's.

`toml_io.dumps` gives the reference's bytes on every config the client
pipeline builds (network new, add-node, set-client, survey new, with and
without log_reg's section) and each package parses the other's; the
pipeline's stages pass their config through stdin and stdout as the
shell scenarios under test/ pipe them; and the proofs-off scenario of
test/client_run-survey (1 CN, 2 DPs holding 1..5 and 10..14) runs as
`python -m drynx_tpu_torch.cmd.server run --cpu` processes driven by
`python -m drynx_tpu_torch.cmd.client survey run --cpu`: the sum is 75,
and every server's listening line names its device. The `--local`
survey and `--serve 2` (an in-process LocalCluster on the CPU) are under
`slow`.
"""
import io
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from drynx_tpu.cmd import toml_io as JTOML
from drynx_tpu_torch.cmd import client as TC
from drynx_tpu_torch.cmd import server as TS
from drynx_tpu_torch.cmd import toml_io as TTOML

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _stage(main, argv, stdin_text="", monkeypatch=None):
    """One pipeline stage in-process: argv, stdin -> (rc, stdout)."""
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin_text))
    monkeypatch.setattr(sys, "stdout", out)
    rc = main(argv)
    monkeypatch.undo()
    return rc, out.getvalue()


def _pipeline_configs(monkeypatch):
    """Every config the client pipeline builds, stage by stage."""
    texts = []
    _, t = _stage(TC.main, ["network", "new"], "", monkeypatch)
    texts.append(t)
    for role, addr, name in (("cn", "127.0.0.1:7001", "cn0"),
                             ("dp", "127.0.0.1:7002", None),
                             ("vn", "127.0.0.1:7003", "vn0")):
        argv = ["network", "add-node", "--role", role, "--address", addr,
                "--public", "0x1f,0x2e"]
        if name:
            argv += ["--name", name]
        _, t = _stage(TC.main, argv, t, monkeypatch)
        texts.append(t)
    _, t = _stage(TC.main, ["network", "set-client"], t, monkeypatch)
    texts.append(t)
    _, plain = _stage(TC.main, ["survey", "new", "--operation", "sum",
                                "--min", "0", "--max", "20", "--proofs"],
                      t, monkeypatch)
    texts.append(plain)
    _, op = _stage(TC.main, ["survey", "set-operation", "--operation",
                             "mean"], plain, monkeypatch)
    texts.append(op)
    _, lr = _stage(TC.main, ["survey", "new", "--operation", "log_reg",
                             "--lr-features", "8", "--lr-records", "768",
                             "--lr-step", "0.05"], t, monkeypatch)
    texts.append(lr)
    _, gen = _stage(TS.main, ["gen", "--address", "127.0.0.1:7009",
                              "--name", "dp7"], "", monkeypatch)
    texts.append(gen)
    return texts


def test_toml_dumps_equals_the_references_on_the_pipelines_configs(
        monkeypatch):
    texts = _pipeline_configs(monkeypatch)
    for text in texts:
        cfg = TTOML.loads(text)
        assert cfg == JTOML.loads(text)
        assert TTOML.dumps(cfg) == JTOML.dumps(cfg) == text
    cfg = TTOML.loads(texts[-2])
    assert cfg["survey"]["lr"] == {
        "features": 8, "records": 768, "k": 2, "precision": 100.0,
        "iterations": 25, "step": 0.05, "lambda": 1.0}
    assert [n["name"] for n in cfg["nodes"]] == ["cn0", "dp1", "vn0"]
    assert TTOML.loads(texts[-3])["survey"]["operation"] == "mean"
    node = TTOML.loads(texts[-1])["node"]
    assert (node["name"], node["port"]) == ("dp7", 7009)
    assert int(node["public_x"], 16) > 0
    with pytest.raises(TypeError):
        TTOML.dumps({"t": [{"a": {"nested": 1}}]})


def test_the_lr_section_is_required_for_log_reg():
    with pytest.raises(SystemExit, match="lr section"):
        TC._lr_params_of({"operation": "log_reg"})
    p = TC._lr_params_of({"lr": {"features": 8, "records": 768}})
    assert (p.n_features, p.n_records, p.num_coeffs()) == (8, 768, 90)


def _port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_client_run_survey_scenario_as_cpu_processes(tmp_path,
                                                     monkeypatch):
    """test/client_run-survey through the port's entry points: three
    `server run --cpu` processes on the configs `server gen` wrote, the
    roster built by the client pipeline's stages, `survey run --cpu`:
    1+...+5 + 10+...+14 = 75. (The gen and client stages run in this
    process; the servers are processes of their own.)"""
    server = [sys.executable, "-m", "drynx_tpu_torch.cmd.server"]
    names = ("cn0", "dp1", "dp2")
    addrs, procs, logs = {}, {}, {}
    for name in names:
        addrs[name] = f"127.0.0.1:{_port()}"
        _, out = _stage(TS.main, ["gen", "--address", addrs[name],
                                  "--name", name], "", monkeypatch)
        (tmp_path / f"{name}.toml").write_text(out)
    np.savetxt(tmp_path / "dp1.data", np.arange(1, 6), fmt="%d")
    np.savetxt(tmp_path / "dp2.data", np.arange(10, 15), fmt="%d")
    try:
        for name in names:
            extra = (["--data", str(tmp_path / f"{name}.data")]
                     if name.startswith("dp") else [])
            logs[name] = open(tmp_path / f"{name}.log", "w")
            procs[name] = subprocess.Popen(
                server + ["run", "--cpu"] + extra,
                stdin=open(tmp_path / f"{name}.toml"), stderr=logs[name],
                stdout=subprocess.DEVNULL, env=_env())
        cfg = ""
        _, cfg = _stage(TC.main, ["network", "new"], "", monkeypatch)
        for name in names:
            node = TTOML.loads((tmp_path / f"{name}.toml").read_text())
            pub = f"{node['node']['public_x']},{node['node']['public_y']}"
            _, cfg = _stage(TC.main, [
                "network", "add-node", "--role", name[:2], "--address",
                addrs[name], "--name", name, "--public", pub], cfg,
                monkeypatch)
        _, cfg = _stage(TC.main, ["survey", "new", "--operation", "sum",
                                  "--min", "0", "--max", "20"], cfg,
                        monkeypatch)
        deadline = time.time() + 120
        lines = {}
        while len(lines) < len(names) and time.time() < deadline:
            for name in names:
                text = (tmp_path / f"{name}.log").read_text()
                if "listening" in text:
                    lines[name] = text.strip().splitlines()[-1]
            time.sleep(0.05)
        for name in names:
            assert lines[name] == (f"drynx node {name} listening on "
                                   f"{addrs[name]} device cpu")
        rc, out = _stage(TC.main, ["survey", "run", "--cpu"], cfg,
                         monkeypatch)
        assert rc == 0
        assert json.loads(out) == {"operation": "sum", "result": 75}
    finally:
        for p in procs.values():
            p.kill()
        for p in procs.values():
            p.wait(timeout=30)
        for f in logs.values():
            f.close()
    assert all(p.returncode is not None for p in procs.values())


@pytest.mark.slow
def test_survey_run_local_and_serve(monkeypatch):
    """The pipeline's `survey run --local --cpu` (an in-process
    LocalCluster of the configured role counts) prints the decoded sum of
    its DPs' dummy data, and `--serve 2` runs two copies through the
    standing SurveyServer, as the reference's do."""
    cfg = {"nodes": [{"name": "cn0", "role": "cn", "host": "127.0.0.1",
                      "port": 0},
                     {"name": "dp1", "role": "dp", "host": "127.0.0.1",
                      "port": 0}],
           "survey": {"operation": "sum", "query_min": 0, "query_max": 9,
                      "proofs": False, "obfuscation": False}}
    rc, out = _stage(TC.main, ["survey", "run", "--local", "--cpu"],
                     TTOML.dumps(cfg), monkeypatch)
    assert rc == 0
    got = json.loads(out)
    assert got["operation"] == "sum" and isinstance(got["result"], int)
    assert 0 <= got["result"] <= 9 * 32
    rc, out = _stage(TC.main, ["survey", "run", "--local", "--cpu",
                               "--serve", "2"], TTOML.dumps(cfg),
                     monkeypatch)
    assert rc == 0
    served = json.loads(out)["surveys"]
    assert sorted(served) == ["cli0", "cli1"]
    # each survey draws its DPs' dummy data from the cluster's generator
    for e in served.values():
        assert e["lane"] in ("fast", "compile")
        assert isinstance(e["result"], int) and 0 <= e["result"] <= 9 * 32
