"""The port's simulation harness against the reference's, on the CPU.

`simul/runner.py`: `SimulationConfig.from_dict` equal to the reference's
on every row of the three runfiles (aliases, the onet boilerplate, the
unknown-key warning), the port's runfile copies byte-equal to the
reference's, `results_csv` equal on the same results. `simul/timedata.py`:
`parse_time_csv`, `aggregate`, `render` and the CLI equal on the same
files.

Marked slow (surveys on CPU clusters): a proofs-off `run_simulation` row
and a chaos row (a killed DP, min_dp_quorum) equal to the clear answer
from the same default_rng(seed) draws and to the reference's result, and
`run_file` writing its CSV.
"""
import dataclasses
import io
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from drynx_tpu.cmd import toml_io as JTOML
from drynx_tpu.simul import runner as JR
from drynx_tpu.simul import timedata as JTD
from drynx_tpu_torch.cmd import toml_io as TTOML
from drynx_tpu_torch.simul import runner as TR
from drynx_tpu_torch.simul import timedata as TTD

ROOT = Path(__file__).resolve().parent.parent
RUNFILES = ("drynx.toml", "minmax.toml", "scaling.toml")


@pytest.mark.parametrize("name", RUNFILES)
def test_runfile_copies_and_rows_equal_the_references(name):
    mine = ROOT / "drynx_tpu_torch" / "simul" / "runfiles" / name
    ref = ROOT / "drynx_tpu" / "simul" / "runfiles" / name
    assert mine.read_bytes() == ref.read_bytes()
    cfg_t, cfg_j = TTOML.loads(mine.read_text()), JTOML.loads(ref.read_text())
    defaults = {k: v for k, v in cfg_t.items() if not isinstance(v, list)}
    rows = cfg_t.get("run", []) or [{}]
    assert len(rows) == len(cfg_j.get("run", []) or [{}])
    for row in rows:
        merged = {**defaults, **row}
        assert (dataclasses.asdict(TR.SimulationConfig.from_dict(merged))
                == dataclasses.asdict(JR.SimulationConfig.from_dict(merged)))


def test_from_dict_aliases_boilerplate_and_warning():
    d = {"NbrServers": 4, "nbrdps": 7, "NbrVNs": 2, "NbrRows": 9,
         "RangesU": 3, "ranges_l": 2, "DiffPSize": 5, "diffpscale": 1.5,
         "Delay": 20, "Bandwidth": 100, "ChaosSeed": 4, "chaos_kill_dps": 1,
         "MinDPQuorum": 6, "Simulation": "Drynx", "Hosts": 3, "Rounds": 1,
         "BF": 2, "Suite": "bn256", "RunWait": 10, "Tls": False,
         "CuttingFactor": 2, "operation": "mean"}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = TR.SimulationConfig.from_dict(d)
    assert dataclasses.asdict(t) == dataclasses.asdict(
        JR.SimulationConfig.from_dict(d))
    assert (t.nbr_servers, t.rows_per_dp, t.delay_ms, t.min_dp_quorum) == (
        4, 9, 20, 6)
    for mod in (TR, JR):
        with pytest.warns(UserWarning, match="nbr_server"):
            cfg = mod.SimulationConfig.from_dict({"nbr_server": 5})
        assert cfg.nbr_servers == 3


def _results():
    return [{"config": {"operation": "sum", "nbr_servers": 3, "nbr_dps": 5,
                        "nbr_vns": 0},
             "timings": {"DataCollectionProtocol": 0.25, "JustExecution": 1.5,
                         "ColdTotal": 2.0}},
            {"config": {"operation": "max", "nbr_servers": 3, "nbr_dps": 5,
                        "nbr_vns": 3},
             "timings": {"JustExecution": 3.125, "VerifyRange": 0.5,
                         "AllProofs": 1.0}}]


def test_results_csv_and_timedata_equal_the_references(tmp_path, capsys):
    assert TR.results_csv(_results()) == JR.results_csv(_results())
    files = []
    for i, text in enumerate([
            "srv0_AggregationPhase,srv1_AggregationPhase,JustExecution,Other\n"
            "0.5,0.75,2.0,1.0\n",
            "AggregationPhase,JustExecution,VerifyRange\n0.25,3.0,0.1\n",
            "x\n"]):
        assert TTD.parse_time_csv(text) == JTD.parse_time_csv(text)
        p = tmp_path / f"r{i}.csv"
        p.write_text(text)
        files.append(str(p))
    runs = [TTD.parse_time_csv(Path(f).read_text()) for f in files]
    agg = TTD.aggregate(runs)
    assert agg == JTD.aggregate(runs)
    assert TTD.PHASES == JTD.PHASES
    for fmt in ("md", "csv"):
        assert TTD.render(agg, fmt) == JTD.render(agg, fmt)
        assert TTD.main(files + ["--format", fmt]) == 0
        mine = capsys.readouterr().out
        assert JTD.main(files + ["--format", fmt]) == 0
        assert mine == capsys.readouterr().out


# ---------------------------------------------------------------------------
# Slow: surveys through the runner
# ---------------------------------------------------------------------------

def _clear_sum(cfg, killed=0):
    rng = np.random.default_rng(cfg["seed"])
    datas = [rng.integers(cfg["query_min"], max(cfg["query_max"], 1),
                          size=(cfg["rows_per_dp"],))
             for _ in range(cfg["nbr_dps"])]
    return int(sum(int(d.sum()) for d in datas[killed:]))


@pytest.fixture(scope="module")
def reference_runner():
    """The reference's runner with the `jax.enable_x64` stand-in of
    tests/test_torch_survey.py (its service module reaches the Pallas
    modules), restored at teardown."""
    import contextlib

    import jax

    import drynx_tpu.crypto as jcrypto

    @contextlib.contextmanager
    def _x64(flag=True):
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", bool(flag))
        try:
            yield
        finally:
            jax.config.update("jax_enable_x64", old)

    saved = jax.enable_x64
    jax.enable_x64 = _x64
    try:
        yield JR
    finally:
        jax.enable_x64 = saved
        for name in ("pallas_ops", "pallas_pairing"):
            sys.modules.pop(f"drynx_tpu.crypto.{name}", None)
            if hasattr(jcrypto, name):
                delattr(jcrypto, name)


@pytest.mark.slow
def test_proofs_off_and_chaos_rows_equal_the_clear_answer(reference_runner,
                                                          tmp_path):
    import torch

    torch.set_num_threads(1)
    rows = [dict(nbr_servers=2, nbr_dps=3, rows_per_dp=8, query_max=15,
                 seed=2),
            dict(nbr_servers=2, nbr_dps=3, rows_per_dp=8, query_max=15,
                 seed=2, chaos_seed=1, chaos_kill_dps=1, min_dp_quorum=2)]
    for row in rows:
        cfg = TR.SimulationConfig.from_dict(row)
        got = TR.run_simulation(cfg, device="cpu")
        killed = cfg.chaos_kill_dps
        assert got["result"] == _clear_sum(dataclasses.asdict(cfg), killed)
        assert got["found"]
        assert got["responders"] == [f"dp{i}" for i in range(killed, 3)]
        assert got["absent"] == [f"dp{i}" for i in range(killed)]
        want = reference_runner.run_simulation(
            JR.SimulationConfig.from_dict(row))
        assert int(want["result"]) == got["result"]
        assert want["responders"] == got["responders"]
        assert "JustExecution" in got["timings"]
    # run_file over a three-row grid writes the CSV of the rows that
    # decoded; the third one's sum passes its dlog_limit: not found, kept
    # out of the CSV and the table, and the CLI fails
    grid = tmp_path / "grid.toml"
    grid.write_text('operation = "sum"\nnbr_servers = 2\nnbr_dps = 2\n'
                    'rows_per_dp = 4\n\n[[run]]\nseed = 1\n\n[[run]]\n'
                    'seed = 2\n\n[[run]]\nseed = 2\ndlog_limit = 3\n')
    res = TR.run_file(str(grid), csv_out="auto", device="cpu")
    text = (tmp_path / "grid.timedata.csv").read_text()
    assert [r["found"] for r in res] == [True, True, False]
    assert text == TR.results_csv(res[:2])
    assert [r["result"] for r in res[:2]] == [
        _clear_sum(dataclasses.asdict(TR.SimulationConfig.from_dict(
            {"nbr_dps": 2, "rows_per_dp": 4, "seed": s}))) for s in (1, 2)]
    assert len(io.StringIO(text).readlines()) == 3
    assert TR.main([str(grid), "--cpu"]) == 1
