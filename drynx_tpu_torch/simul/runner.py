"""TOML-grid simulation runner (reference simul/drynx_simul.go:28-305).

The port's counterpart of drynx_tpu/simul/runner.py: the same configuration
keys, aliases and CSV, each row a survey on a port `LocalCluster`, on the
card unless `device` names another (the CPU, say).

Grid semantics follow onet simulation runfiles: top-level keys are shared
defaults, each [[run]] table overrides them for one run. Output: a list of
result dicts + a CSV string whose columns are the phase taxonomy
(SURVEY.md §5); run_file(csv_out="auto") writes it next to the runfile
(<name>.timedata.csv), csv_out=<path> writes there, None writes nothing.

CLI (every row on the card; --cpu runs them on the CPU):
  python -m drynx_tpu_torch.simul RUNFILE [--csv PATH|auto] [--cpu]
prints each row's result, bitmap codes and wall time, then the timedata
table of the rows' phase seconds (mean and best).
"""
from __future__ import annotations

import dataclasses
import io
import time
import warnings
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SimulationConfig:
    """One grid row (reference SimulationDrynx fields, drynx_simul.go:28-80)."""

    nbr_servers: int = 3
    nbr_dps: int = 5
    nbr_vns: int = 0
    operation: str = "sum"
    proofs: int = 0
    query_min: int = 0
    query_max: int = 15
    rows_per_dp: int = 32
    ranges_u: int = 4
    ranges_l: int = 4
    diffp_size: int = 0
    diffp_scale: float = 0.0
    dlog_limit: int = 25000
    seed: int = 0
    # repeats > 1 reports the LAST (warm) run's phase timings: the first
    # run of each new (servers, dps) shape pays one-time XLA bucket
    # compiles, which contaminated the round-4 grid (83.9 s charged to
    # KeySwitchingPhase on row 1 vs 0.42 s on row 2). The cold first-run
    # total is still recorded in the ColdTotal column.
    repeats: int = 1
    # per-link network model (reference simul/runfiles/drynx.toml:6-7:
    # Delay = 20 ms, Bandwidth = 100 Mbps; sensitivity study
    # TIFS/networkTraffic.py). 0 = ideal network (off).
    delay_ms: float = 0.0
    bandwidth_mbps: float = 0.0
    # chaos rows (drynx_tpu/resilience, ROBUSTNESS.md): kill the first
    # chaos_kill_dps DPs under a FaultPlan seeded with chaos_seed, and let
    # the survey complete over >= min_dp_quorum responders (0 = require
    # all, the strict default).
    chaos_seed: int = 0
    chaos_kill_dps: int = 0
    min_dp_quorum: int = 0

    # reference runfile spellings (drynx_simul.go:28-80) -> our field names
    _ALIASES = {
        "nbrservers": "nbr_servers", "nbrdps": "nbr_dps",
        "nbrvns": "nbr_vns", "nbrrows": "rows_per_dp",
        "rangesu": "ranges_u", "rangesl": "ranges_l",
        "diffpsize": "diffp_size", "diffpscale": "diffp_scale",
        "delay": "delay_ms", "bandwidth": "bandwidth_mbps",
        "delayms": "delay_ms", "bandwidthmbps": "bandwidth_mbps",
        "chaosseed": "chaos_seed", "chaoskilldps": "chaos_kill_dps",
        "mindpquorum": "min_dp_quorum",
    }

    # onet runfile boilerplate the reference tolerates (drynx_simul.go decodes
    # into a struct, extra TOML keys are simply unused) — ignore silently.
    _ONET_BOILERPLATE = {
        "simulation", "hosts", "rounds", "bf", "servers", "suite",
        "runwait", "monitor", "debug", "singlehost",
        "tls", "cuttingfactor",
    }

    @classmethod
    def from_dict(cls, d: dict) -> "SimulationConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        out = {}
        for k, v in d.items():
            name = k.lower()
            name = cls._ALIASES.get(name.replace("_", ""), name)
            if name not in known:
                if name.replace("_", "") in cls._ONET_BOILERPLATE:
                    continue
                # tolerate unknown keys like the reference, but surface them
                # so near-miss typos (nbr_server) don't silently no-op
                warnings.warn(f"ignoring unknown simulation key {k!r} "
                              f"(known: {sorted(known)})")
                continue
            out[name] = v
        return cls(**out)


def run_simulation(cfg: SimulationConfig, device=None) -> dict:
    """Run one configuration end to end on `device` (None: the card);
    returns result + phase timings."""
    from ..resilience import FaultPlan, fault_plan, set_fault_plan

    prev_plan = fault_plan()
    if cfg.chaos_kill_dps > 0:
        plan = FaultPlan(seed=cfg.chaos_seed)
        for i in range(min(cfg.chaos_kill_dps, cfg.nbr_dps)):
            plan.kill(f"dp{i}")
        set_fault_plan(plan)
    try:
        return _run_simulation(cfg, device)
    finally:
        set_fault_plan(prev_plan)


def _run_simulation(cfg: SimulationConfig, device) -> dict:
    from ..service.api import DrynxClient
    from ..service.query import DiffPParams
    from ..service.service import LocalCluster
    from ..service.transport import LinkModel

    rng = np.random.default_rng(cfg.seed)
    link = LinkModel(cfg.delay_ms, cfg.bandwidth_mbps)
    cluster = LocalCluster(n_cns=cfg.nbr_servers, n_dps=cfg.nbr_dps,
                           n_vns=cfg.nbr_vns if cfg.proofs else 0,
                           seed=cfg.seed, dlog_limit=cfg.dlog_limit,
                           link=link, device=device)
    for dp in cluster.dps.values():
        dp.data = rng.integers(cfg.query_min, max(cfg.query_max, 1),
                               size=(cfg.rows_per_dp,)).astype(np.int64)

    client = DrynxClient(cluster)
    diffp = (DiffPParams(noise_list_size=cfg.diffp_size, lap_mean=0.0,
                         lap_scale=cfg.diffp_scale, quanta=1.0,
                         scale=1.0, limit=8.0)
             if cfg.diffp_size else None)

    try:
        return _run_rows(cfg, cluster, client, diffp)
    finally:
        cluster.close()


def _run_rows(cfg, cluster, client, diffp) -> dict:
    cold_total = None
    for _rep in range(max(cfg.repeats, 1)):
        # a fresh survey id per repeat (VN proof state is per-survey);
        # compiled executables and signature/GT tables carry over, so
        # repeat 2+ measures the steady state
        sq = client.generate_survey_query(
            cfg.operation, query_min=cfg.query_min, query_max=cfg.query_max,
            proofs=cfg.proofs, diffp=diffp,
            min_dp_quorum=cfg.min_dp_quorum,
            ranges=[(cfg.ranges_u, cfg.ranges_l)] *
            sq_out_size(cfg) if cfg.proofs else None)
        t0 = time.perf_counter()
        res = client.send_survey_query(sq, seed=cfg.seed)
        total = time.perf_counter() - t0
        if cold_total is None:
            cold_total = total

    timings = dict(res.timers.items())
    timings["JustExecution"] = total
    timings["ColdTotal"] = cold_total
    # bitmap code histogram (1 = verified true): a mis-sized range spec
    # (e.g. u^l smaller than an honest DP's local sum) shows up here as
    # code-0 rows instead of silently polluting the timing capture
    bitmap = {}
    if res.block is not None:
        for code in res.block.data.bitmap.values():
            bitmap[int(code)] = bitmap.get(int(code), 0) + 1
    # found: every decrypted value was inside the discrete-log table (a
    # sum past dlog_limit decodes to 0 and is not a measured survey)
    return {"config": dataclasses.asdict(cfg), "result": res.result,
            "found": bool(np.all(res.decrypted.found)),
            "timings": timings, "bitmap_codes": bitmap,
            "responders": list(res.responders), "absent": list(res.absent),
            "block_hash": res.block.hash() if res.block else None}


def sq_out_size(cfg: SimulationConfig) -> int:
    from ..encoding import output_size

    return output_size(cfg.operation, cfg.query_min, cfg.query_max)


def run_file(path: str, csv_out: Optional[str] = None,
             device=None) -> list[dict]:
    """Run every [[run]] row of a TOML grid file (reference runfiles) on
    `device` (None: the card).

    csv_out: None = no CSV file (caller can use results_csv); "auto" = write
    <runfile>.timedata.csv next to the runfile; any other string = that path.
    The file holds the rows whose values were all found; every row is
    returned, with its `found` flag.
    """
    from ..cmd import toml_io

    with open(path) as f:
        cfg = toml_io.loads(f.read())
    defaults = {k: v for k, v in cfg.items() if not isinstance(v, list)}
    runs = cfg.get("run", []) or [{}]

    results = []
    for row in runs:
        merged = {**defaults, **row}
        results.append(run_simulation(SimulationConfig.from_dict(merged),
                                      device))

    if csv_out == "auto":
        base = path[:-len(".toml")] if path.endswith(".toml") else path
        csv_out = base + ".timedata.csv"
    if csv_out is not None:
        with open(csv_out, "w") as f:
            f.write(results_csv([r for r in results if r["found"]]))
    return results


def results_csv(results: list[dict]) -> str:
    """One CSV row per run; columns = union of phase names (the reference's
    simulation CSV format consumed by parse_time_data_test.go:12-26)."""
    cols: list[str] = []
    for r in results:
        for k in r["timings"]:
            if k not in cols:
                cols.append(k)
    buf = io.StringIO()
    buf.write(",".join(["operation", "servers", "dps", "vns"] + cols) + "\n")
    for r in results:
        c = r["config"]
        row = [c["operation"], str(c["nbr_servers"]), str(c["nbr_dps"]),
               str(c["nbr_vns"])]
        row += [f"{r['timings'].get(k, 0.0):.6f}" for k in cols]
        buf.write(",".join(row) + "\n")
    return buf.getvalue()


def main(argv=None) -> int:
    import argparse
    import csv
    import sys

    from . import timedata

    p = argparse.ArgumentParser(prog="drynx-simul")
    p.add_argument("runfile")
    p.add_argument("--csv", default=None,
                   help="where to write the rows' CSV ('auto': beside the "
                        "runfile)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the CUDA card)")
    a = p.parse_args(argv)
    device = "cpu" if a.cpu else None
    if device is None:
        import torch

        from ..utils.device import resolve

        resolve(None)
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    results = run_file(a.runfile, csv_out=a.csv, device=device)
    for r in results:
        c = r["config"]
        print(f"{c['operation']} servers={c['nbr_servers']} "
              f"dps={c['nbr_dps']} vns={c['nbr_vns']} "
              f"rows={c['rows_per_dp']} proofs={c['proofs']}: result "
              f"{r['result']}"
              f"{'' if r['found'] else ' NOT FOUND (past dlog_limit)'}, "
              f"bitmap {r['bitmap_codes']}, JustExecution "
              f"{r['timings']['JustExecution']:.4f} s, ColdTotal "
              f"{r['timings']['ColdTotal']:.4f} s", flush=True)
    # the table aggregates the rows that decoded; a row that did not
    # fails the run
    found = [r for r in results if r["found"]]
    rows = list(csv.DictReader(results_csv(found).splitlines()))
    runs = [{k: float(v) for k, v in row.items()
             if k not in ("operation", "servers", "dps", "vns")}
            for row in rows]
    print(f"timedata over the {len(found)} of {len(results)} rows that "
          f"decoded:", flush=True)
    sys.stdout.write(timedata.render(timedata.aggregate(runs)))
    return 0 if len(found) == len(results) else 1


__all__ = ["SimulationConfig", "run_simulation", "run_file", "results_csv"]
