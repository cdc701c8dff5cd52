"""Phase-timer CSV post-processing (SURVEY.md §2.1 #30).

A copy of drynx_tpu/simul/timedata.py (pure Python). Mirrors the
reference's simulation time-data pipeline
(simul/test_data/parse_time_data_test.go:12-26 + graphs/*.py): simulation
runs emit a two-row phase-timer CSV (utils/timers.PhaseTimers.csv); this
module parses one or many of those into aligned tables over the canonical
phase taxonomy, aggregates repeated runs, and renders a markdown/CSV summary
table for benchmark comparison against BASELINE.md.

CLI:
  python -m drynx_tpu_torch.simul.timedata run1.csv run2.csv ... [--format md|csv]
"""
from __future__ import annotations

import argparse
import io
import sys

# The reference's flag list (parse_time_data_test.go:18) = phase taxonomy.
PHASES = [
    "Simulation", "JustExecution", "DataCollectionProtocol",
    "DPencoding", "AggregationPhase", "ObfuscationPhase",
    "KeySwitchingPhase", "DROPhase", "Decryption", "GradientDescent",
    "AllProofs", "VerifyRange", "VerifyAggregation", "VerifyObfuscation",
    "VerifyKeySwitch", "VerifyShuffle",
]


def parse_time_csv(text: str) -> dict[str, float]:
    """Two-row CSV (header, values) -> {phase: seconds}. Server-qualified
    keys ("srv0_AggregationPhase") are folded into their phase by max —
    phases run concurrently across servers, so wall-clock is the slowest."""
    lines = [l for l in text.strip().splitlines() if l.strip()]
    if len(lines) < 2:
        return {}
    keys = [k.strip() for k in lines[0].split(",")]
    vals = [float(v) for v in lines[1].split(",")]
    out: dict[str, float] = {}
    for k, v in zip(keys, vals):
        phase = k.rsplit("_", 1)[-1] if "_" in k else k
        phase = phase if phase in PHASES else k
        out[phase] = max(out.get(phase, 0.0), v)
    return out


def aggregate(runs: list[dict[str, float]]) -> dict[str, tuple[float, float]]:
    """Per-phase (mean, min) across repeated runs."""
    out = {}
    for phase in PHASES:
        vals = [r[phase] for r in runs if phase in r]
        if vals:
            out[phase] = (sum(vals) / len(vals), min(vals))
    # preserve any non-taxonomy keys too
    extra = sorted({k for r in runs for k in r} - set(PHASES))
    for k in extra:
        vals = [r[k] for r in runs if k in r]
        out[k] = (sum(vals) / len(vals), min(vals))
    return out


def render(agg: dict[str, tuple[float, float]], fmt: str = "md") -> str:
    buf = io.StringIO()
    if fmt == "md":
        buf.write("| phase | mean s | best s |\n|---|---|---|\n")
        for k, (mean, best) in agg.items():
            buf.write(f"| {k} | {mean:.4f} | {best:.4f} |\n")
    else:
        buf.write("phase,mean_s,best_s\n")
        for k, (mean, best) in agg.items():
            buf.write(f"{k},{mean:.6f},{best:.6f}\n")
    return buf.getvalue()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="drynx-timedata")
    p.add_argument("files", nargs="+")
    p.add_argument("--format", choices=["md", "csv"], default="md")
    a = p.parse_args(argv)
    runs = []
    for f in a.files:
        with open(f) as fh:
            runs.append(parse_time_csv(fh.read()))
    sys.stdout.write(render(aggregate(runs), a.format))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
