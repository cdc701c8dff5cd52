"""Phase-level wall-clock timers -> CSV (a copy of drynx_tpu/utils/timers.py).

Mirrors unlynx StartTimer/EndTimer keyed by "<serverID>_<Phase>" (used at
reference services/service.go:381,412,717-744 and across lib/proof), whose
CSV output feeds simul/test_data/parse_time_data_test.go. The phase taxonomy
(SURVEY.md §5) is preserved so benchmark output stays comparable:
DataCollectionProtocol, AggregationPhase, KeySwitchingPhase, DPencoding,
VerifyRange, VerifyAggregation, VerifyKeySwitch, GradientDescent, Decryption,
AllProofs, JustExecution.
"""
from __future__ import annotations

import io
import time

from ..resilience.policy import named_lock


class PhaseTimers:
    """Thread-safe named wall-clock timers accumulating per-phase seconds.

    With the class flag `echo` set, every completed phase prints to stderr
    immediately — so a benchmark killed mid-run still shows where the time
    went."""

    echo = False

    def __init__(self):
        self._lock = named_lock("timers_lock")
        self._open: dict[str, float] = {}
        self._acc: dict[str, float] = {}
        self._spans: list[tuple[str, float, float]] = []

    def start(self, name: str) -> None:
        with self._lock:
            self._open[name] = time.perf_counter()

    def end(self, name: str) -> float:
        now = time.perf_counter()
        with self._lock:
            t0 = self._open.pop(name, None)
            if t0 is None:
                return 0.0
            dt = now - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._spans.append((name, t0, now))
        if PhaseTimers.echo:
            import sys

            print(f"    [phase] {name}: {dt:.3f}s", file=sys.stderr,
                  flush=True)
        return dt

    def add(self, name: str, dt: float) -> None:
        """Accumulate an externally-measured span. Unlike start/end this is
        safe under arbitrary thread overlap (no shared open-slot state) —
        it is how the concurrent proof creation/verification paths attribute
        their time (service.py: AllProofs / Verify<Type>)."""
        with self._lock:
            self._acc[name] = self._acc.get(name, 0.0) + dt
        if PhaseTimers.echo:
            import sys

            print(f"    [phase] {name}: +{dt:.3f}s", file=sys.stderr,
                  flush=True)

    def add_split(self, phase: str, kind: str, dt: float) -> None:
        """Attribute a span to the host_glue/device_compute split of a
        phase, stored as "<phase>#<kind>" so the split rides every existing
        surface; split_summary() aggregates it."""
        self.add(f"{phase}#{kind}", dt)

    def split_summary(self) -> dict:
        """The "<phase>#<kind>" keys: per-phase seconds by kind, and the
        host_glue_s / device_compute_s totals with the device's share."""
        with self._lock:
            items = list(self._acc.items())
        phases: dict[str, dict] = {}
        totals = {"host_glue": 0.0, "device_compute": 0.0}
        for k, v in items:
            if "#" not in k:
                continue
            phase, kind = k.rsplit("#", 1)
            phases.setdefault(phase, {})[kind] = round(v, 6)
            if kind in totals:
                totals[kind] += v
        denom = totals["host_glue"] + totals["device_compute"]
        return {"phases": phases,
                "host_glue_s": round(totals["host_glue"], 6),
                "device_compute_s": round(totals["device_compute"], 6),
                "device_share": (round(totals["device_compute"] / denom, 4)
                                 if denom > 0 else None)}

    def span(self, name: str, t0: float, t1: float) -> None:
        """Record an absolute (perf_counter) interval beside its
        accumulated total. The caller owns the clock, so overlapping spans
        of concurrent pipeline stages record correctly (the overlap
        measures of server/scheduler.py intersect them)."""
        with self._lock:
            self._acc[name] = self._acc.get(name, 0.0) + (t1 - t0)
            self._spans.append((name, t0, t1))

    def spans(self, prefix: str = "") -> list:
        """Absolute (name, t0, t1) records, ordered by start time."""
        with self._lock:
            out = [s for s in self._spans if s[0].startswith(prefix)]
        return sorted(out, key=lambda s: s[1])

    def clear(self) -> None:
        """Drop accumulated spans (benchmarks isolating a timed window)."""
        with self._lock:
            self._open.clear()
            self._acc.clear()
            self._spans.clear()

    def __getitem__(self, name: str) -> float:
        return self._acc.get(name, 0.0)

    def items(self):
        return sorted(self._acc.items())

    def csv(self) -> str:
        """Two-row CSV (header + values), the simulation output format."""
        buf = io.StringIO()
        keys = [k for k, _ in self.items()]
        buf.write(",".join(keys) + "\n")
        buf.write(",".join(f"{self._acc[k]:.6f}" for k in keys) + "\n")
        return buf.getvalue()


__all__ = ["PhaseTimers"]
