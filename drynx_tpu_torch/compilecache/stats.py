"""Warm-up observability: per-entry status and time, and the cold events.

The port's counterpart of drynx_tpu/compilecache/stats.py. The warm-up
driver (registry.py) is serial, so rows land in the order it drives the
entries; with the class flag `echo` set (the CLI), each entry prints to
stderr as it finishes.

`COLD_EVENTS` records, process-wide, every library that
`utils/cuda_build.load` builds or opens and every table that
`proofs/range_proof` builds (`sig_gt_table`, `sig_gt_pow_tables`,
`gt_base_table`), each as (kind, name, thread name). The standing
server's thread rule is checked against it: once the compile lane has
passed, nothing cold happens on a verify worker or a proof thread.

The reference's persistent-cache listener (`install_cache_listener`,
jax.monitoring) and its `trace_guard` have no counterpart: nothing here
traces, and nvcc's libraries persist under build/ by their sources' digest
(`cuda_build.library_path`).
"""
from __future__ import annotations

import sys
import threading

from ..resilience.policy import named_lock

STATUSES = ("built", "loaded", "executed", "skipped", "error")


class CompileStats:
    """Thread-safe per-entry warm-up accounting.

    Row statuses:
      built     -- nvcc built the library (mode "build"), or found it built
      loaded    -- the library is built and open in this process
      executed  -- the kernel launched once at its rows, or the table is
                   built (mode "execute")
      skipped   -- enumerated, but not driven here (a kernel entry off the
                   card, a table entry without a cluster, a library in
                   mode "build" without nvcc)
      error     -- building, loading, launching or the table build raised
    A library row also says whether its .so was on disk before (`cached`).
    The kernel entries' own launches are kept in `launches`, {(kernel,
    rows): launches}, never in the wrappers' counts.
    """

    echo = False

    def __init__(self):
        self._lock = named_lock("compilestats_lock")
        self.rows: dict[str, dict] = {}
        self.launches: dict = {}

    def record(self, name: str, status: str, seconds: float = 0.0,
               cached: bool | None = None, detail: str = "") -> None:
        assert status in STATUSES, status
        with self._lock:
            self.rows[name] = {"status": status, "seconds": seconds,
                               "cached": cached, "detail": detail}
        if CompileStats.echo:
            extra = "" if cached is None else f" cached={cached}"
            extra += f" ({detail})" if detail else ""
            print(f"    [warm] {name}: {status} {seconds:.3f}s{extra}",
                  file=sys.stderr, flush=True)

    def add_launches(self, counter) -> None:
        with self._lock:
            for key, n in counter.items():
                self.launches[key] = self.launches.get(key, 0) + n

    def count(self, status: str) -> int:
        with self._lock:
            return sum(1 for r in self.rows.values()
                       if r["status"] == status)

    def totals(self) -> dict:
        with self._lock:
            rows = list(self.rows.values())
            launches = sum(self.launches.values())
        out = {"entries": len(rows)}
        for s in STATUSES:
            out[s] = sum(1 for r in rows if r["status"] == s)
        out["errors"] = out.pop("error")
        out["seconds"] = sum(r["seconds"] for r in rows)
        out["cached_libraries"] = sum(1 for r in rows if r["cached"])
        out["launches"] = launches
        return out

    def table(self) -> str:
        """Human-readable per-entry report (the CLI's output)."""
        with self._lock:
            rows = sorted(self.rows.items())
        if not rows:
            return "(no entries recorded)"
        w = max(len(n) for n, _ in rows)
        lines = [f"{'entry':<{w}}  {'status':<8} {'seconds':>8}  cached"]
        for n, r in rows:
            cached = "-" if r["cached"] is None else str(r["cached"]).lower()
            lines.append(f"{n:<{w}}  {r['status']:<8} {r['seconds']:>8.3f}  "
                         f"{cached}" + (f"  {r['detail']}" if r["detail"]
                                        else ""))
        t = self.totals()
        lines.append(
            f"-- {t['entries']} entries: {t['built']} built, {t['loaded']} "
            f"loaded, {t['executed']} executed, {t['skipped']} skipped, "
            f"{t['errors']} errors; {t['seconds']:.1f} s; "
            f"{t['cached_libraries']} libraries already on disk; "
            f"{t['launches']} launches of its own")
        return "\n".join(lines)


class ColdEvents:
    """Process-wide record of cold work: (kind, name, thread name), kind
    "library" or "table", in the order it happened."""

    def __init__(self):
        self._lock = named_lock("cold_events_lock")
        self.events: list[tuple[str, str, str]] = []

    def note(self, kind: str, name: str) -> None:
        with self._lock:
            self.events.append((kind, name, threading.current_thread().name))

    def mark(self) -> int:
        """A position to read the later events from (`since`)."""
        with self._lock:
            return len(self.events)

    def since(self, mark: int = 0) -> list[tuple[str, str, str]]:
        with self._lock:
            return list(self.events[mark:])


# Process-global collectors: LocalCluster's warm-up, the server's compile
# lane and the CLI feed STATS; cuda_build and range_proof feed COLD_EVENTS.
STATS = CompileStats()
COLD_EVENTS = ColdEvents()

__all__ = ["CompileStats", "ColdEvents", "STATS", "COLD_EVENTS", "STATUSES"]
