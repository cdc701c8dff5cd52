"""Per-DP differential-privacy budget accountant (the "epsilon ledger").

The port's counterpart of drynx_tpu/pool/epsilon.py, with the same
journal format: a journal written by either package is read by the other.

Streaming surveys re-ask: every window advance releases another noised
statistic over (mostly) the same rows, and under basic composition each
release spends privacy budget. Without an accountant, "millions of
queries against the same cohort" (ROADMAP item 4) is a privacy bug — the
DiffP noise per release stays constant while the cumulative epsilon grows
without bound. This module makes the spend explicit and durable: a
per-(DP, cohort-digest) budget, charged at admission BEFORE any advance
runs, with the same crash-safe single-spend guarantees the DRO pool's
consumption ledger provides (store.py).

Ledger idiom mirrored from ``CryptoPool``:

  * append-only ``epsilon.jsonl`` journal, every ``consume`` event
    flushed + fsync'd BEFORE the in-memory balance moves — a crash after
    the append never forgets a spend (the conservative direction: budget
    may leak away in a crash window, it can never be double-granted);
  * replay on open skips blank lines and drops a torn final line
    (crash mid-append: the partial event never moved memory either);
  * one named re-entrant lock ("epsilon_ledger_lock") serializes
    check-then-append so two threads racing the last slice of budget
    admit exactly one.

Charging is deliberately conservative: the event is journaled before the
advance executes, so an advance that later fails still consumed budget.
That is privacy-sound (the noise draw and ciphertext delta may have left
the process) and mirrors the DRO pool's discard-don't-reuse stance.

numpy-free and jax-free on purpose — admission control must be able to
reject without touching an accelerator.
"""
from __future__ import annotations

import json
import os

from ..resilience.policy import named_lock
from .store import PoolError

# the runtime determinism recorder (analysis/dettrace.py): every line
_DET_TRACE = os.environ.get("DRYNX_DET_TRACE", "0") == "1"

class EpsilonExhausted(PoolError):
    """A charge would push a (DP, cohort) past its epsilon budget.

    Raised at admission, before any device work: the caller must treat
    it as 'this cohort's budget is spent', never as 'retry' — budget
    only moves one way."""


# float-comparison slack: budgets and per-advance epsilons are operator
# inputs like 1.0 and 0.01 whose binary sums drift by ULPs; a charge that
# lands exactly AT the budget must admit, one past it must not.
_EPS_SLACK = 1e-9


class EpsilonLedger:
    """One on-disk accountant rooted at ``root``.

    Layout::

        root/epsilon.jsonl     append-only consume-event journal

    ``budget`` is the per-(dp, cohort) cap; None defers to the
    resilience policy default (rp.EPSILON_BUDGET / DRYNX_EPSILON_BUDGET
    resolved at the admission call site). Thread-safe; restart-safe:
    a fresh instance over the same root replays the journal and refuses
    exactly the charges the dead process would have.
    """

    def __init__(self, root: str, budget: float | None = None):
        self.root = os.path.abspath(root)
        self.budget = None if budget is None else float(budget)
        self._lock = named_lock("epsilon_ledger_lock", reentrant=True)
        self._spent: dict[tuple[str, str], float] = {}
        self.counters = {"charges": 0, "rejections": 0}
        os.makedirs(self.root, exist_ok=True)
        self._ledger_path = os.path.join(self.root, "epsilon.jsonl")
        self._replay_ledger()

    # -- ledger ------------------------------------------------------------

    def _replay_ledger(self) -> None:
        if not os.path.exists(self._ledger_path):
            return
        with open(self._ledger_path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    # torn final line from a crash mid-append: the event
                    # never moved the in-memory balance in the dead
                    # process either — drop the torn tail
                    continue
                if ev.get("ev") == "consume":
                    k = (str(ev["dp"]), str(ev["cohort"]))
                    self._spent[k] = self._spent.get(k, 0.0) \
                        + float(ev["eps"])

    def _ledger_append(self, ev: dict) -> None:
        line = json.dumps(ev, sort_keys=True)
        if _DET_TRACE:
            # laundered: sort_keys canonicalizes the record bytes
            from ..analysis import dettrace
            dettrace.record("epsilon.journal", line, line.encode(),
                            laundered=True)
        with self._lock:
            with open(self._ledger_path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())

    # -- accountant surface ------------------------------------------------

    def spent(self, dp: str, cohort: str) -> float:
        with self._lock:
            return self._spent.get((str(dp), str(cohort)), 0.0)

    def remaining(self, dp: str, cohort: str,
                  budget: float | None = None) -> float:
        b = self._budget_for(budget)
        return max(0.0, b - self.spent(dp, cohort))

    def check(self, dp: str, cohort: str, eps: float,
              budget: float | None = None) -> bool:
        """Would ``charge`` admit? Read-only (no journal write)."""
        b = self._budget_for(budget)
        with self._lock:
            done = self._spent.get((str(dp), str(cohort)), 0.0)
            return done + float(eps) <= b + _EPS_SLACK

    def charge(self, dp: str, cohort: str, eps: float,
               budget: float | None = None) -> float:
        """Consume ``eps`` from (dp, cohort); returns the new spent total.

        Check-then-journal-then-commit under one lock: the fsync'd
        ``consume`` event lands BEFORE the in-memory balance moves, so a
        crash between them re-plays as spent (never double-granted). A
        charge that would exceed the budget raises ``EpsilonExhausted``
        and journals nothing — rejection is free and repeatable."""
        eps = float(eps)
        if eps < 0:
            raise PoolError(f"negative epsilon charge: {eps}")
        b = self._budget_for(budget)
        k = (str(dp), str(cohort))
        with self._lock:
            done = self._spent.get(k, 0.0)
            if done + eps > b + _EPS_SLACK:
                self.counters["rejections"] += 1
                raise EpsilonExhausted(
                    f"dp={k[0]} cohort={k[1]}: spent {done:.6g} + "
                    f"charge {eps:.6g} exceeds budget {b:.6g}")
            self._ledger_append({"ev": "consume", "dp": k[0],
                                 "cohort": k[1], "eps": eps})
            self._spent[k] = done + eps
            self.counters["charges"] += 1
            return self._spent[k]

    def _budget_for(self, budget: float | None) -> float:
        if budget is not None:
            return float(budget)
        if self.budget is not None:
            return self.budget
        from ..resilience import policy as rp

        env = os.environ.get("DRYNX_EPSILON_BUDGET", "").strip()
        return float(env) if env else rp.EPSILON_BUDGET


__all__ = ["EpsilonLedger", "EpsilonExhausted"]
