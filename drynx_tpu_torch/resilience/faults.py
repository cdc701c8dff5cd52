"""Seeded, deterministic fault injection (the in-process fault plane).

The port's copy of drynx_tpu/resilience/faults.py. A :class:`FaultPlan` is
a list of :class:`FaultSpec` rules plus a seed. ``service/transport.py``'s
``local_call`` consults the process-global plan at four hook points, in
the order a TCP exchange would meet them:

  where="connect"  before the call reaches the node          (refuse, delay)
  where="request"  around the request                        (drop, delay,
                                                              corrupt,
                                                              close_mid_frame)
  where="reply"    around the answer, after the node ran      (same kinds)
  where="node"     the whole node                             (kill, pause,
                                                              partition)

Determinism: every draw is keyed, not streamed. A link-level event draws
from ``np.random.default_rng((seed, spec_idx, name_key(target), seq))``
where ``seq`` is that (spec, target)'s own invocation counter, so whether
a probabilistic spec fires depends only on the plan seed, the target node
and how many times that node hit the hook, never on the global order of
calls. ``count`` caps are per (spec, target) for the same reason;
``spec.fired`` is the total across targets. The same seed gives the same
draws as the reference's plan.

Node-level verdicts are fault episodes: the seeded membership draw is
keyed per (spec, node) and memoized, and the spec's window
``[after_s, after_s + heal_after_s)`` on the plan's clock decides when the
episode is live (``heal_after_s=None``: for the whole run). ``partition``
cuts the links between two fnmatch'd node sets (``target`` x ``peer``)
both ways for the window, one seeded draw per (spec, unordered pair).

No transport import here (transport imports this module).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import hashlib
import threading
import time
from typing import Callable, Optional

import numpy as np

from .policy import named_lock


def _name_key(name: str) -> int:
    """Stable 64-bit key for a node name (``hash()`` is salted per
    process, useless for cross-run determinism)."""
    return int.from_bytes(
        hashlib.blake2s(name.encode(), digest_size=8).digest(), "big")

KINDS = ("refuse", "drop", "delay", "close_mid_frame", "corrupt",
         "kill", "pause", "partition")
WHERES = ("connect", "request", "reply", "node")
NODE_KINDS = ("kill", "pause", "partition")


@dataclasses.dataclass
class FaultSpec:
    """One fault rule. ``target`` is an fnmatch pattern over node names
    ("dp3", "dp*", "*"); ``mtype`` filters by message type for
    request/reply hooks ("*" = any). ``prob`` gates each firing through
    the spec's seeded stream; ``count`` caps total firings (None =
    unlimited). ``delay_s`` parameterizes delay/pause.

    Node-level specs (kill/pause/partition) are *episodes*: live during
    ``[after_s, after_s + heal_after_s)`` on the plan clock;
    ``heal_after_s=None`` means permanent (the legacy never-flap
    semantics). ``peer`` is the second fnmatch set for ``partition`` —
    the cut severs every target×peer link, both directions."""

    where: str
    kind: str
    target: str = "*"
    mtype: str = "*"
    prob: float = 1.0
    count: Optional[int] = None
    delay_s: float = 0.0
    after_s: float = 0.0
    heal_after_s: Optional[float] = None
    peer: str = "*"
    fired: int = 0     # mutated under the plan lock

    def __post_init__(self):
        if self.where not in WHERES:
            raise ValueError(f"unknown fault hook {self.where!r}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in NODE_KINDS and self.where != "node":
            raise ValueError(f"{self.kind!r} is a node-level fault")
        if ((self.heal_after_s is not None or self.after_s)
                and self.where != "node"):
            raise ValueError("fault windows (after_s/heal_after_s) apply "
                             "to node-level faults only")
        if self.heal_after_s is not None and self.heal_after_s <= 0:
            raise ValueError("heal_after_s must be positive")

    def matches(self, target: str, mtype: str) -> bool:
        return (fnmatch.fnmatchcase(target, self.target)
                and (self.mtype == "*" or self.mtype == mtype))

    def window(self) -> tuple[float, Optional[float]]:
        """(down_at, up_at) on the plan clock; up_at None = permanent."""
        up = (None if self.heal_after_s is None
              else self.after_s + self.heal_after_s)
        return (self.after_s, up)


class FaultPlan:
    """A seeded set of fault rules + an explicit kill set.

    Thread-safe: transport handler threads and client threads consult the
    plan concurrently; all draw/counter state mutates under one lock.
    ``clock`` (default ``time.monotonic``) drives fault-episode windows;
    tests inject a fake clock to step time deterministically.
    """

    def __init__(self, seed: int = 0, specs=(),
                 clock: Callable[[], float] = time.monotonic):
        self.seed = int(seed)
        self.specs: list[FaultSpec] = []
        self._clock = clock
        self._t0 = clock()
        self._killed: dict[str, Optional[float]] = {}  # name -> heal time
        self._node_verdicts: dict[tuple[int, str], bool] = {}
        self._pair_verdicts: dict[tuple[int, str, str], bool] = {}
        self._seq: dict[tuple[int, str], int] = {}       # draw counters
        self._fired_by: dict[tuple[int, str], int] = {}  # per-target caps
        self._lock = named_lock("faultplan_lock")
        for s in specs:
            self.add(s)

    def add(self, spec: FaultSpec) -> FaultSpec:
        with self._lock:
            self.specs.append(spec)
        return spec

    # -- episode clock ---------------------------------------------------
    def elapsed(self) -> float:
        """Seconds since the plan epoch (construction or reset_epoch)."""
        return self._clock() - self._t0

    def reset_epoch(self) -> None:
        """Restart the episode timeline at zero — soak harnesses call
        this right before the measured run so ``after_s`` offsets are
        relative to the run, not to plan construction."""
        with self._lock:
            self._t0 = self._clock()

    def _live(self, s: FaultSpec, now: float) -> bool:
        # caller holds the lock; window gate for node-level episodes
        down, up = s.window()
        return down <= now and (up is None or now < up)

    # -- node-level state ------------------------------------------------
    def kill(self, name: str, heal_after_s: Optional[float] = None) -> None:
        """Hard-kill: the node's server closes every connection without
        answering, and clients refuse to dial it. With ``heal_after_s``
        the kill is an episode — the node revives on its own once the
        window elapses."""
        with self._lock:
            self._killed[name] = (None if heal_after_s is None
                                  else self.elapsed() + heal_after_s)

    def revive(self, name: str) -> None:
        with self._lock:
            self._killed.pop(name, None)

    def killed(self, name: str) -> bool:
        with self._lock:
            now = self.elapsed()
            if name in self._killed:
                heal_at = self._killed[name]
                if heal_at is None or now < heal_at:
                    return True
                del self._killed[name]   # window elapsed: healed
            return self._node_verdict(name, "kill", now) is not None

    def node_fault(self, name: str) -> Optional[FaultSpec]:
        """The node-level spec (kill or pause) applying to ``name`` right
        now, if any. Membership draws are keyed per (spec, node) and
        memoized; the spec's episode window decides liveness, so a
        heal-less spec keeps the legacy contract — dead or alive for the
        whole run, never flapping."""
        with self._lock:
            now = self.elapsed()
            if name in self._killed:
                heal_at = self._killed[name]
                if heal_at is None or now < heal_at:
                    return FaultSpec(where="node", kind="kill", target=name)
                del self._killed[name]
            for kind in ("kill", "pause"):
                s = self._node_verdict(name, kind, now)
                if s is not None:
                    return s
        return None

    def _node_verdict(self, name: str, kind: str,
                      now: float) -> Optional[FaultSpec]:
        # caller holds the lock
        for i, s in enumerate(self.specs):
            if s.where != "node" or s.kind != kind:
                continue
            if not s.matches(name, "*"):
                continue
            key = (i, name)
            if key not in self._node_verdicts:
                self._node_verdicts[key] = (
                    s.prob >= 1.0
                    or float(np.random.default_rng(
                        (self.seed, i, _name_key(name))).random()) < s.prob)
            if self._node_verdicts[key] and self._live(s, now):
                return s
        return None

    def partitioned(self, a: str, b: str) -> bool:
        """True if the link between ``a`` and ``b`` is currently cut by a
        live partition episode. Symmetric (a bidirectional cut): a spec
        applies if either orientation matches target×peer. Membership is
        one seeded draw per (spec, unordered pair), so whether a given
        link is in the blast radius never depends on which side dialed
        first."""
        if a == b:
            return False
        with self._lock:
            now = self.elapsed()
            for i, s in enumerate(self.specs):
                if s.kind != "partition":
                    continue
                hit = ((fnmatch.fnmatchcase(a, s.target)
                        and fnmatch.fnmatchcase(b, s.peer))
                       or (fnmatch.fnmatchcase(b, s.target)
                           and fnmatch.fnmatchcase(a, s.peer)))
                if not hit:
                    continue
                lo, hi = sorted((a, b))
                key = (i, lo, hi)
                if key not in self._pair_verdicts:
                    self._pair_verdicts[key] = (
                        s.prob >= 1.0
                        or float(np.random.default_rng(
                            (self.seed, i, _name_key(lo),
                             _name_key(hi))).random()) < s.prob)
                if self._pair_verdicts[key] and self._live(s, now):
                    return True
        return False

    def episodes(self) -> list[dict]:
        """The deterministic down/up timeline: one row per node-level
        spec plus one per explicit kill, each with the window on the plan
        clock (``heal_s`` None = permanent). Soak harnesses diff this
        across same-seed runs to assert identical fault timelines."""
        with self._lock:
            out = []
            for i, s in enumerate(self.specs):
                if s.where != "node":
                    continue
                down, up = s.window()
                out.append({"spec": i, "kind": s.kind, "target": s.target,
                            "peer": s.peer if s.kind == "partition"
                            else None,
                            "down_s": down, "heal_s": up})
            for name in sorted(self._killed):
                out.append({"spec": None, "kind": "kill", "target": name,
                            "peer": None, "down_s": 0.0,
                            "heal_s": self._killed[name]})
        return out

    # -- link-level draws ------------------------------------------------
    def pick(self, where: str, target: str,
             mtype: str = "*") -> Optional[FaultSpec]:
        """First matching link-level spec that fires for this event, with
        its counter consumed. Draws are keyed on (plan seed, spec index,
        target node, that pair's own event counter): the verdict for
        "dp3's second connect" is the same whether dp3 dialed second or
        sixth, so concurrent fan-out cannot perturb a seeded schedule."""
        with self._lock:
            for i, s in enumerate(self.specs):
                if s.where != where or s.where == "node":
                    continue
                if not s.matches(target, mtype):
                    continue
                key = (i, target)
                if (s.count is not None
                        and self._fired_by.get(key, 0) >= s.count):
                    continue
                seq = self._seq.get(key, 0)
                self._seq[key] = seq + 1
                fires = (s.prob >= 1.0
                         or float(np.random.default_rng(
                             (self.seed, i, _name_key(target),
                              seq)).random()) < s.prob)
                if fires:
                    self._fired_by[key] = self._fired_by.get(key, 0) + 1
                    s.fired += 1
                    return s
        return None

    def describe(self) -> str:
        with self._lock:
            rows = []
            for s in self.specs:
                row = (f"{s.where}/{s.kind} target={s.target} "
                       f"mtype={s.mtype} p={s.prob} fired={s.fired}")
                if s.kind == "partition":
                    row += f" peer={s.peer}"
                if s.heal_after_s is not None or s.after_s:
                    down, up = s.window()
                    row += f" window=[{down},{'inf' if up is None else up})"
                rows.append(row)
            if self._killed:
                rows.append(f"killed={sorted(self._killed)}")
        return f"FaultPlan(seed={self.seed}): " + ("; ".join(rows) or "empty")


# Process-global active plan, mirroring transport's LinkModel pattern.
# None (the default) means every hook is a no-op.
_PLAN: Optional[FaultPlan] = None


def fault_plan() -> Optional[FaultPlan]:
    return _PLAN


def set_fault_plan(plan: Optional[FaultPlan]) -> None:
    global _PLAN
    _PLAN = plan


__all__ = ["FaultSpec", "FaultPlan", "fault_plan", "set_fault_plan",
           "KINDS", "WHERES", "NODE_KINDS"]
