"""Opt-in runtime lock-order recorder: the dynamic half of the
concurrency cross-check.

``DRYNX_LOCK_TRACE=1`` makes :mod:`drynx_tpu_torch` call :func:`install` at
import time, replacing ``threading.Lock``/``threading.RLock`` with
factories that return thin wrappers. Every wrapper keeps the usual lock
semantics (``with``, ``acquire(blocking, timeout)``, re-entrancy for
RLock) and additionally maintains a per-thread stack of currently held
locks. When a thread acquires lock B while holding lock A and *both*
carry diagnostic names (``resilience.policy.named_lock``), the ordered
edge ``(name_A, name_B)`` is recorded.

The cross-check (crosscheck.py ``locks``; chip_smoke.py phase 17a) runs
a real 2-worker ``SurveyServer`` drain under this recorder and asserts the
observed edge set is a **subgraph of the static lock-order graph** from
:mod:`.concurrency` — the static analysis must over-approximate what the
runtime actually does, or its cycle verdicts are worthless. Unnamed
locks (torch internals, stdlib queues, per-entry cache locks) participate
in the held stack but never in edges: the contract is only claimed for
the named locks the analysis reasons about.

Process-global and deliberately simple: one edge set, no per-thread
output, O(held locks) work per acquire. Not for production — for tests.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Set, Tuple

from ..resilience.policy import LOCK_NAMES

_ORIG_LOCK = None          # threading.Lock before install()
_ORIG_RLOCK = None
_EDGES: Set[Tuple[str, str]] = set()
_EDGES_GUARD = threading.Lock()          # created pre-install: untraced
_STACKS = threading.local()
_ACQUIRES = 0                            # total traced acquisitions


def _stack() -> List[int]:
    try:
        return _STACKS.held
    except AttributeError:
        _STACKS.held = []
        return _STACKS.held


class _TracedLock:
    """Wrapper around a real Lock/RLock recording acquisition order."""

    def __init__(self, inner, reentrant: bool):
        self._inner = inner
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._on_acquired()
        return got

    def _on_acquired(self) -> None:
        global _ACQUIRES
        stack = _stack()
        me = id(self)
        if not (self._reentrant and me in stack):
            my_name = LOCK_NAMES.get(me)
            with _EDGES_GUARD:
                _ACQUIRES += 1
                if my_name is not None:
                    for held in stack:
                        if held == me:
                            continue
                        held_name = LOCK_NAMES.get(held)
                        if held_name is not None \
                                and held_name != my_name:
                            _EDGES.add((held_name, my_name))
        stack.append(me)

    def release(self) -> None:
        stack = _stack()
        me = id(self)
        # remove the most recent entry for this lock (non-LIFO release
        # is legal for plain locks)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == me:
                del stack[i]
                break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()

    def __getattr__(self, name):
        # Condition() probes _is_owned/_acquire_restore/_release_save;
        # forwarding keeps RLock-backed conditions working and lets a
        # plain Lock raise AttributeError so Condition takes its
        # fallback path, exactly as untraced.
        return getattr(self._inner, name)


def install() -> None:
    """Patch threading.Lock/RLock with tracing factories (idempotent)."""
    global _ORIG_LOCK, _ORIG_RLOCK
    if _ORIG_LOCK is not None:
        return
    _ORIG_LOCK = threading.Lock
    _ORIG_RLOCK = threading.RLock

    def lock_factory():
        return _TracedLock(_ORIG_LOCK(), reentrant=False)

    def rlock_factory():
        return _TracedLock(_ORIG_RLOCK(), reentrant=True)

    threading.Lock = lock_factory
    threading.RLock = rlock_factory


def uninstall() -> None:
    global _ORIG_LOCK, _ORIG_RLOCK
    if _ORIG_LOCK is None:
        return
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
    _ORIG_LOCK = _ORIG_RLOCK = None


def installed() -> bool:
    return _ORIG_LOCK is not None


def observed_edges() -> Set[Tuple[str, str]]:
    """Ordered (outer_name, inner_name) pairs seen so far."""
    with _EDGES_GUARD:
        return set(_EDGES)


def acquisition_count() -> int:
    """Traced acquisitions so far — the non-vacuity signal (a recorder
    that saw zero acquisitions proves nothing)."""
    with _EDGES_GUARD:
        return _ACQUIRES


def reset() -> None:
    global _ACQUIRES
    with _EDGES_GUARD:
        _EDGES.clear()
        _ACQUIRES = 0
