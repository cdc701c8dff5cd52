"""Opt-in runtime protocol recorder: the dynamic half of the
typestate cross-check.

``DRYNX_PROTO_TRACE=1`` makes :mod:`drynx_tpu_torch` call :func:`install` at
import time; the transition sites the static pass reasons about
(:mod:`.typestate`) then report every lifecycle event here, tagged
with a per-instance token: the pool store's tmp-write → fsync →
rename idiom and slab claim → journal → read → unlink sequence, the
``ConnPool`` checkout/return/discard cycle (plus ``Conn.call`` uses),
pane seal and proof-commit, and ``SurveyCheckpoint`` phase-enter /
save. Each instance accumulates an ordered event list.

The cross-check (crosscheck.py ``lifecycles``; chip_smoke.py phase 17c)
drives slab refills, a pool consume/crash-recover cycle, checkpoint
cycles and a ConnPool conversation under this recorder and asserts every observed per-instance sequence is
**accepted by the declared automaton** (:func:`violations` empty) and
that the run was non-vacuous (≥3 protocols exercised, ≥20 instances)
— the runtime proof that the automata shipped as project rules
describe what the code actually does, not a convenient fiction.

The runtime DFAs here deliberately re-state the static tables in
dynamic vocabulary: the static engine reasons about *may*-states over
all paths, the recorder sees the one concrete path taken, so its
acceptance check is a plain DFA run with no joins. Process-global and
deliberately simple: one dict, O(1) work per event, no payload
retention. Not for production — for tests.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, Iterable, List, Mapping, Tuple

_EVENTS: Dict[Tuple[str, str], List[str]] = {}
_GUARD = threading.Lock()                # created pre-install: untraced
_COUNTER = itertools.count(1)
_INSTALLED = False


def install() -> None:
    global _INSTALLED
    _INSTALLED = True


def uninstall() -> None:
    global _INSTALLED
    _INSTALLED = False


def installed() -> bool:
    return _INSTALLED


def reset() -> None:
    with _GUARD:
        _EVENTS.clear()


def new_instance(proto: str) -> str:
    """A fresh per-resource token (``conn:17``). Cheap enough to mint
    unconditionally at instrumented creation sites; nothing is stored
    until the first :func:`record`."""
    return f"{proto}:{next(_COUNTER)}"


def record(instance: str, event: str) -> None:
    """One lifecycle event on one instance. ``instance`` is a token
    from :func:`new_instance`; ``event`` is the automaton vocabulary
    (``open``/``write``/``fsync``/``rename``, ``claim``/``journal``/
    ``read``/``unlink``, ``checkout``/``use``/``put``/``discard``/
    ``close``, ``seal``/``commit``/``ctor``/``load``/``enter``/
    ``save``)."""
    if not _INSTALLED:
        return
    proto = instance.split(":", 1)[0]
    with _GUARD:
        _EVENTS.setdefault((proto, instance), []).append(event)


def event_count() -> int:
    with _GUARD:
        return sum(len(v) for v in _EVENTS.values())


def snapshot() -> Dict[str, object]:
    """JSON-able state for cross-process conformance checking: the
    ordered event sequence per instance."""
    with _GUARD:
        return {
            "instances": {inst: list(seq)
                          for (_p, inst), seq in _EVENTS.items()},
        }


# -- runtime DFAs ------------------------------------------------------------
#
# state -> event -> state; None start key gives the start state. A
# missing (state, event) pair is a rejection. These are the dynamic
# counterparts of typestate.PROTOCOLS: one concrete path, no joins,
# no unborn/poisoned bookkeeping.

AUTOMATA: Dict[str, Mapping[str, Mapping[str, str]]] = {
    "atomic": {
        "": {"open": "open"},
        "open": {"write": "dirty", "fsync": "open",
                 "close": "closed-synced"},
        "dirty": {"write": "dirty", "fsync": "synced"},
        "synced": {"write": "dirty", "fsync": "synced",
                   "close": "closed-synced"},
        "closed-synced": {"rename": "published"},
        "published": {},
    },
    "journal": {
        # append-only fsync'd journal lines (declared-replay paths):
        # any number of append->fsync pairs
        "": {"append": "appended"},
        "appended": {"fsync": "flushed"},
        "flushed": {"append": "appended"},
    },
    "slab": {
        "": {"claim": "claimed"},
        "claimed": {"journal": "journaled"},
        "journaled": {"read": "read"},
        "read": {"read": "read", "unlink": "consumed"},
        "consumed": {},
    },
    "conn": {
        "": {"checkout": "checked-out"},
        "checked-out": {"use": "checked-out", "put": "returned",
                        "discard": "discarded", "close": "closed",
                        "timeout": "suspect"},
        "suspect": {"discard": "discarded", "close": "closed"},
        # a pooled conn can fail its health probe at the next get and
        # be discarded without ever being re-checked-out
        "returned": {"discard": "discarded"},
        "discarded": {},
        "closed": {},
    },
    "seal": {
        "": {"seal": "sealed", "commit": "committed"},
        "sealed": {},
        "committed": {},
    },
    "ckpt": {
        "": {"ctor": "fresh", "load": "resumed"},
        "fresh": {"enter": "entered", "save": "written"},
        "resumed": {"enter": "entered"},
        "entered": {"enter": "entered", "save": "written"},
        "written": {"enter": "entered", "save": "written"},
    },
}

# states a finished sequence may legally stop in (mid-protocol stops
# are fine for conn/ckpt/journal — the process outlives the test
# window — but a slab must not stop between claim and unlink, and an
# atomic tmp write must publish)
ACCEPT_STOP: Dict[str, frozenset] = {
    "atomic": frozenset({"published"}),
    "journal": frozenset({"appended", "flushed"}),
    "slab": frozenset({"consumed"}),
    # "suspect" stops are legal: a conn broken by a transport fault is
    # simply abandoned by chaos/crash paths — reuse-after-timeout is
    # still caught because "suspect" has no "use"/"put" transitions
    "conn": frozenset({"checked-out", "returned", "discarded",
                       "closed", "suspect"}),
    "seal": frozenset({"sealed", "committed"}),
    "ckpt": frozenset({"fresh", "resumed", "entered", "written"}),
}


def accepts(proto: str, events: Iterable[str]) -> Tuple[bool, str]:
    """Run one concrete event sequence through the declared DFA.
    Returns (accepted, explanation)."""
    dfa = AUTOMATA.get(proto)
    if dfa is None:
        return False, f"unknown protocol {proto!r}"
    state = ""
    for i, ev in enumerate(events):
        nxt = dfa.get(state, {}).get(ev)
        if nxt is None:
            return False, (f"event {i} {ev!r} rejected in state "
                           f"{state or 'start'!r}")
        state = nxt
    if state not in ACCEPT_STOP.get(proto, frozenset()):
        return False, f"stopped in non-accepting state {state!r}"
    return True, ""


def violations(snap: Dict[str, object]) -> List[str]:
    """Instances whose observed sequence the declared automaton
    rejects — one human-readable line each, empty = conformant."""
    out = []
    insts = snap.get("instances", {})
    for inst in sorted(insts):
        proto = inst.split(":", 1)[0]
        ok, why = accepts(proto, insts[inst])
        if not ok:
            out.append(f"{inst}: {why} (seq={insts[inst]})")
    return out


def coverage(snap: Dict[str, object]) -> Dict[str, int]:
    """Instances observed per protocol — the non-vacuity surface."""
    counts: Dict[str, int] = {}
    for inst in snap.get("instances", {}):
        proto = inst.split(":", 1)[0]
        counts[proto] = counts.get(proto, 0) + 1
    return counts
