"""Opt-in runtime determinism recorder: the dynamic half of the
determinism cross-check.

``DRYNX_DET_TRACE=1`` makes :mod:`drynx_tpu_torch` call :func:`install` at
import time; the byte-identity sinks the static pass reasons about
(:mod:`.determinism`) then report every write here: ``ProofDB.put``
(which covers ``pane:``/``ckpt:`` blobs, skipchain blocks and
checkpoint persistence), transcript serialization, and the fsync'd
EpsilonLedger / pool-store journal lines. Each write is reduced to a
sha256 hexdigest and stored as a **multiset per (sink, key)** — thread
interleaving may reorder arrivals, but two same-seed runs must produce
the same multiset of bytes at every key or the byte-identity claim is
false.

The cross-check (crosscheck.py ``bytes``; chip_smoke.py phase 17b) runs
the same proofs-on survey twice with the same seed under this recorder and
asserts (a) :func:`divergence` of the two snapshots is empty, and (b)
the statically-declared *laundered* sinks (transcript lines sorted
before hashing, journal records canonicalized with ``sort_keys``)
actually produced identical bytes — the runtime proof that the
launder table in the static pass is honest. Keys that are
nondeterministic **by declared design** (skipchain block bodies embed
the wall-clock ``sample_time`` that ``server/transcript.py``
deliberately excludes) are exempted by prefix, mirroring the
``# drynx: deterministic[...]`` markers at their sources.

Process-global and deliberately simple: one dict, O(1) work per write,
no payload retention (hashes only). Not for production — for tests.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, Iterable, List, Set, Tuple

_RECORDS: Dict[Tuple[str, str], List[str]] = {}
_LAUNDERED: Set[Tuple[str, str]] = set()
_GUARD = threading.Lock()                # created pre-install: untraced
_WRITES = 0
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
    global _WRITES
    with _GUARD:
        _RECORDS.clear()
        _LAUNDERED.clear()
        _WRITES = 0


def record(sink: str, key: str, blob: bytes,
           laundered: bool = False) -> None:
    """One sink write: ``sink`` names the surface (``proofdb``,
    ``transcript``, ``epsilon.journal``, ``pool.journal``), ``key``
    the address within it, ``blob`` the exact bytes written.
    ``laundered=True`` declares the bytes passed a canonicalization
    the static pass credits (sorted lines, sort_keys json) — the
    two-run check asserts those specifically, not just globally."""
    if not _INSTALLED:
        return
    global _WRITES
    h = hashlib.sha256(blob).hexdigest()
    with _GUARD:
        _RECORDS.setdefault((sink, key), []).append(h)
        if laundered:
            _LAUNDERED.add((sink, key))
        _WRITES += 1


def write_count() -> int:
    return _WRITES


def snapshot() -> Dict[str, object]:
    """JSON-able state for cross-process comparison: per-key sorted
    hash multisets plus the laundered key set."""
    with _GUARD:
        return {
            "records": {f"{s}:{k}": sorted(v)
                        for (s, k), v in _RECORDS.items()},
            "laundered": sorted(f"{s}:{k}" for s, k in _LAUNDERED),
            "writes": _WRITES,
        }


def laundered_keys() -> Set[str]:
    with _GUARD:
        return {f"{s}:{k}" for s, k in _LAUNDERED}


def divergence(snap_a: Dict[str, object], snap_b: Dict[str, object],
               exempt: Iterable[str] = ()) -> List[str]:
    """Keys whose write multisets differ between two snapshots,
    excluding keys under any ``exempt`` prefix (declared-nondet
    surfaces like skipchain block bodies). A key present in only one
    run diverges too — same-seed runs must visit the same sinks."""
    ex = tuple(exempt)
    ra = dict(snap_a.get("records", {}))
    rb = dict(snap_b.get("records", {}))
    out = []
    for key in sorted(set(ra) | set(rb)):
        if any(key.startswith(p) for p in ex):
            continue
        if ra.get(key) != rb.get(key):
            out.append(key)
    return out
