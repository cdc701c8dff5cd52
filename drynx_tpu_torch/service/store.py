"""Proof store and survey checkpoints.

The port's counterpart of drynx_tpu/service/store.py: `ProofDB` is the
reference's pure-Python branch of its keyed byte store (an append-only log
of length-prefixed key/value records, last write wins, reloaded on reopen:
the same file layout), with the same API; the native C++ log is not built.
`SurveyCheckpoint` and `pane_key` (a streaming pane's blob) are copies.
It replaces the reference's bbolt store
(services/service_skipchain.go:489, protocols/proof_collection_protocol.go
:318-359).
"""
from __future__ import annotations

import dataclasses
import json
import os

from ..resilience.policy import named_lock

# DRYNX_DET_TRACE: hash every ProofDB write into the runtime determinism
# recorder (analysis/dettrace.py); pane:/ckpt: blobs, skipchain blocks and
# checkpoint persistence all land here.
_DET_TRACE = os.environ.get("DRYNX_DET_TRACE", "0") == "1"

# DRYNX_PROTO_TRACE: report SurveyCheckpoint lifecycle events
# (ctor/load/enter/save) to the runtime protocol recorder
# (analysis/prototrace.py).
_PROTO_TRACE = os.environ.get("DRYNX_PROTO_TRACE", "0") == "1"


class ProofDB:
    """Keyed byte store, last-write-wins, persistent across reopen."""

    def __init__(self, path: str):
        self.path = path
        self._lock = named_lock("proofdb_lock")
        self._mem: dict[bytes, bytes] = {}
        self._order: list[bytes] = []
        if os.path.exists(path):
            with open(path, "rb") as f:
                buf = f.read()
            off = 0
            while off + 8 <= len(buf):
                klen = int.from_bytes(buf[off:off + 4], "little")
                vlen = int.from_bytes(buf[off + 4:off + 8], "little")
                k = buf[off + 8:off + 8 + klen]
                v = buf[off + 8 + klen:off + 8 + klen + vlen]
                if len(v) < vlen:
                    break
                if k not in self._mem:
                    self._order.append(k)
                self._mem[k] = v
                off += 8 + klen + vlen

    @property
    def native(self) -> bool:
        return False

    def put(self, key: str | bytes, value: bytes) -> None:
        k = key.encode() if isinstance(key, str) else key
        if _DET_TRACE:
            from ..analysis import dettrace
            dettrace.record("proofdb", k.decode("utf-8", "replace"),
                            value)
        with self._lock:
            with open(self.path, "ab") as f:
                f.write(len(k).to_bytes(4, "little")
                        + len(value).to_bytes(4, "little") + k + value)
            if k not in self._mem:
                self._order.append(k)
            self._mem[k] = value

    def get(self, key: str | bytes) -> bytes | None:
        k = key.encode() if isinstance(key, str) else key
        with self._lock:
            return self._mem.get(k)

    def keys(self) -> list[bytes]:
        with self._lock:
            return list(self._order)

    def sync(self) -> None:
        """Every put is written through; nothing is buffered."""

    def close(self) -> None:
        """Nothing stays open between puts."""


_CKPT_PREFIX = b"ckpt:"

# A streaming survey's sealed panes keep their range-proof blobs in the same
# log, under a prefix no other path uses: a pane never changes, so every
# window slide and a restarted engine reuse the stored blob as it is.
_PANE_PREFIX = b"pane:"


def pane_key(stream_id: str, pane_id: int, dp_name: str) -> bytes:
    """ProofDB key of one (stream, pane, DP) range-proof blob."""
    return _PANE_PREFIX + f"{stream_id}/{int(pane_id)}/{dp_name}".encode()


@dataclasses.dataclass
class SurveyCheckpoint:
    """Per-survey phase checkpoint: which phase the state machine is in,
    which DPs have contributed, and how many times each phase was entered
    (a clean run has every counter at 1). Persisted through `ProofDB`
    under the ``ckpt:`` key prefix, which the proof paths never use."""

    survey_id: str
    phase: str = "admitted"
    responders: list = dataclasses.field(default_factory=list)
    absent: list = dataclasses.field(default_factory=list)
    resumes: int = 0
    done: bool = False
    phase_entries: dict = dataclasses.field(default_factory=dict)
    progress: dict = dataclasses.field(default_factory=dict)

    def _proto_event(self, event: str) -> None:
        """Report a lifecycle event to the runtime protocol recorder. The
        token is minted at the first event, so the ``from_bytes`` that
        :meth:`load` calls records no ``ctor`` before its ``load``."""
        from ..analysis import prototrace
        inst = getattr(self, "_proto_inst", None)
        if inst is None:
            inst = prototrace.new_instance("ckpt")
            self._proto_inst = inst
            if event != "load":
                prototrace.record(inst, "ctor")
        prototrace.record(inst, event)

    def enter(self, phase: str) -> "SurveyCheckpoint":
        """Record entry into a phase (idempotent re-entries increment
        the counter — that asymmetry is the resume evidence)."""
        if _PROTO_TRACE:
            self._proto_event("enter")
        self.phase = phase
        self.phase_entries[phase] = self.phase_entries.get(phase, 0) + 1
        return self

    def to_bytes(self) -> bytes:
        return json.dumps(dataclasses.asdict(self),
                          sort_keys=True).encode()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "SurveyCheckpoint":
        return cls(**json.loads(raw.decode()))

    def save(self, db: "ProofDB | None") -> None:
        if _PROTO_TRACE:
            self._proto_event("save")
        if db is not None:
            db.put(_CKPT_PREFIX + self.survey_id.encode(),
                   self.to_bytes())

    @classmethod
    def load(cls, db: "ProofDB | None",
             survey_id: str) -> "SurveyCheckpoint | None":
        if db is None:
            return None
        raw = db.get(_CKPT_PREFIX + survey_id.encode())
        if not raw:
            return None
        ck = cls.from_bytes(raw)
        if _PROTO_TRACE:
            ck._proto_event("load")
        return ck


__all__ = ["ProofDB", "SurveyCheckpoint", "pane_key"]
