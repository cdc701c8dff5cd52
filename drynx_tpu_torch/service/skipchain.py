"""Hash-chained audit block store — the skipchain equivalent.

The reference commits each survey's proof-verification bitmap to a cothority
skipchain with a custom block verifier (`VerifyBitmap`,
services/service_skipchain.go:397-435; block creation :498-525). Here the
chain is a sequence of sha3-256-hash-linked blocks with pluggable verifiers;
storage is the proof store. The capability set matches the reference's
usage: create genesis, append blocks (each verifier must accept), fetch
genesis/latest/by-index, and validate the chain. A copy of
drynx_tpu/service/skipchain.py.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Optional

from ..resilience.policy import named_lock
from .store import ProofDB


@dataclasses.dataclass
class DataBlock:
    """Payload committed per survey (reference DataBlock, lib/structs.go)."""

    survey_id: str
    sample_time: float
    bitmap: dict[str, int]         # proof key -> bitmap code (0/1/2/4)

    def canonical(self) -> bytes:
        return json.dumps(
            {"survey_id": self.survey_id, "sample_time": self.sample_time,
             "bitmap": dict(sorted(self.bitmap.items()))},
            sort_keys=True, separators=(",", ":")).encode()


@dataclasses.dataclass
class Block:
    index: int
    prev_hash: str                 # hex
    data: DataBlock

    def hash(self) -> str:
        h = hashlib.sha3_256()
        h.update(self.index.to_bytes(8, "big"))
        h.update(bytes.fromhex(self.prev_hash) if self.prev_hash else b"")
        h.update(self.data.canonical())
        return h.hexdigest()

    def to_bytes(self) -> bytes:
        return json.dumps({
            "index": self.index, "prev_hash": self.prev_hash,
            "survey_id": self.data.survey_id,
            "sample_time": self.data.sample_time,
            "bitmap": self.data.bitmap}).encode()

    @classmethod
    def from_bytes(cls, b: bytes) -> "Block":
        d = json.loads(b.decode())
        return cls(index=d["index"], prev_hash=d["prev_hash"],
                   data=DataBlock(survey_id=d["survey_id"],
                                  sample_time=d["sample_time"],
                                  bitmap=d["bitmap"]))


Verifier = Callable[[Block], bool]


class SkipChain:
    """Append-only verified chain over a ProofDB."""

    def __init__(self, db: ProofDB, verifiers: Optional[list[Verifier]] = None):
        self.db = db
        self.verifiers = list(verifiers or [])
        n = db.get("chain/length")
        self._length = int(n.decode()) if n else 0
        # append is a read-modify-write on _length: two surveys'
        # end_verification commits can race here, so the chain extension
        # is serialized
        self._append_lock = named_lock("skipchain_append_lock")

    # -- reference API surface: CreateProofSkipchain / AppendProofSkipchain
    def create_genesis(self, data: DataBlock) -> Block:
        with self._append_lock:
            if self._length != 0:
                raise ValueError("chain already has a genesis block")
            return self._append_locked(data)

    def append(self, data: DataBlock) -> Block:
        with self._append_lock:
            return self._append_locked(data)

    def _append_locked(self, data: DataBlock) -> Block:
        prev = self.latest()
        blk = Block(index=self._length,
                    prev_hash=prev.hash() if prev else "", data=data)
        for v in self.verifiers:
            if not v(blk):
                raise ValueError(
                    f"block verifier rejected block {blk.index} "
                    f"(survey {data.survey_id})")
        self.db.put(f"chain/block/{blk.index}", blk.to_bytes())
        self._length += 1
        self.db.put("chain/length", str(self._length).encode())
        self.db.sync()
        return blk

    # -- retrieval (reference SendGetGenesis/BlockIntern/LatestBlock)
    def genesis(self) -> Optional[Block]:
        return self.block(0)

    def latest(self) -> Optional[Block]:
        return self.block(self._length - 1) if self._length else None

    def block(self, index: int) -> Optional[Block]:
        if index < 0 or index >= self._length:
            return None
        raw = self.db.get(f"chain/block/{index}")
        return Block.from_bytes(raw) if raw else None

    def block_for_survey(self, survey_id: str) -> Optional[Block]:
        for i in range(self._length):
            b = self.block(i)
            if b and b.data.survey_id == survey_id:
                return b
        return None

    def __len__(self) -> int:
        return self._length

    def validate(self) -> bool:
        """Full chain integrity walk (hash links)."""
        prev_hash = ""
        for i in range(self._length):
            b = self.block(i)
            if b is None or b.index != i or b.prev_hash != prev_hash:
                return False
            prev_hash = b.hash()
        return True


def bitmap_verifier(local_bitmaps: dict[str, dict[str, int]]) -> Verifier:
    """The reference's VerifyBitmap: accept a block iff its bitmap equals the
    VN's own locally-aggregated bitmap for that survey
    (services/service_skipchain.go:397-435)."""

    def verify(blk: Block) -> bool:
        local = local_bitmaps.get(blk.data.survey_id)
        return local is not None and local == blk.data.bitmap

    return verify


__all__ = ["DataBlock", "Block", "SkipChain", "bitmap_verifier"]
