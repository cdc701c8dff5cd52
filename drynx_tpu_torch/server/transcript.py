"""Deterministic per-survey verification transcripts.

A copy of drynx_tpu/server/transcript.py. A transcript is the sorted,
byte-serialized view of ONE survey's verification outcome across the whole
VN roster: for every recorded proof key, a line of
``<vn> <key> <sha256(payload)> <code>``. Two runs of one survey with the
same seed give the same transcript. (``DataBlock.sample_time`` is
wall-clock and deliberately excluded.)
"""
from __future__ import annotations

import hashlib
import os

# the runtime determinism recorder (analysis/dettrace.py): every transcript
_DET_TRACE = os.environ.get("DRYNX_DET_TRACE", "0") == "1"


def survey_transcript(vns, survey_id: str) -> bytes:
    """Serialize one survey's verification outcome across all VNs."""
    lines = []
    for vn in vns.vns:
        stored = vn.stored_proofs(survey_id)
        for key, code in sorted(vn.bitmap_for(survey_id).items()):
            digest = hashlib.sha256(stored.get(key, b"")).hexdigest()
            lines.append(f"{vn.name} {key} {digest} {code}")
    blob = ("\n".join(lines) + "\n").encode()
    if _DET_TRACE:
        # laundered: line order is sorted per VN over a roster-order
        # VN walk, so two same-seed runs must byte-match exactly
        from ..analysis import dettrace
        dettrace.record("transcript", survey_id, blob, laundered=True)
    return blob


def transcript_digest(vns, survey_id: str) -> str:
    return hashlib.sha256(survey_transcript(vns, survey_id)).hexdigest()


__all__ = ["survey_transcript", "transcript_digest"]
