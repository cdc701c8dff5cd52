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


def survey_transcript(vns, survey_id: str) -> bytes:
    """Serialize one survey's verification outcome across all VNs."""
    lines = []
    for vn in vns.vns:
        stored = vn.stored_proofs(survey_id)
        for key, code in sorted(vn.bitmap_for(survey_id).items()):
            digest = hashlib.sha256(stored.get(key, b"")).hexdigest()
            lines.append(f"{vn.name} {key} {digest} {code}")
    return ("\n".join(lines) + "\n").encode()


def transcript_digest(vns, survey_id: str) -> str:
    return hashlib.sha256(survey_transcript(vns, survey_id)).hexdigest()


__all__ = ["survey_transcript", "transcript_digest"]
