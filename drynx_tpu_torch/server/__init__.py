"""Standing survey server: admission control, cross-survey batched
verification, a two-stage encode/verify pipeline over LocalCluster, and
its load generator (server/loadgen.py, imported by name).

The port's counterpart of drynx_tpu/server/. See scheduler.py for the
lanes and the threading rule, admission.py for the shape triage keyed on
the kernel warm-up registry (compilecache/).
"""
from .admission import (Admission, AdmissionController, AdmissionError,
                        EpsilonExhausted, Overloaded, QueueFull,
                        QuotaExceeded)
from .scheduler import SurveyServer, pipeline_overlap, refill_overlap
from .transcript import survey_transcript, transcript_digest

__all__ = [
    "Admission",
    "AdmissionController",
    "AdmissionError",
    "EpsilonExhausted",
    "Overloaded",
    "QueueFull",
    "QuotaExceeded",
    "SurveyServer",
    "pipeline_overlap",
    "refill_overlap",
    "survey_transcript",
    "transcript_digest",
]
