"""Signed proof-request envelopes + VN-side verification with bitmap codes.

Mirrors the reference's lib/proof/structs_proofs.go: every proof (range,
aggregation, obfuscation, shuffle, key-switch) is serialized, Schnorr-signed
by its sender (:117), and shipped to the VNs; a VN verifies the signature and
then — with probability `sample` (rand <= sample, :160,240,317,394,471) —
the payload itself, recording one of the bitmap codes (:22-27):

  BM_FALSE = 0   proof received and verification FAILED
  BM_TRUE  = 1   proof received and verified
  BM_RECVD = 2   proof received, payload verification skipped (sampling)
  BM_BADSIG = 4  signature check failed (payload never inspected)

A copy of drynx_tpu/proofs/requests.py, with one difference: a payload
verifier that raises fails its payload (BM_FALSE) unless the exception is
a fault of the program or the card (`cuda_build.is_fault`: a kernel that
failed to build or launch, memory that ran out, a CUDA error), which
propagates instead of showing up as a dirty bitmap.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional

import numpy as np

from ..utils import log
from ..utils.cuda_build import is_fault
from . import schnorr

BM_FALSE = 0
BM_TRUE = 1
BM_RECVD = 2
BM_BADSIG = 4

PROOF_TYPES = ("range", "shuffle", "aggregation", "obfuscation", "keyswitch")


@dataclasses.dataclass
class ProofRequest:
    """One signed proof envelope (reference ProofRequest :35-108)."""

    proof_type: str          # one of PROOF_TYPES
    survey_id: str
    sender_id: str
    differ_info: str         # disambiguates several proofs from one sender
    round_id: int
    data: bytes              # serialized proof payload
    signature: schnorr.Signature

    def signed_payload(self) -> bytes:
        return _payload(self.proof_type, self.survey_id, self.sender_id,
                        self.differ_info, self.round_id, self.data)

    def storage_key(self) -> str:
        """bbolt key layout (proof_collection_protocol.go:318-330)."""
        return "/".join([self.survey_id, self.proof_type, self.sender_id,
                         self.differ_info])


def _payload(proof_type: str, survey_id: str, sender_id: str,
             differ_info: str, round_id: int, data: bytes) -> bytes:
    h = hashlib.sha3_256()
    for part in (proof_type.encode(), survey_id.encode(), sender_id.encode(),
                 differ_info.encode(), round_id.to_bytes(8, "big")):
        h.update(len(part).to_bytes(4, "big"))
        h.update(part)
    h.update(data)
    return h.digest()


def new_proof_request(proof_type: str, survey_id: str, sender_id: str,
                      differ_info: str, round_id: int, data: bytes,
                      sender_secret: int) -> ProofRequest:
    """Serialize-and-sign (reference New*ProofRequest :110,188,265,342,420)."""
    if proof_type not in PROOF_TYPES:
        raise ValueError(f"unknown proof type {proof_type!r}")
    sig = schnorr.sign(sender_secret,
                       _payload(proof_type, survey_id, sender_id,
                                differ_info, round_id, data))
    return ProofRequest(proof_type=proof_type, survey_id=survey_id,
                        sender_id=sender_id, differ_info=differ_info,
                        round_id=round_id, data=data, signature=sig)


def verify_proof_request(req: ProofRequest, sender_pub,
                         sample: float,
                         verify_payload: Optional[Callable[[bytes, str], bool]],
                         rng: np.random.Generator) -> int:
    """VN-side verification -> bitmap code (reference VerifyProof family
    :135-492: signature check, then `rand.Float64() <= sample` gates the
    payload verification). `verify_payload(data, survey_id)` — the survey id
    lets the verifier fetch the query's expected parameters (e.g. per-value
    range specs, lib/structs.go:446-533)."""
    if not verify_signature(req, sender_pub):
        return BM_BADSIG
    if verify_payload is None or float(rng.random()) > sample:
        return BM_RECVD
    try:
        ok = verify_payload(req.data, req.survey_id)
    except Exception as e:
        if is_fault(e):
            raise
        # a malformed/malicious payload is a FAILED verification, not a
        # crash: the proof must still be counted so the survey's expected-
        # proof counter drains and the (dirty) audit block can commit.
        # Log it — an honest deployment hitting a verifier bug would
        # otherwise be indistinguishable from a malicious prover.
        import traceback

        log.warn(f"verify_payload raised for {req.storage_key()}: "
                 f"{traceback.format_exc(limit=8)}")
        ok = False
    return BM_TRUE if ok else BM_FALSE


def verify_signature(req: ProofRequest, sender_pub) -> bool:
    """Signature-only check (reference VerifyProofSignature :498-505)."""
    return schnorr.verify(sender_pub, req.signed_payload(), req.signature)


__all__ = ["BM_FALSE", "BM_TRUE", "BM_RECVD", "BM_BADSIG", "PROOF_TYPES",
           "ProofRequest", "new_proof_request", "verify_proof_request",
           "verify_signature"]
