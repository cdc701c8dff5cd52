"""Aggregation proof: the published aggregate equals the homomorphic sum of
the published inputs.

The port's counterpart of drynx_tpu/proofs/aggregation.py (unlynx
AggregationListProofCreation/Verification, reference
lib/proof/structs_proofs.go:188-264). The proof is transparent: it
publishes inputs and output, and verification recomputes the sum, one
launch of the reduce kernel on the card.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..crypto import curve as C
from ..crypto import cuda_ops
from . import encoding as enc
from .safe_pickle import TensorState


@dataclasses.dataclass
class AggregationProofBatch(TensorState):
    """Inputs (n_contrib, V, 2, 3, 16) + claimed aggregate (V, 2, 3, 16)."""

    inputs: torch.Tensor
    aggregate: torch.Tensor

    def to_bytes(self) -> bytes:
        n, V = int(self.inputs.shape[0]), int(self.inputs.shape[1])
        head = np.asarray([n, V], dtype=np.int64).tobytes()
        return head + (np.ascontiguousarray(enc.ct_bytes(self.inputs)).tobytes()
                       + np.ascontiguousarray(
                           enc.ct_bytes(self.aggregate)).tobytes())


def create_aggregation_proof(inputs, aggregate) -> AggregationProofBatch:
    return AggregationProofBatch(inputs=inputs.to(torch.int32),
                                 aggregate=aggregate.to(torch.int32))


def verify_aggregation_proof(proof: AggregationProofBatch,
                             device=None) -> np.ndarray:
    """Returns bool (V,): the recomputed sum == the claimed aggregate, on
    `device` (the proof's own when None)."""
    if device is not None:
        proof = proof.to(device)
    x = proof.inputs
    acc = cuda_ops.point_reduce_flat(x.reshape(x.shape[0], -1, 3, x.shape[-1]))
    ok = C.eq(acc.reshape(x.shape[1:]), proof.aggregate)        # (V, 2)
    return ok.all(-1).cpu().numpy()


def verify_aggregation_list(proof: AggregationProofBatch, threshold: float,
                            device=None) -> bool:
    V = int(proof.inputs.shape[1])
    nbr = math.ceil(threshold * V)
    if nbr == 0:
        return True
    sub = AggregationProofBatch(inputs=proof.inputs[:, :nbr],
                                aggregate=proof.aggregate[:nbr])
    return bool(np.all(verify_aggregation_proof(sub, device)))


__all__ = ["AggregationProofBatch", "create_aggregation_proof",
           "verify_aggregation_proof", "verify_aggregation_list"]
