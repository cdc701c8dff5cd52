"""Obfuscation ZK proof: "the same secret scalar s multiplies both ElGamal
components" (K' = s·K, C' = s·C).

The port's counterpart of drynx_tpu/proofs/obfuscation.py (reference
lib/obfuscation/obfuscation_proof.go), with the same challenges and wire
bytes. One proof batch covers a whole ciphertext vector: commitments,
challenges and responses are (V, ...) limb tensors, and creation and
verification are one launch each of the variable-base ladder, with the
batched add and the normalization of the transcript's points, around one
host-side Fiat-Shamir hash.

Sigma protocol per value:
  commit    A1 = w·K, A2 = w·C            (w fresh random)
  challenge c = H(K ‖ C ‖ K' ‖ C' ‖ A1 ‖ A2)
  response  z = w + c·s
  verify    z·K == A1 + c·K'  and  z·C == A2 + c·C'
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..crypto import curve as C
from ..crypto import elgamal as eg
from ..crypto import field as F
from ..crypto.field import FN
from ..crypto.params import NUM_LIMBS
from . import encoding as enc
from .keyswitch import _mul_plain
from .safe_pickle import TensorState


@dataclasses.dataclass
class ObfuscationProofBatch(TensorState):
    """Mirrors PublishedListObfuscationProof (obfuscation_proof.go:20-33)
    with the ciphertext axis batched."""

    orig: torch.Tensor       # (V, 2, 3, 16)
    obf: torch.Tensor        # (V, 2, 3, 16)
    a1: torch.Tensor         # (V, 3, 16) commitment w·K
    a2: torch.Tensor         # (V, 3, 16) commitment w·C
    challenge: torch.Tensor  # (V, 16)
    z: torch.Tensor          # (V, 16)

    def to_bytes(self) -> bytes:
        V = int(self.orig.shape[0])
        head = np.asarray([V], dtype="<i8").tobytes()
        w = _wire(self.orig, self.obf, self.a1, self.a2)
        parts = [*w, enc.scalar_bytes(self.challenge),
                 enc.scalar_bytes(self.z)]
        return head + b"".join(np.ascontiguousarray(p).tobytes()
                               for p in parts)


def _wire(orig, obf, a1, a2) -> list:
    """The canonical bytes of K ‖ C, K' ‖ C', A1 and A2, (V, 128), (V, 128),
    (V, 64), (V, 64): every point through one normalization (one launch of
    the inversion kernel)."""
    V = orig.shape[0]
    b = enc.g1_bytes(torch.cat([orig.reshape(-1, 3, NUM_LIMBS),
                                obf.reshape(-1, 3, NUM_LIMBS), a1, a2]))
    return [b[:2 * V].reshape(V, 128), b[2 * V:4 * V].reshape(V, 128),
            b[4 * V:5 * V], b[5 * V:]]


def _challenge(orig, obf, a1, a2) -> torch.Tensor:
    return enc.hash_to_scalar(*_wire(orig, obf, a1, a2),
                              batch_shape=tuple(orig.shape[:-3]))


def create_obfuscation_proofs(ct, s, generator: Optional[torch.Generator]
                              = None, draws=None) -> ObfuscationProofBatch:
    """ct: (V, 2, 3, 16) pre-obfuscation; s: (V, 16) the secret scalars.
    The commitment randomness w, (V, 16), is drawn from `generator`, or
    given as `draws`. (Reference ObfuscationProofCreation,
    obfuscation_proof.go:47-59.)"""
    dev = ct.device
    if draws is None:
        if generator is None:
            raise ValueError("create_obfuscation_proofs needs a generator "
                             "or draws")
        draws = eg.random_scalars(ct.shape[:-3], generator, dev)
    w, s = draws.to(dev), s.to(dev)
    # s·K, s·C, w·K and w·C in one launch of the ladder over 4V points
    obf, a = eg.ct_scalar_mul(torch.stack([ct, ct]), torch.stack([s, w]))
    a1, a2 = a[..., 0, :, :], a[..., 1, :, :]
    c = _challenge(ct, obf, a1, a2).to(dev)
    z = F.add(w, _mul_plain(c, s), FN)
    return ObfuscationProofBatch(orig=ct, obf=obf, a1=a1, a2=a2,
                                 challenge=c, z=z)


def _verify_kernel(pb: ObfuscationProofBatch) -> torch.Tensor:
    """The two equations, bool (V,): one ladder launch for z·K, z·C, c·K'
    and c·C', one add."""
    zs = torch.stack([pb.z, pb.z], dim=-2)
    cs = torch.stack([pb.challenge, pb.challenge], dim=-2)
    sm = C.scalar_mul(torch.cat([pb.orig, pb.obf]), torch.cat([zs, cs]))
    lhs, c_obf = sm.split(pb.orig.shape[0])
    rhs = C.add(torch.stack([pb.a1, pb.a2], dim=-3), c_obf)
    return C.eq(lhs, rhs).all(-1)


def verify_obfuscation_proofs(proof: ObfuscationProofBatch,
                              device=None) -> np.ndarray:
    """Returns bool (V,), computed on `device` (the proof's own by
    default). Recomputes the Fiat-Shamir challenge. (Reference
    ObfuscationProofVerification, obfuscation_proof.go:80-91.)"""
    if device is not None:
        proof = proof.to(device)
    ok = _verify_kernel(proof).cpu().numpy()
    want = _challenge(proof.orig, proof.obf, proof.a1, proof.a2)
    same = (proof.challenge.cpu().to(torch.int64)
            == want.to(torch.int64)).all(-1).numpy()
    return ok & same


def verify_obfuscation_list(proof: ObfuscationProofBatch, threshold: float,
                            device=None) -> bool:
    """Threshold-sampled verification over the value axis (reference
    ObfuscationListProofVerification, obfuscation_proof.go:94-110)."""
    V = int(proof.orig.shape[0])
    nbr = math.ceil(threshold * V)
    if nbr == 0:
        return True
    sub = ObfuscationProofBatch(
        orig=proof.orig[:nbr], obf=proof.obf[:nbr], a1=proof.a1[:nbr],
        a2=proof.a2[:nbr], challenge=proof.challenge[:nbr], z=proof.z[:nbr])
    return bool(np.all(verify_obfuscation_proofs(sub, device)))


__all__ = ["ObfuscationProofBatch", "create_obfuscation_proofs",
           "verify_obfuscation_proofs", "verify_obfuscation_list"]
