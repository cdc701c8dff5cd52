"""Canonical byte serialization of group elements, and Fiat-Shamir hashing.

The port's counterpart of drynx_tpu/proofs/encoding.py, with the same
bytes:

  scalar / Fp element : 32 bytes big-endian
  G1 point            : x || y (64 B), infinity = all-zero
  G2 point            : x0 || x1 || y0 || y1 (128 B), infinity = all-zero
  GT element          : 6 Fp2 coefficients = 384 B

The *_bytes functions take batched limb tensors on any device, bring
points to affine on that device (the G1 and Fp2 inversion kernels on the
card), and return uint8 numpy arrays with a trailing byte axis.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..crypto import curve as C
from ..crypto import field as F
from ..crypto import g2 as G2
from ..crypto import params
from ..crypto.field import FP
from ..crypto.params import NUM_LIMBS


def limbs_to_bytes(limbs) -> np.ndarray:
    """(..., 16) little-endian 16-bit limbs -> (..., 32) uint8 big-endian."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    a = np.asarray(limbs).astype(np.uint32)
    rev = a[..., ::-1]  # most-significant limb first
    hi = (rev >> 8).astype(np.uint8)
    lo = (rev & 0xFF).astype(np.uint8)
    return np.stack([hi, lo], axis=-1).reshape(a.shape[:-1] + (2 * NUM_LIMBS,))


def bytes_to_limbs(b) -> torch.Tensor:
    """(..., 32) uint8 big-endian -> (..., 16) int32 limbs."""
    a = np.asarray(b, dtype=np.uint8)
    a = a.reshape(a.shape[:-1] + (NUM_LIMBS, 2)).astype(np.int32)
    return torch.from_numpy((a[..., 0] << 8 | a[..., 1])[..., ::-1].copy())


def scalar_bytes(s_limbs) -> np.ndarray:
    return limbs_to_bytes(s_limbs)


def g1_bytes(pts) -> np.ndarray:
    """Jacobian Montgomery G1 (..., 3, 16) -> canonical (..., 64) uint8."""
    x_m, y_m, inf = C.normalize(pts)
    xy = F.from_mont(torch.stack([x_m, y_m], dim=-2), FP)
    out = limbs_to_bytes(xy).reshape(xy.shape[:-2] + (64,))
    out[inf.cpu().numpy()] = 0
    return out


def g2_bytes(pts) -> np.ndarray:
    """Jacobian Montgomery G2 (..., 3, 2, 16) -> canonical (..., 128)
    uint8."""
    x_m, y_m, inf = G2.normalize(pts)
    xy = F.from_mont(torch.stack([x_m, y_m], dim=-3), FP)   # (..., 2, 2, 16)
    out = limbs_to_bytes(xy).reshape(xy.shape[:-3] + (128,))
    out[inf.cpu().numpy()] = 0
    return out


def gt_bytes(f) -> np.ndarray:
    """GT element (..., 6, 2, 16) Montgomery -> (..., 384) uint8."""
    b = limbs_to_bytes(F.from_mont(f, FP))                  # (..., 6, 2, 32)
    return b.reshape(b.shape[:-3] + (6 * 2 * 2 * NUM_LIMBS,))


def ct_bytes(cts) -> np.ndarray:
    """ElGamal ciphertexts (..., 2, 3, 16) -> (..., 128) uint8."""
    b = g1_bytes(cts)  # (..., 2, 64)
    return b.reshape(b.shape[:-2] + (128,))


def hash_to_scalar(*chunks, batch_shape=()) -> torch.Tensor:
    """sha3-512 over concatenated canonical bytes -> mod-n scalar limbs
    batch_shape + (16,), int32 on the CPU.

    Each chunk is a uint8 array of shape (k,) (a shared prefix) or
    batch_shape + (k,) (one per element)."""
    flat = int(np.prod(batch_shape, dtype=np.int64))
    rows = []
    for c in chunks:
        c = np.ascontiguousarray(c)
        if c.shape[:-1] == tuple(batch_shape):
            rows.append(c.reshape(flat, -1))
        else:
            rows.append(np.broadcast_to(c, (flat,) + c.shape).reshape(flat, -1))
    digests = []
    for i in range(flat):
        h = hashlib.sha3_512()
        for c in rows:
            h.update(c[i].tobytes())
        digests.append(int.from_bytes(h.digest(), "big") % params.N)
    return F.from_int(digests).reshape(tuple(batch_shape) + (NUM_LIMBS,))


__all__ = ["limbs_to_bytes", "bytes_to_limbs", "scalar_bytes", "g1_bytes",
           "g2_bytes", "gt_bytes", "ct_bytes", "hash_to_scalar"]
