"""Batched Fp12 = Fp2[w]/(w^6 - XI) arithmetic (flat sextic extension).

The port's counterpart of drynx_tpu/crypto/fp12.py. An element is a tensor
(..., 6, 2, 16): six Fp2 coefficients of w^0..w^5, Montgomery limbs; int32
at module boundaries, int64 inside (the `_` functions, used by the plain
kernel versions of `cuda_pairing`). Products run over the Fp6 sub-tower
(v = w^2, v^3 = XI; f = A(v) + w B(v) with A = (f0, f2, f4), B = (f1, f3, f5))
with Karatsuba at both levels, 18 Fp2 products, stacked into one Montgomery
multiplication. `pair_host` is the port's host pairing: the reference's
pure-Python oracle (`refimpl.pair`), packed into limbs.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fp2 as F2
from . import params, refimpl
from .field import _like, _wide
from .params import NUM_LIMBS


def from_ref(x) -> torch.Tensor:
    """Oracle 6-tuple of Fp2 int pairs -> (6, 2, 16) int32 Montgomery."""
    return from_ref_batch([x])[0]


def from_ref_batch(xs) -> torch.Tensor:
    """A list of oracle Fp12 values -> (N, 6, 2, 16) int32 Montgomery, by
    one byte conversion (the host table builds pack ~10^5 values)."""
    P, R = params.P, params.R
    raw = b"".join((c % P * R % P).to_bytes(32, "little")
                   for x in xs for pair in x for c in pair)
    limbs = np.frombuffer(raw, dtype="<u2").astype(np.int32)
    return torch.from_numpy(limbs.reshape(len(xs), 6, 2, NUM_LIMBS))


def to_ref(x):
    return tuple(F2.to_ref(x[..., k, :, :]) for k in range(6))


def one(batch_shape=(), device="cpu") -> torch.Tensor:
    o = torch.zeros((6, 2, NUM_LIMBS), dtype=torch.int32, device=device)
    o[0] = F2.one(device)
    return o.expand(tuple(batch_shape) + (6, 2, NUM_LIMBS))


def pair_host(p, qs) -> torch.Tensor:
    """e(p, q) for each twist point q of `qs` (host affine ints, None for
    infinity) by the pure-Python oracle: (len(qs), 6, 2, 16) int32."""
    return from_ref_batch([refimpl.pair(p, q) for q in qs])


# ---------------------------------------------------------------------------
# int64 internals; an Fp6 value is a (..., 3, 2, 16) tensor
# ---------------------------------------------------------------------------

def _fp6_mul(a, b):
    """3-way Karatsuba: 6 Fp2 products, as one stacked product."""
    a, b = torch.broadcast_tensors(a, b)
    pairs = torch.stack([a[..., [0, 0, 1], :, :], b[..., [0, 0, 1], :, :]])
    rest = torch.stack([a[..., [1, 2, 2], :, :], b[..., [1, 2, 2], :, :]])
    s = F2._add(pairs, rest)                 # a0+a1, a0+a2, a1+a2 (and b)
    t = F2._mul(torch.cat([a, s[0]], dim=-3), torch.cat([b, s[1]], dim=-3))
    t0, t1, t2, m01, m02, m12 = t.unbind(-3)
    c0 = F2._add(t0, F2._mul_xi(F2._sub(F2._sub(m12, t1), t2)))
    c1 = F2._add(F2._sub(F2._sub(m01, t0), t1), F2._mul_xi(t2))
    c2 = F2._add(F2._sub(F2._sub(m02, t0), t2), t1)
    return torch.stack([c0, c1, c2], dim=-3)


def _fp6_mul_v(a):
    """Multiply by v: (a0, a1, a2) -> (XI a2, a0, a1)."""
    return torch.stack([F2._mul_xi(a[..., 2, :, :]), a[..., 0, :, :],
                        a[..., 1, :, :]], dim=-3)


def _split(f):
    return f[..., 0::2, :, :], f[..., 1::2, :, :]


def _join(A, B):
    return torch.stack([A, B], dim=-3).reshape(A.shape[:-3] + (6, 2, NUM_LIMBS))


def _mul(a, b):
    """Karatsuba over Fp6: 3 Fp6 products = 18 Fp2 products."""
    a, b = torch.broadcast_tensors(a, b)
    A1, B1 = _split(a)
    A2, B2 = _split(b)
    x = torch.stack([A1, B1, F2._add(A1, B1)])
    y = torch.stack([A2, B2, F2._add(A2, B2)])
    t0, t1, t2 = _fp6_mul(x, y)
    return _join(F2._add(t0, _fp6_mul_v(t1)),
                 F2._sub(F2._sub(t2, t0), t1))


def _sqr(a):
    """Complex-method squaring over Fp6: 2 Fp6 products."""
    A, B = _split(a)
    x = torch.stack([A, F2._add(A, B)])
    y = torch.stack([B, F2._add(A, _fp6_mul_v(B))])
    ab, t = _fp6_mul(x, y)
    c0 = F2._sub(F2._sub(t, ab), _fp6_mul_v(ab))
    return _join(c0, F2._add(ab, ab))


def _conj6(a):
    """a^(p^6): negate the odd-w coefficients."""
    A, B = _split(a)
    return _join(A, F2._neg(B))


def mul(a, b):
    return _like(_mul(_wide(a), _wide(b)), a)


def sqr(a):
    return _like(_sqr(_wide(a)), a)


def conj6(a):
    return _like(_conj6(_wide(a)), a)


def eq(a, b):
    return (a == b).flatten(-3).all(-1)


__all__ = ["from_ref", "from_ref_batch", "to_ref", "one", "pair_host", "mul",
           "sqr", "conj6", "eq"]
