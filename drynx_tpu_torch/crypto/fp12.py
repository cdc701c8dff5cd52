"""Batched Fp12 = Fp2[w]/(w^6 - XI) arithmetic (flat sextic extension).

The port's counterpart of drynx_tpu/crypto/fp12.py. An element is a tensor
(..., 6, 2, 16): six Fp2 coefficients of w^0..w^5, Montgomery limbs; int32
at module boundaries, int64 inside (the `_` functions, used by the plain
kernel versions of `cuda_pairing`). Products run over the Fp6 sub-tower
(v = w^2, v^3 = XI; f = A(v) + w B(v) with A = (f0, f2, f4), B = (f1, f3, f5))
with Karatsuba at both levels, 18 Fp2 products, stacked into one Montgomery
multiplication. The inverse goes down the tower (Fp6, Fp2, then one Fermat
inverse in Fp); `csqr` is the Granger-Scott cyclotomic square, the square
only on GPhi12. `pair_host` is the port's host pairing: the reference's
pure-Python oracle (`refimpl.pair`), packed into limbs.
"""
from __future__ import annotations

import numpy as np
import torch

from . import fp2 as F2
from . import params, refimpl
from .field import _like, _wide
from .params import NUM_LIMBS
from ..utils.shapes import broadcast_shape


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


def _fp6_inv(a):
    """1/a in Fp6 by the adjugate: 6 Fp2 products, 3 squares, 3 more
    products, one Fp2 inverse and 3 products (0 maps to 0)."""
    a0, a1, a2 = a.unbind(-3)
    s0, s2, s1 = F2._sqr(torch.stack([a0, a2, a1])).unbind(0)
    p12, p01, p02 = F2._mul(torch.stack([a1, a0, a0]),
                            torch.stack([a2, a1, a2])).unbind(0)
    c0 = F2._sub(s0, F2._mul_xi(p12))
    c1 = F2._sub(F2._mul_xi(s2), p01)
    c2 = F2._sub(s1, p02)
    m0, m1, m2 = F2._mul(torch.stack([a0, a1, a2]),
                         torch.stack([c0, c2, c1])).unbind(0)
    t = F2._add(m0, F2._mul_xi(F2._add(m1, m2)))
    return F2._mul(torch.stack([c0, c1, c2], dim=-3),
                   F2._inv(t).unsqueeze(-3))


def _inv(f):
    """Tower inverse: f = A + w B -> (A - w B) / (A^2 - v B^2)."""
    A, B = _split(f)
    AB = torch.stack([A, B])
    aa, bb = _fp6_mul(AB, AB)
    ra, rb = _fp6_mul(AB, _fp6_inv(F2._sub(aa, _fp6_mul_v(bb))))
    return _join(ra, F2._neg(rb))


# slots of the cyclotomic square's outputs: 3t - 2f_k for even k, 3t + 2f_k
# for odd k
_ODD_SLOT = torch.tensor([k % 2 == 1 for k in range(6)], dtype=torch.bool)


def _csqr(f):
    """Granger-Scott cyclotomic square (eprint 2009/565, section 3.2): 9
    Fp2 squares, stacked into one; the square only for f in GPhi12."""
    f0, f1, f2, f3, f4, f5 = f.unbind(-3)
    sq = F2._sqr(torch.stack([f3, f0, F2._add(f3, f0), f4, f1, F2._add(f4, f1),
                              f5, f2, F2._add(f5, f2)]))
    s0, s1, u6, s2, s3, u7, s4, s5, u8 = sq.unbind(0)
    t6 = F2._sub(F2._sub(u6, s0), s1)
    t7 = F2._sub(F2._sub(u7, s2), s3)
    t8 = F2._mul_xi(F2._sub(F2._sub(u8, s4), s5))
    t0 = F2._add(F2._mul_xi(s0), s1)
    t2 = F2._add(F2._mul_xi(s2), s3)
    t4 = F2._add(F2._mul_xi(s4), s5)
    t = torch.stack([t0, t8, t2, t6, t4, t7], dim=-3)
    odd = _ODD_SLOT.to(f.device)[:, None, None]
    d = torch.where(odd, F2._add(t, f), F2._sub(t, f))
    return F2._add(F2._add(d, d), t)


def _one_like(batch_shape, device):
    return one(batch_shape, device).to(torch.int64)


def _pow_bits(f, bits):
    """f^k, LSB-first square-and-multiply-always over bits (..., n) of k."""
    acc = _one_like(bits.shape[:-1], f.device)
    base = f.expand(bits.shape[:-1] + f.shape[-3:])
    for i in range(bits.shape[-1]):
        acc = torch.where(bits[..., i, None, None, None] == 1,
                          _mul(acc, base), acc)
        base = _sqr(base)
    return acc


def mul(a, b):
    return _like(_mul(_wide(a), _wide(b)), a)


def sqr(a):
    return _like(_sqr(_wide(a)), a)


def conj6(a):
    return _like(_conj6(_wide(a)), a)


def inv(a):
    """1/a through the tower; 0 maps to 0."""
    return _like(_inv(_wide(a)), a)


def csqr(a):
    """Cyclotomic square: a^2 for a in GPhi12 (any other input gives an
    unrelated value)."""
    return _like(_csqr(_wide(a)), a)


def pow_const(f, e: int):
    """f^e for a public exponent e >= 0 (LSB-first square-and-multiply)."""
    bits = torch.tensor([(e >> i) & 1 for i in range(e.bit_length())],
                        dtype=torch.int64, device=f.device)
    return _like(_pow_bits(_wide(f), bits.expand(f.shape[:-3] + bits.shape)),
                 f)


def pow_var(f, k_limbs, n_bits: int = 256):
    """f^k for a per-element exponent given as plain limbs (..., 16): the
    reference's n_bits-step square-and-multiply-always (n_bits < 256 reads
    only the low bits); batches over the leading dims of f and k."""
    k = k_limbs.to(torch.int64)
    bits = (k[..., :, None] >> torch.arange(16, device=k.device)) & 1
    bits = bits.reshape(k.shape[:-1] + (16 * NUM_LIMBS,))[..., :n_bits]
    batch = broadcast_shape(f.shape[:-3], k.shape[:-1])
    return _like(_pow_bits(_wide(f), bits.expand(batch + (n_bits,))), f)


def eq(a, b):
    return (a == b).flatten(-3).all(-1)


__all__ = ["from_ref", "from_ref_batch", "to_ref", "one", "pair_host", "mul",
           "sqr", "conj6", "inv", "csqr", "pow_const", "pow_var", "eq"]
