"""GT-level operations of range-proof verification, through the kernels.

The port's counterpart of what verification takes from
drynx_tpu/crypto/batching.py: elementwise products, the Frobenius maps,
short powers, the product of a batch, and the two membership gates that
every wire-provided GT element passes before a cyclotomic power touches it.
Each function takes GT elements (..., 6, 2, 16) int32 over any leading
dims and flattens them into one launch of a `cuda_pairing` kernel; on CPU
tensors the same calls run the plain versions. There is no bucketing: the
reference's size buckets serve its compile cache, which has no counterpart
here.
"""
from __future__ import annotations

import torch

from . import cuda_pairing as CP
from . import field as F
from . import fp12 as F12
from . import params
from .params import NUM_LIMBS
from ..utils.shapes import broadcast_shape

GT_SHAPE = (6, 2, NUM_LIMBS)


def _flat(a):
    return a.reshape((-1,) + GT_SHAPE)


def gt_mul(a, b):
    """Elementwise GT product over broadcast leading dims (one kernel)."""
    batch = broadcast_shape(a.shape[:-3], b.shape[:-3])
    out = CP.f12_mul_flat(_flat(a.expand(batch + GT_SHAPE)),
                          _flat(b.expand(batch + GT_SHAPE)))
    return out.reshape(batch + GT_SHAPE)


def gt_frob1(a):
    """a^p elementwise."""
    return CP.f12_slotmul_flat(_flat(a), "frob1").reshape(a.shape)


def gt_frob2(a):
    """a^(p^2) elementwise."""
    return CP.f12_slotmul_flat(_flat(a), "frob2").reshape(a.shape)


def _gt_pow(a, k, n_bits: int):
    batch = broadcast_shape(a.shape[:-3], k.shape[:-1])
    k = k.expand(batch + (NUM_LIMBS,)).reshape(-1, NUM_LIMBS)
    out = CP.f12_wpow_flat(_flat(a.expand(batch + GT_SHAPE)), k,
                           n_bits=n_bits, cyc=True)
    return out.reshape(batch + GT_SHAPE)


def gt_pow64(a, k):
    """a^k for short k (the RLC weights, below 2^62): 21 windows of 3 bits,
    cyclotomic squares, so `a` must lie in GPhi12 (callers gate wire values
    through gt_membership_ok first)."""
    return _gt_pow(a, k, 63)


def gt_pow128(a, k):
    """a^k for k below 2^129 (the order gate's t - 1 = p - n), cyclotomic
    squares; `a` must lie in GPhi12."""
    return _gt_pow(a, k, 128)


def gt_reduce_prod(x):
    """The product of N GT elements, (N, 6, 2, 16) -> (6, 2, 16): padded
    with ones to the next power of 8 and folded by the 8-way product
    kernel, one launch per factor of 8 (5 for N = 13,500)."""
    n = x.shape[0]
    if n == 1:
        return x[0]
    target = 8
    while target < n:
        target *= 8
    if target != n:
        x = torch.cat([x, F12.one((target - n,), x.device)])
    while x.shape[0] > 1:
        x = CP.f12_mulreduce8_flat(x.reshape((-1, 8) + GT_SHAPE))
    return x[0]


# the membership and order checks return the host's verdict by design
def gt_membership_ok(a) -> bool:  # drynx: noqa[host-sync-in-hot-path]
    """Every element of `a` lies in GPhi12(p): z^(p^4) z == z^(p^2), i.e.
    z^(p^4 - p^2 + 1) = 1. Outside GPhi12 the cyclotomic square computes an
    unrelated function, so wire values pass this before any cyclotomic
    power."""
    flat = _flat(a)
    z2 = gt_frob2(flat)
    lhs = gt_mul(gt_frob2(z2), flat)
    return bool(F12.eq(lhs, z2).all())


def gt_order_ok(a) -> bool:  # drynx: noqa[host-sync-in-hot-path]
    """Every element of `a` has order dividing n: with t - 1 = p - n,
    frob1(a) == a^(t-1) iff a^(p - (t-1)) = a^n = 1. GPhi12 has order n c
    with 13 | c, so membership alone would let a commit-first forger hide
    a 13th root of unity in `a`. `a` must pass gt_membership_ok first (the
    power takes cyclotomic squares)."""
    flat = _flat(a)
    k = F.from_int(params.P - params.N).to(flat.device)
    return bool(F12.eq(gt_frob1(flat),
                       gt_pow128(flat, k.expand(len(flat), NUM_LIMBS))).all())


def _pairs(fn, px, py, qx, qy):
    out = fn(px.reshape(-1, NUM_LIMBS), py.reshape(-1, NUM_LIMBS),
             qx.reshape(-1, 2, NUM_LIMBS), qy.reshape(-1, 2, NUM_LIMBS))
    return out.reshape(px.shape[:-1] + GT_SHAPE)


def miller(px, py, qx, qy):
    """The Miller value of each (P, Q) pair over leading dims: px, py
    (..., 16), qx, qy (..., 2, 16) affine Montgomery."""
    return _pairs(CP.miller_flat, px, py, qx, qy)


def pair(px, py, qx, qy):
    """e(P, Q) over leading dims (points at infinity are the caller's
    concern, as in the reference's device path)."""
    return _pairs(CP.pair_flat, px, py, qx, qy)


__all__ = ["GT_SHAPE", "gt_mul", "gt_frob1", "gt_frob2", "gt_pow64",
           "gt_pow128", "gt_reduce_prod", "gt_membership_ok", "gt_order_ok",
           "miller", "pair"]
