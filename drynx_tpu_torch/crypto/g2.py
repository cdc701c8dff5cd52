"""Batched G2 (sextic twist E'(Fp2): y^2 = x^3 + 3/XI) group ops.

The port's counterpart of drynx_tpu/crypto/g2.py. A point is an int32
tensor (..., 3, 2, 16): Jacobian (X, Y, Z), each an Fp2 element in
Montgomery form; the point at infinity has Z == 0 (`infinity` gives the
reference's Montgomery ones for X and Y, the kernels' selects give plain
ones; both are the same point).

`scalar_mul` flattens its batch and goes through the ladder kernel of
`cuda_pairing`; `normalize` goes through its Fp2 inversion kernel. On CPU
tensors the same calls run the kernels' plain versions, so `scalar_mul` is
the windowed ladder of the reference's TPU path, not its 256-step jnp
fallback: the points agree, the Jacobian limbs need not. The range-proof
layer blinds its digit signatures with it (V = v A[digit]).
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_pairing
from . import fp2 as F2
from .params import NUM_LIMBS
from ..utils.shapes import broadcast_shape


def from_ref(pt) -> torch.Tensor:
    """Oracle twist point ((x0, x1), (y0, y1)) or None -> (3, 2, 16)."""
    if pt is None:
        x, y, z = (1, 0), (1, 0), (0, 0)
    else:
        x, y = pt
        z = (1, 0)
    return torch.stack([F2.from_ref(x), F2.from_ref(y), F2.from_ref(z)])


# a readback by design: the oracle's Python ints live on the host
def to_ref(pt):  # drynx: noqa[host-sync-in-hot-path]
    """(3, 2, 16) point -> oracle affine point or None; (N, 3, 2, 16) ->
    a list of them."""
    x, y, inf = normalize(pt)
    xs, ys = F2.to_ref(x), F2.to_ref(y)
    if inf.dim() == 0:
        return None if bool(inf) else (xs, ys)
    xs = np.asarray(xs, dtype=object).reshape(-1, 2)
    ys = np.asarray(ys, dtype=object).reshape(-1, 2)
    return [None if i else ((int(x[0]), int(x[1])), (int(y[0]), int(y[1])))
            for i, x, y in zip(inf.cpu().reshape(-1).tolist(), xs, ys)]


def infinity(batch_shape=(), device="cpu") -> torch.Tensor:
    base = from_ref(None).to(device)
    return base.expand(tuple(batch_shape) + (3, 2, NUM_LIMBS))


def is_infinity(p):
    return F2.is_zero(p[..., 2, :, :])


def double(p):
    """Jacobian doubling on the twist (dbl-2009-l)."""
    return cuda_pairing.g2_pdouble(p.to(torch.int64)).to(torch.int32)


def add(p, q):
    """Complete Jacobian addition, batched over broadcast leading dims."""
    return cuda_pairing.g2_padd(p.to(torch.int64),
                                q.to(torch.int64)).to(torch.int32)


def neg(p):
    return torch.stack([p[..., 0, :, :], F2.neg(p[..., 1, :, :]),
                        p[..., 2, :, :]], dim=-3)


def scalar_mul(p, k_limbs):
    """k * Q. k_limbs: (..., 16) plain (non-Montgomery) scalar limbs."""
    batch = broadcast_shape(p.shape[:-3], k_limbs.shape[:-1])
    pb = p.expand(batch + (3, 2, NUM_LIMBS)).reshape(-1, 3, 2, NUM_LIMBS)
    kb = k_limbs.expand(batch + (NUM_LIMBS,)).reshape(-1, NUM_LIMBS)
    out = cuda_pairing.g2_scalar_mul_flat(pb, kb)
    return out.reshape(batch + (3, 2, NUM_LIMBS))


def normalize(p):
    """Jacobian -> affine: returns (x, y, is_inf); x, y Fp2 Montgomery."""
    X, Y, Z = p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :]
    inf = is_infinity(p)
    Zsafe = torch.where(inf[..., None, None], F2.one(p.device).to(p.dtype), Z)
    Zi = cuda_pairing.f2_inv_flat(
        Zsafe.reshape(-1, 2, NUM_LIMBS)).reshape(Z.shape)
    Zi2 = F2.sqr(Zi)
    return F2.mul(X, Zi2), F2.mul(Y, F2.mul(Zi, Zi2)), inf


def eq(p, q):
    """Point equality in Jacobian coords (cross-multiplied, no inversion)."""
    X1, Y1, Z1 = p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :]
    X2, Y2, Z2 = q[..., 0, :, :], q[..., 1, :, :], q[..., 2, :, :]
    Z1Z1, Z2Z2 = F2.sqr(Z1), F2.sqr(Z2)
    same_x = F2.eq(F2.mul(X1, Z2Z2), F2.mul(X2, Z1Z1))
    same_y = F2.eq(F2.mul(Y1, F2.mul(Z2, Z2Z2)),
                   F2.mul(Y2, F2.mul(Z1, Z1Z1)))
    p_inf, q_inf = is_infinity(p), is_infinity(q)
    return (p_inf & q_inf) | (~p_inf & ~q_inf & same_x & same_y)


__all__ = ["from_ref", "to_ref", "infinity", "is_infinity", "double", "add",
           "neg", "scalar_mul", "normalize", "eq"]
