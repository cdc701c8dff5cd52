"""Batched G1 (bn256, y^2 = x^3 + 3) group ops on torch limb tensors.

The port's counterpart of drynx_tpu/crypto/curve.py. A point is an int32
tensor (..., 3, 16): Jacobian (X, Y, Z) limbs in Montgomery form; the point
at infinity has Z == 0 (X, Y arbitrary nonzero: `infinity` gives the
reference's Montgomery ones, the kernels' own selects give plain ones, and
both are the same point).

`add`, `scalar_mul` and `scalar_mul_short` flatten their batch and go
through the kernels of `cuda_ops`; `normalize` goes through the Fp
inversion kernel of `cuda_pairing`. On the card a complete add is then one
launch rather than thousands of small torch ops. On CPU tensors the same
calls run the kernels' plain versions, so `scalar_mul` is the windowed
ladder of the reference's TPU path, not its 256-step jnp fallback; the
points agree, the Jacobian limbs need not.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_ops, cuda_pairing
from . import field as F
from . import params
from .field import FP
from .params import NUM_LIMBS
from ..utils.shapes import broadcast_shape


# ---------------------------------------------------------------------------
# Host helpers: oracle (affine int) <-> tensor (Jacobian limbs)
# ---------------------------------------------------------------------------

def from_ref(pt) -> torch.Tensor:
    """Oracle affine point (or None) -> (3, 16) Jacobian Montgomery limbs."""
    if pt is None:
        x, y, z = 1, 1, 0
    else:
        x, y = pt
        z = 1
    mont = lambda v: params.to_limbs(v * params.R % params.P)
    return torch.tensor([mont(x), mont(y), mont(z)], dtype=torch.int32)


def from_ref_batch(pts) -> torch.Tensor:
    return torch.stack([from_ref(p) for p in pts])


# a readback by design: the oracle's Python ints live on the host
def to_ref(pt):  # drynx: noqa[host-sync-in-hot-path]
    """(..., 3, 16) point(s) -> oracle affine point / list of points."""
    mx, my, inf = normalize(pt)
    xs = F.to_int(F.from_mont(mx, FP))
    ys = F.to_int(F.from_mont(my, FP))
    inf = inf.cpu().numpy()
    if inf.ndim == 0:
        return None if bool(inf) else (int(xs), int(ys))
    flat_x = np.asarray(xs, dtype=object).reshape(-1)
    flat_y = np.asarray(ys, dtype=object).reshape(-1)
    return [None if i else (int(x), int(y))
            for i, x, y in zip(inf.reshape(-1), flat_x, flat_y)]


def infinity(batch_shape=(), device="cpu") -> torch.Tensor:
    base = from_ref(None).to(device)
    return base.expand(tuple(batch_shape) + (3, NUM_LIMBS))


# ---------------------------------------------------------------------------
# Group law
# ---------------------------------------------------------------------------

def is_infinity(p):
    return F.is_zero(p[..., 2, :])


def double(p):
    """Jacobian doubling (a = 0): dbl-2009-l formulas."""
    return cuda_ops.pdouble(p.to(torch.int64)).to(torch.int32)


def _flat_batch(p, k):
    batch = broadcast_shape(p.shape[:-2], k.shape[:-1])
    pb = p.expand(batch + (3, NUM_LIMBS)).reshape(-1, 3, NUM_LIMBS)
    kb = k.expand(batch + (NUM_LIMBS,)).reshape(-1, NUM_LIMBS)
    return batch, pb, kb


def add(p, q):
    """Complete Jacobian addition, batched over broadcast leading dims."""
    batch = broadcast_shape(p.shape[:-2], q.shape[:-2])
    shape = batch + (3, NUM_LIMBS)
    out = cuda_ops.point_add_flat(p.expand(shape).reshape(-1, 3, NUM_LIMBS),
                                  q.expand(shape).reshape(-1, 3, NUM_LIMBS))
    return out.reshape(shape)


def neg(p):
    Y = F.neg(p[..., 1, :], FP)
    return torch.stack([p[..., 0, :], Y, p[..., 2, :]], dim=-2)


def scalar_mul(p, k_limbs):
    """k * P. k_limbs: (..., 16) plain (non-Montgomery) scalar limbs."""
    batch, pb, kb = _flat_batch(p, k_limbs)
    return cuda_ops.scalar_mul_flat(pb, kb).reshape(batch + (3, NUM_LIMBS))


def scalar_mul_short(p, k_limbs, n_bits: int = 64):
    """k * P for short scalars (k < 2^n_bits): the ladder runs
    ceil(n_bits/4) windows instead of 64; higher bits are ignored."""
    batch, pb, kb = _flat_batch(p, k_limbs)
    out = cuda_ops.scalar_mul_flat(pb, kb, n_windows=(n_bits + 3) // 4)
    return out.reshape(batch + (3, NUM_LIMBS))


def normalize(p):
    """Jacobian -> affine: returns (x, y, is_inf); x, y Montgomery limbs."""
    X, Y, Z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    inf = F.is_zero(Z)
    # avoid inv(0): substitute 1 for Z at infinity
    one = FP.one_mont(p.device).to(p.dtype)
    Zsafe = torch.where(inf[..., None], one, Z)
    Zi = cuda_pairing.fp_inv_flat(Zsafe.reshape(-1, NUM_LIMBS)).reshape(Z.shape)
    Zi2 = F.mont_mul(Zi, Zi, FP)
    x = F.mont_mul(X, Zi2, FP)
    y = F.mont_mul(Y, F.mont_mul(Zi, Zi2, FP), FP)
    return x, y, inf


def eq(p, q):
    """Point equality in Jacobian coords (cross-multiplied, no inversion)."""
    X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    X2, Y2, Z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    mul = lambda a, b: F.mont_mul(a, b, FP)
    Z1Z1, Z2Z2 = mul(Z1, Z1), mul(Z2, Z2)
    same_x = F.eq(mul(X1, Z2Z2), mul(X2, Z1Z1))
    same_y = F.eq(mul(Y1, mul(Z2, Z2Z2)), mul(Y2, mul(Z1, Z1Z1)))
    p_inf, q_inf = is_infinity(p), is_infinity(q)
    return (p_inf & q_inf) | (~p_inf & ~q_inf & same_x & same_y)


__all__ = [
    "from_ref", "from_ref_batch", "to_ref", "infinity",
    "is_infinity", "double", "add", "neg", "scalar_mul", "scalar_mul_short",
    "normalize", "eq",
]
