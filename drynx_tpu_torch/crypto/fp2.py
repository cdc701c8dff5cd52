"""Batched Fp2 = Fp[i]/(i^2 + 1) arithmetic on torch limb tensors.

The port's counterpart of drynx_tpu/crypto/fp2.py. An element is a tensor
(..., 2, 16) = (a0, a1) Montgomery limbs. Public functions follow
`field`: int32 in and out at module boundaries, int64 inside (the `_`
functions, which the plain kernel versions of `cuda_pairing` use). Every
result is the canonical residue, so it is byte-identical to the reference's
whatever formula computed it. A product runs its three Fp products as one
stacked Montgomery multiplication, so the plain versions stay few torch ops.
"""
from __future__ import annotations

import numpy as np
import torch

from . import field as F
from . import params
from .field import FP
from .params import NUM_LIMBS

# XI = x0 + i defines Fp12 and the twist; only x1 = 1 is handled
assert params.XI[1] == 1


def from_ref(a) -> torch.Tensor:
    """Oracle (a0, a1) ints -> (2, 16) int32 Montgomery limbs."""
    mont = lambda v: params.to_limbs(v % params.P * params.R % params.P)
    return torch.tensor([mont(a[0]), mont(a[1])], dtype=torch.int32)


def to_ref(x):
    """(..., 2, 16) Montgomery limbs -> (a0, a1) ints, or an object ndarray
    (..., 2) of ints for a batch."""
    a = np.asarray(F.to_int(F.from_mont(x.cpu(), FP)))
    if a.ndim == 1:
        return (int(a[0]), int(a[1]))
    return a


def one(device="cpu") -> torch.Tensor:
    o = torch.zeros((2, NUM_LIMBS), dtype=torch.int32, device=device)
    o[0] = FP.one_mont(device).to(torch.int32)
    return o


# ---------------------------------------------------------------------------
# int64 internals
# ---------------------------------------------------------------------------

def _add(a, b):
    return F._add64(a, b, FP)


def _sub(a, b):
    return F._sub64(a, b, FP)


def _neg(a):
    return F._sub64(torch.zeros_like(a), a, FP)


def _mul(a, b):
    """Karatsuba: (a0 b0 - a1 b1, (a0 + a1)(b0 + b1) - a0 b0 - a1 b1)."""
    a, b = torch.broadcast_tensors(a, b)
    s = _add(torch.stack([a[..., 0, :], b[..., 0, :]]),
             torch.stack([a[..., 1, :], b[..., 1, :]]))
    x = torch.stack([a[..., 0, :], a[..., 1, :], s[0]])
    y = torch.stack([b[..., 0, :], b[..., 1, :], s[1]])
    t0, t1, t2 = F._mont_mul64(x, y, FP)
    return torch.stack([_sub(t0, t1), _sub(_sub(t2, t0), t1)], dim=-2)


def _sqr(a):
    """(a0 + a1 i)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 i."""
    a0, a1 = a[..., 0, :], a[..., 1, :]
    x = torch.stack([_add(a0, a1), a0])
    y = torch.stack([_sub(a0, a1), a1])
    re, t = F._mont_mul64(x, y, FP)
    return torch.stack([re, _add(t, t)], dim=-2)


def _mul_fp(a, s):
    """a times the Fp element s (..., 16)."""
    return F._mont_mul64(a, s.unsqueeze(-2), FP)


def _mul_small(a, k: int):
    out = a
    for _ in range(k - 1):
        out = _add(out, a)
    return out


def _conj(a):
    return torch.stack([a[..., 0, :], _neg(a[..., 1, :])], dim=-2)


def _mul_xi(a):
    """a * XI with XI = x0 + i: (x0 a0 - a1) + (a0 + x0 a1) i."""
    xa = _mul_small(a, params.XI[0])
    return torch.stack([_sub(xa[..., 0, :], a[..., 1, :]),
                        _add(a[..., 0, :], xa[..., 1, :])], dim=-2)


def _inv(a):
    """1/(a0 + a1 i) = (a0 - a1 i)/(a0^2 + a1^2), the norm inverted by
    Fermat (0 maps to 0)."""
    sq = F._mont_mul64(a, a, FP)
    norm = _add(sq[..., 0, :], sq[..., 1, :])
    ninv = F._pow_const64(norm, FP.modulus - 2, FP)
    return _conj(_mul_fp(a, ninv))


# ---------------------------------------------------------------------------
# Public ops (dtype of the first argument in, same dtype out)
# ---------------------------------------------------------------------------

def _public(fn):
    def op(a, *rest):
        out = fn(F._wide(a), *[F._wide(r) if isinstance(r, torch.Tensor)
                                else r for r in rest])
        return F._like(out, a)
    op.__name__ = fn.__name__.lstrip("_")
    op.__doc__ = fn.__doc__
    return op


add = _public(_add)
sub = _public(_sub)
neg = _public(_neg)
mul = _public(_mul)
sqr = _public(_sqr)
mul_fp = _public(_mul_fp)
mul_small = _public(_mul_small)
conj = _public(_conj)
mul_xi = _public(_mul_xi)
inv = _public(_inv)


def eq(a, b):
    return (a == b).all(-1).all(-1)


def is_zero(a):
    return (a == 0).all(-1).all(-1)


__all__ = ["from_ref", "to_ref", "one", "add", "sub", "neg", "mul", "sqr",
           "mul_fp", "mul_small", "conj", "inv", "eq", "is_zero", "mul_xi"]
