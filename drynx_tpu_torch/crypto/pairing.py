"""The optimal-ate pairing in plain PyTorch, the readable form.

The port's counterpart of drynx_tpu/crypto/pairing.py: the Frobenius maps
of the flat tower, `miller_loop`, `final_exp` and `pair`, on batched limb
tensors (int32 at the boundary, int64 inside), following the reference's
formulas. They run on any device as plain tensor code and serve as the
reference beside the kernels: the verifier's path is `cuda_pairing`
(`miller_flat`, `final_exp_flat`, `pair_flat`). The Miller value here is
the reference's, which differs from the kernel's (its add lines are scaled
by -1 against the kernel's); both agree after `final_exp`.
"""
from __future__ import annotations

import torch

from . import cuda_pairing as CP
from . import fp2 as F2
from . import fp12 as F12
from . import params
from .field import _like
from .params import NUM_LIMBS


def _frob(f, which: str):
    return CP.f12_slotmul_plain(f.reshape((-1,) + f.shape[-3:]), which
                                ).reshape(f.shape).to(f.dtype)


def _frob1(f):
    """f^p: conjugate each coefficient, times XI^(k(p-1)/6)."""
    return _frob(f, "frob1")


def _frob2(f):
    """f^(p^2): each coefficient times XI^(k(p^2-1)/6)."""
    return _frob(f, "frob2")


def _frob3(f):
    """f^(p^3): conjugate each coefficient, times XI^(k(p^3-1)/6)."""
    return _frob(f, "frob3")


def _dbl_step(T, xp, yp):
    """2T and the tangent at T evaluated at P, scaled by 2YZ^3:
    l = 2YZ^3 yp - 3X^2 Z^2 xp w + (3X^3 - 2Y^2) w^3."""
    X, Y, Z = T.unbind(-3)
    X2, Y2, Z2 = F2._sqr(torch.stack([X, Y, Z])).unbind(0)
    X3 = F2._mul(X2, X)
    threeX2 = F2._add(F2._add(X2, X2), X2)
    l3 = F2._sub(F2._add(F2._add(X3, X3), X3), F2._add(Y2, Y2))
    l1 = F2._mul_fp(F2._neg(F2._mul(threeX2, Z2)), xp)
    YZ3 = F2._mul(Y, F2._mul(Z, Z2))
    l0 = F2._mul_fp(F2._add(YZ3, YZ3), yp)
    return CP.g2_pdouble(T), CP._line(l0, l1, l3)


def _add_step(T, xq, yq, xp, yp):
    """T + Q (complete add), the line through T and the affine Q evaluated
    at P, scaled by HZ (H = X - xq Z^2, M = Y - yq Z^3):
    l = HZ yp - M xp w + (M xq - HZ yq) w^3, and whether it is vertical."""
    X, Y, Z = T.unbind(-3)
    Z2 = F2._sqr(Z)
    H = F2._sub(X, F2._mul(xq, Z2))
    M = F2._sub(Y, F2._mul(yq, F2._mul(Z, Z2)))
    HZ = F2._mul(H, Z)
    l0 = F2._mul_fp(HZ, yp)
    l1 = F2._mul_fp(F2._neg(M), xp)
    l3 = F2._sub(F2._mul(M, xq), F2._mul(HZ, yq))
    one2 = F2.one(X.device).to(torch.int64).expand_as(xq)
    Tq = CP.g2_padd(T, torch.stack([xq, yq, one2], dim=-3))
    return Tq, CP._line(l0, l1, l3), F2.is_zero(H)


def miller_loop(p_aff, q_aff):
    """f_{6u+2,Q}(P) l_{[6u+2]Q, pi(Q)}(P) l_{[6u+2]Q + pi(Q), -pi^2(Q)}(P),
    batched: p_aff = (xp, yp) (..., 16), q_aff = (xq, yq) (..., 2, 16),
    affine Montgomery. A vertical line contributes 1."""
    xp, yp = (t.to(torch.int64) for t in p_aff)
    xq, yq = (t.to(torch.int64) for t in q_aff)
    batch = torch.broadcast_shapes(xp.shape[:-1], xq.shape[:-2])
    xp, yp = (t.expand(batch + (NUM_LIMBS,)) for t in (xp, yp))
    xq, yq = (t.expand(batch + (2, NUM_LIMBS)) for t in (xq, yq))
    one2 = F2.one(xp.device).to(torch.int64).expand_as(xq)
    T = torch.stack([xq, yq, one2], dim=-3)
    f = F12._one_like(batch, xp.device)

    def add(T, f, xq_, yq_):
        """(T + Q, f l) where the line is not vertical, else (T + Q, f)."""
        Ta, line, vertical = _add_step(T, xq_, yq_, xp, yp)
        keep = ~vertical[..., None, None, None]
        return Ta, torch.where(keep, F12._mul(f, line), f), keep

    for bit in CP.ATE_BITS:
        T, line = _dbl_step(T, xp, yp)
        f = F12._mul(F12._sqr(f), line)
        if bit:
            T, f, _ = add(T, f, xq, yq)
    # the Frobenius corrections also keep T where the line is vertical
    q1x, q1y, nq2x = CP._frobenius_images(xq, yq)
    Ta, f, keep = add(T, f, q1x, q1y)
    _, f, _ = add(torch.where(keep, Ta, T), f, nq2x, yq)
    return f.to(torch.int32)


def _hard_part(f):
    """f^((p^4 - p^2 + 1)/n) for f in GPhi12 (its inverse is conj6): three
    powers by u, Frobenius maps and the Olivos addition chain."""
    mul, sqr, conj = F12.mul, F12.sqr, F12.conj6
    fx = F12.pow_const(f, params.U)
    fx2 = F12.pow_const(fx, params.U)
    fx3 = F12.pow_const(fx2, params.U)
    y0 = mul(mul(_frob1(f), _frob2(f)), _frob3(f))
    y1 = conj(f)
    y2 = _frob2(fx2)
    y3 = conj(_frob1(fx))
    y4 = conj(mul(fx, _frob1(fx2)))
    y5 = conj(fx2)
    y6 = conj(mul(fx3, _frob1(fx3)))
    t0 = mul(mul(sqr(y6), y4), y5)
    t1 = mul(mul(y3, y5), t0)
    t0 = mul(t0, y2)
    t1 = mul(sqr(t1), t0)
    t1 = sqr(t1)
    t0 = mul(t1, y1)
    t1 = mul(t1, y0)
    t0 = sqr(t0)
    return mul(t0, t1)


def final_exp(f):
    """f^((p^12 - 1)/n): the easy part (p^6 - 1)(p^2 + 1), then the hard
    part."""
    f1 = F12.mul(F12.conj6(f), F12.inv(f))
    return _like(_hard_part(F12.mul(_frob2(f1), f1)), f)


def pair(p_aff, q_aff):
    """The reduced optimal-ate pairing, batched (points at infinity are the
    caller's concern, as in the reference)."""
    return final_exp(miller_loop(p_aff, q_aff))


__all__ = ["miller_loop", "final_exp", "pair"]
