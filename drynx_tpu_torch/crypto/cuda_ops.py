"""CUDA kernels for the G1 hot path, each beside its plain PyTorch version.

The port's counterpart of drynx_tpu/crypto/pallas_ops.py. Four of the five
kernels of the encrypted survey's main path live here (the fifth, the Fp
inversion, is in `cuda_pairing`), written in CUDA C++ for sm_90a in
`csrc/g1_ops.cu` over the shared device header `csrc/bn256_g1.cuh`:

  fixed_base_mul_flat  replaces pallas_ops._fixed_base_kernel
  scalar_mul_flat      replaces pallas_ops._scalar_mul_kernel
  point_reduce_flat    replaces pallas_ops._point_reduce_kernel
  point_add_flat       replaces pallas_ops._point_add_kernel

Each wrapper takes int32 limb tensors in the reference layout (points
(N, 3, 16) Jacobian Montgomery, scalars (N, 16) plain). On a CUDA tensor it
launches its kernel, adds one to its count in `LAUNCHES`, and raises if the
launch fails; on a CPU tensor it runs the plain version. There is no other
route between them.

The plain versions follow their kernels step for step: the same window
order, the same table builds, the same complete-add formulas and select
order, and the Pallas kernels' point at infinity (X = Y = 1 plain, Z = 0,
`pallas_ops._inf_like`). The fixed-base kernel sums a row's windows in
FIXED_BASE_TEAM runs, one thread each, then adds the run sums in a binary
tree, and its plain version sums in that order, where the Pallas kernel
adds the windows one after another. Field values are canonical residues, so
a kernel and its plain version agree byte for byte, and agree with the
reference's jnp ladders as points (after normalisation: Jacobian limbs of
one point are not unique, and the tree gives another representative than
the sequential ladder).

What bounds the kernels, and what their design does about it, is noted at
the top of `csrc/g1_ops.cu`.
"""
from __future__ import annotations

import torch

from ..utils import cuda_build
from . import field as F
from .field import FP
from .params import NUM_LIMBS

LAUNCHES = {"fixed_base_mul": 0, "scalar_mul": 0, "point_reduce": 0,
            "point_add": 0}

WINDOW_ENTRIES = 16
# threads per row of the fixed-base kernel (csrc/g1_ops.cu, kFixedBaseTeam):
# the plain version sums in the kernel's grouping and tree order
FIXED_BASE_TEAM = 32


# ---------------------------------------------------------------------------
# Plain group law on int64 (..., 3, 16) point tensors (pallas_ops.make_group)
# ---------------------------------------------------------------------------

def _mul(a, b):
    return F._mont_mul64(a, b, FP)


def _fadd(a, b):
    return F._add64(a, b, FP)


def _fsub(a, b):
    return F._sub64(a, b, FP)


def inf_like(shape, device) -> torch.Tensor:
    """The Pallas kernels' infinity: X = Y = 1 (plain), Z = 0; int64."""
    p = torch.zeros(tuple(shape) + (3, NUM_LIMBS), dtype=torch.int64,
                    device=device)
    p[..., 0, 0] = 1
    p[..., 1, 0] = 1
    return p


def pdouble(p: torch.Tensor) -> torch.Tensor:
    """Jacobian doubling, a = 0 (dbl-2009-l)."""
    X, Y, Z = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    A = _mul(X, X)
    Bv = _mul(Y, Y)
    Cv = _mul(Bv, Bv)
    t0 = _fadd(X, Bv)
    t = _fsub(_mul(t0, t0), _fadd(A, Cv))
    D = _fadd(t, t)
    E = _fadd(_fadd(A, A), A)
    X3 = _fsub(_mul(E, E), _fadd(D, D))
    C2 = _fadd(Cv, Cv)
    C4 = _fadd(C2, C2)
    C8 = _fadd(C4, C4)
    Y3 = _fsub(_mul(E, _fsub(D, X3)), C8)
    YZ = _mul(Y, Z)
    Z3 = _fadd(YZ, YZ)
    return torch.stack([X3, Y3, Z3], dim=-2)


def padd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete Jacobian add: add-2007-bl, then the reference's selects for
    P == Q, P == -Q and either operand at infinity."""
    p, q = torch.broadcast_tensors(p, q)
    X1, Y1, Z1 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    X2, Y2, Z2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]
    Z1Z1 = _mul(Z1, Z1)
    Z2Z2 = _mul(Z2, Z2)
    U1 = _mul(X1, Z2Z2)
    U2 = _mul(X2, Z1Z1)
    S1 = _mul(Y1, _mul(Z2, Z2Z2))
    S2 = _mul(Y2, _mul(Z1, Z1Z1))
    H = _fsub(U2, U1)
    HH = _fadd(H, H)
    I = _mul(HH, HH)
    J = _mul(H, I)
    r = _fsub(S2, S1)
    r = _fadd(r, r)
    V = _mul(U1, I)
    X3 = _fsub(_fsub(_mul(r, r), J), _fadd(V, V))
    SJ = _mul(S1, J)
    Y3 = _fsub(_mul(r, _fsub(V, X3)), _fadd(SJ, SJ))
    t1 = _fadd(Z1, Z2)
    ZZ = _fsub(_fsub(_mul(t1, t1), Z1Z1), Z2Z2)
    Z3 = _mul(ZZ, H)
    res = torch.stack([X3, Y3, Z3], dim=-2)

    p_inf = F.is_zero(Z1)
    q_inf = F.is_zero(Z2)
    h0 = F.is_zero(H)
    r0 = F.is_zero(r)
    sel = lambda c, a, b: torch.where(c[..., None, None], a, b)
    res = sel(h0 & r0 & ~p_inf & ~q_inf, pdouble(p), res)
    res = sel(h0 & ~r0 & ~p_inf & ~q_inf, inf_like(res.shape[:-2], res.device),
              res)
    res = sel(q_inf, p, res)
    res = sel(p_inf, q, res)
    return res


def _digit(k: torch.Tensor, w) -> torch.Tensor:
    """4-bit window digit w of (N, 16) int64 scalar limbs; w an int, or a
    tensor of windows for (N, len(w)) digits."""
    return (k[:, w // 4] >> (4 * (w % 4))) & 0xF


def _select(entries: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Per-element table entry by digit, reading every entry under a mask
    (no load depends on the secret digit). entries: (..., 16, 3, 16)
    broadcast against d: (...) -> (..., 3, 16)."""
    v = torch.arange(WINDOW_ENTRIES, device=d.device)
    mask = (d[..., None] == v).to(torch.int64)
    return (mask[..., None, None] * entries).sum(-3)


# ---------------------------------------------------------------------------
# Plain versions of the kernels (int32 in, int32 out, any device)
# ---------------------------------------------------------------------------

def fixed_base_mul_plain(table, k, n_windows: int = 64):
    """k*P from the shared window table, W add-only windows, little-endian
    digits (pallas_ops._fixed_base_kernel), summed in the fixed-base
    kernel's order: FIXED_BASE_TEAM runs of 64 / FIXED_BASE_TEAM
    consecutive windows, each summed in order from a copy of its first
    selected entry (a run with no window below n_windows is infinity),
    then the run sums added pairwise, (0, 1), (2, 3), ..., level by level
    down to one."""
    tab = table.to(torch.int64)
    k64 = k.to(torch.int64)
    run = 64 // FIXED_BASE_TEAM
    starts = torch.arange(0, 64, run, device=k.device)
    parts = inf_like((k.shape[0], FIXED_BASE_TEAM), k.device)
    for j in range(min(run, n_windows)):
        w = starts + j
        w = w[w < n_windows]            # the runs that reach window j
        sel = _select(tab[w][None], _digit(k64, w))
        g = len(w)
        parts[:, :g] = sel if j == 0 else padd(parts[:, :g], sel)
    while parts.shape[1] > 1:
        parts = padd(parts[:, 0::2], parts[:, 1::2])
    return parts[:, 0].to(torch.int32)


def scalar_mul_plain(p, k, n_windows: int = 64):
    """Variable-base k*P: a 16-entry table d*P, then 4-bit windows
    MSB-first, 4 doublings and one select-add each
    (pallas_ops._scalar_mul_kernel)."""
    P = p.to(torch.int64)
    k64 = k.to(torch.int64)
    tab = [inf_like(P.shape[:1], P.device), P]
    for d in range(2, WINDOW_ENTRIES):
        tab.append(pdouble(tab[d // 2]) if d % 2 == 0 else padd(tab[d - 1], P))
    tab = torch.stack(tab, dim=1)                     # (N, 16, 3, 16)
    acc = _select(tab, _digit(k64, n_windows - 1))
    for w in range(n_windows - 2, -1, -1):
        for _ in range(4):
            acc = pdouble(acc)
        acc = padd(acc, _select(tab, _digit(k64, w)))
    return acc.to(torch.int32)


def point_reduce_plain(pts):
    """Complete-add sum over axis 0 of (R, N, 3, 16), rows in order
    (pallas_ops._point_reduce_kernel)."""
    pts = pts.to(torch.int64)
    acc = pts[0]
    for r in range(1, pts.shape[0]):
        acc = padd(acc, pts[r])
    return acc.to(torch.int32)


def point_add_plain(p, q):
    """Batched complete add (pallas_ops._point_add_kernel)."""
    return padd(p.to(torch.int64), q.to(torch.int64)).to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _launch(kernel, entry, out, inputs, ints, shape=None):
    """Launch csrc/g1_ops.cu's `entry` on the current stream into `out`
    and count it, recording the launch's shape (its rows, out.shape[0],
    unless given); raises if CUDA refused the launch."""
    if out.shape[0] == 0:
        return out
    cuda_build.launch("g1_ops", entry, out, inputs, ints)
    cuda_build.count(LAUNCHES, kernel,
                     out.shape[0] if shape is None else shape)
    return out


def _empty_points(n, device):
    return torch.empty((n, 3, NUM_LIMBS), dtype=torch.int32, device=device)


def fixed_base_mul_flat(table, k, n_windows: int = 64):
    """k*P via a shared fixed-base window table. table: (64, 16, 3, 16) as
    built by elgamal.FixedBase; k: (N, 16) plain scalars -> (N, 3, 16).
    n_windows < 64 truncates the ladder for small scalars (k < 16^W)."""
    device = cuda_build.check_operands(("table", table), ("k", k))
    cuda_build.check_shape("table", table, (64, WINDOW_ENTRIES, 3, NUM_LIMBS))
    cuda_build.check_shape("k", k, (k.shape[0], NUM_LIMBS))
    if not 1 <= n_windows <= 64:
        raise ValueError(f"n_windows must be in [1, 64], got {n_windows}")
    if device.type == "cpu":
        return fixed_base_mul_plain(table, k, n_windows)
    n = k.shape[0]
    return _launch("fixed_base_mul", "g1_fixed_base_mul",
                   _empty_points(n, device), (table, k), (n, n_windows))


def scalar_mul_flat(p, k, n_windows: int = 64):
    """k*P batched: p (N, 3, 16) Jacobian Montgomery, k (N, 16) plain
    scalars -> (N, 3, 16). n_windows < 64 truncates the ladder for short
    scalars (k < 16^W)."""
    device = cuda_build.check_operands(("p", p), ("k", k))
    n = p.shape[0]
    cuda_build.check_shape("p", p, (n, 3, NUM_LIMBS))
    cuda_build.check_shape("k", k, (n, NUM_LIMBS))
    if not 1 <= n_windows <= 64:
        raise ValueError(f"n_windows must be in [1, 64], got {n_windows}")
    if device.type == "cpu":
        return scalar_mul_plain(p, k, n_windows)
    return _launch("scalar_mul", "g1_scalar_mul", _empty_points(n, device),
                   (p, k), (n, n_windows))


def point_reduce_flat(pts):
    """Group-add reduce over axis 0: (R, N, 3, 16) -> (N, 3, 16). A launch
    is recorded in LAUNCH_ROWS as (R, N)."""
    device = cuda_build.check_operands(("pts", pts))
    R, n = pts.shape[0], pts.shape[1]
    cuda_build.check_shape("pts", pts, (R, n, 3, NUM_LIMBS))
    if R < 1:
        raise ValueError("point_reduce_flat needs at least one row")
    if device.type == "cpu":
        return point_reduce_plain(pts)
    return _launch("point_reduce", "g1_point_reduce", _empty_points(n, device),
                   (pts,), (R, n), shape=(R, n))


def point_add_flat(p, q):
    """Complete add, (N, 3, 16) x (N, 3, 16) -> (N, 3, 16)."""
    device = cuda_build.check_operands(("p", p), ("q", q))
    n = p.shape[0]
    cuda_build.check_shape("p", p, (n, 3, NUM_LIMBS))
    cuda_build.check_shape("q", q, (n, 3, NUM_LIMBS))
    if device.type == "cpu":
        return point_add_plain(p, q)
    return _launch("point_add", "g1_point_add", _empty_points(n, device),
                   (p, q), (n,))


__all__ = ["LAUNCHES", "fixed_base_mul_flat", "scalar_mul_flat",
           "point_reduce_flat", "point_add_flat", "fixed_base_mul_plain",
           "scalar_mul_plain", "point_reduce_plain", "point_add_plain",
           "pdouble", "padd", "inf_like"]
