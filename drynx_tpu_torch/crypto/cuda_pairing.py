"""CUDA kernels of the pairing module, each beside its plain PyTorch version.

The port's counterpart of drynx_tpu/crypto/pallas_pairing.py. It holds the
kernels that the survey and the range-proof creation run:

  fp_inv_flat          replaces _fp_inv_kernel          (csrc/fp_inv.cu)
  f2_inv_flat          replaces _f2_inv_kernel          (csrc/g2_ops.cu)
  g2_scalar_mul_flat   replaces _g2_scalar_mul_kernel   (csrc/g2_ops.cu)
  f12_mul_flat         replaces _f12_mul_kernel         (csrc/gt_ops.cu)
  f12_mulreduce8_flat  replaces _f12_mulreduce8_kernel  (csrc/gt_ops.cu)

and the glue around them that the creation path needs: `window_digits`,
`gt_pow_fixed` and `gt_pow_fixed_multi`, whose window-table gather stays
torch indexing, as the reference leaves it to XLA. The wrappers follow the
rules of `cuda_ops`: on a CUDA tensor a wrapper launches its kernel, counts
the launch in `LAUNCHES` and raises if the launch fails; on a CPU tensor it
runs the plain version. There is no other route between them.

The plain G2 group law here (`g2_pdouble`, `g2_padd`, `g2_inf_like`)
follows the reference's make_g2_group step for step: its formulas, its
select order and its point at infinity (X = Y = plain 1, Z = 0), so the
ladder kernel and its plain version agree on raw Jacobian limbs. Fp, Fp2
and Fp12 results are canonical residues, so there any formula gives the
same bytes. The exponent p - 2 is public: both inversions multiply only
where one of its bits is set (the reference multiplies always and selects).
What bounds each kernel is noted at the top of its source.
"""
from __future__ import annotations

import torch

from ..utils import cuda_build
from . import field as F
from . import fp2 as F2
from . import fp12 as F12
from .field import FP
from .params import NUM_LIMBS

LAUNCHES = {"fp_inv": 0, "f2_inv": 0, "g2_scalar_mul": 0, "f12_mul": 0,
            "f12_mulreduce8": 0}

WINDOW_ENTRIES = 16
N_WINDOWS = 64


# ---------------------------------------------------------------------------
# Plain G2 group law on int64 (..., 3, 2, 16) points (make_g2_group)
# ---------------------------------------------------------------------------

def g2_inf_like(shape, device) -> torch.Tensor:
    """The Pallas kernels' infinity on the twist: X = Y = (1, 0) with a
    plain 1, Z = 0; int64."""
    p = torch.zeros(tuple(shape) + (3, 2, NUM_LIMBS), dtype=torch.int64,
                    device=device)
    p[..., 0, 0, 0] = 1
    p[..., 1, 0, 0] = 1
    return p


def g2_pdouble(p: torch.Tensor) -> torch.Tensor:
    """Jacobian doubling on the twist (dbl-2009-l over Fp2)."""
    X, Y, Z = p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :]
    A = F2._sqr(X)
    Bv = F2._sqr(Y)
    Cv = F2._sqr(Bv)
    t = F2._sub(F2._sqr(F2._add(X, Bv)), F2._add(A, Cv))
    D = F2._add(t, t)
    E = F2._add(F2._add(A, A), A)
    X3 = F2._sub(F2._sqr(E), F2._add(D, D))
    C2 = F2._add(Cv, Cv)
    C4 = F2._add(C2, C2)
    Y3 = F2._sub(F2._mul(E, F2._sub(D, X3)), F2._add(C4, C4))
    YZ = F2._mul(Y, Z)
    return torch.stack([X3, Y3, F2._add(YZ, YZ)], dim=-3)


def g2_padd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete Jacobian add on the twist: add-2007-bl, then the
    reference's selects for P == Q, P == -Q and either operand at
    infinity."""
    p, q = torch.broadcast_tensors(p, q)
    X1, Y1, Z1 = p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :]
    X2, Y2, Z2 = q[..., 0, :, :], q[..., 1, :, :], q[..., 2, :, :]
    Z1Z1 = F2._sqr(Z1)
    Z2Z2 = F2._sqr(Z2)
    U1 = F2._mul(X1, Z2Z2)
    U2 = F2._mul(X2, Z1Z1)
    S1 = F2._mul(Y1, F2._mul(Z2, Z2Z2))
    S2 = F2._mul(Y2, F2._mul(Z1, Z1Z1))
    H = F2._sub(U2, U1)
    HH = F2._add(H, H)
    I = F2._sqr(HH)
    J = F2._mul(H, I)
    r = F2._sub(S2, S1)
    r = F2._add(r, r)
    V = F2._mul(U1, I)
    X3 = F2._sub(F2._sub(F2._sqr(r), J), F2._add(V, V))
    SJ = F2._mul(S1, J)
    Y3 = F2._sub(F2._mul(r, F2._sub(V, X3)), F2._add(SJ, SJ))
    ZZ = F2._sub(F2._sub(F2._sqr(F2._add(Z1, Z2)), Z1Z1), Z2Z2)
    Z3 = F2._mul(ZZ, H)
    res = torch.stack([X3, Y3, Z3], dim=-3)

    p_inf = F2.is_zero(Z1)
    q_inf = F2.is_zero(Z2)
    h0 = F2.is_zero(H)
    r0 = F2.is_zero(r)
    sel = lambda c, a, b: torch.where(c[..., None, None, None], a, b)
    res = sel(h0 & r0 & ~p_inf & ~q_inf, g2_pdouble(p), res)
    res = sel(h0 & ~r0 & ~p_inf & ~q_inf,
              g2_inf_like(res.shape[:-3], res.device), res)
    res = sel(q_inf, p, res)
    res = sel(p_inf, q, res)
    return res


def window_digits(k: torch.Tensor, n_win: int = N_WINDOWS) -> torch.Tensor:
    """(..., 16) plain limbs -> (..., n_win) int64 4-bit window values,
    least significant first."""
    w = torch.arange(n_win, device=k.device)
    limbs = k.to(torch.int64)[..., w // 4]
    return (limbs >> (4 * (w % 4))) & 0xF


# ---------------------------------------------------------------------------
# Plain versions of the kernels (int32 in, int32 out, any device)
# ---------------------------------------------------------------------------

def fp_inv_plain(x):
    """x^(p-2) per element, (N, 16) Montgomery in and out, int32."""
    return F._pow_const64(x.to(torch.int64), FP.modulus - 2, FP).to(torch.int32)


def f2_inv_plain(a):
    """1/a per element, (N, 2, 16) Montgomery in and out, int32."""
    return F2._inv(a.to(torch.int64)).to(torch.int32)


def g2_scalar_mul_plain(p, k):
    """k*Q on the twist: a 16-entry table d*Q, then 64 4-bit windows
    MSB-first, 4 doublings and one select-add each, every table entry read
    under a mask (pallas_pairing._g2_scalar_mul_kernel)."""
    Q = p.to(torch.int64)
    tab = [g2_inf_like(Q.shape[:1], Q.device), Q]
    for d in range(2, WINDOW_ENTRIES):
        tab.append(g2_pdouble(tab[d // 2]) if d % 2 == 0
                   else g2_padd(tab[d - 1], Q))
    tab = torch.stack(tab, dim=1)                     # (N, 16, 3, 2, 16)
    digits = window_digits(k)
    v = torch.arange(WINDOW_ENTRIES, device=Q.device)

    def select(d):
        mask = (d[:, None] == v).to(torch.int64)
        return (mask[:, :, None, None, None] * tab).sum(1)

    acc = select(digits[:, N_WINDOWS - 1])
    for w in range(N_WINDOWS - 2, -1, -1):
        for _ in range(4):
            acc = g2_pdouble(acc)
        acc = g2_padd(acc, select(digits[:, w]))
    return acc.to(torch.int32)


def f12_mul_plain(a, b):
    """Fp12 product per element, (N, 6, 2, 16) x (N, 6, 2, 16), int32."""
    return F12._mul(a.to(torch.int64), b.to(torch.int64)).to(torch.int32)


def f12_mulreduce8_plain(g):
    """Product of the 8 Fp12 values of each row, in row order:
    (N, 8, 6, 2, 16) -> (N, 6, 2, 16), int32."""
    g = g.to(torch.int64)
    acc = g[:, 0]
    for w in range(1, 8):
        acc = F12._mul(acc, g[:, w])
    return acc.to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _launch(lib, kernel, shape, inputs):
    """Launch `kernel` of csrc/<lib>.cu into a new int32 tensor of `shape`,
    one element per row, and count it."""
    out = torch.empty(shape, dtype=torch.int32, device=inputs[0].device)
    n = out.shape[0]
    if n == 0:
        return out
    cuda_build.launch(lib, kernel, out, inputs, (n,))
    LAUNCHES[kernel] += 1
    return out


def fp_inv_flat(x):
    """x^(p-2) batched: (N, 16) Montgomery -> (N, 16) Montgomery."""
    device = cuda_build.check_operands(("x", x))
    cuda_build.check_shape("x", x, (len(x), NUM_LIMBS))
    if device.type == "cpu":
        return fp_inv_plain(x)
    return _launch("fp_inv", "fp_inv", x.shape, (x,))


def f2_inv_flat(a):
    """Fp2 inverse batched: (N, 2, 16) Montgomery -> (N, 2, 16)."""
    device = cuda_build.check_operands(("a", a))
    cuda_build.check_shape("a", a, (len(a), 2, NUM_LIMBS))
    if device.type == "cpu":
        return f2_inv_plain(a)
    return _launch("g2_ops", "f2_inv", a.shape, (a,))


def g2_scalar_mul_flat(p, k):
    """k*Q batched: p (N, 3, 2, 16) Jacobian Montgomery, k (N, 16) plain
    scalars -> (N, 3, 2, 16)."""
    device = cuda_build.check_operands(("p", p), ("k", k))
    cuda_build.check_shape("p", p, (len(p), 3, 2, NUM_LIMBS))
    cuda_build.check_shape("k", k, (len(p), NUM_LIMBS))
    if device.type == "cpu":
        return g2_scalar_mul_plain(p, k)
    return _launch("g2_ops", "g2_scalar_mul", p.shape, (p, k))


def f12_mul_flat(a, b):
    """(N, 6, 2, 16) x (N, 6, 2, 16) -> (N, 6, 2, 16)."""
    device = cuda_build.check_operands(("a", a), ("b", b))
    cuda_build.check_shape("a", a, (len(a), 6, 2, NUM_LIMBS))
    cuda_build.check_shape("b", b, (len(a), 6, 2, NUM_LIMBS))
    if device.type == "cpu":
        return f12_mul_plain(a, b)
    return _launch("gt_ops", "f12_mul", a.shape, (a, b))


def f12_mulreduce8_flat(g):
    """(N, 8, 6, 2, 16) -> (N, 6, 2, 16): per-row product of 8 values."""
    device = cuda_build.check_operands(("g", g))
    cuda_build.check_shape("g", g, (len(g), 8, 6, 2, NUM_LIMBS))
    if device.type == "cpu":
        return f12_mulreduce8_plain(g)
    return _launch("gt_ops", "f12_mulreduce8", (g.shape[0], 6, 2, NUM_LIMBS),
                   (g,))


# ---------------------------------------------------------------------------
# Fixed-base GT powers through window tables (pallas_pairing.py:898-940)
# ---------------------------------------------------------------------------

def _reduce_windows(g):
    """(N, 64, 6, 2, 16) gathered window entries -> their product, by two
    passes of the 8-way product kernel (63 Fp12 products, no squarings)."""
    n = g.shape[0]
    r1 = f12_mulreduce8_flat(g.reshape(n * 8, 8, 6, 2, NUM_LIMBS))
    return f12_mulreduce8_flat(r1.reshape(n, 8, 6, 2, NUM_LIMBS))


def gt_pow_fixed(table, k):
    """base^k for a fixed base through its window table
    table[w][j] = base^(j * 16^w), (64, 16, 6, 2, 16); k (N, 16) plain
    limbs -> (N, 6, 2, 16)."""
    digs = window_digits(k)
    w = torch.arange(N_WINDOWS, device=k.device)
    return _reduce_windows(table[w[None, :], digs])


def gt_pow_fixed_multi(tables, base_idx, k):
    """bases[base_idx]^k, each element choosing one of a few fixed bases by
    its window table: tables (NB, 64, 16, 6, 2, 16), base_idx (N,) ints,
    k (N, 16) plain limbs -> (N, 6, 2, 16). The gather reads the entry the
    secret digit names, as the reference's XLA gather does."""
    digs = window_digits(k)
    w = torch.arange(N_WINDOWS, device=k.device)
    return _reduce_windows(tables[base_idx.to(torch.int64)[:, None],
                                  w[None, :], digs])


__all__ = ["LAUNCHES", "fp_inv_flat", "fp_inv_plain", "f2_inv_flat",
           "f2_inv_plain", "g2_scalar_mul_flat", "g2_scalar_mul_plain",
           "f12_mul_flat", "f12_mul_plain", "f12_mulreduce8_flat",
           "f12_mulreduce8_plain", "g2_pdouble", "g2_padd", "g2_inf_like",
           "window_digits", "gt_pow_fixed", "gt_pow_fixed_multi"]
