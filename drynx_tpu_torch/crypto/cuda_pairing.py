"""CUDA kernels of the pairing module, each beside its plain PyTorch version.

The port's counterpart of drynx_tpu/crypto/pallas_pairing.py. It holds the
kernels that the survey and the range proofs run:

  fp_inv_flat          replaces _fp_inv_kernel          (csrc/fp_inv.cu)
  f2_inv_flat          replaces _f2_inv_kernel          (csrc/g2_ops.cu)
  g2_scalar_mul_flat   replaces _g2_scalar_mul_kernel   (csrc/g2_ops.cu)
  f12_mul_flat         replaces _f12_mul_kernel         (csrc/gt_ops.cu)
  f12_mulreduce8_flat  replaces _f12_mulreduce8_kernel  (csrc/gt_ops.cu)
  f12_inv_flat         replaces _f12_inv_kernel         (csrc/gt_ops.cu)
  f12_csqr_flat        replaces _f12_csqr_kernel        (csrc/gt_ops.cu)
  f12_slotmul_flat     replaces _f12_slotmul_kernel     (csrc/gt_ops.cu)
  f12_wpow_flat        replaces _f12_wpow_kernel        (csrc/gt_ops.cu)
  f12_pow_flat         replaces _f12_pow_kernel         (csrc/gt_ops.cu)
  miller_flat          replaces _miller_kernel          (csrc/miller.cu)

and the glue around them: `window_digits`, `gt_pow_fixed` and
`gt_pow_fixed_multi` (whose window-table gather stays torch indexing, as
the reference leaves it to XLA), `final_exp_flat` and `pair_flat`. The
wrappers follow the rules of `cuda_ops`: on a CUDA tensor a wrapper
launches its kernel, counts the launch in `LAUNCHES` and raises if the
launch fails; on a CPU tensor it runs the plain version. There is no other
route between them.

The plain G2 group law here (`g2_pdouble`, `g2_padd`, `g2_inf_like`)
follows the reference's make_g2_group step for step: its formulas, its
select order and its point at infinity (X = Y = plain 1, Z = 0), so the
ladder kernel and its plain version agree on raw Jacobian limbs. Fp, Fp2
and Fp12 results are canonical residues, so there any formula gives the
same bytes. The exponent p - 2 is public: both plain inversions, and the
Fp2 inversion's kernel, multiply only where one of its bits is set (the
reference multiplies always and selects); the Fp inversion's kernel reaches
the same residue by a constant-time safegcd (csrc/fp_inv.cuh).
The Miller value is the exception: its line scalings and Jacobian
coordinates are the kernel's own, so `miller_plain` follows _miller_kernel's
formulas step for step and equals the reference's Miller value only after
the final exponentiation. What bounds each kernel is noted at the top of
its source.
"""
from __future__ import annotations

import functools

import torch

from ..utils import cuda_build
from . import field as F
from . import fp2 as F2
from . import fp12 as F12
from . import params, refimpl
from .field import FP
from .params import NUM_LIMBS

LAUNCHES = {"fp_inv": 0, "f2_inv": 0, "g2_scalar_mul": 0, "f12_mul": 0,
            "f12_mulreduce8": 0, "miller": 0, "f12_inv": 0, "f12_csqr": 0,
            "f12_slotmul": 0, "f12_wpow": 0, "f12_pow": 0}

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


def f12_inv_plain(a):
    """1/a per row through the tower, (N, 6, 2, 16) int32; 0 maps to 0."""
    return F12._inv(a.to(torch.int64)).to(torch.int32)


def f12_csqr_plain(a):
    """Cyclotomic square per row (the square only on GPhi12), int32."""
    return F12._csqr(a.to(torch.int64)).to(torch.int32)


# ---------------------------------------------------------------------------
# Slot multiplications: the Frobenius maps and conj6 (pairing.py:334-378)
# ---------------------------------------------------------------------------

SLOT_MAPS = ("frob1", "frob2", "frob3", "conj6")


@functools.lru_cache(maxsize=None)
def _slot_constants(which: str, device: str) -> torch.Tensor:
    """The six Fp2 constants c_k of `which` on `device`, (6, 2, 16) int32
    Montgomery: the powers of XI^((p^e - 1)/6) for frob<e> (w^(p^e) =
    w XI^((p^e - 1)/6)), +-1 for conj6."""
    if which not in SLOT_MAPS:
        raise ValueError(f"no slot map {which!r}; expected one of {SLOT_MAPS}")
    if which == "conj6":
        consts = [(1, 0) if k % 2 == 0 else (params.P - 1, 0)
                  for k in range(6)]
    else:
        e = SLOT_MAPS.index(which) + 1
        g = refimpl.fp2_pow(params.XI, (params.P ** e - 1) // 6)
        consts, cur = [], (1, 0)
        for _k in range(6):
            consts.append(cur)
            cur = refimpl.fp2_mul(cur, g)
    return torch.stack([F2.from_ref(c) for c in consts]).to(
        device=device, dtype=torch.int32)


def _conjugates(which: str) -> bool:
    """Odd Frobenius powers also conjugate each Fp2 coefficient
    (p = 3 mod 4, so i^p = -i)."""
    return which in ("frob1", "frob3")


def f12_slotmul_plain(a, which: str):
    """out[k] = (conj(a[k]) if frob1/frob3 else a[k]) * c_k per row, int32."""
    x = a.to(torch.int64)
    if _conjugates(which):
        x = F2._conj(x)
    c = _slot_constants(which, str(a.device)).to(torch.int64)
    return F2._mul(x, c).to(torch.int32)


# ---------------------------------------------------------------------------
# Windowed powers (pallas_pairing._f12_wpow_kernel)
# ---------------------------------------------------------------------------

WPOW_WBITS = 3
WPOW_ENTRIES = 1 << WPOW_WBITS


def window3_digits(k: torch.Tensor, n_win: int) -> torch.Tensor:
    """(N, 16) plain limbs -> (N, n_win) int64 3-bit windows, least
    significant first: window w is bits 3w..3w+2 (it may straddle two
    limbs; bits past the top limb read as 0)."""
    kk = k.to(torch.int64)
    w = torch.arange(n_win, device=k.device)
    limb, s = (3 * w) // 16, (3 * w) % 16
    nxt = torch.where(limb + 1 < NUM_LIMBS,
                      kk[:, (limb + 1).clamp(max=NUM_LIMBS - 1)], 0)
    hi = torch.where(s > 13, nxt << (16 - s).clamp(min=0), 0)
    return ((kk[:, limb] >> s) | hi) & (WPOW_ENTRIES - 1)


def f12_wpow_plain(f, k, n_bits: int, cyc: bool = False):
    """f^k per row by 3-bit windows MSB-first over the table [1, f, ...,
    f^7]; `cyc` takes cyclotomic squares (f in GPhi12). f (N, 6, 2, 16),
    k (N, 16) plain limbs, int32 in and out."""
    sqr = F12._csqr if cyc else F12._sqr
    x = f.to(torch.int64)
    n = x.shape[0]
    tab = [F12._one_like((n,), x.device), x]
    for d in range(2, WPOW_ENTRIES):
        tab.append(sqr(tab[d // 2]) if d % 2 == 0 else F12._mul(tab[d - 1], x))
    tab = torch.stack(tab, dim=1)                      # (N, 8, 6, 2, 16)
    n_win = (n_bits + WPOW_WBITS - 1) // WPOW_WBITS
    digits = window3_digits(k, n_win)
    rows = torch.arange(n, device=x.device)
    acc = tab[rows, digits[:, n_win - 1]]
    for w in range(n_win - 2, -1, -1):
        for _ in range(WPOW_WBITS):
            acc = sqr(acc)
        acc = F12._mul(acc, tab[rows, digits[:, w]])
    return acc.to(torch.int32)


# ---------------------------------------------------------------------------
# The Miller loop (pallas_pairing._miller_kernel, formulas at :343-432)
# ---------------------------------------------------------------------------

# 6u + 2 below its leading one, most significant bit first (65 bits)
ATE_BITS = [int(b) for b in bin(6 * params.U + 2)[3:]]


@functools.lru_cache(maxsize=None)
def _twist_frob_constants(device: str) -> torch.Tensor:
    """(3, 2, 16) int64: XI^((p-1)/3), XI^((p-1)/2), XI^((p^2-1)/3)."""
    return torch.stack([F2.from_ref(c) for c in
                        (refimpl._G12, refimpl._G13, refimpl._G22)]
                       ).to(device, torch.int64)


def _frobenius_images(qx, qy):
    """pi(Q) = (conj(x) g12, conj(y) g13) and the x of -pi^2(Q) = (x g22, y)
    for int64 twist coordinates, as one stacked product."""
    g12, g13, g22 = _twist_frob_constants(str(qx.device))
    q1x, q1y, nq2x = F2._mul(
        torch.stack([F2._conj(qx), F2._conj(qy), qx]),
        torch.stack([g12.expand_as(qx), g13.expand_as(qx), g22.expand_as(qx)]))
    return q1x, q1y, nq2x


def _line(l0, l1, l3):
    """The sparse Fp12 l0 + l1 w + l3 w^3."""
    z = torch.zeros_like(l0)
    return torch.stack([l0, l1, z, l3, z, z], dim=-3)


def _miller_dbl(T, f, xp, yp):
    """T <- 2T and f <- f^2 l_{T,T}(P), the tangent scaled by 2YZ^3."""
    X, Y, Z = T.unbind(-3)
    A, Bv, zz = F2._sqr(torch.stack([X, Y, Z])).unbind(0)
    E = F2._add(F2._add(A, A), A)
    AX, Ezz, YZ = F2._mul(torch.stack([A, E, Y]),
                          torch.stack([X, zz, Z])).unbind(0)
    l3 = F2._sub(F2._add(F2._add(AX, AX), AX), F2._add(Bv, Bv))
    YZ3 = F2._mul(YZ, zz)
    l1, l0 = F2._mul_fp(torch.stack([F2._neg(Ezz), F2._add(YZ3, YZ3)]),
                        torch.stack([xp, yp])).unbind(0)
    return g2_pdouble(T), F12._mul(F12._sqr(f), _line(l0, l1, l3))


def _miller_add(T, f, qx, qy, xp, yp):
    """T <- T + Q (madd-2007-bl) and f <- f l_{T,Q}(P) with the line
    HZ yp - r xp w + (r qx - HZ qy) w^3; where the line is vertical (H = 0)
    both stay as they were."""
    X1, Y1, Z1 = T.unbind(-3)
    zz = F2._sqr(Z1)
    U2, Zzz = F2._mul(torch.stack([qx, Z1]), torch.stack([zz, zz])).unbind(0)
    S2 = F2._mul(qy, Zzz)
    Hm, r1 = F2._sub(U2, X1), F2._sub(S2, Y1)
    HmZ = F2._mul(Hm, Z1)
    l0, l1 = F2._mul_fp(torch.stack([HmZ, F2._neg(r1)]),
                        torch.stack([yp, xp])).unbind(0)
    rq, hq = F2._mul(torch.stack([r1, HmZ]), torch.stack([qx, qy])).unbind(0)
    f2 = F12._mul(f, _line(l0, l1, F2._sub(rq, hq)))
    HH = F2._sqr(Hm)
    I4 = F2._add(F2._add(HH, HH), F2._add(HH, HH))
    J, V = F2._mul(torch.stack([Hm, X1]), torch.stack([I4, I4])).unbind(0)
    rm = F2._add(r1, r1)
    X3 = F2._sub(F2._sub(F2._sqr(rm), J), F2._add(V, V))
    YJ = F2._mul(Y1, J)
    Y3 = F2._sub(F2._mul(rm, F2._sub(V, X3)), F2._add(YJ, YJ))
    Z3 = F2._sub(F2._sub(F2._sqr(F2._add(Z1, Hm)), zz), HH)
    keep = ~F2.is_zero(Hm)
    T = torch.where(keep[..., None, None, None],
                    torch.stack([X3, Y3, Z3], dim=-3), T)
    return T, torch.where(keep[..., None, None, None], f2, f)


def miller_plain(px, py, qx, qy):
    """The optimal-ate Miller value per row, (N, 6, 2, 16) int32, for
    affine G1 (px, py) (N, 16) and affine twist points (qx, qy) (N, 2, 16),
    all Montgomery. The bits of 6u + 2 are public: like the kernel, this
    version adds only where one is set."""
    xp, yp = px.to(torch.int64), py.to(torch.int64)
    qx, qy = qx.to(torch.int64), qy.to(torch.int64)
    n = xp.shape[0]
    one2 = F2.one(xp.device).to(torch.int64).expand(n, 2, NUM_LIMBS)
    T = torch.stack([qx, qy, one2], dim=-3)
    f = F12._one_like((n,), xp.device)
    for bit in ATE_BITS:
        T, f = _miller_dbl(T, f, xp, yp)
        if bit:
            T, f = _miller_add(T, f, qx, qy, xp, yp)
    q1x, q1y, nq2x = _frobenius_images(qx, qy)
    T, f = _miller_add(T, f, q1x, q1y, xp, yp)
    _, f = _miller_add(T, f, nq2x, qy, xp, yp)
    return f.to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _launch(lib, kernel, shape, inputs, ints=()):
    """Launch `kernel` of csrc/<lib>.cu into a new int32 tensor of `shape`,
    one element per row (then the kernel's int arguments), and count it,
    recording its rows (`cuda_build.launch_rows` of `inputs`)."""
    out = torch.empty(shape, dtype=torch.int32, device=inputs[0].device)
    n = out.shape[0]
    if n == 0:
        return out
    cuda_build.launch(lib, kernel, out, inputs, (n, *ints))
    cuda_build.count(LAUNCHES, kernel, cuda_build.launch_rows(kernel, inputs))
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


def _f12_operand(name, a):
    device = cuda_build.check_operands((name, a))
    cuda_build.check_shape(name, a, (len(a), 6, 2, NUM_LIMBS))
    return device


def f12_inv_flat(a):
    """(N, 6, 2, 16) -> (N, 6, 2, 16): the Fp12 inverse (0 maps to 0)."""
    if _f12_operand("a", a).type == "cpu":
        return f12_inv_plain(a)
    return _launch("gt_ops", "f12_inv", a.shape, (a,))


def f12_csqr_flat(a):
    """(N, 6, 2, 16) -> (N, 6, 2, 16): the cyclotomic square. The input
    must lie in GPhi12 (pairing outputs after the final exponentiation do)
    for the result to be its square."""
    if _f12_operand("a", a).type == "cpu":
        return f12_csqr_plain(a)
    return _launch("gt_ops", "f12_csqr", a.shape, (a,))


def f12_slotmul_flat(a, which: str):
    """Frobenius^e or conj6 on (N, 6, 2, 16): which in SLOT_MAPS."""
    device = _f12_operand("a", a)
    consts = _slot_constants(which, str(device))
    if device.type == "cpu":
        return f12_slotmul_plain(a, which)
    return _launch("gt_ops", "f12_slotmul", a.shape, (a, consts),
                   (int(_conjugates(which)),))


def f12_wpow_flat(f, k, n_bits: int, cyc: bool = False):
    """f^k by 3-bit windows: f (N, 6, 2, 16), k (N, 16) plain limbs, of
    which the windows read bits 0..3*ceil(n_bits/3)-1. cyc=True takes
    cyclotomic squares and needs f in GPhi12."""
    if not 1 <= n_bits <= 16 * NUM_LIMBS:
        raise ValueError(f"n_bits must be in [1, 256], got {n_bits}")
    device = cuda_build.check_operands(("f", f), ("k", k))
    cuda_build.check_shape("f", f, (len(f), 6, 2, NUM_LIMBS))
    cuda_build.check_shape("k", k, (len(f), NUM_LIMBS))
    if device.type == "cpu":
        return f12_wpow_plain(f, k, n_bits, cyc)
    return _launch("gt_ops", "f12_wpow", f.shape, (f, k),
                   (n_bits, int(cyc)))


def f12_pow_plain(f, k, n_bits: int):
    """_f12_pow_kernel's square-and-multiply-always, LSB-first over n_bits
    bits: fp12.pow_var, the same algorithm."""
    return F12.pow_var(f, k, n_bits)


def f12_pow_flat(f, k, n_bits: int = 256):
    """f^k: f (N, 6, 2, 16), k (N, 16) plain limbs, of which bits
    0..n_bits-1 are read (n_bits < 256 truncates for short exponents)."""
    if not 1 <= n_bits <= 16 * NUM_LIMBS:
        raise ValueError(f"n_bits must be in [1, 256], got {n_bits}")
    device = cuda_build.check_operands(("f", f), ("k", k))
    cuda_build.check_shape("f", f, (len(f), 6, 2, NUM_LIMBS))
    cuda_build.check_shape("k", k, (len(f), NUM_LIMBS))
    if device.type == "cpu":
        return f12_pow_plain(f, k, n_bits)
    return _launch("gt_ops", "f12_pow", f.shape, (f, k), (n_bits,))


def miller_flat(px, py, qx, qy):
    """The Miller value per row, before the final exponentiation: px, py
    (N, 16) and qx, qy (N, 2, 16) affine Montgomery -> (N, 6, 2, 16)."""
    device = cuda_build.check_operands(("px", px), ("py", py), ("qx", qx),
                                       ("qy", qy))
    n = len(px)
    for name, t, shape in (("px", px, (n, NUM_LIMBS)), ("py", py,
                           (n, NUM_LIMBS)), ("qx", qx, (n, 2, NUM_LIMBS)),
                           ("qy", qy, (n, 2, NUM_LIMBS))):
        cuda_build.check_shape(name, t, shape)
    if device.type == "cpu":
        return miller_plain(px, py, qx, qy)
    return _launch("miller", "miller", (n, 6, 2, NUM_LIMBS),
                   (torch.stack([px, py], dim=1),
                    torch.stack([qx, qy], dim=1)))


# ---------------------------------------------------------------------------
# The final exponentiation and the pairing (pallas_pairing.py:1209-1260)
# ---------------------------------------------------------------------------

def final_exp_flat(f):
    """f^((p^12 - 1)/n) per row, (N, 6, 2, 16): the easy part
    (p^6 - 1)(p^2 + 1), then the Devegili-Scott-Dominguez hard part with
    three cyclotomic powers by u and the Olivos chain. After the easy part
    every value lies in GPhi12, so every square there is cyclotomic."""
    u = F.from_int(params.U).to(f.device).expand(len(f), NUM_LIMBS)
    u_bits = params.U.bit_length()
    mul, sqr = f12_mul_flat, f12_csqr_flat

    def frob(g, e: int):
        return f12_slotmul_flat(g, f"frob{e}")

    def conj(g):
        return f12_slotmul_flat(g, "conj6")

    f1 = mul(conj(f), f12_inv_flat(f))
    f2 = mul(frob(f1, 2), f1)

    fx = f12_wpow_flat(f2, u, n_bits=u_bits, cyc=True)
    fx2 = f12_wpow_flat(fx, u, n_bits=u_bits, cyc=True)
    fx3 = f12_wpow_flat(fx2, u, n_bits=u_bits, cyc=True)

    y0 = mul(mul(frob(f2, 1), frob(f2, 2)), frob(f2, 3))
    y1 = conj(f2)
    y2 = frob(fx2, 2)
    y3 = conj(frob(fx, 1))
    y4 = conj(mul(fx, frob(fx2, 1)))
    y5 = conj(fx2)
    y6 = conj(mul(fx3, frob(fx3, 1)))

    t0 = mul(mul(sqr(y6), y4), y5)
    t1 = mul(mul(y3, y5), t0)
    t0 = mul(t0, y2)
    t1 = mul(sqr(t1), t0)
    t1 = sqr(t1)
    t0b = mul(t1, y1)
    t1 = mul(t1, y0)
    t0b = sqr(t0b)
    return mul(t0b, t1)


def pair_flat(px, py, qx, qy):
    """The reduced optimal-ate pairing per row: px, py (N, 16), qx, qy
    (N, 2, 16) affine Montgomery -> (N, 6, 2, 16)."""
    return final_exp_flat(miller_flat(px, py, qx, qy))


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
           "f12_mulreduce8_plain", "f12_inv_flat", "f12_inv_plain",
           "f12_csqr_flat", "f12_csqr_plain", "f12_slotmul_flat",
           "f12_slotmul_plain", "f12_wpow_flat", "f12_wpow_plain",
           "miller_flat", "miller_plain", "final_exp_flat", "pair_flat",
           "SLOT_MAPS", "window3_digits", "ATE_BITS",
           "g2_pdouble", "g2_padd", "g2_inf_like", "window_digits",
           "gt_pow_fixed", "gt_pow_fixed_multi"]
