"""Pure-Python (bigint) reference implementation of the bn256 crypto stack.

This is the correctness oracle for every device-side (PyTorch/CUDA) kernel in
`drynx_tpu_torch.crypto`: each batched limb-tensor op must agree with the functions
here on random inputs.  It is also used host-side for cheap, non-batched work
(key generation, G2 signature setup for range proofs).

Mirrors the capabilities drynx pulls from kyber's bn256 suite
(reference: lib/suite.go:10-20; lib/range/range_proof.go:326-417 uses G1/G2
pairings; lib/proof/structs_proofs.go:498-505 uses Schnorr on G1).

Representation conventions:
  Fp    : int in [0, P)
  Fp2   : tuple (a0, a1) = a0 + a1*i,  i^2 = -1
  Fp12  : tuple of 6 Fp2 coeffs (c0..c5) = sum c_k w^k,  w^6 = XI
  G1    : affine (x, y) ints, or None for the point at infinity
  G2    : affine (x, y) Fp2 pairs on the twist y^2 = x^3 + 3/XI, or None
"""

from . import params
from .params import P, N, B, XI

# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------

def fp_inv(a):
    return pow(a, P - 2, P)


def fp_sqrt(a):
    """Square root in Fp (p = 3 mod 4); returns None if a is not a QR."""
    a %= P
    if a == 0:
        return 0
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a else None


# ---------------------------------------------------------------------------
# Fp2 = Fp[i]/(i^2+1)
# ---------------------------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return (-a[0] % P, -a[1] % P)


def fp2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def fp2_muls(a, s):
    """Multiply by an Fp scalar."""
    return (a[0] * s % P, a[1] * s % P)


def fp2_sq(a):
    # (a0+a1 i)^2 = (a0^2 - a1^2) + 2 a0 a1 i
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, 2 * a[0] * a[1] % P)


def fp2_inv(a):
    # 1/(a0 + a1 i) = (a0 - a1 i)/(a0^2 + a1^2)
    norm_inv = fp_inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * norm_inv % P, -a[1] * norm_inv % P)


def fp2_pow(a, e):
    r = FP2_ONE
    while e:
        if e & 1:
            r = fp2_mul(r, a)
        a = fp2_sq(a)
        e >>= 1
    return r


def fp2_sqrt(a):
    """Square root in Fp2 via the norm method; None if not a QR."""
    if a == FP2_ZERO:
        return FP2_ZERO
    a0, a1 = a
    if a1 == 0:
        r = fp_sqrt(a0)
        if r is not None:
            return (r, 0)
        # sqrt(a0) = sqrt(-a0) * sqrt(-1) = sqrt(-a0) * i  (i^2 = -1)
        r = fp_sqrt(-a0 % P)
        return None if r is None else (0, r)
    alpha = (a0 * a0 + a1 * a1) % P  # norm
    lam = fp_sqrt(alpha)
    if lam is None:
        return None
    inv2 = fp_inv(2)
    delta = (a0 + lam) * inv2 % P
    x0 = fp_sqrt(delta)
    if x0 is None:
        delta = (a0 - lam) * inv2 % P
        x0 = fp_sqrt(delta)
        if x0 is None:
            return None
    x1 = a1 * fp_inv(2 * x0 % P) % P
    cand = (x0, x1)
    return cand if fp2_sq(cand) == (a0 % P, a1 % P) else None


# Twist coefficient b' = 3 / XI
B2 = fp2_muls(fp2_inv(XI), B)

# ---------------------------------------------------------------------------
# Fp12 = Fp2[w]/(w^6 - XI)
# ---------------------------------------------------------------------------

FP12_ONE = (FP2_ONE,) + (FP2_ZERO,) * 5
FP12_ZERO = (FP2_ZERO,) * 6


def fp12_mul(a, b):
    acc = [FP2_ZERO] * 11
    for j in range(6):
        bj = b[j]
        if bj == FP2_ZERO:
            continue
        for k in range(6):
            if a[k] == FP2_ZERO:
                continue
            acc[j + k] = fp2_add(acc[j + k], fp2_mul(a[k], bj))
    out = list(acc[:6])
    for k in range(6, 11):
        out[k - 6] = fp2_add(out[k - 6], fp2_mul(acc[k], XI))
    return tuple(out)


def fp12_sq(a):
    return fp12_mul(a, a)


def fp12_pow(a, e):
    r = FP12_ONE
    while e:
        if e & 1:
            r = fp12_mul(r, a)
        a = fp12_sq(a)
        e >>= 1
    return r


def fp12_csqr(f):
    """Granger-Scott cyclotomic squaring (eprint 2009/565 §3.2) on the flat
    tower — the INT twin of the Mosaic kernel's formulas (pallas_pairing
    make_fp12 f12csqr; parity asserted in tests/test_pairing.py). Valid
    ONLY for f in GΦ12(p); 9 Fp2 squarings vs fp12_sq's 36 Fp2 mults, so
    the host-oracle order-n gate pow halves its squaring bill."""
    f0, f1, f2, f3, f4, f5 = f
    t0 = fp2_sq(f3)
    t1 = fp2_sq(f0)
    t6 = fp2_sub(fp2_sub(fp2_sq(fp2_add(f3, f0)), t0), t1)
    t2 = fp2_sq(f4)
    t3 = fp2_sq(f1)
    t7 = fp2_sub(fp2_sub(fp2_sq(fp2_add(f4, f1)), t2), t3)
    t4 = fp2_sq(f5)
    t5 = fp2_sq(f2)
    t8 = fp2_mul(fp2_sub(fp2_sub(fp2_sq(fp2_add(f5, f2)), t4), t5), XI)
    t0 = fp2_add(fp2_mul(t0, XI), t1)
    t2 = fp2_add(fp2_mul(t2, XI), t3)
    t4 = fp2_add(fp2_mul(t4, XI), t5)

    def out_sub(t, x):            # 3t - 2x
        d = fp2_sub(t, x)
        return fp2_add(fp2_add(d, d), t)

    def out_add(t, x):            # 3t + 2x
        s = fp2_add(t, x)
        return fp2_add(fp2_add(s, s), t)

    return (out_sub(t0, f0), out_add(t8, f1), out_sub(t2, f2),
            out_add(t6, f3), out_sub(t4, f4), out_add(t7, f5))


def fp12_cyc_pow(f, e):
    """f^e via cyclotomic squarings — REQUIRES f in GΦ12 (callers gate)."""
    r = FP12_ONE
    while e:
        if e & 1:
            r = fp12_mul(r, f)
        f = fp12_csqr(f)
        e >>= 1
    return r


def fp12_conj6(a):
    """a^(p^6): conjugation w -> -w (negate odd coefficients)."""
    return tuple(fp2_neg(c) if k % 2 else c for k, c in enumerate(a))


def fp12_inv(a):
    # Norm to Fp6 trick is overkill for an oracle; use Fermat.
    return fp12_pow(a, P**12 - 2)


# ---------------------------------------------------------------------------
# G1: E(Fp) y^2 = x^3 + 3
# ---------------------------------------------------------------------------

def g1_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def g1_neg(pt):
    return None if pt is None else (pt[0], -pt[1] % P)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * fp_inv(2 * y1 % P) % P
    else:
        lam = (y2 - y1) * fp_inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_mul(pt, k):
    k %= N
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = g1_add(acc, add)
        add = g1_add(add, add)
        k >>= 1
    return acc


G1 = params.G1_GEN
assert g1_is_on_curve(G1) and g1_mul(G1, N) is None


# ---------------------------------------------------------------------------
# G2: twist E'(Fp2) y^2 = x^3 + 3/XI, order-n subgroup
# ---------------------------------------------------------------------------

def g2_is_on_curve(pt):
    if pt is None:
        return True
    x, y = pt
    return fp2_sub(fp2_sq(y), fp2_add(fp2_mul(fp2_sq(x), x), B2)) == FP2_ZERO


def g2_neg(pt):
    return None if pt is None else (pt[0], fp2_neg(pt[1]))


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fp2_add(y1, y2) == FP2_ZERO:
            return None
        lam = fp2_mul(fp2_muls(fp2_sq(x1), 3), fp2_inv(fp2_muls(y1, 2)))
    else:
        lam = fp2_mul(fp2_sub(y2, y1), fp2_inv(fp2_sub(x2, x1)))
    x3 = fp2_sub(fp2_sub(fp2_sq(lam), x1), x2)
    y3 = fp2_sub(fp2_mul(lam, fp2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul_raw(pt, k):
    """Scalar mult WITHOUT mod-N reduction (for order checks)."""
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = g2_add(acc, add)
        add = g2_add(add, add)
        k >>= 1
    return acc


def g2_mul(pt, k):
    return g2_mul_raw(pt, k % N)


def _find_g2_generator():
    """Deterministic generator of E'(Fp2)[n] (hashless small-x search)."""
    for xa in range(1, 1000):
        for xb in (0, 1):
            x = (xa, xb)
            rhs = fp2_add(fp2_mul(fp2_sq(x), x), B2)
            y = fp2_sqrt(rhs)
            if y is None:
                continue
            q = g2_mul_raw((x, y), params.TWIST_COFACTOR)
            if q is not None and g2_mul_raw(q, N) is None:
                return q
    raise AssertionError("no G2 generator found")


G2 = _find_g2_generator()
assert g2_is_on_curve(G2)


# ---------------------------------------------------------------------------
# Pairing: Tate pairing e: G1 x G2 -> GT (Fp12), with denominator elimination.
# ---------------------------------------------------------------------------

def untwist(q):
    """Map a twist point (x, y) in E'(Fp2) to E(Fp12): (x*w^2, y*w^3)."""
    x, y = q
    xq = [FP2_ZERO] * 6
    yq = [FP2_ZERO] * 6
    xq[2] = x
    yq[3] = y
    return tuple(xq), tuple(yq)


def _line_value(t, p_aff, xq12, yq12, tangent):
    """Line through t (and p_aff, or tangent at t), evaluated at untwisted Q.

    All slope arithmetic is in Fp (t, p_aff are G1 points); the evaluated
    value is a sparse Fp12 element. Vertical lines return 1 (denominator
    elimination: values in Fp6 are killed by the final exponentiation).
    """
    xt, yt = t
    if tangent:
        lam = 3 * xt * xt * fp_inv(2 * yt % P) % P
    else:
        xp, yp = p_aff
        if (xt - xp) % P == 0:
            return None  # vertical line: contributes 1
        lam = (yt - yp) * fp_inv((xt - xp) % P) % P
    # l(Q) = yQ - yt - lam*(xQ - xt); yQ = y*w^3, xQ = x*w^2 components.
    out = [FP2_ZERO] * 6
    out[0] = ((lam * xt - yt) % P, 0)
    out[2] = fp2_muls(xq12, -lam % P)
    out[3] = yq12
    return tuple(out)


def miller_loop(p1, q2):
    """f_{N,P}(Q) for P in G1, Q in G2 (untwisted on the fly)."""
    xq, yq = q2  # twist coords in Fp2
    t = p1
    f = FP12_ONE
    for bit in bin(N)[3:]:  # from second-most-significant bit down
        line = _line_value(t, None, xq, yq, tangent=True)
        f = fp12_sq(f)
        if line is not None:
            f = fp12_mul(f, line)
        t = g1_add(t, t)
        if bit == "1":
            line = _line_value(t, p1, xq, yq, tangent=False)
            if line is not None:
                f = fp12_mul(f, line)
            t = g1_add(t, p1)
    return f


def final_exp(f):
    return fp12_pow(f, params.FINAL_EXP)


def pair_tate(p1, q2):
    """Reduced Tate pairing e(P, Q); P in G1, Q in G2 (twist coords)."""
    if p1 is None or q2 is None:
        return FP12_ONE
    return final_exp(miller_loop(p1, q2))


# ---------------------------------------------------------------------------
# Optimal ate pairing (the production pairing; loop length 6u+2 — 65 steps
# instead of the 255-bit Tate loop). Both are non-degenerate bilinear maps
# G1 x G2 -> mu_n; the whole stack (BB signatures, range proofs) only needs
# bilinearity + consistency, so device and oracle both use the ate variant.
# ---------------------------------------------------------------------------

ATE_LOOP = 6 * params.U + 2

# G2 Frobenius constants: untwist (x,y)->(x w^2, y w^3); w^(p-1) = XI^((p-1)/6).
_G12 = fp2_pow(params.XI, (params.P - 1) // 3)   # acts on x
_G13 = fp2_pow(params.XI, (params.P - 1) // 2)   # acts on y
_G22 = fp2_pow(params.XI, (params.P * params.P - 1) // 3)
# XI is a non-square in Fp2, so XI^((p^2-1)/2) = -1: -pi^2(Q) = (x*G22, y).


def twist_frob(q):
    """pi(x, y) = (conj(x)*XI^((p-1)/3), conj(y)*XI^((p-1)/2)) on the twist."""
    x, y = q
    return (fp2_mul((x[0], (-x[1]) % P), _G12),
            fp2_mul((y[0], (-y[1]) % P), _G13))


def _ate_line(t, q, p_aff, tangent):
    """Line through twist points t (and q, or tangent at t), evaluated at
    untwisted coordinates of P in G1: l = yp - lam*xp*w + (lam*xt - yt)*w^3."""
    xt, yt = t
    xp, yp = p_aff
    if tangent:
        lam = fp2_mul(fp2_muls(fp2_sq(xt), 3), fp2_inv(fp2_muls(yt, 2)))
    else:
        xq, yq = q
        if xt == xq:
            return None  # vertical: contributes an Fp2 factor, dies in FE
        lam = fp2_mul(fp2_sub(yt, yq), fp2_inv(fp2_sub(xt, xq)))
    out = [FP2_ZERO] * 6
    out[0] = (yp % P, 0)
    out[1] = fp2_muls(lam, (-xp) % P)
    out[3] = fp2_sub(fp2_mul(lam, xt), yt)
    return tuple(out)


def ate_miller_loop(p1, q2):
    """f_{6u+2,Q}(P) * l_{[6u+2]Q,pi(Q)}(P) * l_{[6u+2]Q+pi(Q),-pi^2(Q)}(P)."""
    t = q2
    f = FP12_ONE
    for bit in bin(ATE_LOOP)[3:]:
        f = fp12_sq(f)
        line = _ate_line(t, None, p1, tangent=True)
        f = fp12_mul(f, line)
        t = g2_add(t, t)
        if bit == "1":
            line = _ate_line(t, q2, p1, tangent=False)
            if line is not None:
                f = fp12_mul(f, line)
            t = g2_add(t, q2)
    q1 = twist_frob(q2)
    neg_q2 = (fp2_mul(q2[0], _G22), q2[1])
    line = _ate_line(t, q1, p1, tangent=False)
    if line is not None:
        f = fp12_mul(f, line)
    t = g2_add(t, q1)
    line = _ate_line(t, neg_q2, p1, tangent=False)
    if line is not None:
        f = fp12_mul(f, line)
    return f


def pair(p1, q2):
    """Reduced optimal ate pairing e(P, Q); P in G1, Q in G2 (twist coords)."""
    if p1 is None or q2 is None:
        return FP12_ONE
    return final_exp(ate_miller_loop(p1, q2))


def gphi12_cofactor_element(q: int = 13):
    """An order-q root of unity in GΦ12's COFACTOR subgroup — the element a
    commit-first RLC forger would inject (q must divide Φ12(p)/n; 13 and
    2749 do for this curve). It passes cyclotomic membership
    (batching.gt_membership_ok) but must fail the order-n gate
    (batching.gt_order_ok); both gate tests derive their adversarial input
    from THIS one construction so the curve fact lives in one place."""
    from . import params

    P_, N_ = params.P, params.N
    phi12 = P_**4 - P_**2 + 1
    assert phi12 % N_ == 0 and (phi12 // N_) % q == 0, \
        f"{q} does not divide the GΦ12 cofactor"
    for seed in (3, 5, 7):
        x = tuple((pow(seed, k + 2, P_), pow(seed + 1, k + 3, P_))
                  for k in range(6))
        g = fp12_pow(x, (P_**12 - 1) // phi12)    # project into GΦ12
        cand = fp12_pow(g, phi12 // q)            # kill the order-n part
        if cand != FP12_ONE:
            assert fp12_pow(cand, q) == FP12_ONE
            return cand
    raise AssertionError(f"no order-{q} element found (prob (1/{q})^3)")


__all__ = [
    "fp_inv", "fp_sqrt",
    "fp2_add", "fp2_sub", "fp2_neg", "fp2_mul", "fp2_muls", "fp2_sq",
    "fp2_inv", "fp2_pow", "fp2_sqrt", "FP2_ZERO", "FP2_ONE", "B2",
    "fp12_mul", "fp12_sq", "fp12_pow", "fp12_csqr", "fp12_cyc_pow",
    "fp12_conj6", "fp12_inv",
    "FP12_ONE", "FP12_ZERO",
    "g1_is_on_curve", "g1_neg", "g1_add", "g1_mul", "G1",
    "g2_is_on_curve", "g2_neg", "g2_add", "g2_mul", "G2",
    "untwist", "miller_loop", "final_exp", "pair", "pair_tate",
    "ate_miller_loop", "twist_frob", "ATE_LOOP",
    "gphi12_cofactor_element",
]
