"""bn256 curve parameters for the PyTorch/CUDA port of the Drynx crypto stack
(a copy of drynx_tpu/crypto/params.py; a test holds the two equal).

The reference fixes the whole system's suite to the bn256 pairing curve
(reference: lib/suite.go:10-20, `bn256.NewSuiteG1()`); this module pins the
same curve: the 256-bit Barreto-Naehrig curve used by kyber/golang bn256,

    p = 36u^4 + 36u^3 + 24u^2 + 6u + 1
    n = 36u^4 + 36u^3 + 18u^2 + 6u + 1   (group order)
    u = 6518589491078791937

with E(Fp): y^2 = x^3 + 3 and generator G1 = (1, 2).

Tower choices here are OURS (the framework only needs internal consistency,
not kyber wire compatibility):

  Fp2  = Fp[i]/(i^2 + 1)          (valid: p = 3 mod 4)
  Fp12 = Fp2[w]/(w^6 - XI)        (flat sextic extension; XI verified to be
                                   neither a square nor a cube in Fp2)
  twist E'(Fp2): y^2 = x^3 + 3/XI  (D-type sextic twist; G2 = E'(Fp2)[n])

Limb layout for the device-side (torch) representation: 256-bit integers as
16 little-endian limbs of 16 bits each, stored in uint32 lanes, Montgomery
form with R = 2^256.
"""

# BN parameter
U = 6518589491078791937

# Field prime and group order (match kyber bn256 / golang.org/x/crypto/bn256).
P = 36 * U**4 + 36 * U**3 + 24 * U**2 + 6 * U + 1
N = 36 * U**4 + 36 * U**3 + 18 * U**2 + 6 * U + 1

assert P == 65000549695646603732796438742359905742825358107623003571877145026864184071783
assert N == 65000549695646603732796438742359905742570406053903786389881062969044166799969
assert P % 4 == 3  # so Fp2 = Fp[i]/(i^2+1) is a field

# Curve coefficient and G1 generator (y^2 = x^3 + B).
B = 3
G1_GEN = (1, 2)

# Frobenius trace: #E(Fp) = p + 1 - t = n
TRACE = 6 * U**2 + 1
assert P + 1 - TRACE == N

# Twist curve order over Fp2 for the D-type sextic twist y^2 = x^3 + 3/XI:
# with t2 = t^2 - 2p (trace of E over Fp2) and f2 = sqrt((4p^2 - t2^2)/3),
# #E'(Fp2) = p^2 + 1 - (t2 + 3*f2)/2  (verified empirically; divisible by N).
_T2 = TRACE * TRACE - 2 * P
_F2 = 65000549695646603729472583186153816235393533837839825629408311602454630816845
assert 3 * _F2 * _F2 == 4 * P * P - _T2 * _T2
TWIST_ORDER = P * P + 1 - (_T2 + 3 * _F2) // 2
assert TWIST_ORDER % N == 0
TWIST_COFACTOR = TWIST_ORDER // N

# ---------------------------------------------------------------------------
# Limb layout (device representation)
# ---------------------------------------------------------------------------
LIMB_BITS = 16
NUM_LIMBS = 16  # 256 bits
LIMB_MASK = (1 << LIMB_BITS) - 1

# Montgomery constants, R = 2^256
R = 1 << (LIMB_BITS * NUM_LIMBS)
R_MOD_P = R % P
R2_MOD_P = (R * R) % P
R3_MOD_P = (R * R * R) % P
# -p^-1 mod 2^16 (per-limb Montgomery factor)
NPRIME = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

# Same layout reused for the scalar field (mod N) where needed.
R_MOD_N = R % N
R2_MOD_N = (R * R) % N
NPRIME_N = (-pow(N, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


def to_limbs(x: int, num=NUM_LIMBS) -> list:
    """Little-endian 16-bit limb decomposition of a non-negative int."""
    return [(x >> (LIMB_BITS * k)) & LIMB_MASK for k in range(num)]


def from_limbs(limbs) -> int:
    out = 0
    for k, l in enumerate(limbs):
        out |= int(l) << (LIMB_BITS * k)
    return out


# ---------------------------------------------------------------------------
# Fp2 / Fp12 tower constants
# ---------------------------------------------------------------------------
def _fp2_mul(a, b):
    # (a0 + a1 i)(b0 + b1 i) with i^2 = -1
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _fp2_pow(a, e):
    r = (1, 0)
    while e:
        if e & 1:
            r = _fp2_mul(r, a)
        a = _fp2_mul(a, a)
        e >>= 1
    return r


def _find_xi():
    """Smallest xi = a + i with xi neither square nor cube in Fp2."""
    half = (P * P - 1) // 2
    third = (P * P - 1) // 3
    assert (P * P - 1) % 3 == 0
    for a in range(1, 64):
        xi = (a, 1)
        if _fp2_pow(xi, half) != (1, 0) and _fp2_pow(xi, third) != (1, 0):
            return xi
    raise AssertionError("no xi found")


# Sextic non-residue defining Fp12 = Fp2[w]/(w^6 - XI); also defines the twist.
XI = _find_xi()

# Tate-pairing final exponent, split for efficiency later; exact division holds.
assert (P**12 - 1) % N == 0
FINAL_EXP = (P**12 - 1) // N

__all__ = [
    "U", "P", "N", "B", "G1_GEN", "TRACE", "TWIST_COFACTOR",
    "LIMB_BITS", "NUM_LIMBS", "LIMB_MASK", "R", "R_MOD_P", "R2_MOD_P",
    "R3_MOD_P", "NPRIME", "R_MOD_N", "R2_MOD_N", "NPRIME_N",
    "to_limbs", "from_limbs", "XI", "FINAL_EXP",
]
