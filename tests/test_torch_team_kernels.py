"""The plain versions of the port's ladders and windowed GT power against
the reference, on the crafted cases their team kernels are held on.

csrc/g1_ops.cu's variable-base ladder, csrc/g2_ops.cu's G2 ladder (one
body in csrc/team_ladder.cuh) and csrc/gt_ops.cu's windowed GT power give
each row a team of threads that splits every step's independent
Montgomery products; they compute the plain versions' formulas on
canonical residues, so the card holds them against `scalar_mul_plain`,
`g2_scalar_mul_plain` and `f12_wpow_plain` byte for byte
(tests/test_torch_port.py, chip_smoke.py phase 2), on the cases made by
chip_smoke.crafted_ladder_cases, crafted_g2_ladder_cases and
crafted_wpow_cases. Here those plain versions meet the JAX package's host
oracle (drynx_tpu/crypto/refimpl.py) on the same cases: the ladders as
points, through every branch of their complete add; the power from 1 to
256 bits (windows cut short and windows across limb edges), with and
without cyclotomic squares, and on a value outside GPhi12, where the
cyclotomic chain is Granger-Scott's function and not a power.
"""
import pytest
import torch

from chip_smoke import (WPOW_BITS, crafted_g2_ladder_cases,
                        crafted_ladder_cases, crafted_ladder_scalars,
                        crafted_wpow_cases)
from drynx_tpu.crypto import refimpl as JR
from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
from drynx_tpu_torch.crypto import curve as TC
from drynx_tpu_torch.crypto import field as TF
from drynx_tpu_torch.crypto import fp12 as TF12
from drynx_tpu_torch.crypto import g2 as TG2
from drynx_tpu_torch.crypto import params, refimpl


def test_crafted_scalars_fit_the_limbs_and_name_their_branches():
    n = JR.N
    ks = crafted_ladder_scalars(n)
    assert all(0 <= k < 1 << 256 for k in ks)
    k_dbl = ks[-1]
    assert (k_dbl - 15) * pow(16, -1, n) % n * 16 % n == 15   # 16a = 15
    assert (k_dbl - 15) % 16 == 0


@pytest.mark.parametrize("n_windows", [1, 2, 16, 64])
def test_ladder_plain_matches_reference_on_crafted_cases(n_windows):
    """k P for the crafted scalars (and the point at infinity) equals the
    reference's k P with k read mod 16^W, as points."""
    pts, k = crafted_ladder_cases(TC, TF, refimpl, "cpu")
    with torch.inference_mode():
        got = cuda_ops.scalar_mul_flat(pts, k, n_windows)
    want = [JR.g1_mul(p, int(x) % 16 ** n_windows)
            for p, x in zip(TC.to_ref(pts), TF.to_int(k))]
    assert TC.to_ref(got) == want


def _branches(p, q):
    p_inf, q_inf = TC.is_infinity(p), TC.is_infinity(q)
    both = ~p_inf & ~q_inf
    return {"double": bool((both & TC.eq(p, q)).any()),
            "p = -q": bool((both & TC.eq(p, TC.neg(q))).any()),
            "infinity": bool((p_inf | q_inf).any())}


def test_crafted_ladder_takes_every_branch_of_the_complete_add(monkeypatch):
    """At W = 64 the crafted rows' adds meet a double (16a + 15), a point
    and its negation (n) and infinity (0, zero digits, the infinite row):
    the branches the team kernel's selects must take in the reference's
    order."""
    seen = dict.fromkeys(("double", "p = -q", "infinity"), False)
    padd = cuda_ops.padd

    def spy(p, q):
        for name, hit in _branches(p, q).items():
            seen[name] |= hit
        return padd(p, q)

    monkeypatch.setattr(cuda_ops, "padd", spy)
    pts, k = crafted_ladder_cases(TC, TF, refimpl, "cpu")
    with torch.inference_mode():
        cuda_ops.scalar_mul_flat(pts, k, 64)
    assert seen == {"double": True, "p = -q": True, "infinity": True}


def test_g2_ladder_plain_matches_reference_on_crafted_cases():
    """k Q for the crafted scalars on multiples of the twist's generator
    (and the point at infinity) equals the reference's k Q, as points."""
    pts, k = crafted_g2_ladder_cases(TG2, TF, refimpl, "cpu")
    with torch.inference_mode():
        got = cuda_pairing.g2_scalar_mul_flat(pts, k)
    want = [JR.g2_mul(q, int(x)) for q, x in zip(TG2.to_ref(pts),
                                                 TF.to_int(k))]
    assert TG2.to_ref(got) == want


def _g2_branches(p, q):
    p_inf, q_inf = TG2.is_infinity(p), TG2.is_infinity(q)
    both = ~p_inf & ~q_inf
    return {"double": bool((both & TG2.eq(p, q)).any()),
            "p = -q": bool((both & TG2.eq(p, TG2.neg(q))).any()),
            "infinity": bool((p_inf | q_inf).any())}


def test_crafted_g2_ladder_takes_every_branch_of_the_complete_add(
        monkeypatch):
    """The crafted G2 rows' adds meet a double (16a + 15), a point and its
    negation (n) and infinity (0, zero digits, the infinite row), as the
    G1 rows do."""
    seen = dict.fromkeys(("double", "p = -q", "infinity"), False)
    padd = cuda_pairing.g2_padd

    def spy(p, q):
        for name, hit in _g2_branches(p.to(torch.int32),
                                      q.to(torch.int32)).items():
            seen[name] |= hit
        return padd(p, q)

    monkeypatch.setattr(cuda_pairing, "g2_padd", spy)
    pts, k = crafted_g2_ladder_cases(TG2, TF, refimpl, "cpu")
    with torch.inference_mode():
        cuda_pairing.g2_scalar_mul_flat(pts, k)
    assert seen == {"double": True, "p = -q": True, "infinity": True}


def _windowed(f, k, n_bits, square):
    """f^k by 3-bit windows MSB-first over [1, f, ..., f^7] with the given
    square, in the reference's host arithmetic."""
    tab = [JR.FP12_ONE, f]
    for d in range(2, 8):
        tab.append(square(tab[d // 2]) if d % 2 == 0
                   else JR.fp12_mul(tab[d - 1], f))
    n_win = (n_bits + 2) // 3
    acc = tab[(k >> 3 * (n_win - 1)) & 7]
    for w in range(n_win - 2, -1, -1):
        for _ in range(3):
            acc = square(acc)
        acc = JR.fp12_mul(acc, tab[(k >> 3 * w) & 7])
    return acc


@pytest.mark.parametrize("cyc", [True, False])
@pytest.mark.parametrize("n_bits", WPOW_BITS)
def test_wpow_plain_matches_reference_on_crafted_cases(n_bits, cyc):
    """On the GPhi12 members f^(k mod 2^(3 ceil(n_bits / 3))) by the
    reference's fp12_pow; on every row, the member outside GPhi12 included,
    the reference's own windowed chain with Granger-Scott's square where
    cyc is set (its fp12_csqr) and with a true square where it is not."""
    f, k = crafted_wpow_cases(TF, TF12, params, refimpl, "cpu")
    with torch.inference_mode():
        got = [TF12.to_ref(x) for x in cuda_pairing.f12_wpow_flat(
            f, k, n_bits, cyc)]
    fs = [TF12.to_ref(x) for x in f]
    ks = [int(x) for x in TF.to_int(k)]
    n_win = (n_bits + 2) // 3
    square = JR.fp12_csqr if cyc else JR.fp12_sq
    assert got == [_windowed(x, e, n_bits, square) for x, e in zip(fs, ks)]
    members = len(fs) - 1
    assert got[:members] == [JR.fp12_pow(x, e % (1 << 3 * n_win))
                             for x, e in zip(fs[:members], ks[:members])]


def test_the_crafted_non_member_tells_the_two_squares_apart():
    """The last crafted value lies outside GPhi12: there Granger-Scott's
    function differs from the square, so a kernel that squared truly
    would not give the plain version's bytes with cyc."""
    f, _ = crafted_wpow_cases(TF, TF12, params, refimpl, "cpu")
    fs = [TF12.to_ref(x) for x in f]
    assert all(JR.fp12_csqr(x) == JR.fp12_sq(x) for x in fs[:-1])
    assert JR.fp12_csqr(fs[-1]) != JR.fp12_sq(fs[-1])
