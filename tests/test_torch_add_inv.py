"""The plain versions of the batched add (B5) and the Fp12 inverse (B8)
against the reference, on the crafted cases their kernels are held on, and
the inverse kernel's order of work modelled in torch.

csrc/g1_ops.cu's add is the reduce's body at R = 2 (team_ladder.cuh's
team_add on a team of lanes); csrc/gt_ops.cu's inverse spreads the tower
inverse over six lanes level by level and inverts in Fp by safegcd. Both
compute canonical residues, so the card holds them against
`point_add_plain` and `f12_inv_plain` byte for byte
(tests/test_torch_port.py, chip_smoke.py phase 2). Here those plain
versions meet the JAX reference on the crafted cases: the add
`drynx_tpu.crypto.curve.add` on the reduce's R = 2 pairs (every branch of
the complete add), as points and limb for limb where the sum is finite;
the inverse `drynx_tpu.crypto.fp12.inv` on chip_smoke.crafted_inv_cases,
byte for byte. A torch model of the inverse kernel's levels, with Fermat's
x^(p-2) standing in for safegcd (the two agree, tests/test_torch_inverse.py),
equals the plain version byte for byte, which shows the decomposition
right without the card. The reference is reached through the `reference`
fixture of tests/test_torch_range_proof.py (the `jax.enable_x64`
stand-in).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import crafted_inv_cases, crafted_reduce_cases
from drynx_tpu.crypto import curve as JC
from drynx_tpu.crypto import fp12 as JF12
from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
from drynx_tpu_torch.crypto import curve as TC
from drynx_tpu_torch.crypto import field as F
from drynx_tpu_torch.crypto import fp2 as F2
from drynx_tpu_torch.crypto import fp12 as TF12
from drynx_tpu_torch.crypto import params, refimpl
from drynx_tpu_torch.crypto.field import FP
from drynx_tpu_torch.utils import cuda_build
from test_torch_inverse import _variants
from test_torch_range_proof import reference  # noqa: F401  (a fixture)


def _u32(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _add_pairs():
    return crafted_reduce_cases(TC, params, refimpl, 2, "cpu")


def test_point_add_plain_matches_reference_add_on_crafted_pairs(reference):
    """The reference's complete add gives the same points as the plain
    version and the host oracle, and the same limbs wherever the sum is
    finite."""
    p, q = _add_pairs()
    want = torch.from_numpy(
        np.asarray(JC.add(_u32(p), _u32(q))).astype(np.int32))
    with torch.inference_mode():
        got = cuda_ops.point_add_flat(p, q)
    oracle = [refimpl.g1_add(a, b)
              for a, b in zip(TC.to_ref(p), TC.to_ref(q))]
    assert TC.to_ref(got) == TC.to_ref(want) == oracle
    fin = ~TC.is_infinity(want)
    assert torch.equal(got[fin], want[fin])
    assert [s is None for s in oracle] == [False, False, False, False, True,
                                           True, True]


def test_crafted_add_pairs_take_every_branch_of_the_complete_add():
    """Pair 0 distinct finite points, 1 P at infinity, 2 Q at infinity, 3
    P = Q in other Jacobian limbs (the add doubles), 4 and 5 P = -Q, 6
    both at infinity."""
    p, q = _add_pairs()
    p_inf, q_inf = TC.is_infinity(p), TC.is_infinity(q)
    both = ~p_inf & ~q_inf
    same, opposite = both & TC.eq(p, q), both & TC.eq(p, TC.neg(q))
    assert p_inf.tolist() == [False, True, False, False, False, False, True]
    assert q_inf.tolist() == [False, False, True, False, False, False, True]
    assert same.tolist() == [False, False, False, True, False, False, False]
    assert opposite.tolist() == [False] * 4 + [True, True, False]
    assert not torch.equal(p[3], q[3])


def test_f12_inv_plain_matches_reference_on_crafted_rows(reference):
    """0, 1, a Miller output, a seeded value, b = 0 and a = 0: the plain
    version gives the reference's bytes; 0 maps to 0, 1 to 1, and every
    other row times its inverse is 1."""
    a = crafted_inv_cases(TF12, refimpl, "cpu")
    want = np.asarray(JF12.inv(_u32(a))).astype(np.int32)
    with torch.inference_mode():
        got = cuda_pairing.f12_inv_flat(a)
    assert np.array_equal(got.numpy(), want)
    assert not got[0].any() and torch.equal(got[1], a[1])
    for k in range(1, len(a)):
        assert refimpl.fp12_mul(TF12.to_ref(a[k]), TF12.to_ref(got[k])) \
            == refimpl.FP12_ONE


# ---------------------------------------------------------------------------
# The inverse kernel's levels (csrc/gt_ops.cu team_f12inv), in torch
# ---------------------------------------------------------------------------

def _gt_ops():
    return (cuda_build.CSRC / "gt_ops.cu").read_text()


def _fp6_sum(v, base, stride, r):
    """Karatsuba's operand sum r of the Fp6 value whose component e is
    v[:, base + stride e] (gt_ops.cu fp6_sum)."""
    e0 = r if r < 3 else (1 if r == 5 else 0)
    e1 = e0 if r < 3 else (1 if r == 3 else 2)
    s = v[:, base + stride * e0]
    return F2._add(s, v[:, base + stride * e1]) if r >= 3 else s


def _fp6_part(P, kk):
    """Component kk of the Fp6 product whose six products are P[0..5]
    (gt_ops.cu fp6_part)."""
    p0, p1, p2 = P[0], P[1], P[2]
    return [F2._add(p0, F2._mul_xi(F2._sub(F2._sub(P[5], p1), p2))),
            F2._add(F2._sub(F2._sub(P[3], p0), p1), F2._mul_xi(p2)),
            F2._add(F2._sub(F2._sub(P[4], p0), p2), p1)][kk]


def _kernel_model(f):
    """team_f12inv's six levels on (N, 6, 2, 16) int64 values, the
    adjugate's operand tables read from the source, Fermat for the Fp
    inverse."""
    src = _gt_ops()
    adj_x, adj_y = (int(re.search(rf"{name} = (0x[0-9a-f]+)u", src).group(1),
                        16) for name in ("kAdjX", "kAdjY"))
    stack = lambda vs: torch.stack(vs, dim=1)
    # 1. A^2, B^2
    P = [F2._mul(s, s) for j in range(12)
         for s in [_fp6_sum(f, j // 6, 2, j % 6)]]
    n = [F2._sub(_fp6_part(P, 0), F2._mul_xi(_fp6_part(P[6:], 2))),
         F2._sub(_fp6_part(P, 1), _fp6_part(P[6:], 0)),
         F2._sub(_fp6_part(P, 2), _fp6_part(P[6:], 1))]
    # 2. the adjugate
    Q = [F2._mul(n[(adj_x >> 2 * j) & 3], n[(adj_y >> 2 * j) & 3])
         for j in range(6)]
    c = [F2._sub(Q[0], F2._mul_xi(Q[1])), F2._sub(F2._mul_xi(Q[2]), Q[3]),
         F2._sub(Q[4], Q[5])]
    # 3. t
    T = [F2._mul(n[j], c[(3 - j) % 3]) for j in range(3)]
    t = F2._add(T[0], F2._mul_xi(F2._add(T[1], T[2])))
    # 4. t^-1 = conj(t) / (t0^2 + t1^2)
    t0, t1 = t[..., 0, :], t[..., 1, :]
    norm = F._add64(F._mont_mul64(t0, t0, FP), F._mont_mul64(t1, t1, FP), FP)
    ni = F._pow_const64(norm, FP.modulus - 2, FP)
    ti = torch.stack([F._mont_mul64(t0, ni, FP),
                      F._mont_mul64(F._sub64(torch.zeros_like(t1), t1, FP),
                                    ni, FP)], dim=-2)
    # 5. N^-1 = C t^-1, beside f's slots
    R = torch.cat([stack([F2._mul(c[j], ti) for j in range(3)]), f], dim=1)
    # 6. A N^-1, B N^-1
    S = [F2._mul(_fp6_sum(R, 3 + j // 6, 2, j % 6), _fp6_sum(R, 0, 1, j % 6))
         for j in range(12)]
    return stack([F2._neg(_fp6_part(S[6:], m >> 1)) if m & 1
                  else _fp6_part(S, m >> 1) for m in range(6)])


def _model_rows(which):
    rng = np.random.default_rng(41)
    if which == "crafted":
        return crafted_inv_cases(TF12, refimpl, "cpu")
    if which == "gt":
        base = refimpl.pair(refimpl.G1, refimpl.G2)
        vals, cur = [], base
        for _ in range(3):
            cur = refimpl.fp12_mul(cur, base)
            vals.append(cur)
        return TF12.from_ref_batch(vals)
    return TF12.from_ref_batch([
        [tuple(int.from_bytes(rng.bytes(40), "little") % params.P
               for _ in range(2)) for _ in range(6)] for _ in range(4)])


@pytest.mark.parametrize("which", ["crafted", "gt", "random"])
def test_inverse_kernel_levels_equal_the_plain_version(which):
    """The kernel's levels, in its order, give f12_inv_plain's bytes on
    the crafted rows, on GPhi12 members and on seeded values."""
    a = _model_rows(which)
    with torch.inference_mode():
        got = _kernel_model(a.to(torch.int64)).to(torch.int32)
        want = cuda_pairing.f12_inv_plain(a)
    assert torch.equal(got, want)


def _body(src, head):
    """The text of the function whose definition contains `head`, from
    its head to its closing brace at column 0."""
    body = src[src.index(head):]
    return body[:body.index("\n}\n")]


def test_add_and_inverse_kernels_are_the_designs():
    """The add and the reduce share team_column_sum (the add at R = 2, its
    rows in two tensors) on team_ladder.cuh's team_add; the inverse runs a
    team of six lanes on the product teams' lane setup and inverts in Fp
    by fp_inv_safegcd, not fp_inv_fermat; the tower's one-thread inverse
    is gone and the Fp2 inverse (B14) inverts its norm by fp_inv_safegcd
    too; the variants script times the add's and the inverse's versions,
    the inverse's with safegcd only."""
    g1 = (cuda_build.CSRC / "g1_ops.cu").read_text()
    add = _body(g1, "    point_add_kernel(")
    assert "team_column_sum(AddRows{p, q}, 2, out, n);" in add
    assert "padd(" not in add
    assert "team_column_sum(ReduceRows{pts, n}, r, out, n);" in _body(
        g1, "    point_reduce_kernel(")
    shared = _body(g1, "void team_column_sum(")
    assert "acc = team_add(tm, acc, q);" in shared
    assert "load_g1_v(rows(j, i))" in shared
    assert "if (slot == 0) store_g1(" in shared
    gt = _gt_ops()
    assert "constexpr int kInvTeam = 6;" in gt
    assert '#include "fp_inv.cuh"' in gt
    kernel = _body(gt, "    f12_inv_kernel(")
    assert "prod_lane(n, xch, i, tm)" in kernel
    assert "team_f12inv(tm, x);" in kernel
    team = _body(gt, "void team_f12inv(")
    assert team.count("fp_inv_safegcd(") == 1
    assert "fp_inv_fermat" not in gt
    assert team.count("inv_level<") == 5
    tower = (cuda_build.CSRC / "bn256_tower.cuh").read_text()
    assert not re.search(r"\b(f12inv|fp6_inv|f2inv)\(", tower)
    g2 = (cuda_build.CSRC / "g2_ops.cu").read_text()
    f2_inv = _body(g2, "    f2_inv_kernel(")
    assert f2_inv.count("fp_inv_safegcd(") == 1
    assert "fp_inv_fermat" not in g2
    tv = _variants()
    assert tv.ADD_SHAPES == (90, 270, 810, 900, 13_500)
    assert tv.F12_INV_SHAPES == (1, 13_500)
    labels = {label for label, kind, _, _ in tv.VARIANTS
              if kind in ("add", "f12inv")}
    assert {"point_add lanes=1", "point_add lanes=4", "point_add lanes=8",
            "f12_inv lanes=1, safegcd", "f12_inv lanes=6, safegcd"} <= labels
    assert "f12_inv lanes=6, Fermat" not in labels
