"""The cyclotomic square (B10) and the Fp2 inverse (B14): their plain
versions against the reference, on the crafted cases their kernels are held
on, and each kernel's order of work modelled on the CPU.

csrc/gt_ops.cu's f12_csqr runs one row on a team of six lanes through the
windowed power's team_f12csqr: each lane owns one Fp2 slot, squares at most
two of Granger-Scott's nine sums, and forms its own output slot from the
published squares. `_team_csqr` below follows that lane work, with the
index rules (which sum lane t squares, which squares an even or odd slot
combines) evaluated from the source's own expressions; it equals
`f12_csqr_plain` byte for byte at six lanes and at three, and the six
unit-slot rows tell a wrong slot mapping apart. csrc/g2_ops.cu's f2_inv
takes the norm, inverts it by fp_inv.cuh's safegcd and multiplies back;
`_f2_inv_model` does the same with tests/test_torch_inverse.py's
word-level safegcd model and equals `f2_inv_plain` and the reference's
`refimpl.fp2_inv` and `fp2.inv`. The card holds both kernels against the
plain versions (tests/test_torch_port.py, chip_smoke.py phase 2).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (CLUSTER_ROWS, crafted_csqr_cases,
                        crafted_f2_inv_cases)
from drynx_tpu.crypto import fp2 as JF2
from drynx_tpu.crypto import refimpl as jref
from drynx_tpu_torch.crypto import cuda_pairing
from drynx_tpu_torch.crypto import fp2 as F2
from drynx_tpu_torch.crypto import fp12 as TF12
from drynx_tpu_torch.crypto import g2 as G2
from drynx_tpu_torch.crypto import params, refimpl
from drynx_tpu_torch.utils import cuda_build
from test_torch_add_inv import _body
from test_torch_inverse import _safegcd, _variants
from test_torch_range_proof import reference  # noqa: F401  (a fixture)

P, R = params.P, params.R
RINV = pow(R, -1, P)


def _src(name):
    return (cuda_build.CSRC / name).read_text()


# ---------------------------------------------------------------------------
# B10: team_f12csqr's lane work
# ---------------------------------------------------------------------------

def _c_expr(body, pattern):
    """The C integer expression that `pattern` captures in `body`, as a
    Python function of the names it reads (integer division for /)."""
    expr = re.search(pattern, body).group(1)
    expr = expr.replace("tm.slot", "slot").replace("/", "//")
    return lambda **names: eval(expr, {}, dict(names))


def _index_rules():
    """team_f12csqr's index rules, read from csrc/gt_ops.cu: the square j
    a lane computes in round q, the group g and kind r of square j, and
    the group of the squares an odd slot combines."""
    team = _body(_src("gt_ops.cu"), "void team_f12csqr(")
    return {
        "j": _c_expr(team, r"const int j = ([^;]+);"),
        "g": _c_expr(team, r"const int g = (jj / 3), r = jj % 3;"),
        "r": _c_expr(team, r"const int g = jj / 3, r = (jj % 3);"),
        "odd_g": _c_expr(team, r"const int g = (\(kk \+ 2\) % 3);"),
    }


def _team_csqr(f, lanes, rules=None, xi_slot=1, shift=0):
    """team_f12csqr on (N, 6, 2, 16) int64 rows with `lanes` lanes a row:
    each lane squares its sums, every lane reads all nine back, and lane t
    forms its slots m = t (6 / lanes) + s (stored at slot m + shift, which
    is 0 but in the tests of wrong mappings)."""
    rules = rules or _index_rules()
    slots, sqrs = 6 // lanes, -(-9 // lanes)
    S = [None] * 9
    for slot in range(lanes):
        for q in range(sqrs):
            j = rules["j"](slot=slot, q=q, kPowTeam=lanes)
            if j >= 9:
                continue
            g, r = rules["g"](jj=j), rules["r"](jj=j)
            hi, lo = f[:, 3 + g], f[:, g]
            x = lo if r == 1 else hi
            S[j] = F2._sqr(F2._add(x, lo) if r == 2 else x)
    assert all(s is not None for s in S)
    out = [None] * 6
    for slot in range(lanes):
        for s in range(slots):
            m = slot * slots + s
            kk, c = m >> 1, f[:, m]
            if m & 1:
                g = rules["odd_g"](kk=kk)
                t = F2._sub(F2._sub(S[3 * g + 2], S[3 * g]), S[3 * g + 1])
                t = F2._mul_xi(t) if m == xi_slot else t
                u = F2._add(t, c)
            else:
                t = F2._add(F2._mul_xi(S[3 * kk]), S[3 * kk + 1])
                u = F2._sub(t, c)
            out[(m + shift) % 6] = F2._add(F2._add(u, u), t)
    return torch.stack(out, dim=1)


def _gphi12(n):
    """GPhi12 members: powers of the pairing of the generators."""
    base = refimpl.pair(refimpl.G1, refimpl.G2)
    vals, cur = [], base
    for _ in range(n):
        vals.append(cur)
        cur = refimpl.fp12_mul(cur, base)
    return vals


def _csqr_rows(which):
    if which == "crafted":
        return crafted_csqr_cases(TF12, refimpl, "cpu")
    if which == "gt":
        return TF12.from_ref_batch(_gphi12(3))
    rng = np.random.default_rng(53)
    return TF12.from_ref_batch([
        [tuple(int.from_bytes(rng.bytes(40), "little") % P for _ in range(2))
         for _ in range(6)] for _ in range(4)])


def test_team_size_is_the_kernels():
    """The model's six lanes are the kernel's: kPowTeam, and a lane's
    squares ceil(9 / kPowTeam)."""
    src = _src("gt_ops.cu")
    assert re.search(r"constexpr int kPowTeam = (\d+);", src).group(1) == "6"
    assert "constexpr int kPowSqrs = (9 + kPowTeam - 1) / kPowTeam;" in src


@pytest.mark.parametrize("lanes", [6, 3])
@pytest.mark.parametrize("which", ["crafted", "gt", "random"])
def test_team_csqr_model_equals_the_plain_version(which, lanes):
    """The lane work, at the kernel's six lanes and at three (two slots a
    lane), gives f12_csqr_plain's bytes on the crafted rows (0, 1, the six
    unit slots, GPhi12, outside it), on GPhi12 members and on seeded
    values."""
    a = _csqr_rows(which)
    with torch.inference_mode():
        got = _team_csqr(a.to(torch.int64), lanes).to(torch.int32)
        want = cuda_pairing.f12_csqr_plain(a)
    assert torch.equal(got, want)


def _wrong(kind):
    """The model's arguments with one index rule changed."""
    rules, kw = _index_rules(), {}
    if kind == "square group":
        rules["g"] = lambda jj: (jj // 3 + 1) % 3
    elif kind == "square order":
        rules["r"] = lambda jj: [1, 0, 2][jj % 3]
    elif kind == "slot shift":
        kw["shift"] = 1
    elif kind == "odd group":
        rules["odd_g"] = lambda kk: (kk + 1) % 3
    else:
        kw["xi_slot"] = 3
    return rules, kw


@pytest.mark.parametrize("kind,rows", [
    ("square group", "units"), ("square order", "units"),
    ("slot shift", "units"), ("odd group", "random"), ("xi slot", "random")])
def test_crafted_rows_catch_a_wrong_index_rule(kind, rows):
    """A model with one index rule changed differs from the plain version:
    on the six unit-slot rows w^k where the rule places a square or a
    slot; the odd slots' rules combine the cross terms 2 f_g f_(3+g), which
    vanish on a row of one non-zero slot, so the seeded rows catch those."""
    a = (crafted_csqr_cases(TF12, refimpl, "cpu")[2:8] if rows == "units"
         else _csqr_rows("random"))
    rules, kw = _wrong(kind)
    with torch.inference_mode():
        got = _team_csqr(a.to(torch.int64), 6, rules, **kw)
        want = cuda_pairing.f12_csqr_plain(a)
    assert not torch.equal(got.to(torch.int32), want)
    assert torch.equal(_team_csqr(a.to(torch.int64), 6).to(torch.int32),
                       want)


def test_crafted_csqr_rows_hold_the_named_values():
    """0, 1, the six unit slots w^k, a GPhi12 member (its Granger-Scott
    value is its square) and two seeded values outside GPhi12 (where it is
    not)."""
    a = crafted_csqr_cases(TF12, refimpl, "cpu")
    ref = [TF12.to_ref(a[k]) for k in range(len(a))]
    zero, one = refimpl.FP2_ZERO, refimpl.FP2_ONE
    assert ref[0] == refimpl.FP12_ZERO and ref[1] == refimpl.FP12_ONE
    for k in range(6):
        assert ref[2 + k] == tuple(one if m == k else zero for m in range(6))
    sq = [refimpl.fp12_sq(v) for v in ref[8:]]
    assert [refimpl.fp12_csqr(v) == s for v, s in zip(ref[8:], sq)] == \
        [True, False, False]


def test_f12_csqr_plain_matches_reference_on_gphi12():
    """The plain version gives the reference's refimpl.fp12_csqr on GPhi12
    members (where it is the square) and on the crafted rows, which lie
    outside GPhi12 but for 1 and the pairing value."""
    vals = _gphi12(5)
    a = torch.cat([TF12.from_ref_batch(vals),
                   crafted_csqr_cases(TF12, refimpl, "cpu")])
    with torch.inference_mode():
        got = cuda_pairing.f12_csqr_flat(a)
    want = [jref.fp12_csqr(TF12.to_ref(a[k])) for k in range(len(a))]
    assert [TF12.to_ref(got[k]) for k in range(len(a))] == want
    assert want[:5] == [jref.fp12_sq(v) for v in vals]


# ---------------------------------------------------------------------------
# B14: the norm, safegcd, two products
# ---------------------------------------------------------------------------

def _mm(a, b):
    """mont_mul on canonical residues: a b R^-1 mod p."""
    return a * b * RINV % P


def _f2_inv_model(x):
    """f2_inv_kernel on (N, 2, 16) Montgomery limbs: the norm c0^2 + c1^2
    (below p: mont_mul and fadd return canonical residues), its inverse by
    the word-level safegcd model, (c0 ni, (0 - c1) ni)."""
    out = []
    for c0, c1 in (tuple(params.from_limbs(w) for w in row)
                   for row in x.tolist()):
        assert c0 < P and c1 < P
        norm = (_mm(c0, c0) + _mm(c1, c1)) % P
        ni = _safegcd(norm)
        out.append([params.to_limbs(_mm(c0, ni)),
                    params.to_limbs(_mm((P - c1) % P, ni))])
    return torch.tensor(out, dtype=torch.int32)


def _f2_rows(which):
    if which == "crafted":
        return crafted_f2_inv_cases(F2, params, "cpu")
    if which == "g2 z":
        # Jacobian Z coordinates from the group law of the G2 ladder
        p = torch.stack([G2.from_ref(refimpl.g2_mul(refimpl.G2, 3 + j))
                         for j in range(4)])
        return G2.double(G2.add(p, G2.double(p)))[:, 2].contiguous()
    rng = np.random.default_rng(59)
    return torch.stack([F2.from_ref(tuple(
        int.from_bytes(rng.bytes(40), "little") % P for _ in range(2)))
        for _ in range(16)])


def test_crafted_f2_rows_hold_the_named_values():
    """0, 1, (a, 0), (0, b), -1 - i, the stored limbs (p - 1, p - 1) and
    three seeded values, every limb a canonical residue."""
    x = crafted_f2_inv_cases(F2, params, "cpu")
    ref = [F2.to_ref(x[k]) for k in range(len(x))]
    assert ref[0] == (0, 0) and ref[1] == (1, 0)
    assert ref[2][1] == 0 and ref[2][0] != 0
    assert ref[3][0] == 0 and ref[3][1] != 0
    assert ref[4] == (P - 1, P - 1)
    assert [params.from_limbs(w) for w in x[5].tolist()] == [P - 1, P - 1]
    assert len(x) == 9 and all(params.from_limbs(w) < P
                               for row in x.tolist() for w in row)


@pytest.mark.parametrize("which", ["crafted", "g2 z", "random"])
def test_f2_inv_model_equals_the_plain_version_and_the_reference(which):
    """The kernel's steps give f2_inv_plain's bytes (Fermat's x^(p-2) on
    the norm) and the reference's refimpl.fp2_inv; 0 maps to 0 and every
    other row times its inverse is 1."""
    x = _f2_rows(which)
    got = _f2_inv_model(x)
    with torch.inference_mode():
        assert torch.equal(got, cuda_pairing.f2_inv_plain(x))
    vals = [F2.to_ref(x[k]) for k in range(len(x))]
    assert [F2.to_ref(got[k]) for k in range(len(x))] == \
        [jref.fp2_inv(v) if v != (0, 0) else (0, 0) for v in vals]
    for v, inv in zip(vals, (F2.to_ref(got[k]) for k in range(len(x)))):
        if v != (0, 0):
            assert refimpl.fp2_mul(v, inv) == (1, 0)


def test_f2_inv_plain_matches_the_reference_fp2_inv(reference):
    """The reference's batched fp2.inv on the crafted rows, byte for
    byte."""
    x = crafted_f2_inv_cases(F2, params, "cpu")
    want = np.asarray(JF2.inv(jnp.asarray(x.numpy().astype(np.uint32))))
    with torch.inference_mode():
        got = cuda_pairing.f2_inv_flat(x)
    assert np.array_equal(got.numpy(), want.astype(np.int32))


# ---------------------------------------------------------------------------
# The kernels' designs
# ---------------------------------------------------------------------------

def test_csqr_and_f2_inv_kernels_are_the_designs():
    """f2_inv_kernel runs one row a thread in blocks of 32 and inverts the
    norm by one fp_inv_safegcd; fp_inv_fermat and the one-thread f12csqr
    are gone from csrc/; f12_csqr_kernel runs team_f12csqr on the product
    teams' lane setup and slot loads, in one-warp blocks of kPowTeam-lane
    teams; the variants script times both kernels' versions at their
    cluster shapes, which chip_smoke.CLUSTER_ROWS holds."""
    g2 = _src("g2_ops.cu")
    assert '#include "fp_inv.cuh"' in g2
    assert "constexpr int kF2InvThreads = 32;" in g2
    assert ("__global__ void __launch_bounds__(kF2InvThreads)\n"
            "    f2_inv_kernel(") in g2
    kernel = _body(g2, "    f2_inv_kernel(")
    assert kernel.count("fp_inv_safegcd(") == 1
    assert "if (i >= n) return;" in kernel
    assert kernel.count("if") == 1
    for path in sorted(cuda_build.CSRC.iterdir()):
        text = path.read_text()
        assert "fp_inv_fermat" not in text, path.name
        assert not re.search(r"(?<![\w])f12csqr\b", text), path.name
    gt = _src("gt_ops.cu")
    csqr = _body(gt, "    f12_csqr_kernel(")
    assert "__shared__ Fp2 xch[kPowTeamsPerWarp][2][18];" in csqr
    assert "prod_lane(n, xch, i, tm)" in csqr
    assert "load_slots(c, a + off, tm.slot);" in csqr
    assert "team_f12csqr(tm, c);" in csqr
    assert "store_slots(out + off, tm.slot, c);" in csqr
    launch = _body(gt, "int f12_csqr(")
    assert "f12_csqr_kernel<<<prod_blocks<kPowTeam>(n), 32, 0," in launch
    tv = _variants()
    assert tv.F2_INV_SHAPES == (13_500,) == tuple(CLUSTER_ROWS["f2_inv"])
    assert tv.CSQR_SHAPES == (1, 13_500)
    assert CLUSTER_ROWS["f12_csqr"] == {1: 4}
    labels = {label for label, kind, _, _ in tv.VARIANTS}
    assert {"f2_inv 32 threads a block", "f2_inv 64 threads a block",
            "f2_inv 128 threads a block", "f12_csqr lanes=6",
            "f12_csqr lanes=3"} <= labels
    assert not any("Fermat" in label for label in labels)
