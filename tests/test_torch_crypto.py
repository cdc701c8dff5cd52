"""The PyTorch port's crypto layer against the JAX reference, on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages. Field
values are compared byte for byte; G1 points as affine integers (Jacobian
limbs of one point are not unique, and the reference's jnp ladders take
other routes than its Pallas kernels, which the port's plain versions
mirror). On CPU tensors every kernel wrapper runs its plain version, so
these tests hold the plain versions; the kernels themselves are held
against the plain versions on the card (tests/test_torch_port.py, marked
gpu, and chip_smoke.py).
"""
import ast
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drynx_tpu.crypto import curve as JC
from drynx_tpu.crypto import elgamal as JE
from drynx_tpu.crypto import field as JF
from drynx_tpu.crypto import params as jparams
from drynx_tpu.crypto import refimpl as jref
from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing
from drynx_tpu_torch.crypto import curve as TC
from drynx_tpu_torch.crypto import elgamal as TE
from drynx_tpu_torch.crypto import field as TF
from drynx_tpu_torch.crypto import params as tparams
from drynx_tpu_torch.crypto import refimpl as tref

P, N, R = jparams.P, jparams.N, jparams.R
RNG = np.random.default_rng(2024)


def _rand(n, mod):
    return [int.from_bytes(RNG.bytes(40), "little") % mod for _ in range(n)]


def _t(a):
    """Reference uint32 limbs (numpy or jax) -> port int32 tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _affine(pts):
    """(..., 3, 16) Jacobian Montgomery limbs (either package) -> list of
    affine int pairs or None, computed with Python integers only."""
    a = np.asarray(pts.numpy() if isinstance(pts, torch.Tensor) else pts)
    a = a.astype(np.int64).reshape(-1, 3, 16)
    rinv = pow(R, -1, P)
    out = []
    for X, Y, Z in a:
        x, y, z = (jparams.from_limbs(c) * rinv % P for c in (X, Y, Z))
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, P)
        out.append((x * zi * zi % P, y * zi * zi * zi % P))
    return out


def _points(n):
    """n random G1 points as host affine ints and reference limbs."""
    pts = [jref.g1_mul(jref.G1, k) for k in _rand(n, N)]
    return pts, np.stack([JC.from_ref(p) for p in pts])


# ---------------------------------------------------------------------------
# Copied modules
# ---------------------------------------------------------------------------

def _code_without_docstrings(module):
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("jmod,tmod", [(jparams, tparams), (jref, tref)],
                         ids=["params", "refimpl"])
def test_copied_module_code_and_constants_equal(jmod, tmod):
    assert _code_without_docstrings(jmod) == _code_without_docstrings(tmod)
    for name, val in vars(jmod).items():
        if name.startswith("__") or callable(val) or inspect.ismodule(val):
            continue
        assert getattr(tmod, name) == val, name


@pytest.mark.parametrize("limit", [1, 2, 3, 700])
def test_decryption_table_equals_the_reference(limit):
    """The port builds its discrete-log table's multiples by Jacobian
    additions and one batch inversion; the sorted arrays equal the
    reference's, which adds affine points one inversion a step."""
    mine, ref = TE.DecryptionTable(limit=limit), JE.DecryptionTable(
        limit=limit)
    for name in ("keys", "xs", "ysign", "vals"):
        assert np.array_equal(getattr(mine, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    assert TE._multiples(tref.G1, 0) == []


def test_refimpl_copy_computes_the_same():
    k1, k2 = _rand(2, N)
    assert tref.g1_mul(tref.G1, k1) == jref.g1_mul(jref.G1, k1)
    assert tref.g2_mul(tref.G2, k2) == jref.g2_mul(jref.G2, k2)
    a, b = jref.g1_mul(jref.G1, k1), jref.g1_mul(jref.G1, k2)
    assert tref.g1_add(a, b) == jref.g1_add(a, b)


def test_cuda_header_constants_match_params():
    src = (Path(cuda_ops.__file__).parent.parent / "csrc"
           / "bn256_g1.cuh").read_text()
    words = [int(w, 16) for w in re.findall(
        r"(?:case \d|default): return (0x[0-9a-f]+)u;", src)]
    assert sum(w << (32 * i) for i, w in enumerate(words)) == tparams.P
    nprime = int(re.search(r"NPRIME32 = (0x[0-9a-f]+)u", src).group(1), 16)
    assert (nprime * tparams.P) % (1 << 32) == (1 << 32) - 1


# ---------------------------------------------------------------------------
# Field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["FP", "FN"])
def test_field_exact_against_reference(name):
    jctx, tctx = getattr(JF, name), getattr(TF, name)
    m = jctx.modulus
    a = _rand(40, m) + [0, 1, m - 1, m - 2, 0xFFFF, 1 << 255 % m]
    b = _rand(40, m) + [m - 1, 0, m - 1, 1, m - 1, m - 1]
    A, B = JF.from_int(a), JF.from_int(b)
    At, Bt = TF.from_int(a), TF.from_int(b)
    assert np.array_equal(At.numpy(), A.astype(np.int32))
    pairs = [
        (JF.add(A, B, jctx), TF.add(At, Bt, tctx)),
        (JF.sub(A, B, jctx), TF.sub(At, Bt, tctx)),
        (JF.neg(A, jctx), TF.neg(At, tctx)),
        (JF.mont_mul(A, B, jctx), TF.mont_mul(At, Bt, tctx)),
        (JF.to_mont(A, jctx), TF.to_mont(At, tctx)),
        (JF.from_mont(A, jctx), TF.from_mont(At, tctx)),
        (JF.reduce_512(A, B, jctx), TF.reduce_512(At, Bt, tctx)),
        (JF.batch_inv(A[:40], jctx), TF.batch_inv(At[:40], tctx)),
    ]
    for i, (want, got) in enumerate(pairs):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32)), i
    assert np.array_equal(TF.is_zero(At).numpy(), np.asarray(JF.is_zero(A)))
    assert np.array_equal(TF.eq(At, Bt).numpy(), np.asarray(JF.eq(A, B)))
    assert list(TF.to_int(At)) == a


def test_carry_resolves_every_ripple_exactly():
    """Limbs of 0xFFFF and 0x10000 in runs: the carry must cross whole runs
    in one call, and the value must be kept."""
    rng = np.random.default_rng(5)
    rows = rng.choice([0, 1, 0xFFFE, 0xFFFF, 0x10000, 0x1FFFE],
                      size=(256, 16)).astype(np.int64)
    rows[0] = 0xFFFF
    rows[0, 0] = 0x10000
    v = torch.from_numpy(rows)
    limbs, top = TF._carry(v.clone())
    for row, out, t in zip(rows, limbs.numpy(), top.numpy()):
        value = sum(int(x) << (16 * k) for k, x in enumerate(row))
        assert ((out >= 0) & (out < 1 << 16)).all()
        assert jparams.from_limbs(out) + (int(t) << 256) == value
    big = torch.from_numpy(rng.integers(0, 1 << 57, size=(64, 16)))
    limbs, top = TF._carry(big.clone(), rounds=3)
    for row, out, t in zip(big.numpy(), limbs.numpy(), top.numpy()):
        value = sum(int(x) << (16 * k) for k, x in enumerate(row))
        assert jparams.from_limbs(out) + (int(t) << 256) == value


# ---------------------------------------------------------------------------
# Plain kernel versions against the reference's jnp functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ladder_case():
    """Scalars with the edge digits (0, 1, n-1, a lone top digit) and
    random points; the reference results are computed once."""
    pts, limbs = _points(5)
    ks = [0, 1, N - 1, 15 << 252] + _rand(1, N)
    k = JF.from_int(ks)
    want = JC._scalar_mul_jnp(jnp.asarray(limbs), jnp.asarray(k))
    return dict(pts=pts, limbs=limbs, ks=ks, k=k, want=np.asarray(want))


def test_scalar_mul_plain_matches_reference_ladder_and_oracle(ladder_case):
    c = ladder_case
    got = cuda_ops.scalar_mul_flat(_t(c["limbs"]), _t(c["k"]))
    oracle = [jref.g1_mul(p, k) for p, k in zip(c["pts"], c["ks"])]
    assert _affine(got) == _affine(c["want"]) == oracle
    # the curve-level entry point takes the same route
    assert _affine(TC.scalar_mul(_t(c["limbs"]), _t(c["k"]))) == oracle


def test_scalar_mul_short_plain_matches_oracle():
    pts, limbs = _points(3)
    ks = [0, 1, (1 << 62) + 12345]
    got = TC.scalar_mul_short(_t(limbs), TF.from_int(ks), n_bits=64)
    assert _affine(got) == [jref.g1_mul(p, k) for p, k in zip(pts, ks)]


@pytest.mark.parametrize("n_windows", [64, 16])
def test_fixed_base_mul_plain_matches_reference(n_windows):
    ks = [0, 1, 15, (1 << 63), (1 << 64) - 1] + (
        _rand(3, N) if n_windows == 64 else [12345, 1 << 40, 7])
    k = JF.from_int(ks)
    table = np.asarray(JE.BASE_TABLE.table)
    want = JE._fixed_base_mul_jnp(jnp.asarray(table), jnp.asarray(k),
                                  n_windows)
    got = cuda_ops.fixed_base_mul_flat(_t(table), _t(k), n_windows)
    oracle = [jref.g1_mul(jref.G1, kk % N) for kk in ks]
    assert _affine(got) == _affine(want) == oracle


def test_port_fixed_base_table_is_the_reference_table():
    assert np.array_equal(TE.BASE_TABLE.table.numpy(),
                          np.asarray(JE.BASE_TABLE.table).astype(np.int32))


def _add_operands():
    """Random pairs plus P + P, P + (-P), inf + P, P + inf, inf + inf."""
    pts, limbs = _points(6)
    inf = JC.from_ref(None)
    neg1 = JC.from_ref(jref.g1_neg(pts[1]))
    p = np.stack([limbs[0], limbs[1], inf, limbs[2], inf, limbs[3]])
    q = np.stack([limbs[0], neg1, limbs[4], inf, inf, limbs[5]])
    return p, q


def test_point_add_plain_matches_reference():
    p, q = _add_operands()
    want = np.asarray(JC.add(jnp.asarray(p), jnp.asarray(q)))
    got = cuda_ops.point_add_flat(_t(p), _t(q))
    assert _affine(got) == _affine(want)
    # same formulas: the limbs agree wherever the result is finite
    fin = want[:, 2].any(-1)
    assert np.array_equal(got.numpy()[fin], want[fin].astype(np.int32))
    # curve.add broadcasts and routes through the same wrapper
    assert _affine(TC.add(_t(p), _t(q))) == _affine(want)


def test_point_reduce_plain_matches_sequential_reference_add():
    _, limbs = _points(8)
    pts = limbs.reshape(4, 2, 3, 16)
    want = jnp.asarray(pts[0])
    for r in range(1, 4):
        want = JC.add(want, jnp.asarray(pts[r]))
    got = cuda_ops.point_reduce_flat(_t(pts))
    assert _affine(got) == _affine(want)


def test_fp_inv_plain_matches_reference_batch_inv():
    xs = JF.to_mont(JF.from_int(_rand(6, P) + [1, P - 1]))
    want = np.asarray(JF.batch_inv(xs))
    got = cuda_pairing.fp_inv_flat(_t(xs))
    assert np.array_equal(got.numpy(), want.astype(np.int32))


def test_normalize_and_curve_helpers_match_oracle():
    pts, limbs = _points(3)
    dbl = TC.double(_t(limbs))
    assert _affine(dbl) == [jref.g1_add(p, p) for p in pts]
    x, y, inf = TC.normalize(dbl)
    assert not bool(inf.any())
    assert TC.to_ref(dbl) == [jref.g1_add(p, p) for p in pts]
    assert _affine(TC.neg(_t(limbs))) == [jref.g1_neg(p) for p in pts]
    assert TC.to_ref(TC.infinity((2,))) == [None, None]
    assert bool(TC.eq(dbl, TC.add(_t(limbs), _t(limbs))).all())
    assert np.array_equal(TC.from_ref(pts[0]).numpy(),
                          JC.from_ref(pts[0]).astype(np.int32))


@pytest.mark.parametrize("call", [
    lambda: cuda_ops.point_add_flat(torch.zeros(2, 3, 16, dtype=torch.int64),
                                    torch.zeros(2, 3, 16, dtype=torch.int64)),
    lambda: cuda_ops.point_add_flat(torch.zeros(2, 3, 16, dtype=torch.int32),
                                    torch.zeros(3, 3, 16, dtype=torch.int32)),
    lambda: cuda_ops.scalar_mul_flat(torch.zeros(2, 3, 16, dtype=torch.int32),
                                     torch.zeros(2, 16, dtype=torch.int32), 0),
    lambda: cuda_ops.fixed_base_mul_flat(torch.zeros(8, 16, 3, 16,
                                                     dtype=torch.int32),
                                         torch.zeros(2, 16, dtype=torch.int32)),
    lambda: cuda_pairing.fp_inv_flat(torch.zeros(2, 8, dtype=torch.int32)),
    lambda: cuda_pairing.f2_inv_flat(torch.zeros(2, 2, 16, dtype=torch.int64)),
    lambda: cuda_pairing.f2_inv_flat(torch.zeros(2, 16, dtype=torch.int32)),
    lambda: cuda_pairing.g2_scalar_mul_flat(
        torch.zeros(2, 3, 2, 16, dtype=torch.int32),
        torch.zeros(3, 16, dtype=torch.int32)),
    lambda: cuda_pairing.g2_scalar_mul_flat(
        torch.zeros(2, 3, 16, dtype=torch.int32),
        torch.zeros(2, 16, dtype=torch.int32)),
    lambda: cuda_pairing.f12_mul_flat(
        torch.zeros(2, 6, 2, 16, dtype=torch.int32),
        torch.zeros(2, 6, 2, 16, dtype=torch.uint8)),
    lambda: cuda_pairing.f12_mul_flat(
        torch.zeros(2, 6, 2, 16, dtype=torch.int32),
        torch.zeros(1, 6, 2, 16, dtype=torch.int32)),
    lambda: cuda_pairing.f12_mulreduce8_flat(
        torch.zeros(2, 7, 6, 2, 16, dtype=torch.int32)),
    lambda: cuda_pairing.f12_mulreduce8_flat(
        torch.zeros(2, 8, 6, 2, 16, dtype=torch.float32)),
], ids=["dtype", "shape", "windows", "table", "limbs", "f2_inv-dtype",
        "f2_inv-shape", "g2_scalar_mul-batch", "g2_scalar_mul-point",
        "f12_mul-dtype", "f12_mul-batch", "f12_mulreduce8-rows",
        "f12_mulreduce8-dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(call):
    with pytest.raises((TypeError, ValueError)):
        call()
