"""Range-proof creation of the PyTorch port against the JAX reference, on
the CPU.

The Fp2, Fp12 and G2 modules, the plain versions of the four kernels of
the creation path, the fixed-base GT powers, the signature tables and the
whole proofs-on data collection, fed the same numpy-made inputs and the
same randomness on both sides. Every comparison is exact: bytes, limbs or
integers. G2 points are compared as affine integers (Jacobian limbs of one
point are not unique, and the reference's CPU ladder is its 256-step jnp
scan). The reference's proof path reaches drynx_tpu/crypto/pallas_ops.py,
which does not import under this jax, so the module-scoped `reference`
fixture installs the same `jax.enable_x64` stand-in as
tests/test_torch_survey.py, and at teardown restores the attribute and
forgets the Pallas modules.
"""
import contextlib
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drynx_tpu.crypto as jcrypto
from drynx_tpu.crypto import elgamal as JE
from drynx_tpu.crypto import field as JF
from drynx_tpu.crypto import fp2 as JF2
from drynx_tpu.crypto import fp12 as JF12
from drynx_tpu.crypto import g2 as JG2
from drynx_tpu.crypto import params, refimpl
from drynx_tpu_torch.crypto import cuda_pairing as CP
from drynx_tpu_torch.crypto import elgamal as TE
from drynx_tpu_torch.crypto import field as TF
from drynx_tpu_torch.crypto import fp2 as TF2
from drynx_tpu_torch.crypto import fp12 as TF12
from drynx_tpu_torch.crypto import g2 as TG2
from drynx_tpu_torch.proofs import encoding as TENC
from drynx_tpu_torch.proofs import range_proof as TRP
from drynx_tpu_torch.service import service as TSV

P, N = params.P, params.N
NS, U, L = 2, 4, 2              # servers, base, digits: values in [0, 16)
STATS = np.array([[-7, 3, 7], [0, -1, 5]], dtype=np.int64)   # |v| < 4^2/2
RANGES = [(U, L), (0, 0), (U, L)]   # the middle value carries no proof
SIG_SEED = 11
# 16 a + 15 with 16 a = 15 (mod n): the ladder's last add is Q' + Q' with
# Q' = 15 Q, so it takes the complete add's doubling branch
K_LAST_ADD_DOUBLES = 16 * (15 * pow(16, -1, N) % N) + 15


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _rand(rng, n, mod):
    return [int.from_bytes(rng.bytes(40), "little") % mod for _ in range(n)]


def _fp2_vals(rng, n):
    return [tuple(_rand(rng, 2, P)) for _ in range(n)]


def _fp12_vals(rng, n):
    return [tuple(tuple(_rand(rng, 2, P)) for _ in range(6)) for _ in range(n)]


def _g2_affine(pts):
    """(..., 3, 2, 16) Jacobian Montgomery limbs of either package -> list
    of affine twist points ((x0, x1), (y0, y1)) or None, by integers."""
    a = np.asarray(pts.numpy() if isinstance(pts, torch.Tensor) else pts)
    a = a.astype(np.int64).reshape(-1, 3, 2, 16)
    rinv = pow(params.R, -1, P)
    out = []
    for X, Y, Z in a:
        x, y, z = ((params.from_limbs(c[0]) * rinv % P,
                    params.from_limbs(c[1]) * rinv % P) for c in (X, Y, Z))
        if z == (0, 0):
            out.append(None)
            continue
        zi = refimpl.fp2_inv(z)
        zi2 = refimpl.fp2_mul(zi, zi)
        out.append((refimpl.fp2_mul(x, zi2),
                    refimpl.fp2_mul(y, refimpl.fp2_mul(zi, zi2))))
    return out


@contextlib.contextmanager
def _x64(flag=True):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", bool(flag))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="module")
def reference():
    """The reference's range_proof module, importable and runnable on this
    jax while this module's tests run (see the module docstring)."""
    saved = jax.enable_x64
    jax.enable_x64 = _x64
    try:
        from drynx_tpu.crypto import pallas_ops
        from drynx_tpu.proofs import range_proof
        assert not pallas_ops.available()
        yield range_proof
    finally:
        jax.enable_x64 = saved
        for name in ("pallas_ops", "pallas_pairing"):
            sys.modules.pop(f"drynx_tpu.crypto.{name}", None)
            if hasattr(jcrypto, name):
                delattr(jcrypto, name)


@pytest.fixture(scope="module")
def collection(reference):
    """The proofs-on data collection of 2 DPs x 3 values against 2 servers,
    run by the reference (its service steps, then its batched creation) and
    by the port, with the reference's draws injected into the port."""
    JRP = reference
    rng = np.random.default_rng(SIG_SEED)
    jsigs = [JRP.init_range_sig(U, rng) for _ in range(NS)]
    _, ca_pub = JE.keygen(rng)
    ca_tbl = JE.pub_table(ca_pub).table

    k_enc, k_rp = jax.random.split(jax.random.PRNGKey(21))
    enc_rs = JE.random_scalars(k_enc, STATS.shape)
    shifted = jnp.asarray(STATS + U ** L // 2)
    cts = JE.encrypt_ints_with_tables(JE.BASE_TABLE.table, ca_tbl, shifted,
                                      enc_rs)
    want = JRP.create_range_proof_lists_batched(
        k_rp, np.asarray(shifted), enc_rs, cts, RANGES, {U: jsigs}, ca_tbl)
    # the reference's draws inside that call: one split per (u, l) spec in
    # create_range_proof_list, four in create_range_proofs
    n_proved = STATS.shape[0] * 2
    ks = jax.random.split(jax.random.split(k_rp)[1], 4)
    draws = [_t(JE.random_scalars(ks[i], shape)) for i, shape in enumerate(
        [(n_proved, L)] * 3 + [(NS, n_proved, L)])]

    tsigs = TSV.make_range_sigs(U, NS, seed=SIG_SEED, device="cpu")
    cts_t, got = TSV.collect_with_range_proofs(
        torch.from_numpy(STATS), _t(enc_rs), RANGES, {U: tsigs},
        _t(ca_tbl), draws={(U, L): draws})
    return dict(JRP=JRP, jsigs=jsigs, tsigs=tsigs, ca_tbl=ca_tbl, cts=cts,
                cts_t=cts_t, want=want, got=got)


# ---------------------------------------------------------------------------
# The slice: proofs-on data collection
# ---------------------------------------------------------------------------

def test_collection_payloads_equal_the_reference_and_verify(collection):
    c = collection
    assert np.array_equal(TENC.ct_bytes(c["cts_t"]),
                          np.asarray(c["JRP"].enc.ct_bytes(c["cts"])))
    got = [lst.to_bytes() for lst in c["got"]]
    assert got == [lst.to_bytes() for lst in c["want"]]
    assert [idx.tolist() for idx, _ in c["got"][0].batches] == [[0, 2]]
    ok = c["JRP"].verify_range_proof_payloads_joint(
        got, RANGES, {U: [s.public for s in c["jsigs"]]}, c["ca_tbl"])
    assert ok == [True, True]


def test_collection_rejects_stats_beyond_the_offset(collection):
    stats = torch.from_numpy(STATS).clone()
    stats[0, 0] = U ** L // 2
    with pytest.raises(ValueError, match="u\\^l/2"):
        TSV.collect_with_range_proofs(
            stats, torch.zeros(2, 3, 16, dtype=torch.int32), RANGES,
            {U: collection["tsigs"]}, _t(collection["ca_tbl"]),
            generator=torch.Generator().manual_seed(0))


def test_signature_tables_are_the_references(collection):
    JRP, jsigs, tsigs = collection["JRP"], collection["jsigs"], \
        collection["tsigs"]
    for j, t in zip(jsigs, tsigs):
        assert j.secret == t.secret and j.public == t.public
        assert np.array_equal(t.A.numpy(), j.A.astype(np.int32))
    assert np.array_equal(TRP.sig_gt_table(tsigs, "cpu").numpy(),
                          np.asarray(JRP.sig_gt_table(jsigs)).astype(np.int32))
    assert np.array_equal(TRP.sig_gt_pow_tables(tsigs, "cpu").numpy(),
                          JRP.sig_gt_pow_tables(jsigs).astype(np.int32))
    assert np.array_equal(TRP.gt_base_table().numpy(),
                          np.asarray(JRP.gt_base_table()).astype(np.int32))
    assert np.array_equal(TRP.gt_base().numpy(),
                          np.asarray(JRP.gt_base()).astype(np.int32))


def test_challenge_and_encoders_match_the_reference(reference):
    rng = np.random.default_rng(4)
    wire = {"commit": rng.integers(0, 256, (3, 128), dtype=np.uint8),
            "d": rng.integers(0, 256, (3, 64), dtype=np.uint8),
            "v": rng.integers(0, 256, (2, 3, 2, 128), dtype=np.uint8),
            "a": rng.integers(0, 256, (2, 3, 2, 384), dtype=np.uint8)}
    sy = rng.integers(0, 256, 64, dtype=np.uint8)
    assert np.array_equal(
        TRP.challenge_from_wire(wire, sy, U, L).numpy(),
        reference.challenge_from_wire(wire, sy, U, L).astype(np.int32))
    limbs = np.asarray(JF.from_int(_rand(rng, 5, N)))
    b = reference.enc.limbs_to_bytes(limbs)
    assert np.array_equal(TENC.limbs_to_bytes(_t(limbs)), b)
    assert np.array_equal(TENC.bytes_to_limbs(b).numpy(), limbs.astype(np.int32))
    assert np.array_equal(
        TENC.hash_to_scalar(b[0], b[1]).numpy(),
        reference.enc.hash_to_scalar(b[0], b[1]).astype(np.int32))
    g2 = np.stack([JG2.from_ref(refimpl.g2_mul(refimpl.G2, k))
                   for k in (3, 9)] + [JG2.from_ref(None)])
    assert np.array_equal(TENC.g2_bytes(_t(g2)),
                          reference.enc.g2_bytes(jnp.asarray(g2)))
    gts = np.stack([JF12.from_ref(f) for f in _fp12_vals(rng, 2)])
    assert np.array_equal(TENC.gt_bytes(_t(gts)),
                          reference.enc.gt_bytes(jnp.asarray(gts)))
    phi = np.array([[0, 3], [15, 1]], dtype=np.int64)
    assert np.array_equal(TE.int_to_scalar(torch.from_numpy(-phi)).numpy(),
                          np.asarray(JE.int_to_scalar(-phi)).astype(np.int32))


# ---------------------------------------------------------------------------
# Plain kernel versions against the reference
# ---------------------------------------------------------------------------

def test_g2_scalar_mul_plain_matches_reference(reference):
    """Scalars 0, n - 1, one whose last add doubles and a random one; the
    last point is at infinity."""
    rng = np.random.default_rng(5)
    ks = [0, N - 1, K_LAST_ADD_DOUBLES] + _rand(rng, 1, N)
    pts = [refimpl.g2_mul(refimpl.G2, k) for k in _rand(rng, 3, N)] + [None]
    limbs = np.stack([JG2.from_ref(p) for p in pts])
    k = JF.from_int(ks)
    want = JG2.scalar_mul(jnp.asarray(limbs), jnp.asarray(k))
    got = CP.g2_scalar_mul_flat(_t(limbs), _t(k))
    oracle = [None if p is None else refimpl.g2_mul(p, kk)
              for p, kk in zip(pts, ks)]
    assert _g2_affine(got) == _g2_affine(want) == oracle
    # the group-level entry point broadcasts and takes the same route
    assert _g2_affine(TG2.scalar_mul(_t(limbs[:1]), _t(k))) == [
        refimpl.g2_mul(pts[0], kk) for kk in ks]


def test_f2_inv_plain_matches_reference():
    rng = np.random.default_rng(6)
    a = np.stack([JF2.from_ref(x) for x in _fp2_vals(rng, 6) + [(1, 0),
                                                                 (0, 5)]])
    want = np.asarray(JF2.inv(jnp.asarray(a))).astype(np.int32)
    assert np.array_equal(CP.f2_inv_flat(_t(a)).numpy(), want)
    assert np.array_equal(TF2.inv(_t(a)).numpy(), want)


def test_f12_mul_and_mulreduce8_plain_match_reference():
    rng = np.random.default_rng(7)
    a = np.stack([JF12.from_ref(f) for f in _fp12_vals(rng, 16)])
    want = np.asarray(JF12.mul(jnp.asarray(a[:8]), jnp.asarray(a[8:])))
    got = CP.f12_mul_flat(_t(a[:8]), _t(a[8:]))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    rows = jnp.asarray(a.reshape(2, 8, 6, 2, 16))
    acc = rows[:, 0]
    for w in range(1, 8):
        acc = JF12.mul(acc, rows[:, w])
    got = CP.f12_mulreduce8_flat(_t(a.reshape(2, 8, 6, 2, 16)))
    assert np.array_equal(got.numpy(), np.asarray(acc).astype(np.int32))


def test_fixed_base_gt_powers_match_the_oracle():
    """gt_pow_fixed and gt_pow_fixed_multi on window tables of e(B, B2) and
    e(B, B2)^7, against refimpl.fp12_pow."""
    g = refimpl.pair(refimpl.G1, refimpl.G2)
    bases = [g, refimpl.fp12_pow(g, 7)]
    tables = torch.stack([TRP._window_table(b) for b in bases])
    ks = [0, 1, N - 1, 15 << 252, 0x1234567890ABCDEF]
    k = TF.from_int(ks)
    got = CP.gt_pow_fixed(tables[0], k)
    assert [TF12.to_ref(x) for x in got] == [refimpl.fp12_pow(g, kk)
                                             for kk in ks]
    idx = torch.tensor([1, 0, 1, 1, 0])
    got = CP.gt_pow_fixed_multi(tables, idx, k)
    assert [TF12.to_ref(x) for x in got] == [
        refimpl.fp12_pow(bases[i], kk) for i, kk in zip(idx.tolist(), ks)]
    assert CP.window_digits(TF.from_int([0xFEDC])).tolist()[0][:4] == [
        0xC, 0xD, 0xE, 0xF]


# ---------------------------------------------------------------------------
# Fp2, Fp12 and G2 modules
# ---------------------------------------------------------------------------

def test_fp2_module_matches_reference():
    rng = np.random.default_rng(8)
    xs, ys = _fp2_vals(rng, 6) + [(0, 0)], _fp2_vals(rng, 7)
    a = np.stack([JF2.from_ref(x) for x in xs])
    b = np.stack([JF2.from_ref(y) for y in ys])
    at, bt = torch.stack([TF2.from_ref(x) for x in xs]), _t(b)
    assert np.array_equal(at.numpy(), a.astype(np.int32))
    assert [tuple(r) for r in TF2.to_ref(at)] == [(x[0] % P, x[1] % P)
                                                   for x in xs]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name, want, got in [
            ("add", JF2.add(ja, jb), TF2.add(at, bt)),
            ("sub", JF2.sub(ja, jb), TF2.sub(at, bt)),
            ("mul", JF2.mul(ja, jb), TF2.mul(at, bt)),
            ("sqr", JF2.sqr(ja), TF2.sqr(at)),
            ("neg", JF2.neg(ja), TF2.neg(at)),
            ("conj", JF2.conj(ja), TF2.conj(at)),
            ("mul_xi", JF2.mul_xi(ja), TF2.mul_xi(at)),
            ("mul_small", JF2.mul_small(ja, 5), TF2.mul_small(at, 5)),
            ("mul_fp", JF2.mul_fp(ja, jb[:, 0]), TF2.mul_fp(at, bt[:, 0])),
            ("one", JF2.one(), TF2.one())]:
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32)), name
    assert TF2.eq(at, at).all() and not TF2.eq(at, bt).any()
    assert TF2.is_zero(at).tolist() == [False] * 6 + [True]


def test_fp12_module_matches_reference():
    rng = np.random.default_rng(9)
    fs, gs = _fp12_vals(rng, 3), _fp12_vals(rng, 3)
    a = np.stack([JF12.from_ref(f) for f in fs])
    b = np.stack([JF12.from_ref(g) for g in gs])
    at = TF12.from_ref_batch(fs)
    assert np.array_equal(at.numpy(), a.astype(np.int32))
    assert np.array_equal(TF12.from_ref(fs[0]).numpy(), a[0].astype(np.int32))
    assert TF12.to_ref(at[1]) == tuple(tuple(c % P for c in pair)
                                       for pair in fs[1])
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name, want, got in [
            ("mul", JF12.mul(ja, jb), TF12.mul(at, _t(b))),
            ("sqr", JF12.sqr(ja), TF12.sqr(at)),
            ("conj6", JF12.conj6(ja), TF12.conj6(at)),
            ("one", JF12.one(), TF12.one())]:
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32)), name
    assert TF12.eq(at, at).all() and not TF12.eq(at, _t(b)).any()


def test_g2_module_matches_reference(reference):
    rng = np.random.default_rng(10)
    pts = [refimpl.g2_mul(refimpl.G2, k) for k in _rand(rng, 3, N)]
    a = np.stack([JG2.from_ref(p) for p in pts] + [JG2.from_ref(None)])
    at = torch.stack([TG2.from_ref(p) for p in pts + [None]])
    assert np.array_equal(at.numpy(), a.astype(np.int32))
    assert TG2.to_ref(at) == pts + [None]
    assert TG2.to_ref(at[0]) == pts[0]
    ja = jnp.asarray(a)
    q = np.roll(a, 1, axis=0)
    q[1] = a[1]                                        # P + P
    dbl, add = TG2.double(at), TG2.add(at, _t(q))
    assert _g2_affine(dbl) == _g2_affine(JG2.double(ja))
    assert _g2_affine(add) == _g2_affine(JG2.add(ja, jnp.asarray(q)))
    assert _g2_affine(TG2.neg(at)) == [refimpl.g2_neg(p) for p in pts] + [None]
    # finite results: the same formulas give the same Jacobian limbs
    assert np.array_equal(dbl.numpy()[:3],
                          np.asarray(JG2.double(ja))[:3].astype(np.int32))
    x, y, inf = TG2.normalize(dbl)
    jx, jy, jinf = JG2.normalize(JG2.double(ja))
    assert np.array_equal(x.numpy()[:3], np.asarray(jx)[:3].astype(np.int32))
    assert np.array_equal(y.numpy()[:3], np.asarray(jy)[:3].astype(np.int32))
    assert inf.tolist() == np.asarray(jinf).tolist() == [False] * 3 + [True]
    assert TG2.eq(dbl, TG2.add(at, at)).all()
    assert TG2.is_infinity(TG2.infinity((2,))).all()


def test_tower_header_constants_match_params():
    src = (Path(CP.__file__).parent.parent / "csrc"
           / "bn256_tower.cuh").read_text()
    xi_a = int(re.search(r"XI_A = (\d+);", src).group(1))
    assert params.XI == (xi_a, 1)
    # i^2 = -1 is a valid Fp2: -1 is a non-residue mod p
    assert P % 4 == 3 and pow(P - 1, (P - 1) // 2, P) == P - 1
    # XI is neither a square nor a cube in Fp2, so w^6 - XI is irreducible
    assert refimpl.fp2_pow(params.XI, (P * P - 1) // 2) != (1, 0)
    assert refimpl.fp2_pow(params.XI, (P * P - 1) // 3) != (1, 0)
