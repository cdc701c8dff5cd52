"""The PyTorch port's survey path against the JAX reference, on the CPU.

ElGamal, key switching, logistic regression, the survey setup and the whole
flagship pipeline, fed the same numpy-made inputs and randomness on both
sides. The reference's functions that dispatch through
drynx_tpu/crypto/pallas_ops.py cannot import it under this jax (its line 49
takes the truth value of `jax.enable_x64`, a config State here), so the
module-scoped `reference` fixture installs a context-manager stand-in for
`jax.enable_x64` while this module's tests run, and at teardown restores the
attribute and forgets the Pallas modules, so no other test module sees them.
With the stand-in, `pallas_ops.available()` is False and the reference runs
its jnp paths.
"""
import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drynx_tpu.crypto as jcrypto
from drynx_tpu import flagship as JFL
from drynx_tpu.crypto import curve as JC
from drynx_tpu.crypto import elgamal as JE
from drynx_tpu.crypto import field as JF
from drynx_tpu.crypto import params, refimpl
from drynx_tpu.models import logreg as JLR
from drynx_tpu.parallel import collective as JCOL
from drynx_tpu_torch import flagship as TFL
from drynx_tpu_torch.crypto import elgamal as TE
from drynx_tpu_torch.models import logreg as TLR
from drynx_tpu_torch.parallel import collective as TCOL

N_DPS, N_SERVERS, N_RECORDS, D, ITERS, DLOG = 2, 2, 16, 2, 10, 200
INT64_MIN, INT64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max

# float32 GD: the two libraries take their tensordots and sums in other
# orders, so weights drift apart by a few ulps per step; over <= 20 steps on
# these small sums 1e-4 relative holds with room. float64 leaves ~1e-16 per
# step, so 1e-10 does.
TOL = {"float32": 1e-4, "float64": 1e-10}


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _affine(pts):
    """(..., 3, 16) Jacobian Montgomery limbs -> affine int pairs / None."""
    a = np.asarray(pts.numpy() if isinstance(pts, torch.Tensor) else pts)
    a = a.astype(np.int64).reshape(-1, 3, 16)
    P, rinv = params.P, pow(params.R, -1, params.P)
    out = []
    for X, Y, Z in a:
        x, y, z = (params.from_limbs(c) * rinv % P for c in (X, Y, Z))
        zi = pow(z, -1, P) if z else None
        out.append(None if zi is None else (x * zi * zi % P,
                                            y * zi * zi * zi % P))
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
    """The reference's pipeline at a small size, run once with the
    jax.enable_x64 stand-in in place (see the module docstring)."""
    saved = jax.enable_x64
    jax.enable_x64 = _x64
    try:
        from drynx_tpu.crypto import pallas_ops
        assert not pallas_ops.available()
        X, y, p = JFL.pima_shaped_problem(num_dps=N_DPS, n_records=N_RECORDS,
                                          d=D, max_iterations=ITERS)
        setup = JFL.SurveySetup.create(n_servers=N_SERVERS, dlog_limit=DLOG)
        stats, enc_rs, _, k2 = JFL.make_inputs(X, y, p, N_DPS)
        ks_rs = JE.random_scalars(k2, (N_SERVERS, stats.shape[1]))
        w, dec, found = JFL.build_pipeline(setup, p)(stats, enc_rs, ks_rs)
        yield dict(X=X, y=y, params=p, setup=setup, stats=np.asarray(stats),
                   enc_rs=np.asarray(enc_rs), ks_rs=np.asarray(ks_rs),
                   w=np.asarray(w), dec=np.asarray(dec),
                   found=np.asarray(found))
    finally:
        jax.enable_x64 = saved
        for name in ("pallas_ops", "pallas_pairing"):
            sys.modules.pop(f"drynx_tpu.crypto.{name}", None)
            if hasattr(jcrypto, name):
                delattr(jcrypto, name)


def _port_setup(ref):
    s = ref["setup"]
    return TFL.SurveySetup.from_numpy(
        np.asarray(s.server_secrets), np.asarray(s.coll_pub_table),
        s.query_secret, np.asarray(s.query_pub_table), np.asarray(s.dlog.keys),
        np.asarray(s.dlog.xs), np.asarray(s.dlog.ysign),
        np.asarray(s.dlog.vals), device="cpu")


# ---------------------------------------------------------------------------
# The slice: the whole survey
# ---------------------------------------------------------------------------

def test_pipeline_matches_reference(reference):
    ref = reference
    assert ref["found"].all()
    assert np.array_equal(ref["dec"], ref["stats"].sum(0))
    fn = TFL.build_pipeline(_port_setup(ref), TLR.LRParams(
        **vars(ref["params"])))
    w, dec, found = fn(torch.tensor(ref["stats"]), _t(ref["enc_rs"]),
                       _t(ref["ks_rs"]))
    assert bool(found.all())
    assert np.array_equal(dec.numpy(), ref["dec"])
    np.testing.assert_allclose(w.numpy(), ref["w"], rtol=TOL["float32"],
                               atol=TOL["float32"])


def test_setup_create_is_byte_identical_to_reference(reference):
    ref = reference["setup"]
    got = TFL.SurveySetup.create(n_servers=N_SERVERS, dlog_limit=DLOG,
                                 device="cpu")
    assert got.query_secret == ref.query_secret
    for name in ("server_secrets", "coll_pub_table", "query_pub_table"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(ref, name)).astype(np.int32))
    for name in ("keys", "xs", "ysign", "vals"):
        assert np.array_equal(getattr(got.dlog, name).numpy(),
                              np.asarray(getattr(ref.dlog, name))), name


def test_setup_from_numpy_carries_the_reference_state(reference):
    ref = reference["setup"]
    got = _port_setup(reference)
    assert got.device == torch.device("cpu")
    assert got.server_secrets.dtype == torch.int32
    assert np.array_equal(got.coll_pub_table.numpy(),
                          np.asarray(ref.coll_pub_table).astype(np.int32))
    assert np.array_equal(got.dlog.keys.numpy(), np.asarray(ref.dlog.keys))
    assert got.dlog.limit == DLOG


# ---------------------------------------------------------------------------
# ElGamal and key switching
# ---------------------------------------------------------------------------

def test_encrypt_decrypt_with_injected_r(reference):
    """Plaintexts 0, +-1, INT64_MAX, INT64_MIN and a few others, at the
    pipeline's batch shape so the reference reuses its compiled encrypt."""
    rng = np.random.default_rng(31)
    V = reference["stats"].shape[1]
    special = [0, 1, -1, INT64_MAX, INT64_MIN, 12345, -777]
    values = rng.integers(-DLOG, DLOG, size=(N_DPS, V))
    values.reshape(-1)[:len(special)] = special
    draw = lambda: JF.from_int([int(x) for x in
                                rng.integers(0, 1 << 62, N_DPS * V)])
    r = np.asarray(JF.reduce_512(draw(), draw(), JF.FN)).reshape(N_DPS, V, 16)
    pub_tbl = np.asarray(reference["setup"].coll_pub_table)
    base = np.asarray(JE.BASE_TABLE.table)
    want = JE.encrypt_ints_with_tables(jnp.asarray(base), jnp.asarray(pub_tbl),
                                       jnp.asarray(values), jnp.asarray(r))
    got = TE.encrypt_ints_with_tables(_t(base), _t(pub_tbl),
                                      torch.from_numpy(values), _t(r))
    assert got.shape == (N_DPS, V, 2, 3, 16) and got.dtype == torch.int32
    assert _affine(got) == _affine(want)

    # the magnitude split: exact for every int64, INT64_MIN included
    flat = values.reshape(-1)
    limbs, neg = TE.magnitude_limbs(torch.from_numpy(flat))
    assert [params.from_limbs(row) for row in limbs.numpy()] == [
        abs(int(v)) for v in flat]
    assert neg.tolist() == [bool(v < 0) for v in flat]

    # decrypting under the collective secret gives back m*B, and the
    # discrete-log table gives back m where it covers it
    secret = sum(_secret_ints(reference)) % params.N
    cts = got.reshape(-1, 2, 3, 16)
    m_pts = TE.decrypt_point(cts[:len(special)], TE.secret_to_limbs(secret))
    assert _affine(m_pts) == [refimpl.g1_mul(refimpl.G1, v % params.N)
                              for v in special]
    dec, found = TE.decrypt_ints(cts[len(special):], secret,
                                 TE.DecryptionTable(limit=DLOG))
    assert bool(found.all())
    assert dec.tolist() == flat[len(special):].tolist()


def _secret_ints(reference):
    return [params.from_limbs(row)
            for row in np.asarray(reference["setup"].server_secrets)]


def test_keyswitch_contribution_matches_reference(reference):
    V = reference["stats"].shape[1]
    s = reference["setup"]
    ks = refimpl.g1_mul(refimpl.G1, 99)
    ct = np.stack([np.stack([JC.from_ref(refimpl.g1_mul(ks, i + 1)),
                             JC.from_ref(refimpl.g1_mul(ks, i + 7))])
                   for i in range(V)])[None]            # (1, V, 2, 3, 16)
    r = reference["ks_rs"][:, ::-1].copy()
    x = np.asarray(s.server_secrets)[:, None, :]
    q = np.asarray(s.query_pub_table)
    wk, wc = JCOL.keyswitch_contribution(jnp.asarray(ct), jnp.asarray(x),
                                         jnp.asarray(r), jnp.asarray(q))
    gk, gc = TCOL.keyswitch_contribution(_t(ct), _t(x), _t(r), _t(q))
    assert _affine(gk) == _affine(wk)
    assert _affine(gc) == _affine(wc)
    fin = TCOL.keyswitch_finish(_t(ct[0]), gk[0], gc[0])
    assert fin.shape == (V, 2, 3, 16)
    pubs = [refimpl.g1_mul(refimpl.G1, k) for k in (5, 6, 7)]
    assert TCOL.collective_key(pubs) == JCOL.collective_key(pubs)


# ---------------------------------------------------------------------------
# Logistic regression
# ---------------------------------------------------------------------------

def test_encode_clear_and_unpack_match_reference(reference):
    X, y = reference["X"], reference["y"]
    jp = reference["params"]
    tp = TLR.LRParams(**vars(jp))
    for i in range(N_DPS):
        Xi, yi = TLR.shard_for_dp(X, y, i, N_DPS)
        want = np.asarray(JLR.encode_clear(Xi, yi, jp))
        assert np.array_equal(TLR.encode_clear(Xi, yi, tp).numpy(), want)
    assert np.array_equal(reference["stats"][0],
                          TLR.encode_clear(*TLR.shard_for_dp(X, y, 0, N_DPS),
                                           tp).numpy())
    for a, b in zip(TLR.unpack(torch.tensor(reference["dec"]), tp),
                    JLR.unpack(reference["dec"], jp)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    Xs, ys = TLR.synthetic_dataset(n=32, d=3, seed=5)
    Xj, yj = JLR.synthetic_dataset(n=32, d=3, seed=5)
    assert np.array_equal(Xs, Xj) and np.array_equal(ys, yj)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_matches_reference(reference, dtype):
    jp = JLR.LRParams(**{**vars(reference["params"]), "dtype": dtype,
                         "max_iterations": 20})
    tp = TLR.LRParams(**vars(jp))
    Ts_j = JLR.unpack(reference["dec"], jp)
    Ts_t = TLR.unpack(torch.tensor(reference["dec"]), tp)
    want = np.asarray(JLR.train(Ts_j, jp))
    got = TLR.train(Ts_t, tp)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])
    w = torch.linspace(-0.5, 0.5, D + 1, dtype=torch.float64)
    c_t = TLR.cost(w, [T.double() for T in Ts_t], float(jp.n_records),
                   jp.lambda_, jp.coeffs)
    c_j = JLR.cost(jnp.asarray(w.numpy()), [jnp.asarray(T, jnp.float64)
                                            for T in Ts_j],
                   float(jp.n_records), jp.lambda_, jp.coeffs)
    np.testing.assert_allclose(float(c_t), float(c_j), rtol=1e-12)
