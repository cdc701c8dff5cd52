"""The logistic-regression model's evaluation half against the reference,
on the CPU.

`normalize`, `sigmoid`, `predict_probs`, `predict`, `fold_affine`, the
metrics (`accuracy`, `precision`, `recall`, `f_score`, `auc`) and
`load_csv` are held against drynx_tpu/models/logreg.py on seeded numpy
inputs. The encrypted prediction runs the reference's tests/test_logreg.py
:126 case (d = 3 integer features of n = 6 records, under a key drawn from
a seeded rng): the decrypted margins equal sum_j round(P w'_j) x_j +
round(P w0') in Python integers, a negative weight going through its mod-n
scalar, `found` reports a margin outside the table, and the probabilities
equal the reference's sigmoid of those margins. Under `-m slow` the
reference's own `predict_homomorphic` runs on the same ciphertexts (its
curve arithmetic needs the `jax.enable_x64` stand-in of
tests/test_torch_survey.py, installed in a module-scoped fixture) and
decrypts the same margin integers.
"""
import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drynx_tpu.crypto as jcrypto
from drynx_tpu.models import logreg as JLR
from drynx_tpu_torch.crypto import elgamal as TE
from drynx_tpu_torch.models import logreg as TLR

D, N, P = 3, 6, 100.0


@contextlib.contextmanager
def _x64(flag=True):
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", bool(flag))
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions are thousands of small tensor ops: beside JAX's
    CPU threads in this process, torch's thread pool only contends (as in
    tests/test_torch_verify.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# clear-text prediction and the metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    actual = rng.integers(0, 2, size=40)
    pred = rng.integers(0, 2, size=40)
    probs = rng.uniform(size=40)
    for fn in ("accuracy", "precision", "recall", "f_score"):
        assert getattr(TLR, fn)(pred, actual) == \
            getattr(JLR, fn)(pred, actual), fn
    assert TLR.auc(probs, actual) == JLR.auc(probs, actual)


@pytest.mark.parametrize("pred,actual", [
    ([0, 0, 0], [0, 0, 0]), ([1, 1], [0, 0]), ([0, 1], [1, 1]),
    ([1, 0, 1, 1, 0], [1, 0, 0, 1, 1])])
def test_metric_edges_equal_the_reference(pred, actual):
    for fn in ("accuracy", "precision", "recall", "f_score"):
        assert getattr(TLR, fn)(pred, actual) == \
            getattr(JLR, fn)(pred, actual), fn
    probs = np.linspace(0.1, 0.9, len(pred))
    assert TLR.auc(probs, actual) == JLR.auc(probs, actual)


@pytest.mark.parametrize("stand", [False, True])
def test_clear_prediction_equals_the_reference(stand):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(20, 4)) * 3 + 1
    w = rng.normal(size=5)
    means = tuple(X.mean(0)) if stand else None
    stds = tuple(X.std(0)) if stand else None
    with _x64():
        want = {"probs": _np(JLR.predict_probs(X, jnp.asarray(w), means,
                                               stds)),
                "pred": _np(JLR.predict(X, jnp.asarray(w), means, stds,
                                        threshold=0.4)),
                "norm": _np(JLR.normalize(X)),
                "norm_given": _np(JLR.normalize(X, X.min(0) - 1,
                                                X.max(0) + 1)),
                "sig": _np(JLR.sigmoid(jnp.asarray(X[:, 0])))}
    got = {"probs": _np(TLR.predict_probs(X, w, means, stds)),
           "pred": _np(TLR.predict(X, w, means, stds, threshold=0.4)),
           "norm": _np(TLR.normalize(X)),
           "norm_given": _np(TLR.normalize(X, X.min(0) - 1, X.max(0) + 1)),
           "sig": _np(TLR.sigmoid(X[:, 0]))}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    assert got["pred"].dtype == np.int64


def test_fold_affine_equals_the_reference():
    rng = np.random.default_rng(3)
    w = rng.normal(size=5)
    mu, sd = tuple(rng.normal(size=4)), tuple(rng.uniform(0.5, 2, size=4))
    for args in ((), (mu, sd)):
        w0, wf = TLR.fold_affine(w, *args)
        j0, jf = JLR.fold_affine(w, *args)
        assert w0 == j0 and np.array_equal(wf, jf)
    for mod in (TLR, JLR):
        with pytest.raises(ValueError, match="together"):
            mod.fold_affine(w, mu, None)


@pytest.mark.parametrize("kw", [{}, {"label_column": 2},
                                {"label_column": -1, "sep": ";"}])
def test_load_csv_equals_the_reference(tmp_path, kw):
    rng = np.random.default_rng(5)
    raw = np.concatenate([rng.integers(0, 2, size=(9, 1)),
                          rng.normal(size=(9, 4)).round(3)], axis=1)
    path = tmp_path / "lr.csv"
    np.savetxt(path, raw, delimiter=kw.get("sep", ","), fmt="%.3f")
    (X, y), (JX, Jy) = TLR.load_csv(path, **kw), JLR.load_csv(path, **kw)
    assert np.array_equal(X, JX) and np.array_equal(y, Jy)
    assert X.dtype == np.float64 and y.dtype == np.int64


# ---------------------------------------------------------------------------
# encrypted prediction
# ---------------------------------------------------------------------------

def _case():
    """tests/test_logreg.py:126's shapes from a seeded rng: integer
    features, standardisation, weights (one made negative), and the
    querier's key."""
    rng = np.random.default_rng(31)
    X = rng.integers(0, 8, size=(N, D)).astype(np.float64)
    means = tuple(np.mean(X, 0))
    stds = tuple(np.std(X, 0) + 1e-9)
    w = rng.normal(size=D + 1)
    w[1] = -abs(w[1])
    secret, pub = TE.keygen(rng)
    return X, means, stds, w, secret, pub


def _margins(X, w, means, stds):
    """sum_j round(P w'_j) x_j + round(P w0') in Python integers."""
    w0p, wp = TLR.fold_affine(w, means, stds)
    wi = [int(round(P * v)) for v in wp]
    return [sum(wi[j] * int(X[i, j]) for j in range(D)) + int(round(P * w0p))
            for i in range(N)], wi


@pytest.fixture(scope="module")
def encrypted():
    """The case's records encrypted by the port under the querier's key,
    and the port's `predict_homomorphic` through a table of +-5000, its
    margin ciphertexts, decrypted points and margins recorded."""
    X, means, stds, w, secret, pub = _case()
    gen = torch.Generator().manual_seed(3)
    r = TE.random_scalars((N, D), gen)
    cts = TE.encrypt_ints_with_tables(
        TE.BASE_TABLE.table, TE.pub_table(pub).table,
        torch.from_numpy(X.astype(np.int64)), r)       # (n, d, 2, 3, 16)
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((TLR, "predict_homomorphic_ct"),
                          (TE, "decrypt_point"), (TE, "decrypt_ints")):
            def rec(*a, _fn=getattr(mod, name), _name=name, **k):
                seen[_name] = _fn(*a, **k)
                return seen[_name]
            mp.setattr(mod, name, rec)
        probs, preds, found = TLR.predict_homomorphic(
            cts, w, secret, TE.DecryptionTable(limit=5000), means, stds, P)
    margin, found_dec = seen["decrypt_ints"]
    assert np.array_equal(found.numpy(), found_dec.numpy())
    return dict(X=X, means=means, stds=stds, w=w, secret=secret, cts=cts,
                mct=seen["predict_homomorphic_ct"],
                pts=seen["decrypt_point"], margin=margin.numpy(),
                found=found.numpy(), probs=probs.numpy(),
                preds=preds.numpy())


def test_encrypted_margins_are_the_integer_formula(encrypted):
    e = encrypted
    want, wi = _margins(e["X"], e["w"], e["means"], e["stds"])
    assert min(wi) < 0          # a negative weight, through mod n
    assert e["found"].all()
    assert e["margin"].tolist() == want
    assert np.array_equal(e["preds"], (e["probs"] >= 0.5).astype(np.int64))
    assert e["mct"].shape == (N, 2, 3, 16)


def test_encrypted_probs_match_the_clear_pipeline(encrypted):
    e = encrypted
    with _x64():
        clear = _np(JLR.predict_probs(e["X"], jnp.asarray(e["w"]),
                                      e["means"], e["stds"]))
        ref_sig = _np(JLR.sigmoid(jnp.asarray(e["margin"], jnp.float64) / P))
    np.testing.assert_allclose(e["probs"], ref_sig, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(e["probs"], clear, atol=0.02)
    assert JLR.accuracy(e["probs"] >= 0.5, clear >= 0.5) == 1.0


def test_predict_homomorphic_reports_misses(encrypted, monkeypatch):
    """A table smaller than some margins: `found` is False exactly there,
    and nothing stands in for the missing values (the recorded margin
    ciphertexts and decrypted points replayed, so no ladder runs again)."""
    e = encrypted
    monkeypatch.setattr(TLR, "predict_homomorphic_ct",
                        lambda cts, *a: e["mct"] if cts is e["cts"] else None)
    monkeypatch.setattr(TE, "decrypt_point",
                        lambda ct, x: e["pts"] if ct is e["mct"] else None)
    limit = int(np.median(np.abs(e["margin"])))
    probs, preds, found = TLR.predict_homomorphic(
        e["cts"], e["w"], e["secret"], TE.DecryptionTable(limit=limit),
        e["means"], e["stds"], P)
    hit = np.abs(e["margin"]) <= limit
    assert np.array_equal(found.numpy(), hit) and not hit.all()
    np.testing.assert_allclose(probs.numpy()[hit], e["probs"][hit],
                               rtol=1e-12)
    assert np.array_equal(preds.numpy()[hit], e["preds"][hit])


@pytest.fixture(scope="module")
def reference():
    """The reference's crypto with the jax.enable_x64 stand-in (see the
    module docstring); restores it and forgets the Pallas modules after."""
    saved = jax.enable_x64
    jax.enable_x64 = _x64
    try:
        from drynx_tpu.crypto import elgamal as JE
        from drynx_tpu.crypto import pallas_ops
        assert not pallas_ops.available()
        yield JE
    finally:
        jax.enable_x64 = saved
        for name in ("pallas_ops", "pallas_pairing"):
            sys.modules.pop(f"drynx_tpu.crypto.{name}", None)
            if hasattr(jcrypto, name):
                delattr(jcrypto, name)


@pytest.mark.slow
def test_predict_homomorphic_equals_the_reference(encrypted, reference):
    e, JE = encrypted, reference
    cts = jnp.asarray(e["cts"].numpy().astype(np.uint32))
    with _x64():
        probs, preds, found = JLR.predict_homomorphic(
            cts, e["w"], e["secret"], JE.DecryptionTable(limit=5000),
            means=e["means"], std_devs=e["stds"], precision=P)
        mct = JLR.predict_homomorphic_ct(cts, e["w"], e["means"], e["stds"],
                                         P)
        margin, _ = JE.decrypt_ints(mct, e["secret"],
                                    JE.DecryptionTable(limit=5000))
    assert _np(found).all()
    assert _np(margin).tolist() == e["margin"].tolist()
    np.testing.assert_allclose(_np(probs), e["probs"], rtol=1e-12,
                               atol=1e-12)
    assert np.array_equal(_np(preds), (e["probs"] >= 0.5).astype(np.int64))
