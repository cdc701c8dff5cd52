"""The PyTorch port's obfuscation phase and batched Schnorr check against
the JAX reference, on the CPU.

The ciphertext helpers of `crypto/elgamal.py`, the obfuscation proof of
`proofs/obfuscation.py` (its bytes under the reference's scalars, both
packages' verifiers on a valid proof and on each tampered field, the
threshold sampling) and `proofs/schnorr.verify_batch` on valid and forged
signatures, each against the reference; the cluster's obfuscation
bookkeeping (thresholds, proof counts, the survey's draws, the VNs'
verifier); and, marked slow, two obfuscated proofs-on cluster surveys,
`union` and `bool_AND`, which decode as without obfuscation and commit a
clean block. The reference's crypto reaches
drynx_tpu/crypto/pallas_ops.py, which does not import under this jax, so
the module-scoped `reference` fixture installs the `jax.enable_x64`
stand-in of tests/test_torch_survey.py while this module runs and at
teardown forgets every reference module imported under it. The port's
plain versions run on one torch thread here, in inference mode.
"""
import dataclasses
import math
import pickle
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drynx_tpu.crypto import refimpl
from drynx_tpu_torch.crypto import curve as TC
from drynx_tpu_torch.crypto import elgamal as TE
from drynx_tpu_torch.proofs import encoding as TENC
from drynx_tpu_torch.proofs import obfuscation as TOB
from drynx_tpu_torch.proofs import requests as TRQ
from drynx_tpu_torch.proofs import schnorr as TSCH
from drynx_tpu_torch.proofs.safe_pickle import safe_loads
from drynx_tpu_torch.service import query as TQ
from drynx_tpu_torch.service import service as TSV
from test_torch_cluster import _chip_smoke, _count_wrapper_calls, _x64

# three ciphertexts of 0, 5 and 0 under the key X
V, X, PLAIN = 3, 777, (0, 5, 0)
TAMPERS = ("valid", "z", "a1", "obf", "challenge")


@pytest.fixture(scope="module")
def reference():
    """The reference's elgamal, obfuscation and schnorr modules, importable
    and runnable on this jax while this module's tests run."""
    saved, threads = jax.enable_x64, torch.get_num_threads()
    before = set(sys.modules)
    jax.enable_x64 = _x64
    torch.set_num_threads(1)
    try:
        from drynx_tpu.crypto import elgamal, pallas_ops
        from drynx_tpu.proofs import obfuscation, schnorr
        assert not pallas_ops.available()
        yield SimpleNamespace(elgamal=elgamal, obfuscation=obfuscation,
                              schnorr=schnorr)
    finally:
        jax.enable_x64 = saved
        torch.set_num_threads(threads)
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name.startswith("drynx_tpu."):
                parent, _, attr = name.rpartition(".")
                sys.modules.pop(name)
                if hasattr(sys.modules.get(parent), attr):
                    delattr(sys.modules[parent], attr)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _j(a):
    return jnp.asarray(np.asarray(a).astype(np.uint32))


@pytest.fixture(scope="module")
def obf(reference):
    """The ciphertexts, the reference's s and w draws, and the
    reference's proof over them."""
    pub = refimpl.g1_mul(refimpl.G1, X)
    rs = [11 + 7 * i for i in range(V)]
    ct = TC.from_ref_batch([
        p for m, r in zip(PLAIN, rs)
        for p in (refimpl.g1_mul(refimpl.G1, r),
                  refimpl.g1_add(refimpl.g1_mul(refimpl.G1, m),
                                 refimpl.g1_mul(pub, r)))]).reshape(V, 2, 3,
                                                                    16)
    key = jax.random.PRNGKey(3)
    with _x64(False):
        s = reference.elgamal.random_scalars(jax.random.PRNGKey(9), (V,))
        # create_obfuscation_proofs draws w from its key
        w = reference.elgamal.random_scalars(key, (V,))
        ref = reference.obfuscation.create_obfuscation_proofs(key, _j(ct), s)
        ref_bytes = ref.to_bytes()
    return SimpleNamespace(ct=ct, s=_t(s), w=_t(w), ref=ref,
                           ref_bytes=ref_bytes)


def _port_batch(ref) -> TOB.ObfuscationProofBatch:
    return TOB.ObfuscationProofBatch(**{
        f.name: _t(getattr(ref, f.name))
        for f in dataclasses.fields(TOB.ObfuscationProofBatch)})


def _tampered(pb: TOB.ObfuscationProofBatch, what: str):
    """pb with row 1 of one field changed (another valid point for a1 and
    obf, one flipped bit for z and the challenge)."""
    if what == "valid":
        return pb
    t = getattr(pb, what).clone()
    if what in ("z", "challenge"):
        t[1, 0] ^= 1
    else:
        t[1] = t[0]
    return dataclasses.replace(pb, **{what: t})


# ---------------------------------------------------------------------------
# The ciphertext helpers
# ---------------------------------------------------------------------------

@torch.inference_mode()
@pytest.mark.parametrize("helper", ["ct_add", "ct_sub", "ct_scalar_mul",
                                    "ct_zero", "decrypt_check_zero"])
def test_ciphertext_helpers_match_reference(reference, obf, helper):
    JE = reference.elgamal
    ct, other = obf.ct, obf.ct.flip(0).contiguous()
    xs = TE.secret_to_limbs(X)
    with _x64(False):
        mine, theirs = {
            "ct_add": lambda: (TE.ct_add(ct, other),
                               JE.ct_add(_j(ct), _j(other))),
            "ct_sub": lambda: (TE.ct_sub(ct, other),
                               JE.ct_sub(_j(ct), _j(other))),
            "ct_scalar_mul": lambda: (TE.ct_scalar_mul(ct, obf.s),
                                      JE.ct_scalar_mul(_j(ct), _j(obf.s))),
            "ct_zero": lambda: (TE.ct_zero((V,)), JE.ct_zero((V,))),
            "decrypt_check_zero": lambda: (
                TE.decrypt_check_zero(ct, xs),
                JE.decrypt_check_zero(_j(ct), _j(xs))),
        }[helper]()
    if helper == "decrypt_check_zero":
        assert mine.tolist() == np.asarray(theirs).tolist() == [
            m == 0 for m in PLAIN]
    else:
        assert mine.shape == (V, 2, 3, 16)
        assert np.array_equal(TENC.ct_bytes(mine), TENC.ct_bytes(_t(theirs)))
    if helper == "ct_zero":
        assert TC.is_infinity(mine).all()


# ---------------------------------------------------------------------------
# The obfuscation proof
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def verdicts(reference, obf):
    """Both verifiers on the reference's proof and on each tampered copy:
    the port's in one batch of 5 x V values, the reference's one proof at
    a time."""
    pb = _port_batch(obf.ref)
    copies = [_tampered(pb, what) for what in TAMPERS]
    both = TOB.ObfuscationProofBatch(**{
        f.name: torch.cat([getattr(c, f.name) for c in copies])
        for f in dataclasses.fields(TOB.ObfuscationProofBatch)})
    with torch.inference_mode():
        mine = TOB.verify_obfuscation_proofs(both).reshape(len(TAMPERS), V)
    theirs = []
    with _x64(False):
        for c in copies:
            ref = dataclasses.replace(obf.ref, **{
                f.name: _j(getattr(c, f.name))
                for f in dataclasses.fields(TOB.ObfuscationProofBatch)})
            theirs.append(np.asarray(
                reference.obfuscation.verify_obfuscation_proofs(ref)))
    return dict(zip(TAMPERS, zip(mine, theirs)))


@torch.inference_mode()
def test_obfuscation_proof_bytes_match_reference(obf):
    mine = TOB.create_obfuscation_proofs(obf.ct, obf.s, draws=obf.w)
    assert mine.to_bytes() == obf.ref_bytes
    assert safe_loads(pickle.dumps(mine)).to_bytes() == obf.ref_bytes
    with pytest.raises(ValueError, match="generator or draws"):
        TOB.create_obfuscation_proofs(obf.ct, obf.s)


@pytest.mark.parametrize("what", TAMPERS)
def test_obfuscation_verifiers_agree_with_reference(verdicts, what):
    """Both accept the valid proof; a change to row 1 of z, a1, obf or the
    challenge rejects that row only, in both packages."""
    mine, theirs = verdicts[what]
    want = [True] * V
    if what != "valid":
        want[1] = False
    assert mine.tolist() == theirs.tolist() == want


@torch.inference_mode()
@pytest.mark.parametrize("threshold", [0.0, 1 / 3, 1.0])
def test_obfuscation_list_samples_the_first_values(reference, obf,
                                                   threshold):
    """With z changed at row 1, ceil(threshold V) leading rows are checked:
    none (accepted), row 0 (accepted) or all three (rejected), in both
    packages."""
    bad = _tampered(_port_batch(obf.ref), "z")
    mine = TOB.verify_obfuscation_list(bad, threshold)
    with _x64(False):
        theirs = reference.obfuscation.verify_obfuscation_list(
            dataclasses.replace(obf.ref, z=_j(bad.z)), threshold)
    assert mine == theirs == (math.ceil(threshold * V) < 2)


# ---------------------------------------------------------------------------
# The batched Schnorr check
# ---------------------------------------------------------------------------

@torch.inference_mode()
def test_schnorr_verify_batch_matches_reference(reference):
    """Two valid envelopes signatures, one over another message, one with s
    changed, one whose R is off the curve and one signed by another key:
    the port's batch, the reference's batch and the host check agree on
    each."""
    R = reference.schnorr
    x = 0xC0FFEE1234567
    pub = refimpl.g1_mul(refimpl.G1, x)
    msgs = [TRQ._payload("obfuscation", "s", f"cn{i}", "", 0, b"body%d" % i)
            for i in range(6)]
    sigs = [TSCH.sign(x, m, k=91 + i) for i, m in enumerate(msgs)]
    sigs[2] = TSCH.sign(x, msgs[2] + b"!", k=3)
    s = int.from_bytes(sigs[3].s_bytes, "big")
    sigs[3] = TSCH.Signature(sigs[3].r_bytes, ((s + 1) % refimpl.N)
                             .to_bytes(32, "big"))
    r = bytearray(sigs[4].r_bytes)
    r[-1] ^= 1
    sigs[4] = TSCH.Signature(bytes(r), sigs[4].s_bytes)
    sigs[5] = TSCH.sign(x + 1, msgs[5], k=5)
    pubs = [pub] * len(sigs)
    mine = TSCH.verify_batch(pubs, msgs, sigs, device="cpu")
    with _x64(False):
        theirs = R.verify_batch(pubs, msgs, [
            R.Signature.from_bytes(sg.to_bytes()) for sg in sigs])
    host = [TSCH.verify(p, m, sg) for p, m, sg in zip(pubs, msgs, sigs)]
    want = [True, True, False, False, False, False]
    assert mine.tolist() == np.asarray(theirs).tolist() == host == want
    assert TSCH.verify_batch([], [], [], device="cpu").shape == (0,)


# ---------------------------------------------------------------------------
# The cluster's obfuscation bookkeeping
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cluster():
    c = TSV.LocalCluster(n_cns=2, n_dps=2, n_vns=1, seed=3, dlog_limit=2,
                         device="cpu")
    yield c
    c.close()


def test_obfuscated_query_counts_one_proof_per_cn(reference, cluster):
    """Thresholds as the reference sets them, and the audit block's
    obfuscation entries: one proof per CN with proofs, none without."""
    kw = dict(query_min=0, query_max=15, ranges=[(2, 1)] * 16)
    sq = cluster.generate_survey_query("union", proofs=1, obfuscation=True,
                                       thresholds=0.5, **kw)
    assert sq.obfuscation_proof_threshold == 0.5
    assert TQ.query_to_proofs_nbrs(sq) == [2, 0, 2, 2, 2]
    off = cluster.generate_survey_query("union", query_min=0, query_max=15,
                                        obfuscation=True)
    assert off.obfuscation_proof_threshold == 0.0
    plain = cluster.generate_survey_query("union", proofs=1, **kw)
    assert plain.obfuscation_proof_threshold == 0.0
    assert TQ.query_to_proofs_nbrs(plain) == [2, 0, 2, 0, 2]
    assert "obfuscation" in cluster.vns.vns[0].verify_fns
    with pytest.raises(ValueError, match="non-accepted operation"):
        cluster.generate_survey_query("sum", query_min=0, query_max=15,
                                      proofs=1, obfuscation=True,
                                      ranges=[(2, 1)])


@pytest.mark.parametrize("proofs_on", [False, True])
def test_obfuscation_draws_come_last(cluster, proofs_on):
    """A survey draws what it drew before, then one s per CN and, with
    proofs, its proof's w."""
    draw = lambda obf: cluster._draw(torch.Generator().manual_seed(7), 2, 4,
                                     [(2, 1)] * 4, proofs_on, obf)
    before, after = draw(False), draw(True)
    # enc_rs, the range proofs' s, t, m, v, ks_rs, the key-switch proofs' wr
    # and wx, in the order drawn
    flat = lambda d: [d[0], *[t for ts in d[1].values() for t in ts], d[2],
                      *(d[3] or [])]
    assert len(flat(before)) == (8 if proofs_on else 2)
    assert all(torch.equal(a, b) for a, b in zip(flat(before), flat(after)))
    assert before[4] == [] and len(after[4]) == 2
    gen = torch.Generator().manual_seed(7)
    for t in flat(before):
        TE.random_scalars(t.shape[:-1], gen)
    for s, w in after[4]:
        assert torch.equal(s, TE.random_scalars((4,), gen))
        if proofs_on:
            assert torch.equal(w, TE.random_scalars((4,), gen))
        else:
            assert w is None


# ---------------------------------------------------------------------------
# Two obfuscated proofs-on surveys (minutes on the CPU: slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("op, qmax", [("union", 15), ("bool_AND", 1)])
def test_obfuscated_survey_decodes_as_without_and_commits_a_clean_block(
        cluster, op, qmax):
    """Both surveys with proofs, without obfuscation and with it: the same
    decoded result, a clean block, and chip_smoke.py phase 8's launches
    but for the CN count (2 here) and the range check's folds (2 DPs x
    (qmax + 1 or 1) values x 2 CNs digit proofs, at most 8^2, against
    15,000 in 8^5)."""
    rng = np.random.default_rng(5)
    for dp in cluster.dps.values():
        dp.data = rng.integers(0, qmax + 1, size=6)
    ranges = [(2, 1)] * (qmax + 1 if op == "union" else 1)
    res, counts = {}, {}
    with torch.inference_mode():
        for obfuscation in (False, True):
            sq = cluster.generate_survey_query(
                op, query_min=0, query_max=qmax, proofs=1,
                obfuscation=obfuscation, ranges=ranges)
            with pytest.MonkeyPatch.context() as mp:
                cluster.ensure_range_sigs(2)
                n = _count_wrapper_calls(mp)
                res[obfuscation] = cluster.run_survey(sq, seed=3)
            counts[obfuscation] = dict(n)
    cs = _chip_smoke()
    folds = -2 * (5 - (1 if op == "bool_AND" else 2))
    for obfuscation, n_cns in ((False, 0), (True, 2)):
        want = {k: v - cs.SIGNED_OFFSET_LAUNCHES.get(k, 0)
                + n_cns * cs.OBFUSCATION_LAUNCHES.get(k, 0)
                for k, v in cs.EXPECTED_LAUNCHES_CLUSTER.items()}
        want["f12_mulreduce8"] += folds
        assert counts[obfuscation] == want, obfuscation
    got, plain = res[True], res[False]
    assert np.array_equal(np.asarray(got.result), np.asarray(plain.result))
    assert np.array_equal(got.decrypted.is_zero, plain.decrypted.is_zero)
    bitmap = got.block.data.bitmap
    assert len(bitmap) == sum(TQ.query_to_proofs_nbrs(sq)) == 8
    assert set(bitmap.values()) == {TRQ.BM_TRUE}
    assert sum("/obfuscation/" in k for k in bitmap) == 2
    assert got.timers["ObfuscationPhase"] > 0
    assert got.timers["VerifyObfuscation"] > 0
