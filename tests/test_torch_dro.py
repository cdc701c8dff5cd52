"""The PyTorch port's DRO noise phase and shuffle proof against the JAX
reference, on the CPU.

`parallel/dro.py`'s noise list (the reference's golden parameters of
tests/test_scale_axes.py) and slab widths; `shuffle_rerandomize` under the
reference's permutation and scalars, chunked and not; the shuffle proof's
bytes under a shared rng seed, each package's verifier on the other's
proof and on a changed z and challenge (and, marked slow, on the
reference's cheating provers of tests/test_shuffle_proof.py); and the
cluster's DRO phase: the draws (appended last), a noised sum served by a
restarted cluster's prewarmed entry, a pool slab and a fresh
precomputation in one survey, and, marked slow, a proofs-on noised survey
through the VNs. The reference's crypto
reaches drynx_tpu/crypto/pallas_ops.py, which does not import under this
jax, so the module-scoped `reference` fixture installs the
`jax.enable_x64` stand-in of tests/test_torch_survey.py while this module
runs and forgets every reference module imported under it at teardown.
The port's plain versions run on one torch thread, in inference mode.
"""
import dataclasses
import glob
import os
import pickle
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drynx_tpu.crypto import refimpl
from drynx_tpu_torch import pool as tpool
from drynx_tpu_torch.crypto import curve as TC
from drynx_tpu_torch.crypto import elgamal as TE
from drynx_tpu_torch.crypto import params
from drynx_tpu_torch.parallel import dro as TD
from drynx_tpu_torch.pool import replenish as TREP
from drynx_tpu_torch.proofs import encoding as TENC
from drynx_tpu_torch.proofs import requests as TRQ
from drynx_tpu_torch.proofs import shuffle as TS
from drynx_tpu_torch.proofs.safe_pickle import safe_loads
from drynx_tpu_torch.service import query as TQ
from drynx_tpu_torch.service import service as TSV
from test_torch_cluster import _chip_smoke, _count_wrapper_calls, _x64

# five ciphertexts of the noise values below, under the key of seed 5
K, NOISE = 5, (0, 1, -1, 2, -2)
# tests/test_scale_axes.py:200's golden noise parameters
NOISE_CASES = [
    (100, 0.0, 30.0, 100.0, 1.0, 0.0),
    (1000, 0.0, 30.0, 100.0, 1.0, 0.0),
    (512, 5.0, 2.0, 10.0, 1.0, 0.0),
    (256, -3.0, 1.0, 1.0, 2.0, 0.0),
    (300, 0.0, 50.0, 0.5, 1.0, 0.0),
    (200, 0.0, 30.0, 100.0, 1.0, 400.0),
    (1, 0.0, 30.0, 100.0, 1.0, 0.0),
    (10000, 1.5, 12.0, 7.0, 0.5, 0.0),
]
POINT_FIELDS = ("gamma_pt", "y_pts", "t_pts", "t_gamma", "t_a", "t_b")
# the cluster's noise: phase 9's DRO parameters at 6 values
DIFFP = TQ.DiffPParams(noise_list_size=6, lap_mean=0.0, lap_scale=2.0,
                       quanta=1.0, scale=1.0, limit=8.0)


@pytest.fixture(scope="module")
def reference():
    """The reference's elgamal, dro and shuffle modules, importable and
    runnable on this jax while this module's tests run."""
    saved, threads = jax.enable_x64, torch.get_num_threads()
    before = set(sys.modules)
    jax.enable_x64 = _x64
    torch.set_num_threads(1)
    try:
        from drynx_tpu.crypto import elgamal, pallas_ops
        from drynx_tpu.parallel import dro
        from drynx_tpu.proofs import shuffle
        assert not pallas_ops.available()
        yield SimpleNamespace(elgamal=elgamal, dro=dro, shuffle=shuffle)
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


def _port_proof(ref) -> TS.ShuffleProof:
    """The reference's proof object as the port's."""
    pts = {name: _t(getattr(ref, name)) for name in POINT_FIELDS}
    il = TS.ILMPPProof(commits=_t(ref.ilmpp.commits),
                       responses=list(ref.ilmpp.responses),
                       challenge=ref.ilmpp.challenge)
    return TS.ShuffleProof(ilmpp=il, z=list(ref.z), z_gamma=ref.z_gamma,
                           z_s=ref.z_s, challenge=ref.challenge, **pts)


def _ref_proof(R, pr: TS.ShuffleProof):
    """The port's proof object as the reference's."""
    pts = {name: _j(getattr(pr, name)) for name in POINT_FIELDS}
    il = R.shuffle.ILMPPProof(commits=_j(pr.ilmpp.commits),
                              responses=list(pr.ilmpp.responses),
                              challenge=pr.ilmpp.challenge)
    return R.shuffle.ShuffleProof(ilmpp=il, z=list(pr.z), z_gamma=pr.z_gamma,
                                  z_s=pr.z_s, challenge=pr.challenge, **pts)


@pytest.fixture(scope="module")
def shuffled(reference):
    """The ciphertexts, the reference's shuffle of them (its permutation,
    scalars and output), the port's shuffle under the same draws, and both
    packages' proofs of it under one rng seed."""
    R = reference
    x, pub = TE.keygen(np.random.default_rng(5))
    tbl = TE.pub_table(pub)
    rs = [11 + 7 * i for i in range(K)]
    cts = TC.from_ref_batch([
        p for m, r in zip(NOISE, rs)
        for p in (refimpl.g1_mul(refimpl.G1, r),
                  refimpl.g1_add(refimpl.g1_mul(refimpl.G1, m % params.N),
                                 refimpl.g1_mul(pub, r)))]).reshape(K, 2, 3,
                                                                    16)
    h = TC.from_ref(pub)
    with _x64(False):
        ref_tbl = R.elgamal.pub_table(pub).table
        out, perm, r = R.dro.shuffle_rerandomize(jax.random.PRNGKey(1),
                                                 _j(cts), ref_tbl)
        perm = np.asarray(perm)
        betas = TS.limbs_to_ints(_t(r))
        ref = R.shuffle.prove_shuffle(_j(cts), out, perm, betas, _j(h),
                                      np.random.default_rng(9))
    with torch.inference_mode():
        mine, mperm, mr = TD.shuffle_rerandomize(
            cts, tbl.table, perm=torch.from_numpy(perm), r=_t(r))
        proof = TS.prove_shuffle(cts, _t(out), perm, betas, h,
                                 np.random.default_rng(9))
    return SimpleNamespace(x=x, pub=pub, tbl=tbl, ref_tbl=ref_tbl, cts=cts,
                           h=h, out=_t(out), perm=perm, r=_t(r), betas=betas,
                           ref=ref, mine=mine, mr=mr, proof=proof)


# ---------------------------------------------------------------------------
# (1) The noise list and the slab widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,mean,b,quanta,scale,limit", NOISE_CASES)
def test_noise_values_match_reference(reference, size, mean, b, quanta,
                                      scale, limit):
    got = TD.generate_noise_values(size, mean, b, quanta, scale, limit)
    want = reference.dro.generate_noise_values(size, mean, b, quanta, scale,
                                               limit)
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert np.array_equal(got, TD._generate_noise_values_ref(
        size, mean, b, quanta, scale, limit))


@pytest.mark.parametrize("size,chunk", [(0, None), (1, None), (4096, None),
                                        (4097, None), (10_000, None),
                                        (100_000, None), (9, 3), (10, 3),
                                        (5, 0), (5, 10)])
def test_slab_widths_match_reference(reference, size, chunk):
    assert TD.CHUNK == reference.dro.CHUNK
    assert TD.slab_widths(size, chunk) == reference.dro.slab_widths(size,
                                                                    chunk)


# ---------------------------------------------------------------------------
# (2) The shuffle and re-randomization
# ---------------------------------------------------------------------------

def test_shuffle_matches_reference(shuffled):
    """Under the reference's permutation and scalars the port's output has
    the reference's canonical bytes."""
    s = shuffled
    assert torch.equal(s.mr, s.r)
    assert np.array_equal(TENC.ct_bytes(s.mine), TENC.ct_bytes(s.out))


@torch.inference_mode()
def test_chunked_shuffle_equals_unchunked(shuffled):
    """Slabs of 2 (three slabs over five values) give the unchunked bytes,
    limb for limb, for the precomputation and for the shuffle."""
    s = shuffled
    perm = torch.from_numpy(s.perm)
    pre = TD.precompute_rerandomization(s.tbl.table, K, r=s.r, chunk=0)
    pre2 = TD.precompute_rerandomization(s.tbl.table, K, r=s.r, chunk=2)
    assert torch.equal(pre[0], pre2[0]) and torch.equal(pre[1], pre2[1])
    a, pa, ra = TD.shuffle_rerandomize(s.cts, s.tbl.table, perm=perm,
                                       precomp=pre, chunk=0)
    b, pb, rb = TD.shuffle_rerandomize(s.cts, s.tbl.table, perm=perm,
                                       precomp=pre, chunk=2)
    assert torch.equal(pa, pb) and torch.equal(ra, rb) and torch.equal(a, b)
    assert torch.equal(a, s.mine)


def test_dro_table_convention_typeerrors():
    """FixedBase at the encryption boundary, raw tables in the shuffle
    layer: mixing them is a TypeError; randomness must be given."""
    fb, raw = TE.BASE_TABLE, TE.BASE_TABLE.table
    with pytest.raises(TypeError):
        TD.encrypt_noise(raw, [0])
    with pytest.raises(TypeError):
        TD.precompute_rerandomization(fb, 4)
    with pytest.raises(TypeError):
        TD.shuffle_rerandomize(None, fb)
    with pytest.raises(TypeError):
        TD.dro_pipeline(raw, 4, 0.0, 30.0, 100.0)
    with pytest.raises(ValueError, match="generator"):
        TD.precompute_rerandomization(raw, 4)


# ---------------------------------------------------------------------------
# (3) The shuffle proof
# ---------------------------------------------------------------------------

def test_shuffle_proof_bytes_match_reference(shuffled):
    s = shuffled
    assert s.proof.to_bytes() == s.ref.to_bytes()
    back, a, b = safe_loads(pickle.dumps((s.proof, s.cts.numpy(),
                                          s.out.numpy())))
    assert back.to_bytes() == s.ref.to_bytes()
    assert np.array_equal(a, s.cts.numpy()) and np.array_equal(b, s.out)


@pytest.mark.parametrize("zero_at", [None, 0, 3, 6])
def test_ilmpp_responses_match_fermat_chain(zero_at):
    """The responses from one inverse of the last prefix product equal the
    reference's chain of Fermat inverses (drynx_tpu/proofs/shuffle.py:
    128-134), a y of 0 (mod n) included."""
    rng = np.random.default_rng(11)
    draw = lambda n: [TS._rand_scalar(rng) for _ in range(n)]
    xs, ys, thetas, (c,) = draw(7), draw(7), draw(6), draw(1)
    if zero_at is not None:
        ys[zero_at] = params.N
    want, prod, sign = [], 1, 1
    for i in range(6):
        prod = prod * xs[i] % params.N * pow(ys[i], params.N - 2,
                                             params.N) % params.N
        sign = -sign
        want.append((thetas[i] + sign * c * prod) % params.N)
    assert TS._ilmpp_responses(xs, ys, thetas, c) == want


def _tampered(R, s, what):
    """(proof, outputs) for one tamper: the reference's cheating provers of
    tests/test_shuffle_proof.py (an output replaced by an encryption of 99;
    a duplicated index in place of the permutation), or the valid proof
    with z[1] or the challenge changed."""
    if what in ("z", "challenge"):
        v = getattr(s.proof, what)
        v = [v[0], v[1] ^ 1, *v[2:]] if what == "z" else v ^ 1
        return dataclasses.replace(s.proof, **{what: v}), s.out
    perm = s.perm
    out = s.out
    with torch.inference_mode():
        if what == "value":
            evil = TD.encrypt_noise(s.tbl, [99], r=TE.secret_to_limbs(5)[None])
            out = out.clone()
            out[2] = evil[0]
        else:
            perm = np.asarray([0, 0, 2, 3, 4])
            out, _, _ = TD.shuffle_rerandomize(
                s.cts, s.tbl.table, perm=torch.from_numpy(perm), r=s.r)
    with _x64(False):
        ref = R.shuffle.prove_shuffle(_j(s.cts), _j(out), perm, s.betas,
                                      _j(s.h), np.random.default_rng(13))
    return _port_proof(ref), out


@pytest.mark.parametrize("what", [
    "valid", "z", "challenge",
    # the cheating provers each add a proof and two full checks: slow
    *(pytest.param(w, marks=pytest.mark.slow) for w in ("value",
                                                         "duplicate"))])
def test_shuffle_verifiers_agree_with_reference(reference, shuffled, what):
    """The port accepts the reference's proof and the reference the port's;
    both reject each cheating prover and each changed field."""
    R, s = reference, shuffled
    if what == "valid":
        proof, outs, ref_proof = _port_proof(s.ref), s.out, s.proof
    else:
        proof, outs = _tampered(R, s, what)
        ref_proof = proof
    with torch.inference_mode():
        mine = TS.verify_shuffle(proof, s.cts, outs, s.h)
    with _x64(False):
        theirs = bool(R.shuffle.verify_shuffle(
            _ref_proof(R, ref_proof), _j(s.cts), _j(outs), _j(s.h)))
    assert (mine, theirs) == ((True, True) if what == "valid"
                              else (False, False))


# ---------------------------------------------------------------------------
# (6) The cluster's DRO phase
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("proofs_on", [False, True])
def test_dro_draws_come_last(proofs_on):
    """A survey with noise draws what it drew before, then the noise's
    scalars and per CN the permutation, fresh scalars and, with proofs, a
    128-bit prover seed, in that order."""
    cluster = TSV.LocalCluster.__new__(TSV.LocalCluster)
    cluster.device = torch.device("cpu")
    cluster.cns = [None] * 2
    draw = lambda n: cluster._draw(torch.Generator().manual_seed(7), 2, 4,
                                   [(2, 1)] * 4, proofs_on, True, n)
    before, after = draw(0), draw(6)
    flat = lambda d: [d[0], *[t for ts in d[1].values() for t in ts], d[2],
                      *(d[3] or []), *[t for sw in d[4] for t in sw
                                       if t is not None]]
    assert len(flat(before)) == len(flat(after)) == (12 if proofs_on else 4)
    assert all(torch.equal(a, b) for a, b in zip(flat(before), flat(after)))
    assert before[5] is None
    gen = torch.Generator().manual_seed(7)
    for t in flat(before):
        TE.random_scalars(t.shape[:-1], gen)
    noise_r, per_cn = after[5]
    assert torch.equal(noise_r, TE.random_scalars((6,), gen))
    for perm, r, seed in per_cn:
        assert torch.equal(perm, torch.randperm(6, generator=gen))
        assert torch.equal(r, TE.random_scalars((6,), gen))
        if proofs_on:
            words = torch.randint(0, 1 << 16, (8,), generator=gen)
            assert seed == sum(int(w) << (16 * i)
                               for i, w in enumerate(words))
        else:
            assert seed is None


def _noised_query(cluster, proofs, **kw):
    return cluster.generate_survey_query("sum", query_min=0, query_max=15,
                                         proofs=proofs, diffp=DIFFP, **kw)


def _record_final_list(mp):
    """The last shuffle's output (the final noise list), recorded."""
    box, shuffle = {}, TD.shuffle_rerandomize

    def recorded(*a, **k):
        out = shuffle(*a, **k)
        box["out"] = out[0]
        return out

    mp.setattr(TD, "shuffle_rerandomize", recorded)
    return box


def _check_noised(cluster, res, final, clear):
    """The final list decrypts, with the CNs' secrets, to a permutation of
    the clear noise list, and the answer is the clear sum plus the noise
    at index 0."""
    x = sum(c.secret for c in cluster.cns) % params.N
    want = TD.generate_noise_values(6, 0.0, 2.0, 1.0, 1.0, 8.0)
    # decrypted on the host: m B = C2 - x C1, m found among +-8
    small = {refimpl.g1_mul(refimpl.G1, m % params.N): m
             for m in range(-8, 9)}
    pts = TC.to_ref(final.reshape(-1, 3, 16))
    vals = [small[refimpl.g1_add(c2, refimpl.g1_neg(refimpl.g1_mul(c1, x)))]
            for c1, c2 in zip(pts[0::2], pts[1::2])]
    assert sorted(vals) == sorted(want.tolist())
    assert int(res.result) == clear + vals[0]


@torch.inference_mode()
def test_noised_sum_from_prewarmed_entry_pool_slab_and_fresh(tmp_path):
    """Three CNs, each served another way in one proofs-off survey: CN 0 by
    a prewarmed entry that a restarted cluster re-loads (its file deleted
    when used), CN 1 by a slab of the persistent pool, CN 2 by a fresh
    precomputation. The answer is the clear sum plus the noise at index 0."""
    kw = dict(n_cns=3, n_dps=2, n_vns=0, seed=3, dlog_limit=300,
              device="cpu")
    first = TSV.LocalCluster(**kw)
    calls = TD.PRECOMPUTE_CALLS
    first.prewarm_dro(6, cache_dir=str(tmp_path / "pre"))
    assert TD.PRECOMPUTE_CALLS == calls + 3
    files = sorted(glob.glob(str(tmp_path / "pre" / "precomp_*.npz")))
    assert len(files) == 3
    for path in files[1:]:          # CN 0's entry alone survives
        os.unlink(path)
    first.close()

    store = tpool.CryptoPool(str(tmp_path / "pool"), slab_elems=6)
    cluster = TSV.LocalCluster(pool=store, **kw)
    try:
        assert tpool.active_pool() is store
        assert cluster.load_shuffle_precomp(str(tmp_path / "pre")) == 1
        TREP.refill_slab(store, torch.Generator().manual_seed(1),
                         cluster.coll_tbl.table)
        rng = np.random.default_rng(2)
        for dp in cluster.dps.values():
            dp.data = rng.integers(0, 16, size=6)
        clear = sum(int(dp.data.sum()) for dp in cluster.dps.values())
        calls = TD.PRECOMPUTE_CALLS
        with pytest.MonkeyPatch.context() as mp:
            box = _record_final_list(mp)
            res = cluster.run_survey(_noised_query(cluster, 0), seed=4)
        assert TD.PRECOMPUTE_CALLS == calls + 1          # CN 2 alone
        assert not glob.glob(str(tmp_path / "pre" / "precomp_*.npz"))
        stats = store.stats()
        assert stats["consumed"] == 1 and stats["slabs_live"] == 0
        assert res.timers["DROPhase"] > 0
        _check_noised(cluster, res, box["out"], clear)
    finally:
        cluster.close()
    assert tpool.active_pool() is None


@torch.inference_mode()
def test_prewarmed_entry_serves_one_of_two_loaders(tmp_path):
    """Two clusters that hold the same persisted precomputation: the first
    to take it claims its file, and the other skips the entry, so a
    re-randomization mask never serves twice."""
    kw = dict(n_cns=1, n_dps=1, n_vns=0, seed=3, dlog_limit=10,
              device="cpu")
    a = TSV.LocalCluster(**kw)
    a.prewarm_dro(2, cache_dir=str(tmp_path))
    b = TSV.LocalCluster(**kw)
    assert b.load_shuffle_precomp(str(tmp_path)) == 1
    assert b._take_precomp(0, 2) is not None
    assert a._take_precomp(0, 2) is None
    assert os.listdir(tmp_path) == []


@torch.inference_mode()
def test_chip_smoke_holds_kept_calls_against_plain(monkeypatch):
    """chip_smoke.py phase 9's KeptCalls: each G1 wrapper keeps its
    largest call (the reduce: one call of each shape), the wrappers are
    restored after it, and a changed output row at either end of a kept
    call is caught against the plain version."""
    from drynx_tpu_torch.crypto import cuda_ops, cuda_pairing

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "KEPT_EDGE", 2)
    k = TE.random_scalars((7,), torch.Generator().manual_seed(3))
    before = cuda_ops.scalar_mul_flat
    kept = cs.KeptCalls()
    with kept:
        for n in (3, 7, 5):
            p = cuda_ops.fixed_base_mul_flat(TE.BASE_TABLE.table, k[:n], 2)
            q = cuda_ops.scalar_mul_flat(p, k[:n], n_windows=1)
            s = cuda_ops.point_add_flat(p, q)
            cuda_pairing.fp_inv_flat(s[:, 2].contiguous())
        cuda_ops.point_reduce_flat(torch.stack([p, q, s]))
        cuda_ops.point_reduce_flat(torch.stack([p, q]).transpose(0, 1)
                                   .contiguous())
    assert cuda_ops.scalar_mul_flat is before
    assert kept.hold() == {"fixed_base_mul": [("", 7, (2,))],
                           "fp_inv": [("", 7)], "point_add": [("", 7)],
                           "point_reduce": [("", (3, 5)), ("", (5, 2))],
                           "scalar_mul": [("", 7, (("n_windows", 1),))]}
    # the kept rows of the 7-row call: 0, 1 and 5, 6
    out = kept.kept[("scalar_mul_flat", "", (("n_windows", 1),))][2]
    assert len(out) == 4
    for row in (0, 3):
        out[row, 0, 0] ^= 1
        with pytest.raises(SystemExit,
                           match=r"scalar_mul_flat at \[\('', 7"):
            kept.hold()
        out[row, 0, 0] ^= 1


def test_chip_smoke_kept_calls_of_tags_share_one_plain_run(monkeypatch):
    """Phases 10-12's KeptCalls keep the pairing wrappers too, one largest
    call per wrapper and tag, and hold the kept rows of every tag with the
    same other arguments in one plain run (the Fp12 product: one run; the
    slot maps: one a map)."""
    from drynx_tpu_torch.crypto import cuda_pairing as CP
    from drynx_tpu_torch.crypto import fp12 as TF12
    from drynx_tpu_torch.crypto import params as TPAR

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "KEPT_EDGE", 2)
    rng = np.random.default_rng(5)
    a = TF12.from_ref_batch([tuple(
        (int(rng.integers(1, 2 ** 62)) % TPAR.P,
         int(rng.integers(1, 2 ** 62)) % TPAR.P) for _ in range(6))
        for _ in range(6)])
    plain_calls = []
    mul_plain = CP.f12_mul_plain
    monkeypatch.setattr(CP, "f12_mul_plain", lambda *x: plain_calls.append(
        len(x[0])) or mul_plain(*x))
    kept = cs.KeptCalls([w for w in cs.KeptCalls.PAIRING
                         if w[1] in ("f12_mul_flat", "f12_slotmul_flat")])
    with kept:
        for tag, n in (("x", 3), ("y", 6), ("y", 5)):
            kept.tag = tag
            CP.f12_mul_flat(a[:n], a[:n])
            for which in ("frob1", "conj6"):
                CP.f12_slotmul_flat(a[:n], which)
    plain_calls.clear()     # on the CPU the wrappers ran the plain version
    assert kept.hold() == {
        "f12_mul": [("x", 3), ("y", 6)],
        "f12_slotmul": [("x", 3, ("conj6",)), ("y", 6, ("conj6",)),
                        ("x", 3, ("frob1",)), ("y", 6, ("frob1",))]}
    # 3 rows of tag x and the 4 edge rows of tag y's 6-row call
    assert plain_calls == [3 + 4]
    kept.kept[("f12_mul_flat", "y", ())][2][3, 0, 0, 0] ^= 1
    with pytest.raises(SystemExit, match="f12_mul_flat at"):
        kept.hold()


@pytest.mark.slow
@torch.inference_mode()
def test_proofs_on_noised_survey_commits_a_clean_block():
    """A proofs-on noised sum through one VN (3 CNs, 2 DPs, noise slabs of
    3 values): a clean block with three shuffle entries, chip_smoke.py
    phase 9's launch counts for this size, equal transcripts from two
    same-seed runs, the answer the clear sum plus the noise at index 0, and
    a shuffle proof with one z changed BM_FALSE for its envelope only."""
    from drynx_tpu_torch.server.transcript import transcript_digest

    cluster = TSV.LocalCluster(n_cns=3, n_dps=2, n_vns=1, seed=3,
                               dlog_limit=300, device="cpu")
    rng = np.random.default_rng(2)
    for dp in cluster.dps.values():
        dp.data = rng.integers(0, 16, size=6)
    clear = sum(int(dp.data.sum()) for dp in cluster.dps.values())
    sq = _noised_query(cluster, 1, ranges=[(4, 4)])
    cluster.ensure_range_sigs(4)
    digests = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "CHUNK", 3)
        box = _record_final_list(mp)
        for _ in range(2):
            cluster.vns.vns[0].verify_cache.clear()
            counts = _count_wrapper_calls(mp)
            res = cluster.run_survey(sq, seed=5)
            digests.append(transcript_digest(cluster.vns, sq.survey_id))
    assert digests[0] == digests[1]
    cs = _chip_smoke()
    assert dict(counts) == cs.noised_sum_launches(3, 2, 2 * 4 * 3, True)
    bitmap = res.block.data.bitmap
    assert len(bitmap) == sum(TQ.query_to_proofs_nbrs(sq)) == 11
    assert set(bitmap.values()) == {TRQ.BM_TRUE}
    assert sum("/shuffle/" in k for k in bitmap) == 3
    assert res.timers["VerifyShuffle"] > 0
    _check_noised(cluster, res, box["out"], clear)

    vn, sid = cluster.vns.vns[0], sq.survey_id
    key = f"{sid}/shuffle/cn1/shuffle-cn1"
    proof, a, b = safe_loads(vn.stored_proofs(sid)[key])
    proof.z[0] ^= 1
    cn = cluster.cns[1]
    before = dict(vn.bitmap_for(sid))
    code = vn.receive_proof(TRQ.new_proof_request(
        "shuffle", sid, cn.name, "shuffle-cn1", 0,
        pickle.dumps((proof, a, b)), cn.secret))
    after = vn.bitmap_for(sid)
    assert code == TRQ.BM_FALSE
    assert {k for k in after if after[k] != before.get(k)} == {key}
    cluster.close()
